"""The deployment planner, for two targets.

``target="h100"`` (the default, the card the port serves on): every layer
runs ``tiled``: one ``gemm_int8`` launch with the block shape
:func:`repro_torch.core.tiling.plan_api` picks, unless the DR7' fusion DP
puts it in a multi-layer group, which runs as one ``fused_mlp_q8`` launch.
The pipelined-spatial regime (layers spread over cores) is not offered on
this target yet, so every h100 layer carries ``lare = -1``.

A fusion group's working set is priced by
:func:`repro_torch.kernels.fused_mlp.fused_smem_bytes`, the same function
that sizes the fused kernel's shared memory, against one block's budget.

An LM graph (:func:`~repro_torch.plan.graph.model_graph`, a decode step) is
priced as the port runs it: each GEMM one bf16 ``torch.matmul`` at the
graph's batch, ``max(weight bytes / hbm_bw, ops / peak_bf16_ops)`` plus the
launch term, each node its own group (a repeat- and regime-uniform
partition, as the reference's ``_plan_tpu`` makes it).  Its tile is the one
``gemm_int8`` would take for the shape, the kernel the plan's
``quantize_weights`` points at.

``target="aie"``: the paper's own planner, the JAX package's ``_plan_aie``
over the framework-free models of the VEK280 (``hw.AIE_ML``,
``hw.PL_FABRIC``).  Every layer runs LARE (Alg. 1) and is assigned PL (the
cheapest reuse factor whose resources fit ``pl_budget``) or AIE (a ``P_K x
P_N`` spatial split and the best ``aie::mmul`` tile).  AIE layers then
compete for the array's columns: when the summed ``P_K`` exhausts
``usable_cols`` the planner shrinks the split whose interval suffers least,
and spills into a second band only when shrinking costs more than the
Fig.-6 contention penalty.  PL<->AIE transitions are charged the Fig.-7
crossing.  An AIE plan has no ``fusion_groups`` section (each layer its own
group) and names no kernel of the port: it is planned and verified, never
served.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch import hw as hwlib
from repro_torch.core import boundary, lare, tiling
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_mlp import ROWS, fused_smem_bytes
from repro_torch.plan.artifact import (BoundaryPlan, DeploymentPlan,
                                       FusionGroup, LayerPlan, default_cache,
                                       plan_key)
from repro_torch.plan.graph import DataflowGraph, edge_graph, model_graph

TARGET = "h100"
TARGETS = (TARGET, "aie")

# Per-layer spatial split candidates on the AIE array (paper Fig. 5 sweep).
_AIE_SPLITS = (1, 2, 3, 4, 6, 8)
_AIE_MAX_TILES_PER_LAYER = 12


def as_graph(cfg, *, batch: int | None = None) -> DataflowGraph:
    """Accept an EdgeConfig, a ModelConfig or an already-built graph."""
    if isinstance(cfg, DataflowGraph):
        return cfg
    if hasattr(cfg, "layer_shapes") and hasattr(cfg, "dims"):
        return edge_graph(cfg, batch=batch)
    if hasattr(cfg, "family"):
        return model_graph(cfg, batch=batch or 1)
    raise TypeError(f"cannot build a dataflow graph from {type(cfg)!r}")


def _plan_lm(graph: DataflowGraph, *, hw: hwlib.H100,
             key: str) -> DeploymentPlan:
    """One group per GEMM node of a decode step (see the module doc)."""
    batch = graph.batch
    layers, groups, quantize = [], [], False
    for node in graph:
        compute_s = max(node.weight_bytes() / hw.hbm_bw,
                        2.0 * batch * node.macs / hw.peak_bf16_ops)
        est = hw.kernel_overhead_s + compute_s
        api = tiling.plan_api(batch, node.n_in, node.n_out, hw=hw)
        rules = ["regime=tiled", "bf16 torch.matmul",
                 f"DR7'(fuse_group={node.index})"]
        if node.macs >= 1 << 16:
            quantize = True
        layers.append(LayerPlan(
            index=node.index, name=node.name, n_in=node.n_in,
            n_out=node.n_out, regime="tiled", lare=-1.0, p_k=1, p_n=1,
            band=1, api_tile=api.blocks, fuse_group=node.index,
            est_latency_s=est, est_interval_s=est, act=node.act,
            repeat=node.repeat, rules=tuple(rules)))
        groups.append(FusionGroup(id=node.index, layers=(node.index,),
                                  est_latency_s=est * node.repeat,
                                  vmem_bytes=api.smem_bytes))
    boundaries = [
        BoundaryPlan(after_layer=prev.index, from_regime="tiled",
                     to_regime="tiled",
                     crossing_s=2.0 * prev.out_bytes(batch) / hw.hbm_bw)
        for prev in graph.nodes[:-1]]
    est_latency = sum(g.est_latency_s for g in groups) \
        + sum(b.crossing_s for b in boundaries) + hw.kernel_overhead_s
    return DeploymentPlan(
        network=graph.name, target=TARGET, batch=batch, key=key,
        layers=tuple(layers), boundaries=tuple(boundaries),
        est_latency_s=est_latency, est_interval_s=est_latency,
        serve={"quantize_weights": quantize, "prefill_chunk": None,
               "decode_regime": "tiled"},
        kind=graph.kind, fusion_groups=tuple(groups))


def _plan_h100(graph: DataflowGraph, *, hw: hwlib.H100,
               key: str) -> DeploymentPlan:
    if graph.kind == "lm":
        return _plan_lm(graph, hw=hw, key=key)
    batch = graph.batch
    dims = [graph.nodes[0].n_in] + [n.n_out for n in graph]
    layers: list[LayerPlan] = []
    stages: list[boundary.Stage] = []
    quantize = False
    for node in graph:
        api = tiling.plan_api(batch, node.n_in, node.n_out, hw=hw)
        # The fused kernel computes ceil(batch / ROWS) row tiles where the
        # per-layer kernel computes ceil(batch / block_m) blocks of block_m.
        row_trim = min(1.0, math.ceil(batch / ROWS) * ROWS
                       / (math.ceil(batch / api.block_m) * api.block_m))
        rules = ["regime=tiled", f"DR1'(block={api.blocks})"]
        if api.block_n >= api.block_k:
            rules.append("DR2'(N-favored)")
        if node.macs >= 1 << 16:
            quantize = True
        layers.append(LayerPlan(
            index=node.index, name=node.name, n_in=node.n_in,
            n_out=node.n_out, regime="tiled", lare=-1.0, p_k=1, p_n=1,
            band=1, api_tile=api.blocks, fuse_group=0,
            est_latency_s=api.est_s, est_interval_s=api.est_s,
            act=node.act, repeat=node.repeat, rules=tuple(rules)))
        compute_s = max(api.est_s - hw.kernel_overhead_s, 0.0)
        stages.append(boundary.Stage(
            name=node.name, compute_s=compute_s,
            fused_compute_s=compute_s * row_trim,
            out_bytes=node.out_bytes(batch), smem_bytes=api.smem_bytes))

    def group_bytes(i: int, j: int) -> int:
        # A singleton runs gemm_int8; a longer group runs fused_mlp_q8.
        if i == j:
            return stages[i].smem_bytes
        return fused_smem_bytes(dims[i:j + 2])

    groups = boundary.plan_fusion(stages, hw=hw, group_bytes=group_bytes)
    layers = [dataclasses.replace(l, fuse_group=g,
                                  rules=l.rules + (f"DR7'(fuse_group={g})",))
              for l, g in zip(layers, groups)]

    fusion_groups: list[FusionGroup] = []
    for gid in dict.fromkeys(groups):
        members = [i for i, g in enumerate(groups) if g == gid]
        group_stages = [stages[i] for i in members]
        group_cost = boundary.fused_group_cost(group_stages, hw)
        fusion_groups.append(FusionGroup(
            id=gid, layers=tuple(members), est_latency_s=group_cost,
            vmem_bytes=group_bytes(members[0], members[-1])))
        # Per-layer estimates share the group's launch and epilogue costs,
        # so the layer estimates plus the crossings plus the entry launch sum
        # to the plan's latency.
        base = ([s.compute_s for s in group_stages] if len(members) == 1
                else [s.in_group_compute_s for s in group_stages])
        share = (group_cost - sum(base)) / len(members)
        for i, b in zip(members, base):
            layers[i] = dataclasses.replace(layers[i], est_latency_s=b + share,
                                            est_interval_s=b + share)

    boundaries = [
        BoundaryPlan(after_layer=prev.index, from_regime=prev.regime,
                     to_regime=nxt.regime,
                     crossing_s=2.0 * graph.nodes[prev.index].out_bytes(batch)
                     / hw.hbm_bw)
        for prev, nxt in zip(layers, layers[1:])
        if prev.fuse_group != nxt.fuse_group]
    est_latency = sum(g.est_latency_s for g in fusion_groups) \
        + sum(b.crossing_s for b in boundaries) + hw.kernel_overhead_s
    return DeploymentPlan(
        network=graph.name, target=TARGET, batch=batch, key=key,
        layers=tuple(layers), boundaries=tuple(boundaries),
        est_latency_s=est_latency, est_interval_s=est_latency,
        serve={"quantize_weights": quantize, "prefill_chunk": None,
               "decode_regime": "tiled"},
        kind=graph.kind, fusion_groups=tuple(fusion_groups))


# ---------------------------------------------------------------------------
# AIE path (paper-faithful)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _AieChoice:
    """One (P_K, P_N, api tile) candidate for a layer, pre-penalty."""
    interval_s: float
    latency_s: float
    p_k: int
    p_n: int
    s: tuple[int, int, int]


def _aie_candidates(batch: int, n_in: int, n_out: int,
                    aie: hwlib.AieMl) -> list[_AieChoice]:
    """Legal split candidates sorted fastest-first (DR3/DR5 constraints)."""
    out: list[_AieChoice] = []
    for p_k in _AIE_SPLITS:
        for p_n in _AIE_SPLITS:
            if p_k * p_n > _AIE_MAX_TILES_PER_LAYER or p_n > aie.rows \
                    or p_k > aie.usable_cols:
                continue
            q_k, q_n = math.ceil(n_in / p_k), math.ceil(n_out / p_n)
            # DR5: floors on the dims being split.
            if (p_k > 1 and q_k < 16) or (p_n > 1 and q_n < 32):
                continue
            best_s, best_i = None, float("inf")
            for s in aie.legal_api_tiles_i8:
                t = tiling.aie_tile_interval(batch, q_k, q_n, s, aie)
                if t < best_i:
                    best_s, best_i = s, t
            out.append(_AieChoice(
                interval_s=tiling.aie_spatial_interval(
                    batch, n_in, n_out, p_k, p_n, best_s, aie=aie),
                latency_s=tiling.aie_spatial_latency(
                    batch, n_in, n_out, p_k, p_n, best_s, aie=aie),
                p_k=p_k, p_n=p_n, s=best_s))
    out.sort(key=lambda c: (c.interval_s, c.p_k * c.p_n))
    return out


def _resolve_columns(chosen: dict, cands: dict,
                     aie: hwlib.AieMl) -> dict:
    """Column-exhaustion resolution: shrink cheap splits until the summed
    ``P_K`` fits one band, unless shrinking costs more than spilling
    (Fig. 6).  Returns {layer key: band} and mutates ``chosen``.

    Keys only need to sort stably (ints for a single net; ``(tenant,
    layer)`` tuples when the fleet packer pools several nets' layers into
    one joint resolution), so co-resident networks compete for the same
    columns under the same shrink-vs-spill rule."""

    def cols() -> int:
        return sum(c.p_k for c in chosen.values())

    spill_interval = _spilled_worst_interval(chosen, aie)
    while cols() > aie.usable_cols:
        # Cheapest single-layer shrink that reduces column usage.
        best_li, best_alt, best_cost = None, None, float("inf")
        for li, cur in chosen.items():
            for alt in cands[li]:
                if alt.p_k < cur.p_k:
                    cost = alt.interval_s - cur.interval_s
                    if cost < best_cost:
                        best_li, best_alt, best_cost = li, alt, cost
                    break            # candidates are sorted; first is cheapest
        if best_li is None:
            break                    # nothing shrinkable: must spill
        # Worst interval if we shrink vs worst interval if we stop and spill.
        trial = dict(chosen)
        trial[best_li] = best_alt
        shrink_worst = max(c.interval_s for c in trial.values())
        if shrink_worst > spill_interval:
            break                    # DR6: the band-2 penalty is cheaper
        chosen[best_li] = best_alt
    # Bands first-fit in layer order: only band-1 residents consume band-1
    # columns, so one oversized layer spilling does not cascade every later
    # layer (or tenant) into band 2 while band-1 columns sit free.
    bands: dict = {}
    col = 0
    for li in sorted(chosen):
        c = chosen[li]
        if col + c.p_k <= aie.usable_cols:
            bands[li] = 1
            col += c.p_k
        else:
            bands[li] = 2
    return bands


def _spilled_worst_interval(chosen: dict, aie: hwlib.AieMl) -> float:
    """Worst-layer interval if the current overflow goes to band 2 as-is
    (same first-fit band rule as the final assignment)."""
    spilled = []
    col = 0
    for li in sorted(chosen):
        if col + chosen[li].p_k <= aie.usable_cols:
            col += chosen[li].p_k
        else:
            spilled.append(li)
    worst = 0.0
    penalty = 1.0 + aie.band2_penalty_per_layer * len(spilled)
    for li in sorted(chosen):
        t = chosen[li].interval_s * (penalty if li in spilled else 1.0)
        worst = max(worst, t)
    return worst


@dataclasses.dataclass
class _AiePrep:
    """Per-graph LARE decisions, PL picks and AIE candidate lists: what the
    column allocator needs, before any columns are committed.  Shared by
    the single-net path and the fleet packer
    (:mod:`repro_torch.plan.multinet`), which pools several preps'
    candidates into one joint :func:`_resolve_columns` call."""
    lares: dict[int, lare.LareResult]
    regimes: dict[int, str]
    pl_plans: dict[int, tuple[int, float, float]]   # i -> (rf, ival, lat)
    cands: dict[int, list[_AieChoice]]


def _aie_prepare(graph: DataflowGraph, *, pl_budget: float,
                 pl: hwlib.PlFabric, aie: hwlib.AieMl) -> _AiePrep:
    batch = graph.batch
    lares = {n.index: lare.lare(n.n_in, n.n_out, batch=batch, pl=pl, aie=aie)
             for n in graph}
    regimes = {i: r.decide(pl_budget) for i, r in lares.items()}

    # PL layers: cheapest interval whose resources fit the budget.
    pl_plans: dict[int, tuple[int, float, float]] = {}
    for node in graph:
        if regimes[node.index] != "pl":
            continue
        pick = None
        for rf in pl.legal_reuse_factors(node.n_in, node.n_out):
            res = pl.resources(node.n_in, node.n_out, rf)
            if pl.fits(res) and pl.resource_scalar(res) <= pl_budget:
                pick = rf
                break                                   # rfs ascend: min II
        if pick is None:        # the budget cannot host it: send it to AIE
            regimes[node.index] = "aie"
            continue
        pl_plans[node.index] = (pick, pl.interval_s(pick),
                                pl.latency_s(node.n_in, node.n_out, pick,
                                             batch))

    cands = {n.index: _aie_candidates(batch, n.n_in, n.n_out, aie)
             for n in graph if regimes[n.index] == "aie"}
    return _AiePrep(lares=lares, regimes=regimes, pl_plans=pl_plans,
                    cands=cands)


def _aie_layers(graph: DataflowGraph, prep: _AiePrep,
                chosen: dict[int, _AieChoice], bands: dict[int, int],
                n_band2: int, *,
                aie: hwlib.AieMl = hwlib.AIE_ML) -> list[LayerPlan]:
    """LayerPlans from resolved choices.  ``n_band2`` is the band-2
    population of the WHOLE array (fleet-wide under co-residency), so
    contention is priced against every spilled layer, not just this
    net's."""
    layers: list[LayerPlan] = []
    for node in graph:
        i = node.index
        rules: list[str] = []
        if prep.regimes[i] == "pl":
            rf, ival, lat = prep.pl_plans[i]
            rules.append(
                f"LARE={prep.lares[i].lare:.1f}<=budget -> PL(rf={rf})")
            layers.append(LayerPlan(
                index=i, name=node.name, n_in=node.n_in, n_out=node.n_out,
                regime="pl", lare=prep.lares[i].lare, p_k=1, p_n=1, band=0,
                api_tile=(0, 0, 0), fuse_group=i, est_latency_s=lat,
                est_interval_s=ival, act=node.act, repeat=node.repeat,
                rules=tuple(rules)))
            continue
        c, band = chosen[i], bands[i]
        penalty = (1.0 + aie.band2_penalty_per_layer * n_band2) \
            if band > 1 else 1.0
        rules.append(f"LARE={prep.lares[i].lare:.1f}>budget -> AIE")
        if c.p_k > 1:
            rules.append(f"DR3(K-expansion P_K={c.p_k})")
        rules.append(f"DR1(api={c.s})")
        if band > 1:
            rules.append(f"DR6(band-2 spill, {n_band2} layers)")
        layers.append(LayerPlan(
            index=i, name=node.name, n_in=node.n_in, n_out=node.n_out,
            regime="aie", lare=prep.lares[i].lare, p_k=c.p_k, p_n=c.p_n,
            band=band, api_tile=c.s, fuse_group=i,
            est_latency_s=c.latency_s * penalty,
            est_interval_s=c.interval_s * penalty, act=node.act,
            repeat=node.repeat, rules=tuple(rules)))
    return layers


def _aie_totals(graph: DataflowGraph, layers: list[LayerPlan],
                aie: hwlib.AieMl
                ) -> tuple[list[BoundaryPlan], float, float]:
    """Boundary charges at every PL<->AIE transition (DR7 / Fig. 7) and the
    resulting latency/interval totals."""
    batch = graph.batch
    base_latency = sum(l.est_latency_s for l in layers)
    boundaries: list[BoundaryPlan] = []
    for prev, nxt in zip(layers, layers[1:]):
        if prev.regime != nxt.regime:
            boundaries.append(BoundaryPlan(
                after_layer=prev.index, from_regime=prev.regime,
                to_regime=nxt.regime,
                crossing_s=boundary.crossing_cost_aie(
                    graph.nodes[prev.index].out_bytes(batch), base_latency,
                    aie=aie)))
    est_latency = base_latency + sum(b.crossing_s for b in boundaries)
    est_interval = max(l.est_interval_s for l in layers)
    return boundaries, est_latency, est_interval


def _plan_aie(graph: DataflowGraph, *, pl_budget: float,
              pl: hwlib.PlFabric, aie: hwlib.AieMl,
              key: str) -> DeploymentPlan:
    prep = _aie_prepare(graph, pl_budget=pl_budget, pl=pl, aie=aie)
    chosen = {i: c[0] for i, c in prep.cands.items()}
    bands = _resolve_columns(chosen, prep.cands, aie)
    n_band2 = sum(1 for b in bands.values() if b > 1)
    layers = _aie_layers(graph, prep, chosen, bands, n_band2, aie=aie)
    boundaries, est_latency, est_interval = _aie_totals(graph, layers, aie)
    return DeploymentPlan(
        network=graph.name, target="aie", batch=graph.batch, key=key,
        layers=tuple(layers), boundaries=tuple(boundaries),
        est_latency_s=est_latency, est_interval_s=est_interval,
        serve={"quantize_weights": True, "prefill_chunk": None},
        kind=graph.kind)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def aie_options(*, pl_budget: float = 400.0,
                pl: hwlib.PlFabric | None = None,
                aie: hwlib.AieMl | None = None, machine_model=None) -> dict:
    """The AIE target's knobs with defaults applied, the one source of the
    cache key and the search: a fitted ``machine_model``
    (:class:`repro_torch.characterize.MachineModel`) re-parameterizes
    ``aie`` through its ``aie()``, and its version enters the key."""
    aie = aie if aie is not None else hwlib.AIE_ML
    if machine_model is not None:
        aie = machine_model.aie(base=aie)
    return {"pl_budget": pl_budget,
            "pl": pl if pl is not None else hwlib.PL_FABRIC, "aie": aie,
            "machine_model": machine_model}


def _key_for(graph: DataflowGraph, target: str, hw: hwlib.H100,
             aie_opts: dict | None = None) -> str:
    if target == "aie":
        opts = aie_opts if aie_opts is not None else aie_options()
        mm = opts["machine_model"]
        return plan_key(graph, target, (opts["pl"], opts["aie"]),
                        {"pl_budget": opts["pl_budget"],
                         "machine_model": mm.version if mm is not None
                         else None})
    if target != TARGET:
        raise ValueError(f"unknown target {target!r} (want one of "
                         f"{TARGETS})")
    # An LM plan also reads the bf16 rate, which edge plans leave out.
    extra = {"peak_bf16_ops": hw.peak_bf16_ops} if graph.kind == "lm" \
        else None
    return plan_key(graph, target, (hw,), extra)


def _plan(graph: DataflowGraph, target: str, hw: hwlib.H100,
          aie_opts: dict, key: str) -> DeploymentPlan:
    if target == "aie":
        return _plan_aie(graph, pl_budget=aie_opts["pl_budget"],
                         pl=aie_opts["pl"], aie=aie_opts["aie"], key=key)
    return _plan_h100(graph, hw=hw, key=key)


def plan_deployment(cfg, *, target: str = TARGET, batch: int | None = None,
                    hw: hwlib.H100 = hwlib.H100_SXM,
                    pl_budget: float = 400.0,
                    pl: hwlib.PlFabric | None = None,
                    aie: hwlib.AieMl | None = None, machine_model=None,
                    device=None) -> DeploymentPlan:
    """Plan one deployment of an EdgeConfig, a ModelConfig (its decode
    step) or a graph for ``target``: ``"h100"`` (the card, under ``hw``)
    or ``"aie"`` (the paper's VEK280, under ``pl_budget``, ``pl`` and
    ``aie``).  A fitted ``machine_model`` replaces ``hw`` with its
    ``h100(base=hw)`` and ``aie`` with its ``aie(base=aie)``.

    ``device`` is where the plan will run: ``None`` means the GPU and raises
    when there is none (the plan itself does not depend on it)."""
    resolve_device(device)
    graph = as_graph(cfg, batch=batch)
    if machine_model is not None:
        hw = machine_model.h100(base=hw)
    opts = aie_options(pl_budget=pl_budget, pl=pl, aie=aie,
                       machine_model=machine_model)
    return _plan(graph, target, hw, opts, _key_for(graph, target, hw, opts))


def get_or_plan(cfg, *, target: str = TARGET, batch: int | None = None,
                hw: hwlib.H100 = hwlib.H100_SXM, pl_budget: float = 400.0,
                pl: hwlib.PlFabric | None = None,
                aie: hwlib.AieMl | None = None, machine_model=None,
                cache=None, device=None) -> DeploymentPlan:
    """Cache-aware :func:`plan_deployment`."""
    resolve_device(device)
    cache = cache if cache is not None else default_cache()
    graph = as_graph(cfg, batch=batch)
    if machine_model is not None:
        hw = machine_model.h100(base=hw)
    opts = aie_options(pl_budget=pl_budget, pl=pl, aie=aie,
                       machine_model=machine_model)
    key = _key_for(graph, target, hw, opts)
    hit = cache.get(key)
    if hit is not None:
        return hit
    return cache.put(_plan(graph, target, hw, opts, key))
