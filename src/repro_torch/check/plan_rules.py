"""Layer 1: the plan verifier, with zero execution.

Port of the JAX package's ``check/plan_rules.py`` for the fields the port's
plans carry (``plan/artifact.py``: layers, boundaries, fusion groups,
totals, serve; ``plan/multinet.py``: tenant columns and budgets), for both
targets (``h100``, the card; ``aie``, the paper's VEK280 array):

=======================  ==================================================
rule                     invariant
=======================  ==================================================
plan.unknown-key         no unrecognized top-level artifact keys (info)
plan.layer-chain         indices ascending; edge layers chain n_out -> n_in
plan.tile-legal          h100: each layer's tile is one ``gemm_int8`` takes
                         (``core/tiling.tile_ok``); aie: a legal
                         ``aie::mmul`` i8 shape (DR1)
plan.spatial-budget      aie: P_K*P_N cap, DR5 floors, band legality
plan.column-budget       aie: fleet-wide band-1 columns fit usable_cols
plan.fusion-groups       groups consecutive, uniform, partition the layers
plan.vmem-budget         each group's working set fits one block's shared
                         memory (``hw.smem_bytes``)
plan.boundary-structure  a boundary exactly where the fuse group (h100) or
                         the regime changes
plan.latency-invariant   est == sum(parts) + crossings + overhead >= 0
plan.serve-keys          the serve keys the planner writes are legal
fleet.columns-overlap    aie: tenant column ranges disjoint, each tenant's
                         cols its plan's band-1 columns (DR6)
fleet.budget             budgets cover planned latency + crossing
=======================  ==================================================
"""

from __future__ import annotations

import json
import math
import pathlib

from repro_torch import hw as hwlib
from repro_torch.check import ArtifactError, Finding
from repro_torch.core import tiling
from repro_torch.plan.planner import _AIE_MAX_TILES_PER_LAYER as _AIE_MAX_TILES

# Relative slack for float identities that calibration rescales under.
_REL_TOL = 5e-3

# The planner's keys, the LM batch policy, the priority class, the tail
# contract and the supervisor's knobs the fleet planner adds
# (plan/multinet.py), and the record calibration feedback adds
# (plan/calibrate.py).
_SERVE_KEYS = {"decode_regime", "quantize_weights", "prefill_chunk",
               "slots", "admit_per_tick", "max_queue_depth", "calibration",
               "resilience", "priority", "slo"}
_PRIORITIES = ("critical", "standard", "batch")
_RESILIENCE_KEYS = {"breaker_k", "breaker_cooldown", "retries", "backoff_s",
                    "deadline_factor"}
_DECODE_REGIMES = ("pipeline", "tiled")

# The artifact's top-level keys (``plan/artifact.py``, ``plan/multinet.py``).
_PLAN_KEYS = {"schema", "kind", "network", "target", "batch", "key",
              "layers", "boundaries", "fusion_groups", "totals", "serve"}
_FLEET_KEYS = {"schema", "kind", "name", "target", "key", "tenants",
               "totals"}
_TENANT_KEYS = {"net_id", "col_offset", "cols", "crossing_s",
                "latency_budget_s", "plan"}


def _close(a: float, b: float, *, rel: float = _REL_TOL,
           abs_tol: float = 1e-9) -> bool:
    return math.isclose(a, b, rel_tol=rel, abs_tol=abs_tol)


def as_fleet(fleet_or_plan):
    """A ``FleetPlan`` as is; a ``DeploymentPlan`` as a one-tenant fleet."""
    from repro_torch.plan.multinet import FleetPlan
    if isinstance(fleet_or_plan, FleetPlan):
        return fleet_or_plan
    return FleetPlan.from_plan(fleet_or_plan)


def unknown_key_findings(d: dict, known: set, *, what: str,
                         tenant: str | None = None) -> list:
    """Info findings for top-level keys the schema does not define: the
    loader ignores them, so a misspelt section would silently do nothing."""
    return [Finding(rule="plan.unknown-key", severity="info", tenant=tenant,
                    detail=f"{what} artifact carries unknown top-level key "
                           f"{k!r} (ignored by the loader)")
            for k in sorted(set(d) - known)]


def load_artifact(path):
    """Decode a plan or fleet artifact into a ``FleetPlan`` and its
    load-time findings, without executing it.  Undecodable input raises
    :class:`ArtifactError`."""
    from repro_torch.plan.artifact import DeploymentPlan
    from repro_torch.plan.multinet import FleetPlan
    p = pathlib.Path(path)
    try:
        text = p.read_text()
    except OSError as e:
        raise ArtifactError(f"{p}: {e.strerror or e}") from None
    try:
        d = json.loads(text)
    except json.JSONDecodeError as e:
        raise ArtifactError(f"{p}: malformed plan JSON "
                            f"({e.msg} at line {e.lineno})") from None
    if not isinstance(d, dict):
        raise ArtifactError(f"{p}: plan artifact must be a JSON object, "
                            f"got {type(d).__name__}")
    findings = []
    try:
        if "tenants" in d:
            findings += unknown_key_findings(d, _FLEET_KEYS, what="fleet",
                                             tenant=d.get("name"))
            for t in d["tenants"]:
                findings += unknown_key_findings(
                    t, _TENANT_KEYS, what="tenant", tenant=t.get("net_id"))
                findings += unknown_key_findings(
                    t["plan"], _PLAN_KEYS, what="plan",
                    tenant=t.get("net_id"))
            fleet = FleetPlan.from_dict(d)
        else:
            findings += unknown_key_findings(d, _PLAN_KEYS, what="plan",
                                             tenant=d.get("network"))
            fleet = FleetPlan.from_plan(DeploymentPlan.from_dict(d))
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise ArtifactError(f"{p}: undecodable plan artifact "
                            f"({e.__class__.__name__}: {e})") from None
    return fleet, findings


# ---------------------------------------------------------------------------
# Single-plan rules
# ---------------------------------------------------------------------------

def verify_plan(plan, *, tenant: str | None = None, hw=None,
                aie=None) -> list:
    """All layer-1 findings for one ``DeploymentPlan``: an ``aie`` plan's
    tiles and splits against ``aie`` (default ``hw.AIE_ML``), any other's
    against the card's kernels and ``hw`` (default ``hw.H100_SXM``)."""
    hw = hw if hw is not None else hwlib.H100_SXM
    aie = aie if aie is not None else hwlib.AIE_ML
    tenant = tenant if tenant is not None else plan.network
    tiles = (_rule_tiles_aie(plan, tenant, aie) if plan.target == "aie"
             else _rule_tiles(plan, tenant))
    return (_rule_layer_chain(plan, tenant) + tiles
            + _rule_fusion_groups(plan, tenant, hw)
            + _rule_boundaries(plan, tenant)
            + _rule_latency_invariant(plan, tenant)
            + _rule_serve_section(plan, tenant))


def _rule_layer_chain(plan, tenant) -> list:
    fs = []
    idx = [l.index for l in plan.layers]
    if idx != sorted(set(idx)):
        fs.append(Finding(
            rule="plan.layer-chain", severity="error", tenant=tenant,
            detail=f"layer indices must be unique and ascending, got {idx}"))
    if plan.kind == "edge":
        for prev, nxt in zip(plan.layers, plan.layers[1:]):
            if prev.n_out != nxt.n_in:
                fs.append(Finding(
                    rule="plan.layer-chain", severity="error", tenant=tenant,
                    layer=nxt.index,
                    detail=f"layer {nxt.name!r} consumes n_in={nxt.n_in} but "
                           f"{prev.name!r} produces n_out={prev.n_out}"))
    return fs


def _rule_tiles(plan, tenant) -> list:
    """Every layer's tile runs ``gemm_int8`` (its singleton group, or the
    per-layer rung), which takes only the tiles it was built for."""
    return [Finding(
        rule="plan.tile-legal", severity="error", tenant=tenant,
        layer=l.index,
        detail=f"tile {tuple(l.api_tile)} on {l.name!r} is not one "
               f"gemm_int8 takes (block_m in {tiling.BLOCK_M}, block_k in "
               f"{tiling.BLOCK_K}, block_n in {tiling.BLOCK_N})")
        for l in plan.layers
        if len(l.api_tile) != 3 or not tiling.tile_ok(*l.api_tile)]


def _rule_tiles_aie(plan, tenant, aie) -> list:
    """DR1 (legal aie::mmul shapes), DR3/DR5 (split caps and floors) and
    band legality of every AIE-regime layer (PL layers hold no tile)."""
    fs = []
    for l in plan.layers:
        if l.regime == "pl":
            continue
        if tuple(l.api_tile) not in aie.legal_api_tiles_i8:
            fs.append(Finding(
                rule="plan.tile-legal", severity="error", tenant=tenant,
                layer=l.index,
                detail=f"api tile {tuple(l.api_tile)} on {l.name!r} is not "
                       f"a legal aie::mmul i8 shape"))
        if l.p_k * l.p_n > _AIE_MAX_TILES or l.p_n > aie.rows \
                or l.p_k > aie.usable_cols:
            fs.append(Finding(
                rule="plan.spatial-budget", severity="error", tenant=tenant,
                layer=l.index,
                detail=f"split {l.p_k}x{l.p_n} on {l.name!r} exceeds the "
                       f"per-layer tile cap ({_AIE_MAX_TILES}) or array "
                       f"dims"))
        q_k = math.ceil(l.n_in / max(l.p_k, 1))
        q_n = math.ceil(l.n_out / max(l.p_n, 1))
        if (l.p_k > 1 and q_k < 16) or (l.p_n > 1 and q_n < 32):
            fs.append(Finding(
                rule="plan.spatial-budget", severity="error", tenant=tenant,
                layer=l.index,
                detail=f"DR5 floor violated on {l.name!r}: split "
                       f"{l.p_k}x{l.p_n} leaves q_k={q_k}, q_n={q_n} "
                       f"(need q_k>=16 when P_K>1, q_n>=32 when P_N>1)"))
        if l.band not in (1, 2):
            fs.append(Finding(
                rule="plan.spatial-budget", severity="error", tenant=tenant,
                layer=l.index,
                detail=f"band {l.band} on {l.name!r} (AIE layers sit in "
                       f"band 1 or the spill band 2)"))
    return fs


def _rule_fusion_groups(plan, tenant, hw) -> list:
    """DR7' structure: groups partition the layers into consecutive runs,
    each repeat- and regime-uniform, matching the per-layer fuse_group ids;
    every group's working set fits one block's shared memory."""
    fs = []
    by_index = {l.index: l for l in plan.layers}
    seen: list = []
    for g in plan.fusion_groups:
        members = list(g.layers)
        if not members or members != list(range(members[0],
                                                 members[-1] + 1)):
            fs.append(Finding(
                rule="plan.fusion-groups", severity="error", tenant=tenant,
                layer=members[0] if members else None,
                detail=f"group {g.id} layers {members} are not consecutive"))
        missing = [i for i in members if i not in by_index]
        if missing:
            fs.append(Finding(
                rule="plan.fusion-groups", severity="error", tenant=tenant,
                detail=f"group {g.id} names layer indices {missing} the "
                       f"plan does not have"))
            continue
        ls = [by_index[i] for i in members]
        if len({l.repeat for l in ls}) > 1 or len({l.regime for l in ls}) > 1:
            fs.append(Finding(
                rule="plan.fusion-groups", severity="error", tenant=tenant,
                layer=members[0],
                detail=f"group {g.id} mixes repeats/regimes "
                       f"({[(l.repeat, l.regime) for l in ls]}) - a fused "
                       f"launch executes all members together"))
        bad_ids = [l.index for l in ls if l.fuse_group != g.id]
        if bad_ids:
            fs.append(Finding(
                rule="plan.fusion-groups", severity="error", tenant=tenant,
                layer=bad_ids[0],
                detail=f"layers {bad_ids} carry fuse_group != group id "
                       f"{g.id}"))
        seen += members
        if g.vmem_bytes > hw.smem_bytes:
            fs.append(Finding(
                rule="plan.vmem-budget", severity="error", tenant=tenant,
                layer=members[0] if members else None,
                detail=f"group {g.id} working set {g.vmem_bytes} B exceeds "
                       f"one block's shared memory {hw.smem_bytes} B"))
    if plan.fusion_groups and sorted(seen) != sorted(by_index):
        fs.append(Finding(
            rule="plan.fusion-groups", severity="error", tenant=tenant,
            detail=f"fusion groups cover layers {sorted(seen)} but the plan "
                   f"has {sorted(by_index)} (must partition exactly)"))
    return fs


def _rule_boundaries(plan, tenant) -> list:
    """DR7 structure: a boundary charge exists exactly where the fuse group
    or the regime changes (an AIE plan: where the regime changes), and its
    regimes match the adjacent layers."""
    fs = []
    by_after = {b.after_layer: b for b in plan.boundaries}
    if len(by_after) != len(plan.boundaries):
        fs.append(Finding(
            rule="plan.boundary-structure", severity="error", tenant=tenant,
            detail="duplicate boundary after_layer entries"))
    aie = plan.target == "aie"
    expected = {prev.index: (prev, nxt)
                for prev, nxt in zip(plan.layers, plan.layers[1:])
                if prev.regime != nxt.regime
                or (not aie and prev.fuse_group != nxt.fuse_group)}
    for after, (prev, nxt) in expected.items():
        b = by_after.get(after)
        if b is None:
            fs.append(Finding(
                rule="plan.boundary-structure", severity="error",
                tenant=tenant, layer=after,
                detail=f"missing boundary after layer {after} "
                       f"({prev.name!r} -> {nxt.name!r} crosses a "
                       f"group/regime edge but charges nothing)"))
            continue
        if b.from_regime != prev.regime or b.to_regime != nxt.regime:
            fs.append(Finding(
                rule="plan.boundary-structure", severity="error",
                tenant=tenant, layer=after,
                detail=f"boundary after layer {after} says "
                       f"{b.from_regime}->{b.to_regime} but the layers are "
                       f"{prev.regime}->{nxt.regime}"))
        if b.crossing_s < 0:
            fs.append(Finding(
                rule="plan.boundary-structure", severity="error",
                tenant=tenant, layer=after,
                detail=f"negative crossing charge {b.crossing_s} after "
                       f"layer {after}"))
    for after in sorted(set(by_after) - set(expected)):
        fs.append(Finding(
            rule="plan.boundary-structure", severity="error", tenant=tenant,
            layer=after,
            detail=f"boundary after layer {after} charges a crossing no "
                   f"group/regime change justifies"))
    return fs


def _rule_latency_invariant(plan, tenant) -> list:
    """``est_latency == sum(layer est x repeat) + sum(crossings) +
    overhead`` with ``overhead >= 0``, and the fusion-group estimates sum to
    the per-layer parts (each layer carries its share of its group).  An
    AIE plan's totals sum its layers un-repeated and it has no groups."""
    fs = []
    aie = plan.target == "aie"
    parts = sum(l.est_latency_s * (1 if aie else l.repeat)
                for l in plan.layers)
    crossings = sum(b.crossing_s for b in plan.boundaries)
    overhead = plan.est_latency_s - parts - crossings
    tol = _REL_TOL * max(plan.est_latency_s, 1e-12)
    if overhead < -tol:
        fs.append(Finding(
            rule="plan.latency-invariant", severity="error", tenant=tenant,
            detail=f"est_latency_s={plan.est_latency_s:.3e} is less than "
                   f"its parts (layers {parts:.3e} + crossings "
                   f"{crossings:.3e}): overhead {overhead:.3e} < 0"))
    if plan.est_latency_s <= 0 or plan.est_interval_s <= 0:
        fs.append(Finding(
            rule="plan.latency-invariant", severity="error", tenant=tenant,
            detail=f"totals must be positive (est_latency_s="
                   f"{plan.est_latency_s}, est_interval_s="
                   f"{plan.est_interval_s})"))
    if plan.fusion_groups and not aie:
        group_sum = sum(g.est_latency_s for g in plan.fusion_groups)
        if not _close(group_sum, parts, abs_tol=tol):
            fs.append(Finding(
                rule="plan.latency-invariant", severity="error",
                tenant=tenant,
                detail=f"fusion-group estimates sum to {group_sum:.3e} but "
                       f"the per-layer parts sum to {parts:.3e} (shares no "
                       f"longer decompose the group costs)"))
    return fs


def _rule_serve_section(plan, tenant) -> list:
    """Serve-section vocabulary: the keys the port's planners write
    (``decode_regime``, ``quantize_weights``, the LM batch policy
    ``slots``, ``prefill_chunk``, ``admit_per_tick``, ``max_queue_depth``,
    the ``priority`` class, the ``slo`` tail contract and the supervisor's
    ``resilience`` knobs) must be legal and consistent, beside calibration
    feedback's ``calibration`` record; any other key is one warning, since
    nothing in the port reads it."""
    fs = []
    serve = plan.serve

    def bad(detail, severity="error"):
        fs.append(Finding(rule="plan.serve-keys", severity=severity,
                          tenant=tenant, detail=detail))

    if not isinstance(serve, dict):
        bad(f"serve section must be an object, got {type(serve).__name__}")
        return fs
    for k in sorted(set(serve) - _SERVE_KEYS):
        bad(f"serve section carries unknown key {k!r} (the port reads "
            f"{sorted(_SERVE_KEYS)})", severity="warning")
    slo = serve.get("slo")
    if slo is not None:
        if not isinstance(slo, dict):
            bad(f"serve.slo must be an object, got {type(slo).__name__}")
        else:
            p95, p99 = slo.get("p95_s"), slo.get("p99_s")
            if not isinstance(p95, (int, float)) or p95 <= 0:
                bad(f"serve.slo.p95_s must be a positive number, got {p95!r}")
            if p99 is not None and (not isinstance(p99, (int, float))
                                    or (isinstance(p95, (int, float))
                                        and p99 < p95)):
                bad(f"serve.slo.p99_s={p99!r} must be >= p95_s={p95!r} "
                    f"(a p99 tighter than p95 is unsatisfiable)")
    prio = serve.get("priority")
    if prio is not None and prio not in _PRIORITIES:
        bad(f"serve.priority={prio!r} is not one of {_PRIORITIES}")
    dr = serve.get("decode_regime")
    if dr is not None and dr not in _DECODE_REGIMES:
        bad(f"serve.decode_regime={dr!r} is not one of {_DECODE_REGIMES}")
    qw = serve.get("quantize_weights")
    if qw is not None and not isinstance(qw, bool):
        bad(f"serve.quantize_weights must be a bool, got {qw!r}")
    res = serve.get("resilience")
    if res is not None:
        if not isinstance(res, dict):
            bad(f"serve.resilience must be an object, "
                f"got {type(res).__name__}")
        else:
            _check_resilience(res, bad)
    # LM continuous-batching policy.
    for k in ("slots", "admit_per_tick", "max_queue_depth", "prefill_chunk"):
        v = serve.get(k)
        if v is not None and (not isinstance(v, int) or isinstance(v, bool)
                              or v < 1):
            bad(f"serve.{k}={v!r} must be an int >= 1 (or null)")
    slots = serve.get("slots")
    depth = serve.get("max_queue_depth")
    if isinstance(slots, int) and isinstance(depth, int) and depth < slots:
        bad(f"serve.max_queue_depth={depth} < slots={slots}: admission "
            f"would refuse requests the batcher has free slots for",
            severity="warning")
    if plan.kind == "lm" and slo is not None and slots is None:
        bad("LM tenant has an SLO but no batch policy (slots) - the "
            "batcher falls back to built-in defaults", severity="warning")
    return fs


def _check_resilience(res: dict, bad) -> None:
    """The supervisor's knobs, as the reference checks them: an unknown
    knob warns; the breaker's K, cooldown and retries are ints at or above
    their floors, backoff a number >= 0 and the deadline factor > 0."""
    for k in sorted(set(res) - _RESILIENCE_KEYS):
        bad(f"serve.resilience carries unknown knob {k!r} "
            f"(known: {sorted(_RESILIENCE_KEYS)})", severity="warning")
    for k, floor in (("breaker_k", 1), ("breaker_cooldown", 0),
                     ("retries", 0)):
        v = res.get(k)
        if v is not None and (not isinstance(v, int) or isinstance(v, bool)
                              or v < floor):
            bad(f"serve.resilience.{k}={v!r} must be an int >= {floor}")
    for k in ("backoff_s", "deadline_factor"):
        v = res.get(k)
        if v is not None and (not isinstance(v, (int, float))
                              or isinstance(v, bool) or v < 0
                              or (k == "deadline_factor" and v <= 0)):
            bad(f"serve.resilience.{k}={v!r} must be a number "
                f"{'> 0' if k == 'deadline_factor' else '>= 0'}")


# ---------------------------------------------------------------------------
# Fleet rules
# ---------------------------------------------------------------------------

def verify_fleet(fleet, *, hw=None, aie=None) -> list:
    """All layer-1 findings for a ``FleetPlan``: each tenant's plan rules,
    an AIE fleet's column budget, and the fleet's latency budgets."""
    aie = aie if aie is not None else hwlib.AIE_ML
    fs: list = []
    for t in fleet.tenants:
        fs += verify_plan(t.plan, tenant=t.net_id, hw=hw, aie=aie)
        if t.crossing_s < 0:
            fs.append(Finding(
                rule="fleet.budget", severity="error", tenant=t.net_id,
                detail=f"negative crossing charge {t.crossing_s}"))
        planned = t.plan.est_latency_s + t.crossing_s
        if t.latency_budget_s < planned * (1 - _REL_TOL):
            fs.append(Finding(
                rule="fleet.budget", severity="warning", tenant=t.net_id,
                detail=f"latency budget {t.latency_budget_s:.3e}s is below "
                       f"the planned latency {planned:.3e}s - every request "
                       f"starts in violation"))
    if fleet.target == "aie":
        fs += _rule_fleet_columns(fleet, aie)
    if fleet.tenants:
        worst = max(t.total_latency_s for t in fleet.tenants)
        if not _close(fleet.est_latency_s, worst,
                      abs_tol=_REL_TOL * max(worst, 1e-12)):
            fs.append(Finding(
                rule="fleet.budget", severity="error", tenant=fleet.name,
                detail=f"fleet est_latency_s={fleet.est_latency_s:.3e} != "
                       f"worst tenant total {worst:.3e} (nets sharing the "
                       f"card are judged by the slowest)"))
    return fs


def _rule_fleet_columns(fleet, aie) -> list:
    """DR6 fleet-wide: band-1 columns across ALL tenants fit usable_cols,
    tenant ranges are disjoint, and each tenant's ``cols`` matches the
    band-1 column sum of its own plan."""
    fs = []
    total = 0
    spans = []
    for t in fleet.tenants:
        declared = sum(l.p_k for l in t.plan.layers
                       if l.regime == "aie" and l.band == 1)
        if t.cols != declared:
            fs.append(Finding(
                rule="fleet.columns-overlap", severity="error",
                tenant=t.net_id,
                detail=f"tenant declares cols={t.cols} but its plan's "
                       f"band-1 layers occupy {declared}"))
        if t.cols:
            spans.append((t.col_offset, t.col_offset + t.cols, t.net_id))
        total += t.cols
    if total > aie.usable_cols:
        fs.append(Finding(
            rule="plan.column-budget", severity="error", tenant=fleet.name,
            detail=f"fleet band-1 columns {total} exceed usable_cols="
                   f"{aie.usable_cols} (DR6: spill must go to band 2, not "
                   f"off the array)"))
    spans.sort()
    for (a0, a1, na), (b0, b1, nb) in zip(spans, spans[1:]):
        if b0 < a1:
            fs.append(Finding(
                rule="fleet.columns-overlap", severity="error", tenant=nb,
                detail=f"column range [{b0}, {b1}) overlaps {na!r}'s "
                       f"[{a0}, {a1})"))
    return fs
