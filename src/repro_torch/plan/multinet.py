"""Several nets on one device: the fleet plan.

``target="h100"`` (the default): the nets (edge nets and LMs) time-share
the card, so each is planned by the single-net search; the hand-off of
each net's result is charged one DR7' crossing, and each tenant's latency
budget is ``budget_factor x (planned + crossing)``, the budget the serving
router measures against.  An LM
tenant's serve section also carries the continuous batcher's policy, as the
reference's ``_plan_fleet_tpu`` writes it: a fair share of
``serve_slots_total`` slots across the LM tenants, the ``prefill_chunk``,
one admission a tick and a queue-depth bound of ``queue_depth_factor``
slot generations.  Every tenant's serve section carries its priority
class (``critical`` edge, ``standard`` LM), its tail contract (``slo``:
p95 at the budget, p99 at 1.5x) and the supervisor's ``resilience`` knobs
(:data:`repro_torch.faults.RESILIENCE_DEFAULTS`), as the reference's
``_with_slo`` writes them.  An h100 tenant holds no array columns
(``col_offset`` and ``cols`` 0, as the reference's TPU tenants).

``target="aie"``: the paper's Section V-C co-residency, the reference's
``_plan_fleet_aie``.  Every net runs its own LARE pass, then ALL nets' AIE
layers enter one :func:`planner._resolve_columns` call keyed by ``(tenant,
layer)``: the shrink-vs-spill rule trades one net's split width against
another net's spill penalty.  Tenants receive contiguous, non-overlapping
band-1 column ranges (``col_offset``/``cols``), and each net's off-array
hand-off is charged a DR7 crossing
(:func:`repro_torch.core.boundary.crossing_cost_aie`).

A fleet artifact written before tenants carried columns decodes with
``col_offset`` and ``cols`` 0.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib

from repro_torch import hw as hwlib
from repro_torch.core import boundary
from repro_torch.device import resolve_device
from repro_torch.faults import RESILIENCE_DEFAULTS
from repro_torch.plan import planner
from repro_torch.plan.artifact import (PLAN_SCHEMA_VERSION, PLANNER_VERSION,
                                       DeploymentPlan, atomic_write_text,
                                       default_cache)

DEFAULT_BUDGET_FACTOR = 2.0

# The LM tenants' serve-policy knobs and their defaults (the reference's
# SERVE_DEFAULTS less the budget factor).
LM_SERVE_DEFAULTS = {
    "serve_slots_total": 8,
    "prefill_chunk": 8,
    "queue_depth_factor": 4,
}


def _band1_cols(plan: DeploymentPlan) -> int:
    """Band-1 array columns a plan occupies (0 off the AIE target)."""
    if plan.target != "aie":
        return 0
    return sum(l.p_k for l in plan.layers
               if l.regime == "aie" and l.band == 1)


@dataclasses.dataclass(frozen=True)
class TenantPlan:
    """One net's slice of the fleet: its plan, its columns, its budget."""
    net_id: str
    plan: DeploymentPlan
    col_offset: int              # first band-1 column on the array (aie)
    cols: int                    # band-1 columns occupied (0 on h100)
    crossing_s: float
    latency_budget_s: float

    @property
    def total_latency_s(self) -> float:
        return self.plan.est_latency_s + self.crossing_s

    def to_dict(self) -> dict:
        return {"net_id": self.net_id, "col_offset": self.col_offset,
                "cols": self.cols, "crossing_s": self.crossing_s,
                "latency_budget_s": self.latency_budget_s,
                "plan": self.plan.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "TenantPlan":
        return cls(net_id=d["net_id"],
                   plan=DeploymentPlan.from_dict(d["plan"]),
                   col_offset=d.get("col_offset", 0), cols=d.get("cols", 0),
                   crossing_s=d["crossing_s"],
                   latency_budget_s=d["latency_budget_s"])


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    name: str
    target: str
    key: str
    tenants: tuple[TenantPlan, ...]
    est_latency_s: float          # the slowest tenant
    schema: int = PLAN_SCHEMA_VERSION

    def tenant(self, net_id: str) -> TenantPlan:
        for t in self.tenants:
            if t.net_id == net_id:
                return t
        raise KeyError(f"no tenant {net_id!r} in fleet {self.name!r}")

    @property
    def net_ids(self) -> list[str]:
        return [t.net_id for t in self.tenants]

    @property
    def band1_cols_used(self) -> int:
        return sum(t.cols for t in self.tenants)

    def to_dict(self) -> dict:
        totals = {"est_latency_s": self.est_latency_s}
        if self.target == "aie":
            totals["band1_cols_used"] = self.band1_cols_used
        return {"schema": self.schema, "kind": "fleet", "name": self.name,
                "target": self.target, "key": self.key,
                "tenants": [t.to_dict() for t in self.tenants],
                "totals": totals}

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "FleetPlan":
        if d.get("schema") != PLAN_SCHEMA_VERSION:
            raise ValueError(f"unsupported fleet schema: {d.get('schema')!r}")
        return cls(name=d["name"], target=d["target"], key=d["key"],
                   tenants=tuple(TenantPlan.from_dict(t)
                                 for t in d["tenants"]),
                   est_latency_s=d["totals"]["est_latency_s"])

    @classmethod
    def from_json(cls, s: str) -> "FleetPlan":
        return cls.from_dict(json.loads(s))

    def save(self, path: str | os.PathLike) -> pathlib.Path:
        return atomic_write_text(path, self.to_json() + "\n")

    @classmethod
    def load(cls, path: str | os.PathLike) -> "FleetPlan":
        return cls.from_json(pathlib.Path(path).read_text())

    @classmethod
    def from_plan(cls, plan: DeploymentPlan, *,
                  budget_factor: float = DEFAULT_BUDGET_FACTOR
                  ) -> "FleetPlan":
        """Wrap a single-net :class:`DeploymentPlan` as a one-tenant fleet."""
        tenant = TenantPlan(net_id=plan.network, plan=plan, col_offset=0,
                            cols=_band1_cols(plan), crossing_s=0.0,
                            latency_budget_s=budget_factor
                            * plan.est_latency_s)
        return cls(name=plan.network, target=plan.target,
                   key=f"fleet:{plan.key}", tenants=(tenant,),
                   est_latency_s=plan.est_latency_s)


def _net_ids(graphs) -> list[str]:
    """Unique tenant ids (duplicate nets get an #index suffix)."""
    seen: dict[str, int] = {}
    out = []
    for g in graphs:
        n = seen.get(g.name, 0)
        seen[g.name] = n + 1
        out.append(g.name if n == 0 else f"{g.name}#{n}")
    return out


def fleet_key(cfgs, *, target: str = planner.TARGET,
              batch: int | None = None,
              budget_factor: float = DEFAULT_BUDGET_FACTOR,
              hw: hwlib.H100 = hwlib.H100_SXM, pl_budget: float = 400.0,
              pl: hwlib.PlFabric | None = None,
              aie: hwlib.AieMl | None = None, machine_model=None,
              **lm_serve) -> str:
    """The cache key :func:`plan_fleet` files these arguments' fleet under:
    every net's plan key (machine model included), the budget factor and,
    when the fleet has an LM tenant, the LM serve knobs (``lm_serve``,
    defaulting as in :func:`plan_fleet`)."""
    unknown = set(lm_serve) - set(LM_SERVE_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown serve option(s): {sorted(unknown)}")
    graphs = [planner.as_graph(c, batch=batch) for c in cfgs]
    if machine_model is not None:
        hw = machine_model.h100(base=hw)
    opts = planner.aie_options(pl_budget=pl_budget, pl=pl, aie=aie,
                               machine_model=machine_model)
    payload = {"planner": PLANNER_VERSION, "target": target,
               "fleet": [planner._key_for(g, target, hw, opts)
                         for g in graphs],
               "budget_factor": budget_factor}
    if any(g.kind == "lm" for g in graphs):
        payload["lm_serve"] = {**LM_SERVE_DEFAULTS, **lm_serve}
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()
                          ).hexdigest()


def _with_slo(serve: dict, kind: str, budget_s: float) -> dict:
    """The tail contract, the priority class and the supervisor's knobs,
    written into the plan's serve section so the runtime
    (:class:`~repro_torch.obs.slo.SloMonitor`, the router, the supervisor)
    needs no side channel: p95 at the tenant's latency budget
    (``budget_factor x (planned + crossing)``), p99 at 1.5x that; an edge
    tenant is ``critical`` (the trigger path), an LM ``standard``; the
    ``resilience`` block is :data:`repro_torch.faults.RESILIENCE_DEFAULTS`.
    """
    return {
        **serve,
        "priority": "standard" if kind == "lm" else "critical",
        "slo": {"p95_s": budget_s, "p99_s": 1.5 * budget_s},
        "resilience": dict(RESILIENCE_DEFAULTS),
    }


def _plan_fleet_aie(graphs, ids, *, key: str, budget_factor: float,
                    opts: dict) -> FleetPlan:
    pl, aie = opts["pl"], opts["aie"]
    preps = [planner._aie_prepare(g, pl_budget=opts["pl_budget"], pl=pl,
                                  aie=aie) for g in graphs]
    # Joint column resolution: all nets' AIE layers in one pool, keyed by
    # (tenant, layer) so band assignment walks tenants in placement order.
    cands = {(ti, li): c
             for ti, p in enumerate(preps) for li, c in p.cands.items()}
    chosen = {k: c[0] for k, c in cands.items()}
    bands = planner._resolve_columns(chosen, cands, aie)
    n_band2 = sum(1 for b in bands.values() if b > 1)

    tenants: list[TenantPlan] = []
    col = 0
    for ti, (g, prep, net_id) in enumerate(zip(graphs, preps, ids)):
        t_chosen = {li: chosen[(ti, li)] for li in prep.cands}
        t_bands = {li: bands[(ti, li)] for li in prep.cands}
        layers = planner._aie_layers(g, prep, t_chosen, t_bands, n_band2,
                                     aie=aie)
        bounds, est_latency, est_interval = planner._aie_totals(g, layers,
                                                                aie)
        plan = DeploymentPlan(
            network=g.name, target="aie", batch=g.batch,
            key=f"{key}:{net_id}", layers=tuple(layers),
            boundaries=tuple(bounds), est_latency_s=est_latency,
            est_interval_s=est_interval,
            serve={"quantize_weights": True, "prefill_chunk": None},
            kind=g.kind)
        # DR7 at the net boundary: the net's result streams off-array
        # through the PLIO fabric shared by every co-resident tenant.
        crossing = boundary.crossing_cost_aie(
            g.nodes[-1].out_bytes(g.batch), plan.est_latency_s, aie=aie)
        cols_used = _band1_cols(plan)
        budget = budget_factor * (plan.est_latency_s + crossing)
        plan = dataclasses.replace(plan, serve=_with_slo(plan.serve, g.kind,
                                                         budget))
        tenants.append(TenantPlan(
            net_id=net_id, plan=plan, col_offset=col, cols=cols_used,
            crossing_s=crossing, latency_budget_s=budget))
        col += cols_used
    return FleetPlan(name="+".join(ids), target="aie", key=key,
                     tenants=tuple(tenants),
                     est_latency_s=max(t.total_latency_s for t in tenants))


def plan_fleet(cfgs, *, target: str = planner.TARGET,
               batch: int | None = None,
               budget_factor: float = DEFAULT_BUDGET_FACTOR,
               serve_slots_total: int = LM_SERVE_DEFAULTS["serve_slots_total"],
               prefill_chunk: int | None = LM_SERVE_DEFAULTS["prefill_chunk"],
               queue_depth_factor: int = LM_SERVE_DEFAULTS[
                   "queue_depth_factor"],
               hw: hwlib.H100 = hwlib.H100_SXM, pl_budget: float = 400.0,
               pl: hwlib.PlFabric | None = None,
               aie: hwlib.AieMl | None = None, machine_model=None,
               cache=None, device=None) -> FleetPlan:
    """Plan N nets (EdgeConfigs, ModelConfigs or graphs) on one device:
    ``target="h100"``, the card, under ``hw``; ``"aie"``, the paper's
    VEK280 array, under ``pl_budget``, ``pl`` and ``aie`` (a fitted
    ``machine_model`` re-parameterizes both, as in
    :func:`~repro_torch.plan.planner.plan_deployment`).  ``device`` is
    where the fleet will run (``None``: the GPU, raising when there is
    none).  Repeat calls with the same nets, machine model, budget factor
    and LM serve knobs hit the cache."""
    resolve_device(device)
    if not cfgs:
        raise ValueError("plan_fleet needs at least one network")
    graphs = [planner.as_graph(c, batch=batch) for c in cfgs]
    ids = _net_ids(graphs)
    key = fleet_key(graphs, target=target, budget_factor=budget_factor,
                    hw=hw, pl_budget=pl_budget, pl=pl, aie=aie,
                    machine_model=machine_model,
                    serve_slots_total=serve_slots_total,
                    prefill_chunk=prefill_chunk,
                    queue_depth_factor=queue_depth_factor)
    cache = cache if cache is not None else default_cache()
    hit = cache.get_fleet(key)
    if hit is not None:
        return hit
    if target == "aie":
        opts = planner.aie_options(pl_budget=pl_budget, pl=pl, aie=aie,
                                   machine_model=machine_model)
        return cache.put_fleet(_plan_fleet_aie(
            graphs, ids, key=key, budget_factor=budget_factor, opts=opts),
            key=key)
    if machine_model is not None:
        hw = machine_model.h100(base=hw)
    n_lm = sum(1 for g in graphs if g.kind == "lm") or 1
    tenants = []
    for g, net_id in zip(graphs, ids):
        plan = planner._plan_h100(g, hw=hw, key=f"{key}:{net_id}")
        if g.kind == "lm":
            slots = max(1, serve_slots_total // n_lm)
            plan = dataclasses.replace(plan, serve={
                **plan.serve, "slots": slots, "prefill_chunk": prefill_chunk,
                "admit_per_tick": 1,
                "max_queue_depth": max(1, queue_depth_factor * slots)})
        crossing = boundary.crossing_cost(g.nodes[-1].out_bytes(g.batch), hw)
        budget = budget_factor * (plan.est_latency_s + crossing)
        plan = dataclasses.replace(plan, serve=_with_slo(plan.serve, g.kind,
                                                         budget))
        tenants.append(TenantPlan(net_id=net_id, plan=plan, col_offset=0,
                                  cols=0, crossing_s=crossing,
                                  latency_budget_s=budget))
    fleet = FleetPlan(name="+".join(ids), target=target, key=key,
                      tenants=tuple(tenants),
                      est_latency_s=max(t.total_latency_s for t in tenants))
    return cache.put_fleet(fleet, key=key)
