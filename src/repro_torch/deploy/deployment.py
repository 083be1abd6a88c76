"""``Deployment``: the one-call facade over plan -> verify -> engines ->
serve.

    from repro_torch.deploy import Deployment
    dep = Deployment.build(["jet_tagger", "tau_select"])   # plans + engines
    router = dep.serve()                                   # live router
    router.drive(iters=20)                                 # measured traffic
    rows = dep.bench()                                     # planned-vs-measured

Port of the JAX package's ``deploy/deployment.py``, trimmed to its plan,
verify and engine stages; characterization is not ported yet.  The verify
stage is the fail-closed design-rule gate (``repro_torch.check``): error
findings raise :class:`PlanVerificationError` before any engine is built.
Everything runs on ``device`` (``None``: the GPU, raising when there is
none).
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.check import PlanVerificationError, check_fleet
from repro_torch.device import resolve_device
from repro_torch.models import edge as edge_lib
from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.plan.multinet import plan_fleet


@dataclasses.dataclass(frozen=True)
class BenchRow:
    """One planned-vs-measured judgement."""
    net_id: str
    planned_s: float
    measured_s: float
    extra: str = ""

    @property
    def ratio(self) -> float:
        return (self.planned_s / self.measured_s if self.measured_s > 0
                else float("inf"))

    @property
    def within_2x(self) -> bool:
        return 0.5 <= self.ratio <= 2.0


def resolve_configs(specs) -> list:
    """Edge net names or ``EdgeConfig`` objects, one or many."""
    if specs is None:
        return []
    if not isinstance(specs, (list, tuple)):
        specs = [specs]
    out = []
    for s in specs:
        if not isinstance(s, str):
            out.append(s)
        elif s in edge_lib.EDGE_NETS:
            out.append(edge_lib.edge_config(s))
        else:
            raise ValueError(f"unknown edge net {s!r} "
                             f"(want one of {sorted(edge_lib.EDGE_NETS)})")
    return out


class Deployment:
    """A built deployment: the fleet plan, the verify stage's findings and
    outcome, one engine per tenant, and the serving router.  Construct with
    :meth:`build`."""

    def __init__(self, fleet, engines: dict, device: torch.device, tracer,
                 findings: list, verify: str):
        self.fleet = fleet
        self.engines = engines
        self.device = device
        self.tracer = tracer
        self.findings = findings   # the warnings and info of the gate
        self.verify = verify       # "clean", "1 info, 2 warning", "skipped"
        self._router = None

    @classmethod
    def build(cls, configs, *, target: str = "h100", device=None,
              seed: int = 0, params: dict | None = None,
              qparams: dict | None = None, calib_x: dict | None = None,
              trace=False, check: bool = True) -> "Deployment":
        """Plan ``configs`` as one fleet for ``target``, verify the plan, and
        build one :class:`EdgeEngine` per tenant.

        ``params`` / ``qparams`` / ``calib_x`` map a net id to the float
        params, quantized params or calibration batch its engine uses (see
        :class:`EdgeEngine`); nets without an entry draw weights from
        ``seed``.  ``trace`` is ``True`` (a fresh :class:`Tracer`) or a
        tracer to fill.  ``check=False`` skips the verify stage and records
        it as skipped; otherwise an error finding raises
        :class:`PlanVerificationError` before any engine is built."""
        device = resolve_device(device)
        tracer = (trace if isinstance(trace, Tracer)
                  else Tracer() if trace else NULL_TRACER)
        cfgs = resolve_configs(configs)
        with tracer.span("stage/plan", tenant="deploy"):
            fleet = plan_fleet(cfgs, target=target, device=device)
        with tracer.span("stage/verify", tenant="deploy", skipped=not check):
            findings = check_fleet(fleet) if check else []
        counts = collections.Counter(f.severity for f in findings)
        if counts["error"]:
            raise PlanVerificationError(findings)
        verify = "skipped" if not check else (", ".join(
            f"{n} {s}" for s, n in sorted(counts.items())) or "clean")
        by_name = {c.name: c for c in cfgs}
        params, qparams, calib_x = params or {}, qparams or {}, calib_x or {}
        engines = {}
        from repro_torch.serve.engine import EdgeEngine
        with tracer.span("stage/engines", tenant="deploy"):
            for tp in fleet.tenants:
                engines[tp.net_id] = EdgeEngine(
                    by_name[tp.plan.network], params.get(tp.net_id),
                    plan=tp.plan, seed=seed,
                    qparams=qparams.get(tp.net_id),
                    calib_x=calib_x.get(tp.net_id), device=device)
        return cls(fleet, engines, device, tracer, findings, verify)

    @property
    def plans(self) -> dict:
        return {t.net_id: t.plan for t in self.fleet.tenants}

    def serve(self):
        """The fleet behind a :class:`Router` over this deployment's engines
        (memoized: repeated calls return the same live router)."""
        from repro_torch.serve.router import Router
        if self._router is None:
            tracer = self.tracer if self.tracer is not NULL_TRACER else None
            self._router = Router.from_fleet(self.fleet, engines=self.engines,
                                             tracer=tracer)
        return self._router

    def bench(self, *, iters: int = 5, warmup: int = 1) -> list[BenchRow]:
        """Planned-vs-measured rows: each engine is warmed up, timed for
        ``iters`` calls, and judged by its median against the plan."""
        rows = []
        for tp in self.fleet.tenants:
            eng = self.engines[tp.net_id]
            x = torch.ones((tp.plan.batch, eng.cfg.dims[0]),
                           dtype=torch.float32, device=self.device)
            for _ in range(warmup):
                eng.infer(x)
            eng.reset_measurements()
            for _ in range(iters):
                eng.infer(x)
            rows.append(BenchRow(
                net_id=tp.net_id, planned_s=tp.plan.est_latency_s,
                measured_s=eng.measured_p50_s,
                extra=f"fuse_groups={len(tp.plan.groups())};"))
        return rows
