"""``Deployment``: the one-call facade over characterize -> plan -> verify
-> engines -> serve.

    from repro_torch.deploy import Deployment
    dep = Deployment.build(["jet_tagger", "tau_select"])   # fit + plan +
    router = dep.serve()                                   #   engines
    router.drive(iters=20)                                 # measured traffic
    rows = dep.bench()                                     # planned-vs-measured
    dep.recalibrate()                                      # feedback loop

Port of the JAX package's ``deploy/deployment.py`` for the edge nets.  The
stages (:mod:`repro_torch.deploy.stages`) run in order: characterize fits
the machine model the plan is made under (``machine_model="auto"`` by
default: the launch cost and int8 rate timed on the deployment's device, as
the served engine runs), plan makes the fleet plan, verify is the
fail-closed design-rule gate (``repro_torch.check``: error findings raise
:class:`PlanVerificationError` before any engine is built), and engines
builds one engine per tenant, whose forward is a CUDA graph on the card.
Everything runs on ``device`` (``None``: the GPU, raising when there is
none).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.deploy.stages import PIPELINE, StageContext, StageResult
from repro_torch.models import edge as edge_lib
from repro_torch.obs import NULL_TRACER, Tracer


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
    """A built deployment: the stages' results, the fleet plan, the verify
    stage's findings, one engine per tenant, and the serving router.
    Construct with :meth:`build`; the pipeline state lives on ``self.ctx``
    and per-stage provenance on :attr:`stage_results`."""

    def __init__(self, ctx: StageContext):
        self.ctx = ctx
        self._router = None

    @classmethod
    def build(cls, configs, *, target: str = "h100", machine_model="auto",
              device=None, seed: int = 0, params: dict | None = None,
              qparams: dict | None = None, calib_x: dict | None = None,
              trace=False, check: bool = True,
              cache=None) -> "Deployment":
        """Characterize, plan ``configs`` as one fleet for ``target``,
        verify the plan, and build one :class:`EdgeEngine` per tenant.

        ``machine_model``: see :class:`~repro_torch.deploy.stages.
        CharacterizeStage`.  ``"auto"`` (default) fits the launch cost and
        int8 rate on ``device``; ``"stock"`` (or None) keeps
        ``hw.H100_SXM``; ``"quick"``/``"full"`` run the characterization
        sweep; a ``MachineModel``, a path to one or an ``hw.H100`` is used
        as given.  ``params`` / ``qparams`` / ``calib_x`` map a net id to
        the float params, quantized params or calibration batch its engine
        uses (see :class:`EdgeEngine`); nets without an entry draw weights
        from ``seed``.  ``trace`` is ``True`` (a fresh :class:`Tracer`) or
        a tracer to fill: every stage emits a ``stage/<name>`` span.
        ``check=False`` skips the verify stage and records it as skipped;
        otherwise an error finding raises :class:`PlanVerificationError`
        before any engine is built.  ``cache`` is the plan cache (default:
        the process-wide one)."""
        tracer = (trace if isinstance(trace, Tracer)
                  else Tracer() if trace else NULL_TRACER)
        ctx = StageContext(
            configs=resolve_configs(configs), target=target,
            machine_model=machine_model, device=resolve_device(device),
            cache=cache, seed=seed, params=dict(params or {}),
            qparams=dict(qparams or {}), calib_x=dict(calib_x or {}),
            tracer=tracer, verify=check)
        for stage in PIPELINE:
            t0 = time.perf_counter()
            res = stage.run(ctx)
            if tracer.enabled:
                tracer.add(f"stage/{stage.name}", t0, time.perf_counter(),
                           tenant="deploy", cached=res.cached,
                           skipped=res.skipped)
        return cls(ctx)

    # -- typed views over the pipeline state ------------------------------
    @property
    def stage_results(self) -> dict[str, StageResult]:
        """Each stage's result, in pipeline order: ``characterize``,
        ``plan``, ``verify``, ``engines``."""
        return dict(self.ctx.results)

    @property
    def machine_model(self):
        """The resolved model (``MachineModel`` or ``hw.H100``), or None
        for the stock constants."""
        return self.ctx.model

    @property
    def fleet(self):
        return self.ctx.fleet

    @property
    def engines(self) -> dict:
        return self.ctx.engines

    @property
    def device(self) -> torch.device:
        return self.ctx.device

    @property
    def tracer(self):
        return self.ctx.tracer

    @property
    def findings(self) -> list:
        """The warnings and info the verify stage recorded (error findings
        abort the build)."""
        return list(self.ctx.findings)

    @property
    def verify(self) -> str:
        """"clean", "1 info, 2 warning" or "skipped"."""
        res = self.ctx.results["verify"]
        return "skipped" if res.skipped else res.detail

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
        """Planned-vs-measured rows: each engine is warmed up (its first
        call captures the graph on the card), timed for ``iters`` calls, and
        judged by its median against the plan."""
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

    def recalibrate(self):
        """Feed the engines' measured latencies back and rescale the fleet
        plan (:func:`repro_torch.plan.calibrate.recalibrate_fleet`): costs
        and budgets (with the fleet's own headroom factor) move; tiles,
        groups and engines stay.  The live router, if any, adopts the new
        fleet.  Returns (and adopts) it."""
        from repro_torch.plan import calibrate
        measurements = calibrate.measurements_from_engines(self.engines)
        if not measurements:
            raise RuntimeError("nothing measured yet: serve traffic or run "
                               ".bench() before recalibrating")
        fleet = calibrate.recalibrate_fleet(self.fleet, measurements,
                                            cache=self.ctx.cache)
        if self._router is not None:
            self._router.adopt_fleet(fleet)
        else:
            for tp in fleet.tenants:
                self.engines[tp.net_id].plan = tp.plan
        self.ctx.fleet = fleet
        return fleet
