"""``Deployment``: the one-call facade over characterize -> plan -> verify
-> engines -> serve.

    from repro_torch.deploy import Deployment
    dep = Deployment.build(["jet_tagger", "tau_select"])   # fit + plan +
    router = dep.serve()                                   #   engines
    router.drive(iters=20)                                 # measured traffic
    rows = dep.bench()                                     # planned-vs-measured
    dep.recalibrate()                                      # feedback loop

Port of the JAX package's ``deploy/deployment.py`` for the edge nets and
the ported LMs (Griffin, RWKV-6), alone or in one fleet:

    dep = Deployment.build(["jet_tagger", "tau_select",
                            configs.get("recurrentgemma-2b").config],
                           lm_params={"recurrentgemma-2b": (cfg, params)})
    router = dep.serve()        # router.infer(...) edge, router.submit(...) LM

``Deployment.build(configs, stop_after="plan")`` plans only;
``Deployment.build(plan=path)`` serves a plan artifact as it is.  The
stages (:mod:`repro_torch.deploy.stages`) run in order: characterize fits
the machine model the plan is made under (``machine_model="auto"`` by
default: the launch cost and int8 rate timed on the deployment's device, as
the served engine runs), plan makes the fleet plan, verify is the
fail-closed design-rule gate (``repro_torch.check``: error findings raise
:class:`PlanVerificationError` before any engine is built), and engines
builds one engine per tenant: an edge engine whose forward is a CUDA graph
on the card, or an LM continuous batcher under the plan's batch policy,
whose decode tick is one.
Everything runs on ``device`` (``None``: the GPU, raising when there is
none).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.deploy.stages import (PIPELINE, StageContext, StageResult,
                                       resolve_configs)
from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.plan.artifact import DeploymentPlan
from repro_torch.plan.multinet import FleetPlan

_STAGE_ORDER = tuple(s.name for s in PIPELINE)


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

    @property
    def derived(self) -> str:
        return (f"planned_us={self.planned_s * 1e6:.1f};"
                f"ratio={self.ratio:.2f};within_2x={self.within_2x};"
                f"{self.extra}src=measured")

    def as_record(self, name: str | None = None) -> dict:
        """The reference's benchmark-row shape (``name``, ``us_per_call``,
        ``derived``)."""
        return {"name": name or f"deploy/{self.net_id}/planned-vs-measured",
                "us_per_call": round(self.measured_s * 1e6, 3),
                "derived": self.derived}


def _load_plan(plan) -> FleetPlan:
    """A FleetPlan, a DeploymentPlan, or a path to either artifact."""
    from repro_torch.check.plan_rules import load_artifact
    if isinstance(plan, FleetPlan):
        return plan
    if isinstance(plan, DeploymentPlan):
        return FleetPlan.from_plan(plan)
    return load_artifact(plan)[0]


class Deployment:
    """A built deployment: the stages' results, the fleet plan, the verify
    stage's findings, one engine per tenant, and the serving router.
    Construct with :meth:`build`; the pipeline state lives on ``self.ctx``
    and per-stage provenance on :attr:`stage_results`."""

    def __init__(self, ctx: StageContext):
        self.ctx = ctx
        self._router = None

    @classmethod
    def build(cls, configs=None, *, target: str = "h100",
              machine_model="auto", device=None, seed: int = 0,
              params: dict | None = None, qparams: dict | None = None,
              calib_x: dict | None = None, lm_params: dict | None = None,
              max_len: int = 256, stop_after: str | None = None,
              artifact_dir=None, batch: int | None = None, plan=None,
              trace=False, check: bool = True,
              cache=None) -> "Deployment":
        """Characterize, plan ``configs`` as one fleet for ``target``,
        verify the plan, and build one engine per tenant.

        ``configs``: one or many edge net names, LM arch ids (``"lm:<arch>"``
        or bare: the arch's smoke config), ``EdgeConfig``s or
        ``ModelConfig``s (a full config plans at scale).  ``lm_params`` maps
        an LM tenant's net id to ``(cfg, params)``; an LM without an entry
        draws weights from ``seed``; its batcher holds ``max_len`` cache
        positions a slot.  ``stop_after``: ``"characterize"``, ``"plan"``
        or ``"verify"`` for a partial pipeline.  ``artifact_dir``: the plan
        stage writes the plan (or fleet) artifact there.  ``plan``: a
        ``FleetPlan``, ``DeploymentPlan`` or a path to one, served as it is
        (no characterize, no planning).  ``batch`` is the plans' batch.

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
        if stop_after is not None and stop_after not in _STAGE_ORDER:
            raise ValueError(f"stop_after must be one of {_STAGE_ORDER}, "
                             f"got {stop_after!r}")
        tracer = (trace if isinstance(trace, Tracer)
                  else Tracer() if trace else NULL_TRACER)
        ctx = StageContext(
            configs=resolve_configs(configs), target=target, batch=batch,
            artifact_dir=artifact_dir,
            machine_model=machine_model if plan is None else None,
            device=resolve_device(device), cache=cache,
            seed=seed, params=dict(params or {}),
            qparams=dict(qparams or {}), calib_x=dict(calib_x or {}),
            lm_params=dict(lm_params or {}), max_len=max_len,
            tracer=tracer, verify=check)
        if plan is not None:
            ctx.fleet = _load_plan(plan)
        dep = cls(ctx)
        dep._run_until(stop_after or _STAGE_ORDER[-1])
        return dep

    def _run_until(self, last: str):
        """Run the stages not run yet, through ``last``; each emits a
        ``stage/<name>`` span when tracing."""
        for stage in PIPELINE:
            if stage.name not in self.ctx.results:
                t0 = time.perf_counter()
                res = stage.run(self.ctx)
                if self.ctx.tracer.enabled:
                    self.ctx.tracer.add(
                        f"stage/{stage.name}", t0, time.perf_counter(),
                        tenant="deploy", cached=res.cached,
                        skipped=res.skipped)
            if stage.name == last:
                break

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
    def fleet(self) -> FleetPlan:
        if self.ctx.fleet is None:
            raise RuntimeError("not planned yet (run the plan stage)")
        return self.ctx.fleet

    @property
    def plan(self):
        """The single-net ``DeploymentPlan``, or the ``FleetPlan`` when
        several nets were deployed together."""
        fleet = self.fleet
        return fleet.tenants[0].plan if len(fleet.tenants) == 1 else fleet

    @property
    def engines(self) -> dict:
        """net id -> live engine (``EdgeEngine`` | ``ContinuousBatcher``),
        built on first access if the pipeline stopped before them."""
        self._run_until("engines")
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
        """Planned-vs-measured rows of the edge tenants (an LM request's
        latency includes its queue wait, so LM tenants have none): each
        engine is warmed up (its first call captures the graph on the
        card), timed for ``iters`` calls, and judged by its median against
        the plan."""
        rows = []
        for tp in self.fleet.tenants:
            if tp.plan.kind != "edge":
                continue
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

    def summary(self) -> str:
        """The stages and the tenants, one line each (the CLI's deploy
        report)."""
        lines = ["stages:"]
        lines += [f"  {self.ctx.results[name]}" for name in _STAGE_ORDER
                  if name in self.ctx.results]
        if self.ctx.fleet is not None:
            lines.append("tenants:")
            for t in self.ctx.fleet.tenants:
                lines.append(
                    f"  {t.net_id:<18} kind={t.plan.kind:<5} "
                    f"planned={t.plan.est_latency_s * 1e6:9.1f}us "
                    f"budget={t.latency_budget_s * 1e6:9.1f}us "
                    f"groups={len(t.plan.groups())}")
        if "verify" in self.ctx.results:
            res = self.ctx.results["verify"]
            if res.skipped:
                lines.append("check: skipped (check=False)")
            elif not self.ctx.findings:
                lines.append("check: clean (all design rules hold)")
            else:
                lines.append(f"check: {res.detail}")
                lines += [f"  {f}" for f in self.ctx.findings]
        if self.tracer.enabled:
            lines.append(f"tracing: {len(self.tracer.spans)} spans "
                         f"({self.tracer.dropped} dropped)")
        return "\n".join(lines)
