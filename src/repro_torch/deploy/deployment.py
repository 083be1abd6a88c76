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
    report = dep.replay("flash_crowd")   # an open-loop scenario replay

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


def _fault_injector(faults):
    """A live ``FaultInjector`` from a ``faults=`` argument: an injector
    passes through, a ``FaultPlan`` arms fresh counters, a list or tuple of
    specs (or spec dicts) becomes a plan, anything else is a path to a
    saved plan."""
    from repro_torch.faults import FaultInjector, FaultPlan
    if faults is None:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultPlan):
        return faults.injector()
    if isinstance(faults, (list, tuple)):
        return FaultPlan(faults=tuple(faults)).injector()
    return FaultPlan.load(faults).injector()


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
        self._router_kw = None

    @classmethod
    def build(cls, configs=None, *, target: str = "h100",
              machine_model="auto", device=None, seed: int = 0,
              params: dict | None = None, qparams: dict | None = None,
              calib_x: dict | None = None, lm_params: dict | None = None,
              max_len: int = 256, stop_after: str | None = None,
              artifact_dir=None, batch: int | None = None, plan=None,
              trace=False, check: bool = True, cache=None,
              faults=None, pl_budget: float | None = None) -> "Deployment":
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
        ``target``: ``"h100"`` (the card) or ``"aie"`` (the paper's VEK280,
        planned and verified only: the engines stage refuses it), whose
        LARE decisions take ``pl_budget`` (default 400 DSP-equivalents).

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
        the process-wide one).  ``faults``: a
        :class:`~repro_torch.faults.FaultPlan`, injector, list of specs or
        path to a saved plan, armed on the build's hooks (``build``, before
        any stage and at the verify stage, and the plan cache's
        ``cache.read``); arm serving faults with ``Router.arm_faults``."""
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
        if pl_budget is not None:
            if target != "aie":
                raise ValueError(f"pl_budget prices the AIE target's LARE "
                                 f"decisions; target is {target!r}")
            ctx.plan_kw["pl_budget"] = pl_budget
        if plan is not None:
            ctx.fleet = _load_plan(plan)
        dep = cls(ctx)
        ctx.injector = _fault_injector(faults)
        if ctx.injector is not None:
            ctx.cache.injector = ctx.injector
            if ctx.injector.fire("build") is not None:
                from repro_torch.faults import InjectedFault
                raise InjectedFault("deployment build: injected failure")
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

    def serve(self, *, shed_after: int | None = None,
              drift_threshold: float | None = None,
              drift_min_samples: int = 5, slo=True, defer_limit: int = 4,
              resilience=True, fresh: bool = False):
        """The fleet behind a :class:`Router` over this deployment's engines.
        Memoized: repeated calls with the same arguments return the same
        live router; other arguments, or ``fresh=True``, build a new one
        over the same engines (their graphs kept, the router's metrics
        new).

        ``shed_after``: consecutive budget violations after which a tenant
        is shed.  ``drift_threshold`` / ``drift_min_samples``: the drift
        watcher's band and sample floor (None: off); a replan writes
        through this deployment's plan cache.  ``slo``: ``True`` attaches
        an :class:`~repro_torch.obs.slo.SloMonitor` with each tenant's
        p95/p99 budgets from its plan's serve section (the router's
        priority scheduling, deferrals aging out after ``defer_limit``
        ticks), an ``SloMonitor`` is used as it is, ``False``/``None``
        serves without one.  ``resilience``: ``True``
        attaches a :class:`~repro_torch.serve.resilience.Supervisor` from
        each plan's ``serve["resilience"]`` knobs (breakers, retries, the
        degradation ladder), a ``Supervisor`` is used as it is,
        ``False``/``None`` leaves dispatch unsupervised."""
        from repro_torch.obs.slo import SloMonitor
        from repro_torch.serve.router import Router
        kw = {"shed_after": shed_after, "drift_threshold": drift_threshold,
              "drift_min_samples": drift_min_samples, "slo": slo,
              "defer_limit": defer_limit, "resilience": resilience}
        if self._router is None or fresh or kw != self._router_kw:
            tracer = self.tracer if self.tracer is not NULL_TRACER else None
            monitor = slo if isinstance(slo, SloMonitor) else (
                SloMonitor.from_fleet(self.fleet, tracer=tracer)
                if slo else None)
            self._router = Router.from_fleet(
                self.fleet, engines=self.engines, cache=self.ctx.cache,
                tracer=tracer, slo=monitor, defer_limit=defer_limit,
                shed_after=shed_after, drift_threshold=drift_threshold,
                drift_min_samples=drift_min_samples,
                resilience=resilience or None)
            self._router_kw = kw
        return self._router

    @property
    def slo(self):
        """The live router's SLO monitor (None before :meth:`serve` or when
        serving with ``slo=False``)."""
        return self._router.slo if self._router is not None else None

    def health(self) -> dict:
        """The served fleet's resilience state (``Router.health()``): per
        tenant its failures, breaker and ladder level, and the fleet's
        replan counters.  Empty before :meth:`serve`."""
        return self._router.health() if self._router is not None else {}

    def replay(self, scenario: str = "steady", *, duration_s: float = 0.25,
               seed: int = 0, speed: float = 1.0, requests=None,
               json_dir=None, faults=None, **scenario_kw):
        """Open-loop traffic through the served fleet
        (:mod:`repro_torch.obs.workload`): generate the scenario's trace (or
        take ``requests``, e.g. from :func:`~repro_torch.obs.workload.
        load_trace`), warm the router, fire the arrivals on the wall clock,
        and return the :class:`~repro_torch.obs.workload.ReplayReport`.
        ``json_dir`` also writes the per-tenant
        ``BENCH_serve_<net>__<scenario>.json`` snapshots.  ``faults`` (a
        ``FaultPlan``, an injector, a list of specs or a saved plan's path;
        default: the plan given to :meth:`build`) is armed on the router
        after the warmup, so the warmup uses up no scheduled fault."""
        from repro_torch.obs import workload
        router = self.serve()
        inputs = router.warmup()
        injector = (_fault_injector(faults) if faults is not None
                    else self.ctx.injector)
        if injector is not None:
            router.arm_faults(injector)
        if requests is None:
            tenants = {t.net_id: t.plan.kind for t in self.fleet.tenants}
            requests = workload.make_scenario(
                scenario, tenants, duration_s=duration_s, seed=seed,
                **scenario_kw)
        report = workload.replay(router, requests, inputs=inputs,
                                 speed=speed)
        report.scenario = scenario
        if json_dir is not None:
            workload.write_replay_snapshots(
                report, json_dir, scenario=scenario, slo=router.slo,
                meta={"source": "Deployment.replay", "seed": seed,
                      "duration_s": duration_s})
        return report

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

    def recalibrate(self, *, budget_factor: float | None = None):
        """Feed measured latencies back and rescale the fleet plan
        (:func:`repro_torch.plan.calibrate.recalibrate_fleet`): the live
        router's measurements when it has served traffic (its
        ``replan_fleet``), the engines' otherwise.  Costs and budgets (with
        the fleet's own headroom factor, or ``budget_factor``) move; tiles,
        groups and engines stay.  Returns (and adopts) the new fleet.

        The planner's own rung: when the recalibration fails while a fitted
        machine model is in play, the deployment drops to the stock
        constants (a ``degrade/machine_model`` span), keeps the current
        fleet and returns it.  Under the stock constants already, or with
        nothing measured, the error is raised."""
        try:
            return self._recalibrate(budget_factor)
        except Exception as exc:
            if self.ctx.model is None or "nothing measured" in str(exc):
                raise
            t0 = time.perf_counter()
            self.ctx.model = None
            if self.ctx.tracer.enabled:
                self.ctx.tracer.add(
                    "degrade/machine_model", t0, time.perf_counter(),
                    tenant="deploy", error=str(exc)[:160])
            return self.ctx.fleet

    def _recalibrate(self, budget_factor):
        from repro_torch.plan import calibrate
        router = self._router
        if router is not None and any(
                router.tenant(nid).metrics.count for nid in router.net_ids):
            fleet = router.replan_fleet(budget_factor=budget_factor)
        else:
            measurements = calibrate.measurements_from_engines(self.engines)
            if not measurements:
                raise RuntimeError("nothing measured yet: serve traffic or "
                                   "run .bench() before recalibrating")
            fleet = calibrate.recalibrate_fleet(self.fleet, measurements,
                                                cache=self.ctx.cache,
                                                budget_factor=budget_factor)
            if router is not None:
                router.adopt_fleet(fleet)
            else:
                for tp in fleet.tenants:
                    self.engines[tp.net_id].plan = tp.plan
        self.ctx.fleet = fleet
        return fleet

    # -- the instruments -------------------------------------------------
    def export_trace(self, path="trace.json"):
        """Write the span stream as a Chrome/Perfetto ``trace.json`` (load
        at https://ui.perfetto.dev); returns the path."""
        from repro_torch.obs import write_chrome
        return write_chrome(self.tracer.spans, path,
                            dropped=self.tracer.dropped)

    def export_prometheus(self, path="metrics.prom"):
        """Write the per-(tenant, kind) span aggregates as a Prometheus
        text-exposition snapshot, with the tracer's dropped-span counter
        and, once serving, the SLO, profile and ``repro_resilience_*``
        families; returns the path."""
        from repro_torch.obs import aggregate, write_prometheus
        slo = self.slo
        return write_prometheus(
            aggregate(self.tracer.spans), path,
            dropped=self.tracer.dropped if self.tracer.enabled else None,
            slo=slo.snapshot() if slo is not None else None,
            profile=self.profile() or None,
            resilience=self.health() or None)

    def attribution(self):
        """Plan-vs-measured rows per (tenant, span kind): see
        :func:`repro_torch.obs.attribution`."""
        from repro_torch.obs import attribution as attr
        return attr(self.plans, self.tracer.spans)

    def format_attribution(self) -> str:
        from repro_torch.obs import format_attribution
        return format_attribution(self.attribution(), slo=self.slo,
                                  profile=self.profile())

    def profile_hw(self):
        """The ceilings this deployment was planned under: the fitted
        machine model's ``h100()`` when one was characterized, a caller's
        ``hw.H100`` as given, else the stock :data:`repro_torch.hw.
        H100_SXM`, the constants the planner read."""
        from repro_torch import hw as hwlib
        model = self.ctx.model
        if model is None:
            return hwlib.H100_SXM
        return model if isinstance(model, hwlib.H100) else model.h100()

    def _profile_stats(self) -> dict:
        """Measured ``(tenant, kind)`` windows: the tracer's spans when
        tracing is on, else the engines' always-on windows
        (``span_stats()``), so profiling needs no ``trace=True``."""
        from repro_torch.obs import aggregate
        if self.tracer.enabled and self.tracer.spans:
            return aggregate(self.tracer.spans)
        return {(nid, kind): agg
                for nid, eng in self.ctx.engines.items()
                for kind, agg in eng.span_stats().items()}

    def profile(self, *, hw=None) -> list:
        """Roofline rows (:func:`repro_torch.obs.profile.profile`) per
        measured (tenant, span kind) window and per fusion group: achieved
        FLOP/s and bytes/s, the ceiling, the bound, the roofline fraction
        clamped and raw, and each tenant's measured LARE.  Empty until
        traffic has been served (or :meth:`bench` has run)."""
        from repro_torch.obs import profile as prof
        return prof(self.plans, self._profile_stats(),
                    hw=hw if hw is not None else self.profile_hw())

    def format_profile(self) -> str:
        from repro_torch.obs import format_profile
        return format_profile(self.profile())

    def graph_overhead(self) -> dict:
        """Per tenant, the plan's model FLOPs against what its served step
        runs (:func:`repro_torch.launch.graph_analysis.graph_overhead`):
        the edge engine's forward, the batcher's decode tick.  The batcher
        decodes all its slots a tick, so its model FLOPs scale by the slot
        count, as the JAX package's ``hlo_overhead`` scales them."""
        from repro_torch.launch.graph_analysis import graph_overhead
        out = {}
        for nid, eng in self.engines.items():
            plan = self.plans.get(nid)
            if plan is None or not plan.layers:
                continue
            model_flops = plan.work()["flops"]
            slots = getattr(eng, "slots", None)
            if slots:
                model_flops *= slots
            out[nid] = graph_overhead(model_flops, eng)
        return out

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
        slo = self.slo
        if slo is not None:
            counts = slo.violation_counts()
            total = sum(counts.values())
            if total:
                per = " ".join(f"{t}={n}" for t, n in sorted(counts.items())
                               if n)
                lines.append(f"slo: {total} violation event(s) {per}")
            else:
                lines.append("slo: ok (no violation events)")
        lines += self._health_lines()
        if self.tracer.enabled:
            lines.append(f"tracing: {len(self.tracer.spans)} spans "
                         f"({self.tracer.dropped} dropped)")
        return "\n".join(lines)

    def _health_lines(self) -> list[str]:
        """The summary's health block: each sick tenant (failures, a ladder
        below the fused rung, a breaker not closed), else one ok line, and
        the replan failures; nothing before :meth:`serve`."""
        health = self.health()
        if not health:
            return []
        sick = {nid: h for nid, h in health["tenants"].items()
                if h["failures"] or h["degrade_level"]
                or h.get("state", "closed") != "closed"}
        lines = []
        if sick:
            lines.append("health:")
            for nid, h in sorted(sick.items()):
                bits = [f"failures={h['failures']}",
                        f"level={h['degrade_level']}"]
                if "state" in h:
                    bits.append(f"breaker={h['state']} "
                                f"opens={h['breaker_opens']} "
                                f"recloses={h['breaker_recloses']}")
                lines.append(f"  {nid:<14} " + " ".join(bits))
        else:
            supervised = ("supervised" if health["supervised"]
                          else "unsupervised")
            lines.append(f"health: ok ({supervised}; no failures, all "
                         f"breakers closed, ladder at level 0)")
        if health["replan_failures"]:
            lines.append(f"health: {health['replan_failures']} replan "
                         f"failure(s), serving on the current fleet")
        return lines
