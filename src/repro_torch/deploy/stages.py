"""The facade's stages: characterize -> plan -> verify -> engines, as
explicit objects.

Port of the JAX package's ``deploy/stages.py`` for the edge nets and the
ported LMs on the card, and for the paper's AIE target up to its verify
stage (an AIE plan is planned and verified, never served).  Each stage
reads its inputs off a :class:`StageContext`, writes one output back, and
returns a :class:`StageResult`: output, wall time, whether it was served
from a cache or memo, the artifact it loaded or wrote.
:class:`repro_torch.deploy.Deployment` runs them in order.

=============== =============================== =======================
stage           inputs (ctx fields)             output (ctx field)
=============== =============================== =======================
characterize    machine_model spec, device,     model + plan_kw["hw"]
                target                          (aie: ["machine_model"])
plan            configs, target, plan_kw, cache fleet (FleetPlan)
verify          fleet, plan_kw, verify flag     findings (design rules)
engines         fleet, configs, weights,        engines {net_id: engine}
                lm_params
=============== =============================== =======================
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Any

import torch

from repro_torch import hw as hwlib
from repro_torch.obs import NULL_TRACER
from repro_torch.plan import PlanCache, default_cache
from repro_torch.plan.multinet import FleetPlan, fleet_key, plan_fleet

# (sweep, device)-keyed memo of full characterization runs: every
# Deployment in the process shares one fitted MachineModel per sweep density
# and device instead of re-timing the microbenchmarks.
_SWEEP_MEMO: dict[tuple, Any] = {}


@dataclasses.dataclass(frozen=True)
class StageResult:
    """What one stage did: its output, provenance and cost."""
    stage: str
    output: Any
    cached: bool = False                 # served from a cache/memo/artifact
    skipped: bool = False                # inputs made the stage a no-op
    artifact: pathlib.Path | None = None
    wall_s: float = 0.0
    detail: str = ""

    def __str__(self) -> str:
        state = ("cached" if self.cached else
                 "skipped" if self.skipped else "ran")
        art = f" -> {self.artifact}" if self.artifact else ""
        det = f" ({self.detail})" if self.detail else ""
        return f"{self.stage:<12} {state:<7} {self.wall_s:7.2f}s{det}{art}"


@dataclasses.dataclass
class StageContext:
    """Everything the stages read and write: the pipeline's typed state.

    Inputs are set by :meth:`repro_torch.deploy.Deployment.build`; each
    stage fills in its output field (``model``/``fleet``/``findings``/
    ``engines``) and records its :class:`StageResult` under ``results``."""
    configs: list = dataclasses.field(default_factory=list)
    target: str = "h100"
    batch: int | None = None             # the plan's batch (None: the net's)
    artifact_dir: pathlib.Path | None = None   # the plan stage writes here
    machine_model: Any = "auto"          # spec; resolved by CharacterizeStage
    device: torch.device = torch.device("cpu")
    cache: PlanCache | None = None
    plan_kw: dict = dataclasses.field(default_factory=dict)
    seed: int = 0
    params: dict = dataclasses.field(default_factory=dict)
    qparams: dict = dataclasses.field(default_factory=dict)
    calib_x: dict = dataclasses.field(default_factory=dict)
    lm_params: dict = dataclasses.field(default_factory=dict)
    max_len: int = 256                   # each LM batcher's cache length
    tracer: Any = NULL_TRACER            # repro_torch.obs.Tracer when tracing
    verify: bool = True                  # run the design-rule gate
    injector: Any = None                 # repro_torch.faults.FaultInjector
    # stage outputs
    model: Any = None                    # MachineModel | H100 | None
    fleet: FleetPlan | None = None
    findings: list = dataclasses.field(default_factory=list)
    engines: dict = dataclasses.field(default_factory=dict)
    results: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.cache is None:
            self.cache = default_cache()
        if self.artifact_dir is not None:
            self.artifact_dir = pathlib.Path(self.artifact_dir)

    def record(self, res: StageResult) -> StageResult:
        self.results[res.stage] = res
        return res


def resolve_configs(specs) -> list:
    """One or many config specs as config objects.  A spec is an
    ``EdgeConfig`` or ``ModelConfig`` (passed through), an edge net name,
    or an LM arch id, bare or as ``"lm:<arch>"`` (``gemma2_2b``,
    ``gemma2_9b``, ``gemma2_27b``, ``qwen2_5_3b``, ``qwen2_vl_72b``,
    ``mixtral_8x22b``, ``deepseek_v3_671b``, ``whisper_medium``,
    ``recurrentgemma_2b``, ``rwkv6_7b``), which resolves to the arch's
    smoke config; pass ``configs.get(arch).config`` to plan the published
    shape."""
    from repro_torch import configs as configs_lib
    from repro_torch.models import edge
    if specs is None:
        return []
    if not isinstance(specs, (list, tuple)):
        specs = [specs]
    out = []
    for s in specs:
        if not isinstance(s, str):
            out.append(s)
            continue
        name = s[3:] if s.startswith("lm:") else s
        if not s.startswith("lm:") and name in edge.EDGE_NETS:
            out.append(edge.edge_config(name))
            continue
        try:
            out.append(configs_lib.get(name).smoke)
        except ValueError:
            raise ValueError(
                f"unknown edge net or LM arch {s!r} (edge nets: "
                f"{sorted(edge.EDGE_NETS)}; LM archs: "
                f"{', '.join(configs_lib.ARCH_NAMES)})") from None
    return out


class CharacterizeStage:
    """Resolve the ``machine_model`` spec into the planner's machine model.

    Spec values:

    * ``None`` / ``"stock"``: the stock ``hw.H100_SXM`` constants (skip);
    * ``"auto"``: the fast calibration of the ``gemm_int8`` term on the
      context's device (:func:`repro_torch.plan.calibrate.
      calibrated_device_model`, memoized per process), so planned-vs-
      measured is meaningful there;
    * ``"quick"`` / ``"full"``: the full characterization sweep at that
      density (:func:`repro_torch.characterize.characterize`, memoized per
      sweep and device);
    * a path: ``MachineModel.load(path)``, refused unless it was fitted on
      this host, torch and CUDA build and card
      (:func:`provenance_mismatch`);
    * a ``MachineModel``: used as-is (its ``h100()`` is planned under);
    * an ``hw.H100``: used as-is.

    For ``target="aie"`` a fitted model goes to the planner whole
    (``plan_kw["machine_model"]``): its ``aie()`` re-parameterizes the
    array (the band-2 slope of ``contention``) and its version enters the
    plan keys, as the reference's does; the card's constants are not read.
    """

    name = "characterize"

    def run(self, ctx: StageContext) -> StageResult:
        from repro_torch.characterize import MachineModel, characterize
        spec = ctx.machine_model
        t0 = time.perf_counter()

        def done(model, *, cached=False, skipped=False, artifact=None,
                 detail=""):
            ctx.model = model
            if isinstance(model, hwlib.H100):
                ctx.plan_kw.setdefault("hw", model)
            elif model is not None and ctx.target == "aie":
                ctx.plan_kw.setdefault("machine_model", model)
            elif model is not None:
                ctx.plan_kw.setdefault("hw", model.h100())
            return ctx.record(StageResult(
                stage=self.name, output=model, cached=cached, skipped=skipped,
                artifact=artifact, wall_s=time.perf_counter() - t0,
                detail=detail))

        if spec is None or spec == "stock":
            return done(None, skipped=True, detail="stock hw constants")
        if isinstance(spec, hwlib.H100):
            return done(spec, cached=True, detail="caller-supplied h100 model")
        if isinstance(spec, MachineModel):
            return done(spec, cached=True,
                        detail=f"caller-supplied {spec.version[:12]}")
        if spec == "auto":
            from repro_torch.plan import calibrate
            cached = calibrate.device_model_memoized(ctx.device)
            model = calibrate.calibrated_device_model(ctx.device)
            return done(model, cached=cached,
                        detail=f"gemm_int8 calibration on {ctx.device}")
        if spec in ("quick", "full"):
            memo = (spec, str(ctx.device))
            if memo in _SWEEP_MEMO:
                return done(_SWEEP_MEMO[memo], cached=True,
                            detail=f"{spec} sweep (memo)")
            model = characterize(sweep=spec, device=ctx.device,
                                 tracer=ctx.tracer)
            _SWEEP_MEMO[memo] = model
            return done(model, detail=f"{spec} sweep")
        if isinstance(spec, (str, pathlib.Path)):
            path = pathlib.Path(spec)
            model = MachineModel.load(path)
            other = provenance_mismatch(model, ctx.device)
            if other:
                raise ValueError(
                    f"{path} was fitted on another machine ({other}): "
                    f"characterize this one (python -m "
                    f"repro_torch.characterize) or pass machine_model="
                    f"'quick'")
            return done(model, cached=True, artifact=path,
                        detail=f"loaded {path.name}")
        raise TypeError(f"cannot resolve machine_model spec {spec!r}")


def provenance_mismatch(model, device: torch.device) -> dict:
    """Where a loaded MachineModel's provenance differs from ``device``'s
    host, torch and CUDA build and card name, as ``{key: (fitted, here)}``:
    empty when its constants describe this machine."""
    from repro_torch.characterize.model import card_identity
    here = card_identity(device)
    return {k: (model.provenance.get(k), here[k])
            for k in ("host", "torch", "cuda", "card")
            if model.provenance.get(k) != here[k]}


class PlanStage:
    """Plan the configs as one (possibly single-tenant) fleet under the
    characterized machine model; the fleet cache answers repeat questions
    (the result's ``cached`` flag says it did).  A fleet already on the
    context (``Deployment.build(plan=...)``) is served as given.  With an
    ``artifact_dir`` the plan (one tenant) or the fleet is written there."""

    name = "plan"

    def run(self, ctx: StageContext) -> StageResult:
        t0 = time.perf_counter()
        if ctx.fleet is not None:
            return ctx.record(StageResult(
                stage=self.name, output=ctx.fleet, cached=True,
                wall_s=time.perf_counter() - t0,
                detail="pre-built plan supplied"))
        if not ctx.configs:
            raise ValueError("plan stage needs at least one config "
                             "(or a pre-built plan=)")
        kw = dict(target=ctx.target, batch=ctx.batch, **ctx.plan_kw)
        cached = ctx.cache.get_fleet(fleet_key(ctx.configs, **kw)) is not None
        ctx.fleet = plan_fleet(ctx.configs, cache=ctx.cache,
                               device=ctx.device, **kw)
        artifact = None
        if ctx.artifact_dir is not None:
            if len(ctx.fleet.tenants) == 1:
                t = ctx.fleet.tenants[0]
                artifact = t.plan.save(
                    ctx.artifact_dir / f"{t.net_id}_{ctx.target}.json")
            else:
                artifact = ctx.fleet.save(
                    ctx.artifact_dir
                    / f"fleet_{ctx.fleet.name}_{ctx.target}.json")
        return ctx.record(StageResult(
            stage=self.name, output=ctx.fleet, cached=cached,
            artifact=artifact, wall_s=time.perf_counter() - t0,
            detail=f"{len(ctx.fleet.tenants)} tenant(s), "
                   f"key={ctx.fleet.key[:12]}"))


class VerifyStage:
    """The fail-closed design-rule gate between planning and engines:
    :func:`repro_torch.check.check_fleet` over the planned fleet, under the
    same machine model, BEFORE any engine exists.  Error findings raise
    :class:`repro_torch.check.PlanVerificationError`; warnings and info
    land on ``ctx.findings``.  ``verify=False`` records it as skipped.  An
    armed injector's ``build`` fault raises :class:`InjectedFault` here,
    before any engine exists."""

    name = "verify"

    def run(self, ctx: StageContext) -> StageResult:
        from repro_torch.check import PlanVerificationError, check_fleet
        t0 = time.perf_counter()
        if not ctx.verify:
            return ctx.record(StageResult(
                stage=self.name, output=[], skipped=True,
                wall_s=time.perf_counter() - t0, detail="check=False"))
        if ctx.fleet is None:
            raise ValueError("verify stage needs a planned fleet "
                             "(run the plan stage first)")
        if ctx.injector is not None:
            spec = ctx.injector.fire("build", tenant="verify")
            if spec is not None:
                from repro_torch.faults import InjectedFault
                raise InjectedFault("verify stage: injected failure")
        from repro_torch.plan.planner import aie_options
        aie = aie_options(
            aie=ctx.plan_kw.get("aie"),
            machine_model=ctx.plan_kw.get("machine_model"))["aie"]
        ctx.findings = check_fleet(ctx.fleet, hw=ctx.plan_kw.get("hw"),
                                   aie=aie)
        counts: dict[str, int] = {}
        for f in ctx.findings:
            counts[f.severity] = counts.get(f.severity, 0) + 1
        if counts.get("error"):
            raise PlanVerificationError(ctx.findings)
        detail = (", ".join(f"{n} {s}" for s, n in sorted(counts.items()))
                  or "clean")
        return ctx.record(StageResult(
            stage=self.name, output=list(ctx.findings),
            wall_s=time.perf_counter() - t0, detail=detail))


class EngineStage:
    """One engine per tenant, running exactly the tenant's plan.

    An edge tenant gets an :class:`~repro_torch.serve.EdgeEngine`: weights
    quantized with activation scales calibrated by a float forward
    (``fused_dense``), the forward a CUDA graph on the card;
    ``ctx.params`` / ``qparams`` / ``calib_x`` map a net id to its float
    params, quantized params or calibration batch.  An LM tenant gets a
    plan-driven :class:`~repro_torch.serve.ContinuousBatcher` of
    ``ctx.max_len`` over ``ctx.lm_params[net_id] = (cfg, params)``.  Other
    nets draw weights from ``ctx.seed``.  A plan for the AIE array is
    refused: no engine of the port runs one."""

    name = "engines"

    def run(self, ctx: StageContext) -> StageResult:
        from repro_torch.models import api, edge as edge_lib
        from repro_torch.serve.engine import ContinuousBatcher, EdgeEngine
        if ctx.fleet is None:
            raise ValueError("engine stage needs a planned fleet "
                             "(run the plan stage first)")
        aie = [t.net_id for t in ctx.fleet.tenants if t.plan.target == "aie"]
        if aie:
            raise ValueError(
                f"tenant(s) {aie} are planned for the AIE array (target "
                f"'aie'), which no engine of the port runs: build with "
                f"stop_after='plan' or 'verify', or plan for 'h100'")
        t0 = time.perf_counter()
        by_name = {c.name: c for c in ctx.configs}
        for tp in ctx.fleet.tenants:
            if tp.net_id in ctx.engines:
                continue
            cfg = by_name.get(tp.plan.network)
            if tp.plan.kind == "lm":
                if tp.net_id in ctx.lm_params:
                    cfg, params = ctx.lm_params[tp.net_id]
                elif cfg is None:
                    raise ValueError(
                        f"LM tenant {tp.net_id!r} needs its config: pass "
                        f"lm_params={{net_id: (cfg, params)}} or build from "
                        f"config objects")
                else:
                    gen = torch.Generator(device=ctx.device).manual_seed(
                        ctx.seed)
                    params = api.init(cfg, gen, device=ctx.device)
                ctx.engines[tp.net_id] = ContinuousBatcher(
                    cfg, params, plan=tp.plan, max_len=ctx.max_len,
                    device=ctx.device)
                continue
            if cfg is None:
                cfg = edge_lib.edge_config(tp.plan.network)
            ctx.engines[tp.net_id] = EdgeEngine(
                cfg, ctx.params.get(tp.net_id), plan=tp.plan, seed=ctx.seed,
                qparams=ctx.qparams.get(tp.net_id),
                calib_x=ctx.calib_x.get(tp.net_id), device=ctx.device)
        kinds = [tp.plan.kind for tp in ctx.fleet.tenants]
        return ctx.record(StageResult(
            stage=self.name, output=ctx.engines,
            wall_s=time.perf_counter() - t0,
            detail=f"{kinds.count('edge')} edge + {kinds.count('lm')} lm"))


PIPELINE = (CharacterizeStage(), PlanStage(), VerifyStage(), EngineStage())
