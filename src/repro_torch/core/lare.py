"""LARE: Latency-Adjusted Resource Equivalence (the paper's Algorithm 1).

For a dense layer ``(n_in, n_out)``:

1. sweep the PL (hls4ml) reuse factor ``rf`` over its legal values, collecting
   the resource/performance trade-off curve ``(R_PL(rf), P_PL(rf))``;
2. take the AIE performance point ``P_AIE`` for the same layer;
3. interpolate the PL curve to find ``rf_eq`` with
   ``P_PL(rf_eq) == P_AIE``: the latency-adjusted resource equivalent is
   ``LARE = R_PL(rf_eq)``.

LARE is both a decision boundary (deploy the layer on PL iff its PL
resource budget exceeds LARE) and an efficiency indicator (a low LARE says
a small PL budget already matches the AIE mapping).

The port of the JAX package's ``core/lare.py`` over the framework-free
models :data:`repro_torch.hw.AIE_ML` and :data:`repro_torch.hw.PL_FABRIC`.
``aie_interval_s`` may be injected from a measured run: the profiler
(:mod:`repro_torch.obs.profile`) injects the card's measured interval, which
answers the paper's question "PL or the accelerator?" with this card's
time.

:func:`lare_spatial` is the counterpart of the JAX package's ``lare_tpu``
(it prices no TPU): the core-equivalence of a layer pipelined over cards
against the same layer tiled on one card.  No planner of the port reads it.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Callable

from repro_torch import hw as hwlib
from repro_torch.core import tiling


@dataclasses.dataclass(frozen=True)
class LarePoint:
    """One point of the PL trade-off curve."""
    rf: int
    interval_s: float           # 1/throughput (paper's performance measure)
    latency_s: float
    resource: float             # scalar resource (DSP-equivalents)
    fits: bool


@dataclasses.dataclass(frozen=True)
class LareResult:
    n_in: int
    n_out: int
    aie_interval_s: float
    rf_eq: float                # interpolated equivalent reuse factor
    lare: float                 # R_PL at rf_eq (the metric)
    pl_curve: tuple[LarePoint, ...]
    aie_favorable_below: float  # budget threshold: below -> deploy on AIE

    def decide(self, pl_budget: float) -> str:
        """Decision boundary: 'pl' if the budget can match AIE, else 'aie'."""
        return "pl" if pl_budget >= self.lare else "aie"

    @property
    def aie_efficiency(self) -> float:
        """Efficiency indicator in [0,1]: LARE normalized by the resource an
        ideally-utilized AIE tile would pin down (dsp-equivalents)."""
        return min(1.0, self.lare / hwlib.AIE_ML.dsp58_equiv_per_tile)


def pl_curve(n_in: int, n_out: int, *, batch: int = 8,
             strategy: str = "resource",
             pl: hwlib.PlFabric = hwlib.PL_FABRIC) -> list[LarePoint]:
    """HLS4ML resource/performance sweep over legal reuse factors."""
    pts = []
    for rf in pl.legal_reuse_factors(n_in, n_out):
        res = pl.resources(n_in, n_out, rf, strategy=strategy)
        pts.append(LarePoint(
            rf=rf,
            interval_s=pl.interval_s(rf),
            latency_s=pl.latency_s(n_in, n_out, rf, batch),
            resource=pl.resource_scalar(res),
            fits=pl.fits(res),
        ))
    return pts


def lare(n_in: int, n_out: int, *, batch: int = 8,
         strategy: str = "resource",
         pl: hwlib.PlFabric = hwlib.PL_FABRIC,
         aie: hwlib.AieMl = hwlib.AIE_ML,
         aie_interval_s: float | None = None) -> LareResult:
    """Paper Algorithm 1.  ``aie_interval_s`` may be injected from a measured
    run; by default it comes from the calibrated single-tile model (naive
    1-layer-per-tile mapping, as in Section III-B)."""
    curve = pl_curve(n_in, n_out, batch=batch, strategy=strategy, pl=pl)
    if aie_interval_s is None:
        s_best, _ = tiling.aie_best_single_tile(batch, n_in, n_out, aie)
        aie_interval_s = tiling.aie_tile_interval(batch, n_in, n_out, s_best,
                                                  aie)
    # PL curve is monotone: interval increases with rf, resource decreases.
    ivals = [p.interval_s for p in curve]
    idx = bisect.bisect_left(ivals, aie_interval_s)
    if idx == 0:
        rf_eq, r_eq = float(curve[0].rf), curve[0].resource
    elif idx >= len(curve):
        rf_eq, r_eq = float(curve[-1].rf), curve[-1].resource
    else:
        lo, hi = curve[idx - 1], curve[idx]
        f = (aie_interval_s - lo.interval_s) / max(hi.interval_s - lo.interval_s, 1e-30)
        rf_eq = lo.rf + f * (hi.rf - lo.rf)
        # log-space interpolation of resources (curve is ~1/rf).
        r_eq = math.exp(math.log(max(lo.resource, 1e-9))
                        + f * (math.log(max(hi.resource, 1e-9))
                               - math.log(max(lo.resource, 1e-9))))
    return LareResult(n_in, n_out, aie_interval_s, rf_eq, r_eq,
                      tuple(curve), aie_favorable_below=r_eq)


# --------------------------------------------------------------------------
# Core-equivalence between the pipelined-spatial and the tiled regime
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LareSpatialResult:
    """:func:`lare_spatial`'s answer; a core is a card."""
    n_in: int
    n_out: int
    tiled_latency_s: float       # the tiled layer's latency on kernel_cores
    kernel_cores: int
    core_eq: float               # pipeline cards needed to match (the metric)
    pipeline_curve: tuple[tuple[int, float], ...]   # (cards, latency_s)

    def decide(self, pipeline_core_budget: int) -> str:
        return "pipeline" if pipeline_core_budget >= self.core_eq else "tiled"


def lare_spatial(n_in: int, n_out: int, *, batch: int = 8, itemsize: int = 1,
                 kernel_cores: int = 1, max_cores: int = 64,
                 hw: hwlib.H100 = hwlib.H100_SXM,
                 tiled_latency_s: float | None = None,
                 pipeline_latency_fn: Callable[[int], float] | None = None,
                 ) -> LareSpatialResult:
    """The LARE adaptation on cards, the JAX package's ``lare_tpu`` with a
    card for a core.

    *Tiled regime* (the "AIE side"): the layer runs as one planned
    ``gemm_int8`` on ``kernel_cores`` cards (:func:`tiling.plan_gemm`), or
    at ``tiled_latency_s`` where measured.

    *Pipelined-spatial regime* (the "PL side"): the layer owns ``c`` cards
    of a layer pipeline (``train/pipeline_par.py`` runs one); its stage
    time is the K-split GEMM on ``c`` cards (:func:`tiling.plan_spatial`)
    plus the hand-off of its outputs to the next stage over NVLink.  The
    curve doubles ``c`` up to ``max_cores``; ``core_eq`` interpolates the
    cards at which the pipeline matches the tiled latency."""
    if tiled_latency_s is None:
        plan = tiling.plan_gemm(batch, n_in, n_out, itemsize=itemsize,
                                axis_sizes=(kernel_cores,), hw=hw,
                                max_tiles=kernel_cores)
        tiled_latency_s = plan.est_s
    curve: list[tuple[int, float]] = []
    c = 1
    while c <= max_cores:
        if pipeline_latency_fn is not None:
            t = pipeline_latency_fn(c)
        else:
            sp = tiling.plan_spatial(batch, n_in, n_out, itemsize=itemsize,
                                     axis_sizes=(c,), hw=hw, max_tiles=c,
                                     q_k_floor=1, q_n_floor=1)
            api = tiling.plan_api(batch, sp.q_k, sp.q_n, hw=hw)
            handoff = batch * n_out * itemsize / hw.nvlink_bw
            t = api.est_s + sp.est_collective_s + handoff
        curve.append((c, t))
        c *= 2
    core_eq = float("inf")
    for c, t in curve:
        if t <= tiled_latency_s:
            prev = next(((pc, pt) for pc, pt in reversed(curve) if pc < c),
                        None)
            if prev is not None and prev[1] > tiled_latency_s:
                pc, pt = prev
                f = (pt - tiled_latency_s) / max(pt - t, 1e-30)
                core_eq = pc + f * (c - pc)
            else:
                core_eq = float(c)
            break
    return LareSpatialResult(n_in, n_out, tiled_latency_s, kernel_cores,
                             core_eq, tuple(curve))
