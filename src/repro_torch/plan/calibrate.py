"""Calibrate the card's machine model against the path the engine runs.

Port of the JAX package's ``plan/calibrate.py``.  The planner's latency
estimates come from an :class:`~repro_torch.hw.H100`.  Its two launch terms
(``kernel_overhead_s``, ``fused_epilogue_s``) are stock values no card
measured, so planned-vs-measured comparisons need a model fitted to what a
served request really pays.

:func:`calibrated_device_model` times ``gemm_int8`` pipelines, the shape of
computation the plan executor runs, at the 3 points of the ``calibrate``
grid, on the engine's device as the engine runs them (a CUDA graph per call
on the card, the plain path on the CPU); least-squares fits ``t = launches
* overhead + padded_ops / peak``; and returns an ``H100`` with those two
constants substituted.  The full sweep (:mod:`repro_torch.characterize`)
also fits the fused boundary and the memory rate.

The calibration-feedback half of the loop: :func:`feedback` writes one
plan's measured latency back into the cache, and :func:`recalibrate_fleet`
rescales a whole ``FleetPlan`` from measurements (the fleet autotune).
"""

from __future__ import annotations

import dataclasses

from repro_torch import hw as hwlib
from repro_torch.device import resolve_device


def feedback(plan, measured_latency_s: float, *, cache=None):
    """Write a measured end-to-end latency back into the plan cache.

    The plan's per-layer/boundary estimates are rescaled by ``measured /
    planned`` and a ``calibration`` record lands in the plan's ``serve``
    section; the updated plan is re-``put`` under its ORIGINAL key, so the
    next ``get_or_plan`` with the same question returns calibrated costs.
    Tiles and groups are untouched: only the cost annotations move.  The
    fusion groups' estimates scale with their layers', so they keep
    summing to the layers' parts, as the verify stage's
    ``plan.latency-invariant`` rule requires (the reference leaves them)."""
    from repro_torch.plan.artifact import default_cache
    if measured_latency_s <= 0:
        raise ValueError(f"measured latency must be > 0, "
                         f"got {measured_latency_s}")
    if plan.est_latency_s <= 0:
        raise ValueError("plan has no positive latency estimate to calibrate")
    # The total carries a fixed entry-launch overhead on top of the
    # per-layer/boundary parts; scale only the parts so the invariant
    # est_latency == sum(parts) + overhead survives calibration.
    parts = sum(l.est_latency_s * l.repeat for l in plan.layers) \
        + sum(b.crossing_s for b in plan.boundaries)
    overhead = max(plan.est_latency_s - parts, 0.0)
    if parts > 0 and measured_latency_s > overhead:
        scale = (measured_latency_s - overhead) / parts
    else:                           # degenerate: fall back to proportional
        scale = measured_latency_s / plan.est_latency_s
    layers = tuple(dataclasses.replace(
        l, est_latency_s=l.est_latency_s * scale,
        est_interval_s=l.est_interval_s * scale) for l in plan.layers)
    bounds = tuple(dataclasses.replace(b, crossing_s=b.crossing_s * scale)
                   for b in plan.boundaries)
    groups = tuple(dataclasses.replace(g, est_latency_s=g.est_latency_s
                                       * scale)
                   for g in plan.fusion_groups)
    calibrated = dataclasses.replace(
        plan, layers=layers, boundaries=bounds, fusion_groups=groups,
        est_latency_s=measured_latency_s,
        est_interval_s=plan.est_interval_s
        * (measured_latency_s / plan.est_latency_s),
        serve={**plan.serve,
               "calibration": {"measured_latency_s": measured_latency_s,
                               "scale": scale}})
    cache = cache if cache is not None else default_cache()
    cache.put(calibrated)
    return calibrated


def recalibrate_fleet(fleet, measurements: dict, *, cache=None,
                      budget_factor: float | None = None):
    """Recalibrate a whole :class:`~repro_torch.plan.multinet.FleetPlan`
    from measured per-tenant latencies (``net_id -> seconds``, a robust
    statistic such as the p50).  Each measured tenant's plan goes through
    :func:`feedback`, its latency budget is re-derived from the calibrated
    latency with the SAME headroom factor the fleet was planned with
    (``budget_factor`` overrides it), and the fleet totals are recomputed.
    Tiles and groups are untouched, so engines keep running."""
    tenants = []
    for tp in fleet.tenants:
        m = measurements.get(tp.net_id)
        if m is not None and m > 0 and tp.plan.est_latency_s > 0:
            plan = feedback(tp.plan, m, cache=cache)
        else:
            plan = tp.plan
        planned = tp.plan.est_latency_s + tp.crossing_s
        factor = budget_factor if budget_factor is not None else (
            tp.latency_budget_s / planned if planned > 0 else 2.0)
        tenants.append(dataclasses.replace(
            tp, plan=plan,
            latency_budget_s=factor * (plan.est_latency_s + tp.crossing_s)))
    return dataclasses.replace(
        fleet, tenants=tuple(tenants),
        est_latency_s=max(t.total_latency_s for t in tenants))


def measurements_from_engines(engines: dict) -> dict:
    """``net_id -> measured seconds`` from live engines: the windowed p50,
    else the mean, skipping engines with nothing recorded yet."""
    out = {}
    for net_id, eng in engines.items():
        m = getattr(eng, "measured_p50_s", 0.0) \
            or getattr(eng, "measured_mean_s", 0.0)
        if m > 0:
            out[net_id] = m
    return out


_MODEL_MEMO: dict = {}


def _memo_key(device, batch: int, base: hwlib.H100) -> tuple:
    return (str(resolve_device(device)), batch, base)


def device_model_memoized(device=None, *, batch: int = 8,
                          base: hwlib.H100 = hwlib.H100_SXM) -> bool:
    """Whether :func:`calibrated_device_model` would answer from its memo
    (no re-timing) for these arguments."""
    return _memo_key(device, batch, base) in _MODEL_MEMO


def calibrated_device_model(device=None, *, batch: int = 8,
                            base: hwlib.H100 = hwlib.H100_SXM) -> hwlib.H100:
    """``base`` with ``kernel_overhead_s`` and ``peak_int8_ops`` fitted to
    the ``calibrate`` grid of the ``gemm_int8`` term, timed on ``device``
    (``None``: the card, raising when there is none).

    The fit is memoized per (device, batch, base) for the process: every
    consumer shares one calibration instead of re-timing the sweep."""
    from repro_torch.characterize import fit_term, run_term
    key = _memo_key(device, batch, base)
    if key in _MODEL_MEMO:
        return _MODEL_MEMO[key]
    samples = run_term("gemm_int8", sweep="calibrate", batch=batch,
                       device=resolve_device(device))
    tf = fit_term("gemm_int8", samples)
    model = dataclasses.replace(
        base, peak_int8_ops=tf.constants["peak_int8_ops"],
        kernel_overhead_s=tf.constants["kernel_overhead_s"])
    _MODEL_MEMO[key] = model
    return model
