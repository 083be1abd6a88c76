"""Microbenchmark primitives for the characterization of the card.

Port of the JAX package's ``characterize/harness.py``.  Each ``time_*``
helper runs ONE microbenchmark point, the same shape of computation the
planner charges a cost term for, and returns a :class:`Sample`: the
measured time plus the regressor values the fitter needs (launch count,
padded op count, boundary bytes).

The helpers time what :meth:`repro_torch.serve.EdgeEngine.infer` pays.  On
the card that is the step as a CUDA graph, called as the engine calls it
(:class:`~repro_torch.kernels.graph.GraphedForward`): the input copied into
the graph's static input, the replay, the output cloned out and the
finiteness guard read back.  The time is the host clock from the call to
the result ready on the host, as the reference's ``wall_timer`` takes it
around ``block_until_ready``, so the fit sees the host's part of a request
as the engine's callers do.  Each sample also keeps the device time of one
bare replay of the step (``device_seconds``, CUDA events), which the
``fused_chain`` fit reads (see ``fit``): the rest of the host time is the
call's host part.  The input lies
where :meth:`Deployment.bench`'s does, on the engine's device.  On the CPU
the same step runs eagerly through the kernels' plain versions.

One term is not timed at all: the AI-Engine array's band-2 contention
(:func:`model_band2_point`) reads the paper-calibrated AIE model
(:func:`repro_torch.core.tiling.aie_spatial_interval`), as the reference's
does on hosts without the array, and its samples are labelled
``src=model``.

Every helper takes a ``timer`` hook so tests (and dry-run fits) can replace
timing with a synthetic analytical cost: the whole sweep -> fit -> artifact
machinery then runs deterministically in milliseconds.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch

from repro_torch import hw as hwlib
from repro_torch.core import tiling
from repro_torch.kernels import fused_mlp
from repro_torch.kernels import ops
from repro_torch.kernels.graph import GraphedForward, finite_guard


@dataclasses.dataclass(frozen=True)
class Sample:
    """One microbenchmark observation: measured seconds + fit regressors."""
    term: str                      # cost term this point characterizes
    inputs: dict                   # sweep coordinates (depth, width, dtype...)
    regressors: dict               # named regressor values for the LSQ fit
    seconds: float                 # measured (or synthetic) host time
    device_seconds: float | None = None   # one replay, the card only

    def to_dict(self) -> dict:
        return {"term": self.term, "inputs": dict(self.inputs),
                "regressors": dict(self.regressors),
                "seconds": self.seconds,
                "device_seconds": self.device_seconds}

    @classmethod
    def from_dict(cls, d: dict) -> "Sample":
        return cls(term=d["term"], inputs=dict(d["inputs"]),
                   regressors=dict(d["regressors"]), seconds=d["seconds"],
                   device_seconds=d.get("device_seconds"))


# Timer type: (term, regressors) -> synthetic seconds per call.
Timer = Callable[..., float]


def _request(fn, x: torch.Tensor):
    """One call of ``fn`` on ``x`` as the engine makes it, ending in the
    guard's read-back (graph-replayed on the card, eager on the CPU), and on
    the card the bare replay of the captured step (for its device time)."""
    if x.device.type != "cuda":
        return (lambda: math.isfinite(float(finite_guard(fn(x))))), None
    graphed = GraphedForward(fn, x.shape, x.device, dtype=x.dtype)

    def call():
        return math.isfinite(graphed(x)[1])
    return call, lambda: graphed.graph.graph.replay()


def wall_timer(call, replay=None, *, iters: int = 51,
               warmup: int = 3) -> tuple[float, float | None]:
    """Median host seconds per call of ``call``, which ends in a read-back,
    so the result is ready on the host (the first warm-up call captures the
    graph); and with ``replay``, the device seconds of one replay of the
    captured step, from CUDA events around ``iters`` back-to-back replays
    (the input copy, the output clone and the read-back left out)."""
    for _ in range(warmup):
        call()
    host = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        host.append(time.perf_counter() - t0)
    host.sort()
    device = None
    if replay is not None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            replay()
        e1.record()
        e1.synchronize()
        device = e0.elapsed_time(e1) * 1e-3 / iters
    return host[len(host) // 2], device


def _ceil_to(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def int8_pipeline_regressors(width: int, depth: int, batch: int, *,
                             hw: hwlib.H100 = hwlib.H100_SXM) -> dict:
    """Fit regressors for a depth-layer width x width int8 GEMM pipeline.

    ``padded_ops`` is what :func:`repro_torch.core.tiling.plan_api` charges
    a layer at its tile, times the rate it charges at: the waves of CTAs
    over the SMs, each CTA's padded ``block_m x block_n x K`` tile, on every
    SM.  Then ``padded_ops / peak_int8_ops`` is the planner's compute term
    exactly, and the fitted rate enters the planner as the rate its own
    term implies.  Inter-launch activation traffic is characterized by the
    ``boundary`` sweep."""
    bm, bk, bn = tiling.plan_api(batch, width, width, hw=hw).blocks
    r_m, r_k, r_n = (math.ceil(batch / bm), math.ceil(width / bk),
                     math.ceil(width / bn))
    waves = math.ceil(r_m * r_n / hw.sms)
    ops_per_layer = waves * 2.0 * bm * bn * r_k * bk * hw.sms
    return {"launches": float(depth), "padded_ops": depth * ops_per_layer}


def time_int8_pipeline(width: int, depth: int, *, batch: int = 8,
                       iters: int = 51, timer: Timer | None = None,
                       device: torch.device | None = None) -> Sample:
    """One (depth, width) point of the int8 GEMM-pipeline sweep: ``depth``
    ``gemm_int8`` launches at the planner's tile, each requantized to int8
    for the next, the shape of the engine's per-layer rung."""
    regs = int8_pipeline_regressors(width, depth, batch)
    inputs = {"depth": depth, "width": width, "dtype": "int8",
              "batch": batch}
    if timer is not None:
        return Sample("gemm_int8", inputs, regs, timer("gemm_int8", regs))
    ws = torch.ones((depth, width, width), dtype=torch.int8, device=device)
    sc = torch.ones((width,), dtype=torch.float32, device=device)
    bm, bk, bn = tiling.plan_api(batch, width, width).blocks

    def f(x):
        h = x
        for i in range(depth):
            y = ops.gemm_int8(h, ws[i], sc, 1.0, block_m=bm, block_k=bk,
                              block_n=bn, out_dtype=torch.float32)
            h = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
        return h

    x = torch.ones((batch, width), dtype=torch.int8, device=device)
    t, t_dev = wall_timer(*_request(f, x), iters=iters)
    return Sample("gemm_int8", inputs, regs, t, t_dev)


def fused_chain_regressors(width: int, depth: int, batch: int) -> dict:
    """Fit regressors for a depth-layer fused chain.

    One launch regardless of depth; ``padded_ops`` uses the fused kernel's
    OWN compute extent (its row tiles of ``ROWS`` rows x the widths padded
    to the int8 mma's k and m), and ``inner_layers`` counts the fused
    epilogue requantizes, the per-boundary cost the planner charges as
    ``H100.fused_epilogue_s``."""
    rows = _ceil_to(batch, fused_mlp.ROWS)
    kp = _ceil_to(width, fused_mlp.K_MULTIPLE)
    np_ = _ceil_to(width, fused_mlp.N_MULTIPLE)
    return {"one": 1.0,
            "padded_ops": depth * 2.0 * rows * kp * np_,
            "inner_layers": float(depth - 1)}


def time_fused_chain(width: int, depth: int, *, batch: int = 8,
                     iters: int = 51, timer: Timer | None = None,
                     device: torch.device | None = None) -> Sample:
    """One (depth, width) point of the fused-chain sweep: the SAME layer
    stack as :func:`time_int8_pipeline`, run as ONE ``fused_mlp_q8``
    launch.  Fitting it against the multi-launch pipeline is what turns the
    fuse-vs-split decision into a measured trade-off."""
    regs = fused_chain_regressors(width, depth, batch)
    inputs = {"depth": depth, "width": width, "dtype": "int8",
              "batch": batch}
    if timer is not None:
        return Sample("fused_chain", inputs, regs,
                      timer("fused_chain", regs))
    group = ops.pack_group(
        [torch.ones((width, width), dtype=torch.int8, device=device)
         for _ in range(depth)],
        [torch.ones((width,), dtype=torch.float32, device=device)
         for _ in range(depth)],
        [torch.zeros((width,), dtype=torch.float32, device=device)
         for _ in range(depth)],
        [1.0] * depth, act="relu")
    x = torch.ones((batch, width), dtype=torch.float32, device=device)
    t, t_dev = wall_timer(*_request(lambda h: ops.fused_group(h, group), x),
                          iters=iters)
    return Sample("fused_chain", inputs, regs, t, t_dev)


def time_unfused_chain(n_launches: int, act_bytes: int, *, iters: int = 51,
                       timer: Timer | None = None,
                       device: torch.device | None = None) -> Sample:
    """One point of the DR7' boundary sweep: ``n_launches`` SEPARATE
    element-wise launches over an ``act_bytes`` activation.  Each un-fused
    boundary pays a launch plus the activation's round trip, which is what
    :func:`repro_torch.core.boundary.crossing_cost` charges."""
    regs = {"launches": float(n_launches),
            "launch_bytes": float(n_launches) * act_bytes}
    inputs = {"n_launches": n_launches, "act_bytes": act_bytes}
    if timer is not None:
        return Sample("boundary", inputs, regs, timer("boundary", regs))
    n = max(act_bytes // 4, 1)                      # float32 elements

    def chain(v):
        for _ in range(n_launches):
            v = torch.add(v, 0.5)                   # one kernel, one trip
        return v

    x = torch.ones((n,), dtype=torch.float32, device=device)
    t, t_dev = wall_timer(*_request(chain, x), iters=iters)
    return Sample("boundary", inputs, regs, t, t_dev)


def model_band2_point(n_band2: int, *, shape=(8, 128, 128), aie=None,
                      timer: Timer | None = None) -> Sample:
    """One point of the band-2 contention sweep.

    The AIE array is not on this machine, so the sweep reads the
    paper-calibrated analytical curves (:mod:`repro_torch.core.tiling`)
    instead of a clock, labelled ``src=model`` in the artifact's fit.  On a
    real VEK280 the same fit consumes measured intervals."""
    m, k, n = shape
    regs = {"n_band2": float(n_band2), "one": 1.0}
    inputs = {"n_band2": n_band2, "shape": list(shape)}
    if timer is not None:
        return Sample("contention", inputs, regs, timer("contention", regs))
    t = tiling.aie_spatial_interval(m, k, n, 2, 2, layers_in_band_2=n_band2,
                                    aie=aie or hwlib.AIE_ML)
    return Sample("contention", inputs, regs, t)
