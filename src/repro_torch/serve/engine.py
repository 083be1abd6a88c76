"""EdgeEngine: executes an h100 :class:`DeploymentPlan` for an edge net.

Port of the edge half of the JAX package's ``serve/engine.py``.  The engine
owns the quantized weights and the planned forward, built once at
construction (groups, tiles, packed weights and scales fixed), and times
every request.  Its degradation ladder has two rungs: level 0 runs the
plan's fused groups (``fused_mlp_q8``), level 1 the per-layer path
(``gemm_int8``, ``fused=False``).  Both give the same answers to 1e-5, so
degrading never changes a result.
"""

from __future__ import annotations

import collections
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models import edge as edge_lib
from repro_torch.obs import NULL_TRACER, summarize


class NonFiniteOutput(RuntimeError):
    """An engine produced NaN/inf: the request fails instead of returning
    garbage."""


class EdgeEngine:
    """Serve one edge net on ``device`` (``None``: the GPU, raising when
    there is none).

    Weights: ``qparams`` as given (layers without a calibrated
    ``x_scale`` use the ``x_scale`` argument); else ``params`` (float) are
    quantized with activation scales calibrated on ``calib_x`` (default: a
    seeded normal batch); else params are drawn from ``seed``.
    """

    def __init__(self, cfg, params=None, *, plan=None, x_scale: float = 0.05,
                 seed: int = 0, qparams=None, calib_x=None, tracer=None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.trace_label = cfg.name
        self.plan = plan if plan is not None else edge_lib.deployment_plan(
            cfg, device=self.device)
        if qparams is None:
            if params is None:
                gen = torch.Generator().manual_seed(seed)
                params = edge_lib.init_edge(cfg, generator=gen,
                                            device=self.device)
            if calib_x is None:
                gen = torch.Generator().manual_seed(seed + 7)
                calib_x = torch.randn((cfg.batch, cfg.dims[0]),
                                      generator=gen, dtype=torch.float32)
            params = [{k: v.to(self.device) for k, v in p.items()}
                      for p in params]
            qparams = edge_lib.quantize_edge(
                params, calib_x=torch.as_tensor(calib_x).to(self.device),
                act=cfg.act)
        self.qparams = [{k: v.to(self.device) if torch.is_tensor(v) else v
                         for k, v in q.items()} for q in qparams]
        self.x_scale = x_scale
        self._fwd = edge_lib.build_forward_q8(self.qparams, cfg,
                                              x_scale=x_scale, plan=self.plan)
        self.degrade_level = 0
        self._fwd_fallback = None
        self.faults = 0
        self.reset_measurements()

    def _fallback(self):
        """The per-layer (``fused=False``) forward, built on first use."""
        if self._fwd_fallback is None:
            self._fwd_fallback = edge_lib.build_forward_q8(
                self.qparams, self.cfg, x_scale=self.x_scale, plan=self.plan,
                fused=False)
        return self._fwd_fallback

    def degrade(self) -> bool:
        """Step down to the per-layer rung; True if a demotion happened."""
        if self.degrade_level == 0:
            self.degrade_level = 1
            return True
        return False

    def restore(self) -> bool:
        """Re-promote to the fused rung; True on change."""
        if self.degrade_level > 0:
            self.degrade_level = 0
            return True
        return False

    def infer(self, x) -> torch.Tensor:
        """One request: ``(batch, dims[0])`` in, a ready ``(batch,
        dims[-1])`` f32 tensor on the engine's device out."""
        t0 = time.perf_counter()
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        fwd = self._fwd if self.degrade_level == 0 else self._fallback()
        y = fwd(x)
        # The finiteness guard reads one flag back to the host, which also
        # waits for the forward: infer returns a ready result by contract.
        if not bool(torch.isfinite(y).all()):
            t1 = time.perf_counter()
            self.faults += 1
            if self.tracer.enabled:
                self.tracer.add("fault/non_finite", t0, t1,
                                tenant=self.trace_label)
            raise NonFiniteOutput(f"{self.trace_label}: non-finite output")
        t1 = time.perf_counter()
        self.calls += 1
        self._latencies.append(t1 - t0)
        if self.tracer.enabled:
            self.tracer.add("infer", t0, t1, trace=self.calls,
                            tenant=self.trace_label)
        return y

    def span_stats(self) -> dict:
        """The edge path's one span kind, ``infer``, over the window."""
        if not self._latencies:
            return {}
        agg = summarize(self._latencies)
        agg["total_count"] = self.calls
        return {"infer": agg}

    @property
    def measured_p50_s(self) -> float:
        """Median over the recent-call window."""
        if not self._latencies:
            return 0.0
        xs = sorted(self._latencies)
        return xs[len(xs) // 2]

    def reset_measurements(self):
        """Drop accumulated timings (e.g. after warmup)."""
        self.calls = 0
        self._latencies = collections.deque(maxlen=256)
