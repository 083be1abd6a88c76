"""Parameterized sweep grids over the cost terms the h100 planner charges.

Port of the JAX package's ``characterize/sweeps.py``, on its grids (the
fused chain's cut to one block's shared memory).  Four terms: three
matching the constants the h100 planner reads, one the ``"aie"`` planner
reads:

* ``gemm_int8``   -- multi-launch ``gemm_int8`` pipelines over a (depth,
  width) grid -> the fixed cost of one launch (``H100.kernel_overhead_s``)
  and the int8 rate (``peak_int8_ops``).
* ``fused_chain`` -- the SAME int8 layer stacks run as ONE ``fused_mlp_q8``
  launch -> the cost of a layer boundary kept inside the fused kernel
  (``H100.fused_epilogue_s``), fitted on device time and kept only where
  the fit resolves it above its residual (``fit``), so the planner's
  fuse-vs-split decision (DR7') is priced by this card or by the stock
  constant, never by noise.
* ``boundary``    -- un-fused element-wise launch chains over an
  (n_launches, act_bytes) grid -> the DR7' crossing cost's fixed launch and
  per-byte parts (``hbm_bw``).
* ``contention``  -- the band-2 spill population sweep -> the Fig.-6
  contention slope (``AieMl.band2_penalty_per_layer``).  The array is not
  on this machine, so its points read the analytical AIE curves (labelled
  ``model``), as the reference's do; no h100 plan reads the slope.

Left out: the reference's ``gemm_f32`` term, which fits the float rate that
no edge plan of the port reads.

Three grids: ``quick`` (CI-sized), ``full`` (denser, for committed
artifacts) and ``calibrate`` (the 3-point grid
:func:`repro_torch.plan.calibrate.calibrated_device_model` fits).
"""

from __future__ import annotations

from repro_torch.characterize import harness
from repro_torch.characterize.harness import Sample, Timer

# (depth, width) grids for the GEMM pipeline sweep.
_GEMM_GRIDS = {
    "calibrate": ((2, 128), (6, 128), (2, 512)),
    "quick": ((2, 64), (6, 64), (2, 128), (6, 128), (2, 512)),
    "full": ((2, 64), (4, 64), (6, 64), (2, 128), (4, 128), (6, 128),
             (2, 256), (4, 256), (2, 512), (4, 512)),
}
# (depth, width) grids for the fused chain sweep.  Two widths minimum: with
# a single width, `inner_layers` (= depth-1) is collinear with the {one,
# padded_ops} columns and the epilogue coefficient is unfittable.  The fused
# kernel holds every layer's weights in one block's shared memory, so at
# width 256 it takes at most 3 layers: the reference's (4, 256) and (6, 256)
# points become (3, 256) and (6, 128), (8, 128).
_FUSED_GRIDS = {
    "calibrate": ((2, 64), (6, 64), (2, 256)),
    "quick": ((2, 64), (6, 64), (2, 256), (3, 256)),
    "full": ((2, 64), (4, 64), (6, 64), (8, 64), (2, 256), (3, 256),
             (6, 128), (8, 128)),
}
# (n_launches, act_bytes) grids for the boundary sweep.
_BOUNDARY_GRIDS = {
    "calibrate": ((2, 1 << 12), (8, 1 << 12), (2, 1 << 20)),
    "quick": ((2, 1 << 12), (8, 1 << 12), (2, 1 << 20), (8, 1 << 20)),
    "full": ((2, 1 << 12), (4, 1 << 12), (8, 1 << 12), (2, 1 << 16),
             (8, 1 << 16), (2, 1 << 20), (4, 1 << 20), (8, 1 << 20)),
}

_CONTENTION_GRIDS = {
    "calibrate": (0, 1, 2),
    "quick": (0, 1, 2, 3),
    "full": (0, 1, 2, 3, 4, 6),
}

TERMS = ("gemm_int8", "fused_chain", "boundary", "contention")
SWEEPS = ("calibrate", "quick", "full")


def grid(term: str, sweep: str):
    """The (term, sweep) coordinate grid, recorded in artifact provenance."""
    tables = {"gemm_int8": _GEMM_GRIDS, "fused_chain": _FUSED_GRIDS,
              "boundary": _BOUNDARY_GRIDS, "contention": _CONTENTION_GRIDS}
    if term not in tables:
        raise ValueError(f"unknown term {term!r}; choose from {TERMS}")
    if sweep not in tables[term]:
        raise ValueError(f"unknown sweep {sweep!r}; choose from {SWEEPS}")
    return tables[term][sweep]


def run_term(term: str, *, sweep: str = "quick", batch: int = 8,
             iters: int = 51, timer: Timer | None = None, device=None,
             aie=None, tracer=None) -> list[Sample]:
    """Run one cost term's sweep on ``device`` (a resolved device; the
    synthetic ``timer`` and the ``contention`` term need none); returns its
    samples.  ``aie`` is the AIE model the contention points read (default
    ``hw.AIE_ML``).  With ``tracer`` (a :class:`repro_torch.obs.Tracer`)
    the whole term sweep is timed as one ``characterize/<term>`` span."""
    if tracer is not None and tracer.enabled:
        with tracer.span(f"characterize/{term}", tenant="characterize",
                         sweep=sweep):
            return run_term(term, sweep=sweep, batch=batch, iters=iters,
                            timer=timer, device=device, aie=aie)
    g = grid(term, sweep)
    if term == "contention":
        return [harness.model_band2_point(n, aie=aie, timer=timer)
                for n in g]
    kw = {"iters": iters, "timer": timer, "device": device}
    if term == "gemm_int8":
        return [harness.time_int8_pipeline(w, d, batch=batch, **kw)
                for d, w in g]
    if term == "fused_chain":
        return [harness.time_fused_chain(w, d, batch=batch, **kw)
                for d, w in g]
    return [harness.time_unfused_chain(n, b, **kw) for n, b in g]


def run_sweep(*, sweep: str = "quick", batch: int = 8, iters: int = 51,
              terms=TERMS, timer: Timer | None = None, device=None,
              aie=None, tracer=None) -> list[Sample]:
    """Run every requested term's sweep (the CLI entry's workhorse)."""
    out: list[Sample] = []
    for term in terms:
        out.extend(run_term(term, sweep=sweep, batch=batch, iters=iters,
                            timer=timer, device=device, aie=aie,
                            tracer=tracer))
    return out
