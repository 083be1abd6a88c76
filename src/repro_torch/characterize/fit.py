"""Least-squares model fitting over characterization samples.

Port of the JAX package's ``characterize/fit.py``, the fit and the clamps
copied, trimmed to the four terms the port sweeps.  Each cost term is a
linear model in its sweep's regressors, so one ``lstsq`` per term recovers
the machine constants the planner charges:

* ``gemm_int8``:  t = overhead * launches + inv_peak * padded_ops
* ``fused_chain``: t = const + inv_peak * padded_ops + epilogue * inner_layers
* ``boundary``:   t = const + dispatch * launches + per_byte * launch_bytes
* ``contention``: t = base * (1 + slope * n_band2)

Two departures from the reference, both where its fit would hand the
planner noise:

* the int8 rate's clamp keeps the datasheet rate where the reference's
  threshold (1e-15 s/OP) sits under this card's datasheet;
* ``fused_chain`` is fitted on the samples' device time where every sample
  has one (one bare replay, CUDA events): the epilogue is a fraction of a
  microsecond inside one launch, under the host clock's noise, and the
  host's fixed part of a call drops out of device time.  Its
  ``fused_epilogue_s`` is kept only where the fit resolves it, its share
  across the grid (slope times the span of ``inner_layers``) above twice
  the fit's RMS residual; else the term carries no constant and the stock
  one stands.

Every :class:`TermFit` carries its relative-RMS residual so an artifact is
auditable: a term whose residual blew up says "this host does not behave
linearly in this regressor", not "trust these constants".
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch import hw as hwlib
from repro_torch.characterize.harness import Sample

# regressor design per term (column order matters: constants map 1:1).
_DESIGNS = {
    "gemm_int8": ("launches", "padded_ops"),
    "fused_chain": ("one", "padded_ops", "inner_layers"),
    "boundary": ("one", "launches", "launch_bytes"),
    "contention": ("one", "n_band2"),
}
# Terms read off an analytical model, not a clock (the artifact's label).
_MODELLED = ("contention",)


@dataclasses.dataclass(frozen=True)
class TermFit:
    """One fitted cost term: named constants + fit-quality evidence."""
    term: str
    constants: dict                # name -> fitted value (clamped, derived)
    coefficients: tuple            # raw lstsq solution, design order
    residual_rel_rms: float        # rms(pred - t) / mean(t)
    n_samples: int
    source: str                    # "measured" (host clock), "device"
                                   # (CUDA events) or "model"

    def to_dict(self) -> dict:
        return {"term": self.term, "constants": dict(self.constants),
                "coefficients": list(self.coefficients),
                "residual_rel_rms": self.residual_rel_rms,
                "n_samples": self.n_samples, "source": self.source}

    @classmethod
    def from_dict(cls, d: dict) -> "TermFit":
        return cls(term=d["term"], constants=dict(d["constants"]),
                   coefficients=tuple(d["coefficients"]),
                   residual_rel_rms=d["residual_rel_rms"],
                   n_samples=d["n_samples"], source=d["source"])


# Terms fitted on device time where every sample has one (see above).
_DEVICE_TIMED = ("fused_chain",)


def _lstsq(samples: list[Sample], columns: tuple,
           times: list[float]) -> tuple[tuple, float, float]:
    """Coefficients, relative and absolute RMS residual of ``times``."""
    import numpy as np
    a = np.array([[s.regressors.get(c, 1.0 if c == "one" else 0.0)
                   for c in columns] for s in samples])
    t = np.array(times)
    coef, *_ = np.linalg.lstsq(a, t, rcond=None)
    pred = a @ coef
    mean = float(np.mean(t)) or 1.0
    rms = float(np.sqrt(np.mean((pred - t) ** 2)))
    return tuple(float(c) for c in coef), rms / mean, rms


def _constants_for(term: str, coef: tuple) -> dict:
    """Map raw coefficients to the named machine constants, with the
    physical clamps the planner needs (positive peaks, non-negative costs)."""
    if term == "gemm_int8":
        overhead, inv_peak = coef
        # The reference falls back to 1e12 OP/s below a slope of 1e-15 s/OP,
        # under this card's datasheet rate (1.979e15): here a slope that
        # puts the rate above the datasheet, or at or below zero, means the
        # compute is lost in the noise at these shapes, and the datasheet
        # rate stands.
        datasheet = hwlib.H100_SXM.peak_int8_ops
        peak = min(1.0 / inv_peak, datasheet) if inv_peak > 0 else datasheet
        return {"kernel_overhead_s": max(overhead, 1e-6),
                "peak_int8_ops": max(peak, 1e6)}
    if term == "fused_chain":
        _, _, epilogue = coef
        # The fused launch's own dispatch and throughput are characterized
        # by the gemm_int8 term; this sweep isolates what keeping a layer
        # boundary INSIDE the kernel costs (the epilogue requantize).
        return {"fused_epilogue_s": max(epilogue, 0.0)}
    if term == "boundary":
        _, dispatch, per_byte = coef
        # crossing_cost charges 2*bytes/hbm_bw per boundary; invert the
        # fitted per-byte slope into that effective bandwidth.  A slope at or
        # below noise means the round trip is unmeasurably cheap here ->
        # effectively infinite bandwidth (overhead-bound host).
        hbm_bw = 2.0 / per_byte if per_byte > 1e-18 else 1e15
        return {"dispatch_s": max(dispatch, 0.0), "hbm_bw": hbm_bw}
    if term == "contention":
        base, slope_abs = coef
        slope = slope_abs / base if base > 0 else 0.0
        return {"band2_penalty_per_layer": max(slope, 0.0)}
    raise ValueError(f"unknown term {term!r}")


def fit_term(term: str, samples: list[Sample]) -> TermFit:
    """Fit one cost term from its sweep samples."""
    if term not in _DESIGNS:
        raise ValueError(f"unknown term {term!r}")
    rows = [s for s in samples if s.term == term]
    if len(rows) < len(_DESIGNS[term]):
        raise ValueError(f"term {term!r} needs >= {len(_DESIGNS[term])} "
                         f"samples, got {len(rows)}")
    device = term in _DEVICE_TIMED and all(
        s.device_seconds is not None for s in rows)
    coef, rel, rms = _lstsq(rows, _DESIGNS[term], [
        s.device_seconds if device else s.seconds for s in rows])
    if not math.isfinite(rel):
        raise ValueError(f"term {term!r} fit diverged (residual={rel})")
    constants = _constants_for(term, coef)
    if term == "fused_chain":
        inner = [s.regressors["inner_layers"] for s in rows]
        if coef[2] * (max(inner) - min(inner)) <= 2.0 * rms:
            del constants["fused_epilogue_s"]      # unresolved: stock stands
    source = ("model" if term in _MODELLED
              else "device" if device else "measured")
    return TermFit(term=term, constants=constants, coefficients=coef,
                   residual_rel_rms=rel, n_samples=len(rows), source=source)


def fit_all(samples: list[Sample]) -> dict[str, TermFit]:
    """Fit every term present in the sample set."""
    terms = []
    for s in samples:                      # preserve first-seen term order
        if s.term not in terms:
            terms.append(s.term)
    return {t: fit_term(t, samples) for t in terms}
