"""MachineModel: the versioned, serializable characterization artifact.

Port of the JAX package's ``characterize/model.py``.  A ``MachineModel``
holds the fitted cost terms (:class:`repro_torch.characterize.fit.TermFit`)
plus provenance (host, torch and CUDA versions, the card's name and power
limit, sweep grids).  Its ``version`` is a sha256 over the SEMANTIC content
(schema + fitted constants), hashed as the reference hashes it, so two runs
that fit the same constants agree on version and any constant change
produces a new one.

Consumers never read the fits directly; they ask for the re-parameterized
machine model of the card::

    mm = characterize(sweep="quick")
    plan = plan_deployment(cfg, hw=mm.h100())
    aie_plan = plan_deployment(cfg, target="aie", machine_model=mm)

whose fitted constants enter every plan key (``plan/artifact.py``), so
plans made under another model never answer for this one.  ``h100()``
carries the card's terms and ``aie()`` the AIE array's band-2 slope
(``contention``); neither reads the other's, so a fitted slope moves no
h100 plan.

JSON schema (``MODEL_SCHEMA_VERSION``)::

    {"schema": 1, "version": "<sha256>",
     "fits": {"gemm_int8": {"constants": {...}, "residual_rel_rms": ...},
              ...},
     "provenance": {"host": ..., "torch": ..., "cuda": ..., "card": ...,
                    "power_limit": ..., "sweep": ..., "grids": {...}}}
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import platform
import subprocess

import torch

from repro_torch import hw as hwlib
from repro_torch.characterize import fit as fitlib
from repro_torch.characterize import sweeps as sweeplib
from repro_torch.characterize.fit import TermFit
from repro_torch.device import resolve_device

MODEL_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Fitted machine-model artifact: cost-term fits + provenance."""
    fits: dict                     # term -> TermFit
    provenance: dict
    schema: int = MODEL_SCHEMA_VERSION

    # -- identity ---------------------------------------------------------
    @property
    def version(self) -> str:
        """sha256 over schema + the fitted CONSTANTS, the only part of a
        fit the planner reads: not provenance, not residuals, not raw
        coefficients.  Two characterization runs that land on the same
        clamped constants agree on version, and any constant change
        produces a new one."""
        payload = {"schema": self.schema,
                   "fits": {t: dict(f.constants) for t, f in
                            sorted(self.fits.items())}}
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    def constant(self, term: str, name: str, default=None):
        f = self.fits.get(term)
        if f is None:
            return default
        return f.constants.get(name, default)

    def residuals(self) -> dict:
        return {t: f.residual_rel_rms for t, f in self.fits.items()}

    # -- machine-model substitution ---------------------------------------
    def h100(self, base: hwlib.H100 = hwlib.H100_SXM) -> hwlib.H100:
        """``base`` with every fitted constant substituted: the launch cost
        and int8 rate (``gemm_int8``), the fused boundary
        (``fused_chain``) and the device-memory rate (``boundary``)."""
        kw = {}
        for term, name in (("gemm_int8", "kernel_overhead_s"),
                           ("gemm_int8", "peak_int8_ops"),
                           ("fused_chain", "fused_epilogue_s"),
                           ("boundary", "hbm_bw")):
            value = self.constant(term, name)
            if value is not None:
                kw[name] = value
        return dataclasses.replace(base, **kw) if kw else base

    def aie(self, base: hwlib.AieMl = hwlib.AIE_ML) -> hwlib.AieMl:
        """``base`` with every AIE-side fitted constant substituted (the
        band-2 slope of ``contention``)."""
        slope = self.constant("contention", "band2_penalty_per_layer")
        if slope is None:
            return base
        return dataclasses.replace(base, band2_penalty_per_layer=slope)

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema": self.schema, "version": self.version,
                "fits": {t: f.to_dict() for t, f in self.fits.items()},
                "provenance": dict(self.provenance)}

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "MachineModel":
        if d.get("schema") != MODEL_SCHEMA_VERSION:
            raise ValueError(f"unsupported machine-model schema: "
                             f"{d.get('schema')!r}")
        mm = cls(fits={t: TermFit.from_dict(f) for t, f in d["fits"].items()},
                 provenance=dict(d.get("provenance", {})))
        want = d.get("version")
        if want is not None and want != mm.version:
            raise ValueError(
                f"machine-model version mismatch: artifact says "
                f"{want[:12]}..., content hashes to {mm.version[:12]}... "
                f"(artifact edited by hand?)")
        return mm

    @classmethod
    def from_json(cls, s: str) -> "MachineModel":
        return cls.from_dict(json.loads(s))

    def save(self, path: str | os.PathLike) -> pathlib.Path:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json() + "\n")
        return p

    @classmethod
    def load(cls, path: str | os.PathLike) -> "MachineModel":
        return cls.from_json(pathlib.Path(path).read_text())


def card_identity(device: torch.device | None) -> dict:
    """What a fit describes besides its constants: the host, the torch and
    CUDA builds, and on the card its name and power limit (as ``nvidia-smi``
    reports them; None where it cannot say)."""
    out = {"host": platform.node(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "card": None, "power_limit": None}
    if device is not None and device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
        try:
            line = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader", f"--id={device.index or 0}"],
                capture_output=True, text=True, timeout=30,
                check=True).stdout.strip()
            out["power_limit"] = line or None
        except (OSError, subprocess.SubprocessError):
            pass
    return out


def _provenance(sweep: str, batch: int, iters: int, terms,
                device: torch.device | None) -> dict:
    return {
        **card_identity(device),
        "machine": platform.machine(),
        "python": platform.python_version(),
        "device": None if device is None else str(device),
        "sweep": sweep,
        "batch": batch,
        "iters": iters,
        "grids": {t: [list(g) if isinstance(g, tuple) else g
                      for g in sweeplib.grid(t, sweep)] for t in terms},
    }


def characterize(*, sweep: str = "quick", batch: int = 8, iters: int = 51,
                 terms=sweeplib.TERMS, timer=None, device=None, aie=None,
                 tracer=None) -> MachineModel:
    """Run the characterization sweeps on ``device`` (``None``: the card,
    raising when there is none) and fit the machine model.

    ``timer`` replaces measurement with a synthetic cost function (tests,
    dry runs; no device is touched); ``terms`` restricts the sweep (e.g.
    only ``("gemm_int8",)``); ``aie`` is the AIE model the ``contention``
    points read; ``tracer`` (a :class:`repro_torch.obs.Tracer`)
    records one span per term sweep.
    """
    if timer is None:
        device = resolve_device(device)
    samples = sweeplib.run_sweep(sweep=sweep, batch=batch, iters=iters,
                                 terms=terms, timer=timer, device=device,
                                 aie=aie, tracer=tracer)
    fits = fitlib.fit_all(samples)
    prov = _provenance(sweep, batch, iters, terms,
                       None if timer is not None else device)
    if timer is not None:
        prov["timer"] = "synthetic"
    else:
        prov["samples"] = [s.to_dict() for s in samples]
    return MachineModel(fits=fits, provenance=prov)
