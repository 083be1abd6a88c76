"""Characterization of the card: measured machine-model artifacts.

Port of the JAX package's ``characterize`` package.  ``harness`` times the
primitives the h100 planner charges (multi-launch ``gemm_int8`` pipelines,
fused ``fused_mlp_q8`` chains, un-fused launch boundaries) as the served
engine runs them, a CUDA graph per call on the card, and reads the AIE
array's band-2 contention off the paper's model (``src=model``); ``sweeps``
parameterizes them into calibrate/quick/full grids; ``fit``
least-squares-fits each cost term; and ``model`` packages the result as a
sha256-versioned :class:`MachineModel` JSON artifact with provenance.

The planner consumes it as the card's machine model::

    mm = characterize(sweep="quick")          # or MachineModel.load(path)
    plan = plan_deployment(cfg, hw=mm.h100())
    aie_plan = plan_deployment(cfg, target="aie", machine_model=mm)
    dep = Deployment.build(["jet_tagger"], machine_model=mm)

CLI::

    PYTHONPATH=src python -m repro_torch.characterize --sweep quick --out model.json
"""

from repro_torch.characterize.fit import TermFit, fit_all, fit_term
from repro_torch.characterize.harness import Sample
from repro_torch.characterize.model import (MODEL_SCHEMA_VERSION,
                                            MachineModel, characterize)
from repro_torch.characterize.sweeps import SWEEPS, TERMS, run_sweep, run_term

__all__ = [
    "MODEL_SCHEMA_VERSION", "MachineModel", "SWEEPS", "Sample", "TERMS",
    "TermFit", "characterize", "fit_all", "fit_term", "run_sweep", "run_term",
]
