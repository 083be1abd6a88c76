"""Machine model of the port's target card, an NVIDIA H100 SXM.

The fusion DP (``core/boundary.py``) and the tile planner
(``core/tiling.py``) read it under the same attribute names the JAX
package's TPU model carries: ``hbm_bw``, ``kernel_overhead_s`` and
``fused_epilogue_s``.  ``smem_bytes`` (shared memory one block may use)
plays the role the TPU model's VMEM size plays.  ``peak_bf16_ops`` (the
tensor cores, which bf16 ``tiled_gemm`` and an LM's bf16 GEMMs run on) and
``f32_fma_ops`` (the CUDA cores, which f32 ``tiled_gemm`` and
``fused_dense`` run on) are read only by their tile planners and the LM
planner, and ``dram_round_trip_s`` (one round trip to device memory, which
``fused_dense``'s planner charges per K stage) only by that planner, so
they stay out of the edge plans' keys (``plan_key: False``); an LM plan's
key adds the bf16 rate itself.

Rates and sizes are the H100 SXM datasheet's (not measured on a card).  The
two launch-cost terms are the stock values that plans made with
``machine_model="stock"`` use; they are not measured.  A characterization
(:mod:`repro_torch.characterize`) fits them, with the int8 rate and the
memory rate, on the card as the served engine runs, and its
``MachineModel.h100()`` (or ``Deployment.build``'s default ``"auto"``
calibration) replaces them.
"""

from __future__ import annotations

import dataclasses

# Rates no edge plan reads: ``plan/artifact.py`` leaves them out of the key.
_NOT_IN_PLAN_KEY = {"plan_key": False}


@dataclasses.dataclass(frozen=True)
class H100:
    # H100 SXM datasheet, not measured.
    sms: int = 132
    hbm_bw: float = 3.35e12              # B/s
    peak_int8_ops: float = 1979e12       # OP/s, dense int8 tensor cores
    smem_bytes: int = 232_448            # dynamic shared memory per block
    # Stock values, not measured (a characterization replaces them): the
    # fixed host-to-card cost of one kernel launch, and the cost of one
    # layer boundary kept inside the fused kernel (requantize through shared
    # memory instead of a new launch).
    kernel_overhead_s: float = 4e-6
    fused_epilogue_s: float = 3e-7
    # Dense bf16 on the tensor cores, and f32 FMAs on the CUDA cores (128
    # lanes per SM per clock), both the datasheet's, not measured.
    peak_bf16_ops: float = dataclasses.field(default=989e12,
                                             metadata=_NOT_IN_PLAN_KEY)
    f32_fma_ops: float = dataclasses.field(default=67e12,
                                           metadata=_NOT_IN_PLAN_KEY)
    # Placeholder, not measured: one dependent round trip from an SM to
    # device memory and back.
    dram_round_trip_s: float = dataclasses.field(default=6e-7,
                                                 metadata=_NOT_IN_PLAN_KEY)


H100_SXM = H100()

