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
key adds the bf16 rate itself.  So do the card's memory size and its two
link rates, NVLink within a node and the network between nodes, which only
the dry run's roofline and the spatial planner read.

The paper's two other substrates sit apart from it: :class:`AieMl` (the
VEK280 AI-Engine array) and :class:`PlFabric` (its programmable logic under
hls4ml), copies of the JAX package's models with the paper's constants.  No
plan the port makes reads them; the LARE metric (:mod:`repro_torch.core.
lare`) prices a layer against them, and the profiler's measured LARE does so
with the card's measured time.

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
import math

KiB = 1024

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
    # The dry run's roofline (launch/roofline.py) and the spatial planner
    # (core/tiling.py), datasheet, not measured: 80 GB of HBM3, NVLink 4's
    # 900 GB/s aggregate a card (the counterpart of the TPU model's
    # ``ici_bw``), and one 400 Gb/s NDR port a card to the network (its
    # ``dcn_bw``).
    hbm_bytes: int = dataclasses.field(default=80 * 10**9,
                                       metadata=_NOT_IN_PLAN_KEY)
    nvlink_bw: float = dataclasses.field(default=900e9,
                                         metadata=_NOT_IN_PLAN_KEY)
    net_bw: float = dataclasses.field(default=50e9,
                                      metadata=_NOT_IN_PLAN_KEY)


H100_SXM = H100()


# ---------------------------------------------------------------------------
# The paper's substrates, priced by LARE (never by a plan of the card)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AieMl:
    """AMD Versal VEK280 AIE-ML array model (paper Section IV-B constants)."""

    clock_hz: float = 1e9                # hardened, up to 1 GHz
    macs_per_cycle_int8: int = 256       # per compute tile
    tiles_total: int = 304               # 38 cols x 8 rows
    cols: int = 38
    rows: int = 8
    usable_cols: int = 31                # AIE4ML restriction (cols 7..37)
    local_mem_bytes: int = 64 * KiB      # per-tile data memory
    load_bw: float = 64e9                # B/s local read (2x256-bit @1GHz)
    store_bw: float = 32e9               # B/s local write (1x256-bit @1GHz)
    cascade_bits: int = 512              # west->east partial-sum bus
    stream_bits: int = 32                # per-tile in/out streaming ports
    plio_bw: float = 5e9                 # B/s (128-bit @ 312.5 MHz)
    dsp58_equiv_per_tile: float = 58.0   # paper: one tile ~ 58 DSP58s
    # Fig.-6 band-spill contention: fractional latency added per layer placed
    # in a spilled band.  A machine-model field (not a tiling-module
    # constant), as in the JAX package, whose characterization fits it.
    band2_penalty_per_layer: float = 0.085

    # Legal aie::mmul API tile shapes for i8 x i8 (paper Fig. 4 y-axis).
    legal_api_tiles_i8: tuple = (
        (4, 8, 4), (4, 8, 8), (4, 16, 4), (4, 16, 8), (8, 8, 4), (8, 8, 8),
    )

    # Empirical per-API-shape efficiency (fraction of peak MACs/cycle reached in
    # steady state), calibrated to reproduce Fig. 4's ordering: (4,8,8) and
    # (4,16,8) best; small-N shapes starve the wide accumulators.
    def api_efficiency(self, s_m: int, s_k: int, s_n: int) -> float:
        base = {
            (4, 8, 4): 0.52, (4, 8, 8): 0.95, (4, 16, 4): 0.55,
            (4, 16, 8): 0.93, (8, 8, 4): 0.60, (8, 8, 8): 0.82,
        }.get((s_m, s_k, s_n), 0.40)
        return base


@dataclasses.dataclass(frozen=True)
class PlFabric:
    """HLS4ML-on-PL spatial-dataflow model (VEK280 PL side, paper Section III).

    A dense layer (n_in, n_out) with reuse factor rf:
      * uses  ceil(n_in*n_out / rf) multipliers (DSP58s),
      * has initiation interval II ~= rf cycles (plus fixed pipeline depth),
      * stores all weights on-chip (BRAM under the Resource strategy, LUT/FF
        under the Latency strategy).
    """

    clock_hz: float = 312.5e6            # PL clock used in the paper
    dsp_total: int = 1312                # approximate VEK280 PL DSP58 budget
    lut_total: int = 900_000             # approximate; configurable
    bram_bits_total: int = 967 * 36 * 1024  # approximate 36kb BRAM blocks
    pipeline_depth: int = 12             # fixed pipeline fill latency (cycles)
    # The Latency strategy burns ~alpha LUTs per weight bit instead of BRAM.
    latency_strategy_lut_per_weight_bit: float = 1.1

    def legal_reuse_factors(self, n_in: int, n_out: int) -> list[int]:
        """HLS4ML legal rf values: divisors of n_in*n_out (capped)."""
        total = n_in * n_out
        rfs = [d for d in range(1, min(total, 4096) + 1) if total % d == 0]
        return rfs

    def dsps(self, n_in: int, n_out: int, rf: int) -> int:
        return math.ceil(n_in * n_out / rf)

    def interval_cycles(self, rf: int) -> int:
        return max(1, rf)

    def latency_s(self, n_in: int, n_out: int, rf: int, batch: int = 8) -> float:
        # Streaming batch through a pipelined datapath: fill + (batch-1)*II.
        cycles = self.pipeline_depth + math.ceil(math.log2(max(2, n_in))) \
            + (batch - 1) * self.interval_cycles(rf) + self.interval_cycles(rf)
        return cycles / self.clock_hz

    def interval_s(self, rf: int) -> float:
        return self.interval_cycles(rf) / self.clock_hz

    def resources(self, n_in: int, n_out: int, rf: int, *,
                  strategy: str = "resource", weight_bits: int = 8) -> dict:
        """Resource vector for one dense layer at a given reuse factor."""
        dsp = self.dsps(n_in, n_out, rf)
        w_bits = n_in * n_out * weight_bits
        if strategy == "latency":
            lut = int(w_bits * self.latency_strategy_lut_per_weight_bit) + 40 * dsp
            bram_bits = 0
        else:
            lut = 28 * dsp
            bram_bits = w_bits if rf > 1 else 0  # rf=1 keeps weights in fabric
        return {"dsp": dsp, "lut": lut, "bram_bits": bram_bits}

    def fits(self, res: dict) -> bool:
        return (res["dsp"] <= self.dsp_total and res["lut"] <= self.lut_total
                and res["bram_bits"] <= self.bram_bits_total)

    def resource_scalar(self, res: dict) -> float:
        """Single-number resource consumption: DSP-equivalents (paper's x-axis).

        LUT and BRAM contributions are folded in as fractional DSP-equivalents
        by budget share, so one scalar spans the three PL resource types.
        """
        return (res["dsp"]
                + res["lut"] / self.lut_total * self.dsp_total * 0.25
                + res["bram_bits"] / self.bram_bits_total * self.dsp_total * 0.25)


AIE_ML = AieMl()
PL_FABRIC = PlFabric()
