"""Block choice for the Hopper ``gemm_int8`` kernel (the DR1'/DR2' search).

The kernel (``kernels/csrc/gemm_int8.cu``) is instantiated for the tiles in
``BLOCK_M x BLOCK_K x BLOCK_N`` and takes no other: one CTA of 256 threads
owns a ``(block_m, block_n)`` output tile and steps over K in ``block_k``
chunks staged through shared memory.  :func:`plan_api` scores every legal
tile with a roofline model of this card and keeps the cheapest.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

from repro_torch import hw as hwlib

# The tiles gemm_int8.cu instantiates.  Every block_m * block_n is a multiple
# of the kernel's 256 threads and every block_k a multiple of 4 (__dp4a).
BLOCK_M = (8, 16, 32, 64)
BLOCK_K = (32, 64, 128)
BLOCK_N = (32, 64, 128)
THREADS = 256


def tile_ok(block_m: int, block_k: int, block_n: int) -> bool:
    return block_m in BLOCK_M and block_k in BLOCK_K and block_n in BLOCK_N


def smem_bytes(block_m: int, block_k: int, block_n: int) -> int:
    """Shared memory of one CTA: the x tile and the transposed w tile, whose
    rows are padded by 4 bytes against bank conflicts."""
    return block_m * block_k + block_n * (block_k + 4)


@dataclasses.dataclass(frozen=True)
class ApiPlan:
    block_m: int
    block_k: int
    block_n: int
    smem_bytes: int
    est_s: float

    @property
    def blocks(self) -> tuple[int, int, int]:
        return (self.block_m, self.block_k, self.block_n)


def plan_api(m: int, k: int, n: int, *,
             hw: hwlib.H100 = hwlib.H100_SXM) -> ApiPlan:
    """Cheapest legal tile for an (m, k, n) int8 GEMM.

    Compute is charged per wave of CTAs over the SMs, padding included; HBM
    traffic re-reads x once per N block and w once per M block.  Ties go to
    the least padded work, then to wider N blocks (DR2')."""
    per_sm_ops = hw.peak_int8_ops / hw.sms
    best: tuple | None = None
    for bm, bk, bn in itertools.product(BLOCK_M, BLOCK_K, BLOCK_N):
        r_m, r_k, r_n = math.ceil(m / bm), math.ceil(k / bk), math.ceil(n / bn)
        waves = math.ceil(r_m * r_n / hw.sms)
        t_compute = waves * 2.0 * bm * bn * r_k * bk / per_sm_ops
        traffic = m * k * r_n + k * n * r_m + 4 * m * n
        est = max(t_compute, traffic / hw.hbm_bw) + hw.kernel_overhead_s
        padded = r_m * bm * r_k * bk * r_n * bn
        score = (est, padded, -bn, -bk)
        if best is None or score < best[0]:
            best = (score, ApiPlan(bm, bk, bn, smem_bytes(bm, bk, bn), est))
    return best[1]
