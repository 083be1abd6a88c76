"""Block choice for the Hopper GEMM kernels (the DR1'/DR2' search).

Two tile sets, one per kernel family, each instantiated by its kernels and
no other tile taken:

* ``gemm_int8`` (``kernels/csrc/gemm_int8.cu``): ``BLOCK_M x BLOCK_K x
  BLOCK_N``, chosen by :func:`plan_api`.  The edge plans' tiles.
* ``tiled_gemm`` and ``fused_dense`` (``kernels/csrc/gemm_tile.cuh``):
  ``TILED_BLOCK_M x TILED_BLOCK_K x TILED_BLOCK_N`` over int8, f32 and bf16
  operands, chosen by :func:`plan_tiled` for the operand size, as the JAX
  package's ``plan_api(m, k, n, itemsize=...)`` chooses.

In both, one CTA of 256 threads owns a ``(block_m, block_n)`` output tile
and steps over K in ``block_k`` chunks staged through shared memory.  Both
planners are one search (:func:`_search`) that scores every tile of the set
with a roofline model of this card and keeps the cheapest; it is memoised,
since the kernel wrappers plan on every call.
"""

from __future__ import annotations

import dataclasses
import functools
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


# The tiles gemm_tile.cuh instantiates (GEMM_TILE_FOR_ALL).  Warps own rows,
# lanes own columns, so block_m is a multiple of the 8 warps and block_n of
# the 32 lanes; block_k is a multiple of 4 (__dp4a).
TILED_BLOCK_M = (8, 16, 32, 64)
TILED_BLOCK_K = (16, 32, 64)
TILED_BLOCK_N = (32, 64, 128)


def tiled_tile_ok(block_m: int, block_k: int, block_n: int) -> bool:
    return (block_m in TILED_BLOCK_M and block_k in TILED_BLOCK_K
            and block_n in TILED_BLOCK_N)


def tiled_smem_bytes(block_m: int, block_k: int, block_n: int,
                     itemsize: int) -> int:
    """Shared memory of one ``tiled_gemm``/``fused_dense`` CTA: int8 tiles
    as in :func:`smem_bytes`; f32 and bf16 tiles are staged as f32."""
    if itemsize == 1:
        return smem_bytes(block_m, block_k, block_n)
    return 4 * (block_m * block_k + block_k * block_n)


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


@functools.lru_cache(maxsize=4096)
def _search(m: int, k: int, n: int, tiles: tuple, itemsize: int,
            ops_per_s: float, hw: hwlib.H100) -> ApiPlan:
    """Cheapest of ``tiles`` (block_m, block_k, block_n options) for an
    (m, k, n) GEMM with ``itemsize``-byte operands at ``ops_per_s``.

    Compute is charged per wave of CTAs over the SMs, padding included; HBM
    traffic re-reads x once per N block and w once per M block, and writes a
    4-byte output.  Ties go to the least padded work, then to wider N blocks
    (DR2')."""
    per_sm_ops = ops_per_s / hw.sms
    best: tuple | None = None
    for bm, bk, bn in itertools.product(*tiles):
        r_m, r_k, r_n = math.ceil(m / bm), math.ceil(k / bk), math.ceil(n / bn)
        waves = math.ceil(r_m * r_n / hw.sms)
        t_compute = waves * 2.0 * bm * bn * r_k * bk / per_sm_ops
        traffic = itemsize * (m * k * r_n + k * n * r_m) + 4 * m * n
        est = max(t_compute, traffic / hw.hbm_bw) + hw.kernel_overhead_s
        padded = r_m * bm * r_k * bk * r_n * bn
        score = (est, padded, -bn, -bk)
        if best is None or score < best[0]:
            best = (score, ApiPlan(bm, bk, bn,
                                   tiled_smem_bytes(bm, bk, bn, itemsize),
                                   est))
    return best[1]


def plan_api(m: int, k: int, n: int, *,
             hw: hwlib.H100 = hwlib.H100_SXM) -> ApiPlan:
    """Cheapest ``gemm_int8`` tile for an (m, k, n) int8 GEMM, charged at
    ``hw.peak_int8_ops``."""
    return _search(m, k, n, (BLOCK_M, BLOCK_K, BLOCK_N), 1,
                   hw.peak_int8_ops, hw)


def plan_tiled(m: int, k: int, n: int, *, itemsize: int = 2,
               hw: hwlib.H100 = hwlib.H100_SXM) -> ApiPlan:
    """Cheapest tile for an (m, k, n) ``tiled_gemm`` or ``fused_dense`` with
    ``itemsize``-byte operands (1 int8, 2 bf16, 4 f32), charged at the rate
    of the instructions the kernel issues: ``hw.dp4a_ops`` for int8,
    ``hw.f32_fma_ops`` for f32 and bf16 (widened to f32)."""
    rates = {1: hw.dp4a_ops, 2: hw.f32_fma_ops, 4: hw.f32_fma_ops}
    if itemsize not in rates:
        raise ValueError(f"no tiled_gemm tiles for {itemsize}-byte operands")
    return _search(m, k, n, (TILED_BLOCK_M, TILED_BLOCK_K, TILED_BLOCK_N),
                   itemsize, rates[itemsize], hw)
