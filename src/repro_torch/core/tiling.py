"""Block choice for the Hopper GEMM kernels (the DR1'/DR2' search).

Three tile sets, each instantiated by its kernels and no other tile taken:

* ``gemm_int8`` (``kernels/csrc/gemm_int8.cu``): ``BLOCK_M x BLOCK_K x
  BLOCK_N``, chosen by :func:`plan_api`.  The edge plans' tiles.  One CTA
  of 256 threads owns a ``(block_m, block_n)`` output tile and steps over K
  in ``block_k`` chunks through a three-stage ring in shared memory, with
  the products on the int8 tensor cores (``mma.sync``).
* ``fused_dense`` and f32 ``tiled_gemm`` (``kernels/csrc/gemm_tile.cuh``,
  CUDA cores): ``TILED_BLOCK_M x TILED_BLOCK_K x TILED_BLOCK_N``, the same
  shape of CTA, chosen by :func:`plan_dense`.
* bf16 and int8 ``tiled_gemm`` (``kernels/csrc/tiled_gemm.cu``, tensor
  cores): ``TC_BLOCK_M x TC_BLOCK_N`` with a ``block_k`` of 128 bytes, one
  consumer warpgroup per 64 rows fed by a ``TC_STAGES``-deep ring, chosen
  by :func:`plan_tiled` for the operand size, as the JAX package's
  ``plan_api(m, k, n, itemsize=...)`` chooses.

The planners are one search (:func:`_search`) that scores every tile of a
set with a roofline model of this card and keeps the cheapest; it is
memoised, since the kernel wrappers plan on every call.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math

from repro_torch import hw as hwlib

# The tiles gemm_int8.cu instantiates.  Every block_m is a multiple of 8 and
# every block_n of 16 (the int8 mma.sync's n and m sides: the kernel
# computes the transposed tile) and every block_k of 32 (its k).
BLOCK_M = (8, 16, 32, 64)
BLOCK_K = (32, 64, 128)
BLOCK_N = (32, 64, 128)
STAGES = 3            # gemm_int8.cu's ring of x and w tiles
SKEW = 16             # bytes added to each tile row against bank conflicts


def tile_ok(block_m: int, block_k: int, block_n: int) -> bool:
    return block_m in BLOCK_M and block_k in BLOCK_K and block_n in BLOCK_N


def smem_bytes(block_m: int, block_k: int, block_n: int) -> int:
    """Shared memory of one CTA, as the kernel launches it: ``STAGES`` x
    tiles and transposed w tiles, every row padded by ``SKEW`` bytes."""
    return STAGES * (block_m + block_n) * (block_k + SKEW)


# The tiles gemm_tile.cuh instantiates (GEMM_TILE_FOR_ALL).  Warps own rows,
# lanes own columns, so block_m is a multiple of the 8 warps and block_n of
# the 32 lanes.
TILED_BLOCK_M = (8, 16, 32, 64)
TILED_BLOCK_K = (16, 32, 64)
TILED_BLOCK_N = (32, 64, 128)


def dense_tile_ok(block_m: int, block_k: int, block_n: int) -> bool:
    """A tile of the CUDA-core set (``fused_dense``, f32 ``tiled_gemm``)."""
    return (block_m in TILED_BLOCK_M and block_k in TILED_BLOCK_K
            and block_n in TILED_BLOCK_N)


def dense_smem_bytes(block_m: int, block_k: int, block_n: int) -> int:
    """Shared memory of one CUDA-core CTA: f32 and bf16 tiles are staged as
    f32."""
    return 4 * (block_m * block_k + block_k * block_n)


# The tiles tiled_gemm.cu's tensor-core kernel instantiates for bf16 and
# int8: one consumer warpgroup per 64 rows, wgmma widths up to 256, and
# block_k = 128 bytes, one 128-byte swizzled row per operand row.
TC_BLOCK_M = (64, 128)
TC_BLOCK_N = (64, 128, 256)
TC_ROW_BYTES = 128
TC_STAGES = 4
_TC_SMEM_EXTRA = 1024 + 2 * TC_STAGES * 8   # alignment slack, mbarriers


def tc_block_k(itemsize: int) -> int:
    """The tensor-core kernel's block_k for ``itemsize``-byte operands."""
    return TC_ROW_BYTES // itemsize


def tiled_tile_ok(block_m: int, block_k: int, block_n: int,
                  itemsize: int) -> bool:
    """A tile ``tiled_gemm`` takes for ``itemsize``-byte operands: the
    tensor-core set for int8 and bf16, the CUDA-core set for f32."""
    if itemsize == 4:
        return dense_tile_ok(block_m, block_k, block_n)
    return (itemsize in (1, 2) and block_m in TC_BLOCK_M
            and block_n in TC_BLOCK_N and block_k == tc_block_k(itemsize))


def tiled_smem_bytes(block_m: int, block_k: int, block_n: int,
                     itemsize: int) -> int:
    """Shared memory of one ``tiled_gemm`` CTA: the tensor-core kernel's
    ring of ``TC_STAGES`` x and w tiles plus its barriers and alignment
    slack for int8 and bf16; the CUDA-core tiles for f32."""
    if itemsize == 4:
        return dense_smem_bytes(block_m, block_k, block_n)
    return (TC_STAGES * (block_m * block_k + block_k * block_n) * itemsize
            + _TC_SMEM_EXTRA)


# One function object per operand size, so the memoised search sees the
# same argument on every call.
_TC_SMEM = {size: functools.partial(tiled_smem_bytes, itemsize=size)
            for size in (1, 2)}


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
            ops_per_s: float, hw: hwlib.H100, smem, *, out_bytes: int = 4,
            rereads: bool = True) -> ApiPlan:
    """Cheapest of ``tiles`` (block_m, block_k, block_n options) for an
    (m, k, n) GEMM with ``itemsize``-byte operands at ``ops_per_s``;
    ``smem(bm, bk, bn)`` is a CTA's shared memory.

    Compute is charged per wave of CTAs over the SMs, padding included.  HBM
    traffic writes an ``out_bytes`` output and reads each operand once, or,
    with ``rereads``, x once per N block and w once per M block.  Ties go to
    the least padded work, then to wider N blocks (DR2')."""
    per_sm_ops = ops_per_s / hw.sms
    best: tuple | None = None
    for bm, bk, bn in itertools.product(*tiles):
        r_m, r_k, r_n = math.ceil(m / bm), math.ceil(k / bk), math.ceil(n / bn)
        waves = math.ceil(r_m * r_n / hw.sms)
        t_compute = waves * 2.0 * bm * bn * r_k * bk / per_sm_ops
        reads = m * k * r_n + k * n * r_m if rereads else m * k + k * n
        traffic = itemsize * reads + out_bytes * m * n
        est = max(t_compute, traffic / hw.hbm_bw) + hw.kernel_overhead_s
        padded = r_m * bm * r_k * bk * r_n * bn
        score = (est, padded, -bn, -bk)
        if best is None or score < best[0]:
            best = (score, ApiPlan(bm, bk, bn, smem(bm, bk, bn), est))
    return best[1]


def plan_api(m: int, k: int, n: int, *,
             hw: hwlib.H100 = hwlib.H100_SXM) -> ApiPlan:
    """Cheapest ``gemm_int8`` tile for an (m, k, n) int8 GEMM, charged at
    ``hw.peak_int8_ops``."""
    return _search(m, k, n, (BLOCK_M, BLOCK_K, BLOCK_N), 1,
                   hw.peak_int8_ops, hw, smem_bytes)


def plan_dense(m: int, k: int, n: int, *, itemsize: int = 4,
               hw: hwlib.H100 = hwlib.H100_SXM) -> ApiPlan:
    """Cheapest CUDA-core tile for an (m, k, n) ``fused_dense`` (f32 or
    bf16 operands, widened to f32) or f32 ``tiled_gemm``, charged at
    ``hw.f32_fma_ops``."""
    if itemsize not in (2, 4):
        raise ValueError(f"no fused_dense tiles for {itemsize}-byte operands")
    return _search(m, k, n, (TILED_BLOCK_M, TILED_BLOCK_K, TILED_BLOCK_N),
                   itemsize, hw.f32_fma_ops, hw, dense_smem_bytes)


def plan_tiled(m: int, k: int, n: int, *, itemsize: int = 2,
               hw: hwlib.H100 = hwlib.H100_SXM) -> ApiPlan:
    """Cheapest ``tiled_gemm`` tile for an (m, k, n) GEMM with
    ``itemsize``-byte operands (1 int8, 2 bf16, 4 f32), charged at the rate
    of the units the kernel runs on: the tensor cores for int8
    (``hw.peak_int8_ops``) and bf16 (``hw.peak_bf16_ops``), the CUDA cores
    for f32 (:func:`plan_dense`).  The tensor-core kernel's re-reads of x
    and w are charged to the 50 MB L2, not to HBM: each operand is read
    from HBM once."""
    if itemsize == 4:
        return plan_dense(m, k, n, itemsize=4, hw=hw)
    rates = {1: hw.peak_int8_ops, 2: hw.peak_bf16_ops}
    if itemsize not in rates:
        raise ValueError(f"no tiled_gemm tiles for {itemsize}-byte operands")
    return _search(m, k, n, (TC_BLOCK_M, (tc_block_k(itemsize),), TC_BLOCK_N),
                   itemsize, rates[itemsize], hw, _TC_SMEM[itemsize],
                   out_bytes=4 if itemsize == 1 else 2, rereads=False)
