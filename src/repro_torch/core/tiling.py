"""Block choice for the Hopper GEMM kernels (the DR1'/DR2' search).

Three tile sets, each instantiated by its kernels and no other tile taken:

* ``gemm_int8`` (``kernels/csrc/gemm_int8.cu``): ``BLOCK_M x BLOCK_K x
  BLOCK_N``, chosen by :func:`plan_api`.  The edge plans' tiles.  One CTA
  of 256 threads owns a ``(block_m, block_n)`` output tile and steps over K
  in ``block_k`` chunks through a three-stage ring in shared memory, with
  the products on the int8 tensor cores (``mma.sync``).
* f32 ``tiled_gemm`` (``kernels/csrc/gemm_tile.cuh``, CUDA cores):
  ``TILED_BLOCK_M x TILED_BLOCK_K x TILED_BLOCK_N``, the same shape of
  CTA, chosen by :func:`plan_dense`.
* ``fused_dense`` (``kernels/csrc/fused_dense.cu``, CUDA cores):
  ``FD_BLOCK_M x FD_BLOCK_K x FD_BLOCK_N``, chosen by
  :func:`plan_fused_dense`.  One CTA of ``FD_WARPS`` warps owns a
  ``(block_m, block_n)`` output strip and stages its whole K strip of x
  and w in shared memory by asynchronous copies issued at entry, or, where
  K passes ``block_k``, a ring of two ``block_k`` chunks; the warps split
  K and reduce their partial sums through shared memory.
* bf16 and int8 ``tiled_gemm`` (``kernels/csrc/tiled_gemm.cu``, tensor
  cores): ``TC_BLOCK_M x TC_BLOCK_N`` with a ``block_k`` of 128 bytes, one
  consumer warpgroup per 64 rows fed by a ``TC_STAGES``-deep ring, chosen
  by :func:`plan_tiled` for the operand size, as the JAX package's
  ``plan_api(m, k, n, itemsize=...)`` chooses.

The GEMM planners are one search (:func:`_search`) that scores every tile
of a set with a roofline model of this card and keeps the cheapest;
:func:`plan_fused_dense` adds to that model a device-memory round trip per
K stage.  All are memoised, since the kernel wrappers plan on every
call.

:func:`plan_spatial` and :func:`plan_gemm` split one GEMM over several
cards (the JAX package's spatial level, a card for a TPU core), priced with
:func:`collective_time` on the card's NVLink and network rates; the
pipelined-spatial regime of :func:`repro_torch.core.lare.lare_spatial`
reads them.  No plan the port serves reads them.

The paper's own model of the AI-Engine array closes the module, the JAX
package's copy, framework-free: one tile (:func:`aie_tile_latency`,
:func:`aie_tile_interval`, :func:`aie_best_single_tile`), which
:func:`repro_torch.core.lare.lare` reads for its default AIE interval, and a
layer spread over ``P_K x P_N`` tiles (:func:`aie_spatial_latency`,
:func:`aie_spatial_interval`, with the Fig.-6 band-spill contention, and
:func:`aie_optimized_interval`), which the ``"aie"`` target of the planner
reads.  No plan of the card reads them.
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


# The tiles gemm_tile.cuh instantiates (GEMM_TILE_FOR_ALL) for f32
# tiled_gemm.  Warps own rows, lanes own columns, so block_m is a multiple of
# the 8 warps and block_n of the 32 lanes.
TILED_BLOCK_M = (8, 16, 32, 64)
TILED_BLOCK_K = (16, 32, 64)
TILED_BLOCK_N = (32, 64, 128)


def dense_tile_ok(block_m: int, block_k: int, block_n: int) -> bool:
    """A tile of f32 ``tiled_gemm``'s CUDA-core set."""
    return (block_m in TILED_BLOCK_M and block_k in TILED_BLOCK_K
            and block_n in TILED_BLOCK_N)


def dense_smem_bytes(block_m: int, block_k: int, block_n: int) -> int:
    """Shared memory of one f32 ``tiled_gemm`` CUDA-core CTA."""
    return 4 * (block_m * block_k + block_k * block_n)


# The tiles fused_dense.cu instantiates (FD_FOR_ALL): block_m x block_n
# output strips of at most 512 outputs (16 a lane), instantiated per
# (block_m, block_n); block_k is the K chunk of one stage, a run-time value,
# a multiple of 16 so every chunk starts on a 16-byte boundary in both
# dtypes.
FD_BLOCK_M = (8, 16)
FD_BLOCK_K = (16, 32, 64, 128, 256, 512, 1024, 2048)
FD_BLOCK_N = (8, 16, 32, 64)
FD_MAX_OUTPUTS = 512
FD_WARPS = 8          # fused_dense.cu's kWarps: the split of K


def fused_dense_tile_ok(block_m: int, block_k: int, block_n: int) -> bool:
    """A tile of ``fused_dense``'s set."""
    return (block_m in FD_BLOCK_M and block_k in FD_BLOCK_K
            and block_n in FD_BLOCK_N
            and block_m * block_n <= FD_MAX_OUTPUTS)


def fused_dense_stages(k: int, block_k: int) -> int:
    """K stages of one ``fused_dense`` CTA: device-memory round trips."""
    return -(-k // block_k)


def fused_dense_smem_bytes(block_m: int, block_k: int, block_n: int, k: int,
                           itemsize: int) -> int:
    """Shared memory of one ``fused_dense`` CTA at depth ``k``, as
    ``fused_dense.cu``'s ``layout()`` computes it (the launch is refused
    otherwise): one buffer of a chunk of ``min(k, block_k)`` K values, two
    when K takes more than one chunk, plus the warps' partial sums (f32).
    A chunk holds the x rows, each padded to an odd number of 16-byte
    units (a warp's two row groups then read distinct banks), and the w
    rows of the chunk rounded up to 4, ``block_n`` wide."""
    chunk = min(k, block_k)
    x_row = -(-chunk * itemsize // 16) * 16
    if x_row // 16 % 2 == 0:
        x_row += 16
    stage = block_m * x_row + -(-chunk // 4) * 4 * block_n * itemsize
    buffers = 1 if k <= block_k else 2
    return buffers * stage + FD_WARPS * block_m * block_n * 4


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


def plan_dense(m: int, k: int, n: int, *,
               hw: hwlib.H100 = hwlib.H100_SXM) -> ApiPlan:
    """Cheapest CUDA-core tile for an (m, k, n) f32 ``tiled_gemm``, charged
    at ``hw.f32_fma_ops``."""
    return _search(m, k, n, (TILED_BLOCK_M, TILED_BLOCK_K, TILED_BLOCK_N),
                   4, hw.f32_fma_ops, hw, dense_smem_bytes)


@functools.lru_cache(maxsize=4096)
def plan_fused_dense(m: int, k: int, n: int, *, itemsize: int = 4,
                     hw: hwlib.H100 = hwlib.H100_SXM) -> ApiPlan:
    """Cheapest ``fused_dense`` tile for an (m, k, n) layer with f32 or
    bf16 operands: the launch, a device-memory round trip
    (``hw.dram_round_trip_s``) per K stage, then the larger of the CTAs'
    f32 FMAs (waves over the SMs, the K padding included) and the HBM
    traffic (x once per N strip, w once per M strip).  A tile whose shared
    memory passes ``hw.smem_bytes`` is never taken.  A round trip outweighs
    what a narrower strip saves at the widths the port runs, so the plan
    makes the fewest K stages that budget allows; ties go to the smaller
    ``block_k``."""
    if itemsize not in (2, 4):
        raise ValueError(f"no fused_dense tiles for {itemsize}-byte operands")
    per_sm_ops = hw.f32_fma_ops / hw.sms
    best: tuple | None = None
    for bm, bk, bn in itertools.product(FD_BLOCK_M, FD_BLOCK_K, FD_BLOCK_N):
        smem = fused_dense_smem_bytes(bm, bk, bn, k, itemsize)
        if not fused_dense_tile_ok(bm, bk, bn) or smem > hw.smem_bytes:
            continue
        r_m, r_n = math.ceil(m / bm), math.ceil(n / bn)
        stages = fused_dense_stages(k, bk)
        waves = math.ceil(r_m * r_n / hw.sms)
        t_compute = waves * 2.0 * bm * bn * (-(-k // 4) * 4) / per_sm_ops
        traffic = itemsize * (m * k * r_n + k * n * r_m) + 4 * m * n
        est = (hw.kernel_overhead_s + stages * hw.dram_round_trip_s
               + max(t_compute, traffic / hw.hbm_bw))
        score = (est, stages, bk, -bn)
        if best is None or score < best[0]:
            best = (score, ApiPlan(bm, bk, bn, smem, est))
    if best is None:
        raise ValueError(f"fused_dense: no tile fits ({m}, {k}, {n}) in "
                         f"{hw.smem_bytes} bytes of shared memory")
    return best[1]


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
        return plan_dense(m, k, n, hw=hw)
    rates = {1: hw.peak_int8_ops, 2: hw.peak_bf16_ops}
    if itemsize not in rates:
        raise ValueError(f"no tiled_gemm tiles for {itemsize}-byte operands")
    return _search(m, k, n, (TC_BLOCK_M, (tc_block_k(itemsize),), TC_BLOCK_N),
                   itemsize, rates[itemsize], hw, _TC_SMEM[itemsize],
                   out_bytes=4 if itemsize == 1 else 2, rereads=False)


# --------------------------------------------------------------------------
# The spatial level: a GEMM split over cards (DR3', DR5', DR6')
# --------------------------------------------------------------------------

# Cards one NVLink switch joins (an HGX H100 node): a reduction over at most
# this many runs on NVLink, a larger one crosses the network.
NVLINK_RANKS = 8


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """Across-card tiling: the split factors of K and N."""
    p_k: int
    p_n: int
    q_k: int                      # per-card K extent
    q_n: int                      # per-card N extent
    bands: int                    # 1: the K group fits the fast axis (DR6')
    est_collective_s: float

    @property
    def tiles(self) -> int:
        return self.p_k * self.p_n


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    m: int
    k: int
    n: int
    itemsize: int
    spatial: SpatialPlan
    api: ApiPlan
    est_s: float
    rules: tuple[str, ...]        # which design rules drove the decision


def collective_time(bytes_per_device: float, group: int, *, axis_bw: float,
                    kind: str = "reduce_scatter") -> float:
    """Ring-collective time over a ``group`` of cards at ``axis_bw``."""
    if group <= 1 or bytes_per_device <= 0:
        return 0.0
    steps = group - 1
    if kind == "all_reduce":
        vol = 2.0 * bytes_per_device * steps / group
    elif kind in ("reduce_scatter", "all_gather", "all_to_all"):
        vol = bytes_per_device * steps / group
    else:
        raise ValueError(kind)
    return vol / axis_bw


def _divisors_leq(x: int, cap: int) -> list[int]:
    return [d for d in range(1, min(x, cap) + 1) if x % d == 0]


def plan_spatial(m: int, k: int, n: int, *, itemsize: int = 1,
                 axis_sizes=(NVLINK_RANKS,),
                 hw: hwlib.H100 = hwlib.H100_SXM,
                 q_k_floor: int = 512, q_n_floor: int = 512,
                 max_tiles: int | None = None) -> SpatialPlan:
    """Pick (P_K, P_N) over the cards, the JAX package's rules with a card
    for a core: each split runs :func:`plan_api` on its (m, q_k, q_n)
    block, and the K group reduces its f32 partial sums by a ring
    reduce-scatter.  ``axis_sizes`` lists the mesh axes in preference
    order, fast first; the fast axis holds at most :data:`NVLINK_RANKS`
    cards.  A K group that fits it reduces at ``hw.nvlink_bw``; a larger
    one spills onto the network (``bands`` > 1, DR6') and reduces at
    ``hw.net_bw``.  Below the per-card floor (DR5') no split is taken; at
    equal time the larger K split wins (DR3').  ``itemsize`` is the
    operands' (the block plan is ``gemm_int8``'s)."""
    total_devices = math.prod(axis_sizes)
    cap = min(total_devices, max_tiles or total_devices)
    axis0 = min(axis_sizes[0], NVLINK_RANKS)
    best: tuple[float, SpatialPlan] | None = None
    for p_k in _divisors_leq(max(k // 128, 1), cap):
        for p_n in _divisors_leq(max(n // 128, 1), cap // p_k):
            q_k, q_n = math.ceil(k / p_k), math.ceil(n / p_n)
            if p_k * p_n > 1 and (q_k < q_k_floor or q_n < q_n_floor):
                continue  # DR5' per-card floor
            bands = 1 if p_k <= axis0 else math.ceil(p_k / axis0)
            red_bytes = m * q_n * 4
            bw = hw.nvlink_bw if bands == 1 else hw.net_bw   # DR6'
            t_red = collective_time(red_bytes, p_k, axis_bw=bw,
                                    kind="reduce_scatter")
            api = plan_api(m, q_k, q_n, hw=hw)
            est = api.est_s + t_red
            plan = SpatialPlan(p_k, p_n, q_k, q_n, bands, t_red)
            if best is None or (est, -p_k) < (best[0], -best[1].p_k):
                best = (est, plan)
    assert best is not None
    return best[1]


def plan_gemm(m: int, k: int, n: int, *, itemsize: int = 1,
              axis_sizes=(NVLINK_RANKS,),
              hw: hwlib.H100 = hwlib.H100_SXM,
              max_tiles: int | None = None) -> GemmPlan:
    """The two-level plan of one GEMM over cards (the paper's Algorithm
    2): :func:`plan_spatial`, then :func:`plan_api` on one card's block;
    ``rules`` names the design rules that shaped it."""
    rules: list[str] = []
    spatial = plan_spatial(m, k, n, itemsize=itemsize, axis_sizes=axis_sizes,
                           hw=hw, max_tiles=max_tiles)
    if spatial.p_k > 1:
        rules.append("DR3'(K-expansion)")
    if spatial.tiles > 1:
        rules.append("DR5'(per-device floor held)")
    if spatial.bands > 1:
        rules.append("DR6'(band spill penalized)")
    api = plan_api(m, spatial.q_k, spatial.q_n, hw=hw)
    rules.append(f"DR1'(block={api.blocks})")
    if api.block_n >= api.block_k:
        rules.append("DR2'(N-favored)")
    est = api.est_s + spatial.est_collective_s
    return GemmPlan(m, k, n, itemsize, spatial, api, est, tuple(rules))


# --------------------------------------------------------------------------
# The paper's AIE-ML model (calibrated to its Figs. 4-6)
# --------------------------------------------------------------------------

_AIE_CALL_OVERHEAD_CYC = 6        # per aie::mmul macro-call loop overhead
_AIE_DMA_SETUP_CYC = 220          # per-tile DMA/lock setup per inference
_AIE_CASCADE_HOP_CYC = 14         # partial-sum hop west->east
_AIE_UNROLL = 2                   # manual 2x2x2 unrolling (paper IV-C)


def aie_api_legal(s: tuple[int, int, int], m: int, q_k: int, q_n: int,
                  aie: hwlib.AieMl = hwlib.AIE_ML) -> bool:
    s_m, s_k, s_n = s
    if (s_m, s_k, s_n) not in aie.legal_api_tiles_i8:
        return False
    # 2x unrolling makes the effective tile twice the base size per dim.
    return (m % (s_m * _AIE_UNROLL) == 0 and q_k % (s_k * _AIE_UNROLL) == 0
            and q_n % (s_n * _AIE_UNROLL) == 0)


def aie_tile_latency(m: int, q_k: int, q_n: int,
                     s: tuple[int, int, int] = (4, 8, 8),
                     aie: hwlib.AieMl = hwlib.AIE_ML) -> float:
    """Latency (s) of one (m, q_k, q_n) i8 GEMM on ONE AIE-ML compute tile.

    Model: compute cycles at the API shape's calibrated efficiency, local-
    memory load cycles for the A/B sub-tiles (2x256-bit loads/cycle), per-call
    loop overhead, and fixed DMA/lock setup.  Shape asymmetry (paper Fig. 4:
    up to 2x faster when q_n > q_k) enters through the output-accumulator
    utilization factor.
    """
    s_m, s_k, s_n = s
    r_m = math.ceil(m / (s_m * _AIE_UNROLL))
    r_k = math.ceil(q_k / (s_k * _AIE_UNROLL))
    r_n = math.ceil(q_n / (s_n * _AIE_UNROLL))
    calls = r_m * r_k * r_n
    macs_per_call = (s_m * s_k * s_n) * _AIE_UNROLL**3
    eff = aie.api_efficiency(s_m, s_k, s_n)
    # Output-stationarity: wide-N workloads keep the 2x-unrolled accumulators
    # busy; K-heavy workloads serialize on the reduction chain.
    shape_util = min(1.0, 0.55 + 0.45 * min(2.0, q_n / max(q_k, 1)) / 2.0 * 2)
    if q_k > q_n:
        shape_util = max(0.5, 1.0 - 0.25 * math.log2(q_k / q_n))
    compute_cyc = calls * macs_per_call / (aie.macs_per_cycle_int8 * eff * shape_util)
    # Local-memory traffic: A and B sub-tiles re-read per call (64 B/cycle).
    load_cyc = calls * (s_m * s_k + s_k * s_n) * _AIE_UNROLL**2 / 64.0
    cyc = max(compute_cyc, load_cyc) + calls * _AIE_CALL_OVERHEAD_CYC / _AIE_UNROLL \
        + _AIE_DMA_SETUP_CYC
    return cyc / aie.clock_hz


def aie_spatial_latency(m: int, k: int, n: int, p_k: int, p_n: int,
                        s: tuple[int, int, int] = (4, 8, 8),
                        layers_in_band_2: int = 0,
                        aie: hwlib.AieMl = hwlib.AIE_ML) -> float:
    """Latency (s) of spatially tiling an (m,k,n) GEMM over p_k x p_n tiles.

    Adds: input streaming over the 32-bit per-tile port, cascade hops for the
    K-direction partial sums, and the Fig.-6 band-spill contention penalty.
    """
    q_k, q_n = math.ceil(k / p_k), math.ceil(n / p_n)
    t_tile = aie_tile_latency(m, q_k, q_n, s, aie)
    stream_in_cyc = (m * q_k) / (aie.stream_bits / 8)      # bytes @ 4 B/cycle
    cascade_cyc = (p_k - 1) * _AIE_CASCADE_HOP_CYC
    stream_out_cyc = (m * q_n) / (aie.stream_bits / 8)
    t = t_tile + (stream_in_cyc + cascade_cyc + stream_out_cyc) / aie.clock_hz
    if layers_in_band_2 > 0:
        t *= 1.0 + aie.band2_penalty_per_layer * layers_in_band_2
    return t


def aie_tile_interval(m: int, q_k: int, q_n: int,
                      s: tuple[int, int, int] = (4, 8, 8),
                      aie: hwlib.AieMl = hwlib.AIE_ML) -> float:
    """STEADY-STATE initiation interval (s) of one tile — the paper's
    throughput measure (Fig. 2/Table I report MHz = batch/interval).

    Unlike :func:`aie_tile_latency`, per-inference setup (DMA locks, loop
    prologue) pipelines away; the interval is bound by the slowest of
    compute, the 32-bit input stream, and the 32-bit output stream.
    """
    s_m, s_k, s_n = s
    eff = aie.api_efficiency(s_m, s_k, s_n)
    shape_util = min(1.0, 0.55 + 0.45 * min(2.0, q_n / max(q_k, 1)))
    shape_util = max(0.5, min(shape_util, 1.0))
    compute_cyc = (m * q_k * q_n) / (aie.macs_per_cycle_int8 * eff * shape_util)
    stream_in_cyc = (m * q_k) / (aie.stream_bits / 8)
    stream_out_cyc = (m * q_n) / (aie.stream_bits / 8)
    return max(compute_cyc, stream_in_cyc, stream_out_cyc) / aie.clock_hz


def aie_spatial_interval(m: int, k: int, n: int, p_k: int, p_n: int,
                         s: tuple[int, int, int] = (4, 8, 8),
                         layers_in_band_2: int = 0,
                         aie: hwlib.AieMl = hwlib.AIE_ML) -> float:
    """Steady-state interval of a spatially tiled layer: per-tile interval on
    its (q_k, q_n) slice + cascade chain + band-spill contention (DR6)."""
    q_k, q_n = math.ceil(k / p_k), math.ceil(n / p_n)
    cyc = aie_tile_interval(m, q_k, q_n, s, aie) * aie.clock_hz
    cyc += (p_k - 1) * _AIE_CASCADE_HOP_CYC
    t = cyc / aie.clock_hz
    if layers_in_band_2 > 0:
        t *= 1.0 + aie.band2_penalty_per_layer * layers_in_band_2
    return t


def aie_optimized_interval(layer_shapes, batch: int = 8, *,
                           max_tiles_per_layer: int = 12,
                           aie: hwlib.AieMl = hwlib.AIE_ML) -> float:
    """Deploy a dense pipeline with the Section-IV design rules: per layer,
    spatially tile over up to `max_tiles_per_layer` tiles, K-expansion first
    (DR3), DR5 floor on split dims, one band (DR6).  Returns the steady-state
    pipeline interval (slowest layer)."""
    n_layers = len(layer_shapes)
    t_worst = 0.0
    for n_in, n_out in layer_shapes:
        best = aie_tile_interval(batch, n_in, n_out, aie=aie)
        for p_k in (1, 2, 3, 4, 6):
            for p_n in (1, 2, 3, 4, 6):
                if p_k * p_n > max_tiles_per_layer:
                    continue
                q_k, q_n = n_in / p_k, n_out / p_n
                # DR5 floor applies to the dims being SPLIT (stream-bound
                # narrow layers may still split K alone).
                if (p_k > 1 and q_k < 16) or (p_n > 1 and q_n < 32):
                    continue
                if n_layers * p_k > aie.usable_cols:
                    continue                     # DR6: one band
                best = min(best, aie_spatial_interval(batch, n_in, n_out,
                                                      p_k, p_n, aie=aie))
        t_worst = max(t_worst, best)
    return t_worst


def aie_best_single_tile(m: int, k: int, n: int,
                         aie: hwlib.AieMl = hwlib.AIE_ML,
                         ) -> tuple[tuple[int, int, int], float]:
    """DR1 search: best legal API tile for a single-tile workload."""
    best = None
    for s in aie.legal_api_tiles_i8:
        if not aie_api_legal(s, m, k, n, aie):
            continue
        t = aie_tile_latency(m, k, n, s, aie)
        if best is None or t < best[1]:
            best = (s, t)
    if best is None:  # fall back: pad to the default shape
        best = ((4, 8, 8), aie_tile_latency(m, k, n, (4, 8, 8), aie))
    return best
