"""The port's ``tiled_gemm`` and ``fused_dense`` against the JAX package.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode (``repro.kernels.ops``), as
``tests/test_kernels.py`` does, and its ``ref.py`` oracle.  Both get the
same seeded numpy inputs.  Tolerances are the reference's own:
``tiled_gemm`` exact for int8, rtol 1e-5 (atol 8e-5) for f32 and 2e-2
(atol 0.16) for bf16; ``fused_dense`` rtol 1e-5 / atol 1e-4 for f32.  The
bf16 ``fused_dense`` cases, which the reference does not test, are held to
its bf16 ``tiled_gemm`` tolerance.  ``_split_k_emulated`` writes
``fused_dense.cu``'s summation order (K chunks, the warps' slices, the
partials in warp order) in torch and is held to the same references.  The
``gpu`` tests hold each CUDA kernel to its plain version on a card and skip
without one.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch import hw
from repro_torch.core import tiling
from repro_torch.kernels import fused_dense as fd
from repro_torch.kernels import ops
from repro_torch.kernels import tiled_gemm as tg

ACTS = ["none", "relu", "gelu", "silu", "tanh", "sigmoid"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
EDGE_NETS = ("jet_tagger", "tau_select", "vae", "qubit", "autoencoder")


def _edge_layer_shapes():
    from repro_torch.models import edge
    return [(8, k, n) for name in EDGE_NETS
            for k, n in edge.edge_config(name).layer_shapes]


# fused_dense's planner and order cases: the 26 edge layers at M = 8 (19
# distinct shapes; x rows of K = 27 and 250 and w rows of N = 2 and 5 are
# not 16-byte multiples), a ragged M = 13 and a multi-strip M = 200.
DENSE_SHAPES = sorted(set(_edge_layer_shapes())) + [(13, 100, 70),
                                                    (200, 300, 260)]


def _randn(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _pair(a, dtype):
    """One numpy array as (jax, torch) arrays of ``dtype``."""
    return jnp.asarray(a, getattr(jnp, dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# tiled_gemm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [
    (8, 64, 64), (8, 192, 256), (16, 128, 384), (33, 100, 130),  # ragged
    (8, 512, 512), (1, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_gemm_matches_pallas(m, k, n, dtype):
    rng = np.random.default_rng(42)
    (xj, xt), (wj, wt) = (_pair(_randn(rng, s), dtype)
                          for s in ((m, k), (k, n)))
    want = ref_ops.tiled_gemm(xj, wj, block_m=8, block_k=64, block_n=128)
    got = ops.tiled_gemm(xt, wt)
    assert got.dtype == xt.dtype and got.shape == (m, n)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 8)
    np.testing.assert_allclose(_np(got),
                               np.asarray(ref.tiled_gemm(xj, wj), np.float32),
                               rtol=tol, atol=tol * 8)


# The reference sweeps its TPU tiles; the port sweeps its own (the plain
# version takes any, the kernel only these).
@pytest.mark.parametrize("ref_blocks,blocks", [
    ((8, 128, 128), (8, 16, 32)), ((16, 64, 256), (16, 64, 128)),
    ((32, 256, 128), (32, 32, 64))])
def test_tiled_gemm_block_sweep(ref_blocks, blocks):
    rng = np.random.default_rng(43)
    (xj, xt), (wj, wt) = (_pair(_randn(rng, s), "float32")
                          for s in ((32, 256), (256, 512)))
    bm, bk, bn = ref_blocks
    want = ref_ops.tiled_gemm(xj, wj, block_m=bm, block_k=bk, block_n=bn)
    got = ops.tiled_gemm(xt, wt, block_m=blocks[0], block_k=blocks[1],
                         block_n=blocks[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_tiled_gemm_int8_accumulates_exactly():
    rng = np.random.default_rng(44)
    x = rng.integers(-127, 127, (8, 256)).astype(np.int8)
    w = rng.integers(-127, 127, (256, 128)).astype(np.int8)
    want = ref_ops.tiled_gemm(jnp.asarray(x), jnp.asarray(w), block_m=32,
                              block_k=128, block_n=128)
    got = ops.tiled_gemm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))


def test_tiled_gemm_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="not one the kernel takes"):
        ops.tiled_gemm(x, torch.zeros((16, 8)), block_m=8, block_k=128,
                       block_n=128)
    with pytest.raises(ValueError, match="one dtype"):
        tg.tiled_gemm_contract(x, torch.zeros((16, 8), dtype=torch.int8),
                               block_m=8, block_k=16, block_n=32)
    assert tg.tiled_gemm_contract(
        x.to(torch.int8), torch.zeros((16, 8), dtype=torch.int8), block_m=64,
        block_k=128, block_n=64) == ((8, 8), torch.int32)


# The tensor-core set (int8, bf16) and the CUDA-core set (f32) share no
# tile: each dtype takes its own and refuses the other's.
@pytest.mark.parametrize("dtype,takes,refuses", [
    (torch.int8, [(64, 128, 64), (128, 128, 256), (64, 128, 128)],
     [(8, 16, 32), (64, 64, 128), (64, 64, 64), (32, 128, 64)]),
    (torch.bfloat16, [(64, 64, 64), (128, 64, 256), (128, 64, 128)],
     [(8, 16, 32), (64, 64, 32), (64, 128, 64), (16, 64, 64)]),
    (torch.float32, [(8, 16, 32), (64, 64, 128), (16, 32, 64)],
     [(64, 64, 256), (128, 64, 64), (64, 128, 64)]),
])
def test_tiled_gemm_contract_takes_each_dtypes_tile_set(dtype, takes,
                                                        refuses):
    x = torch.zeros((8, 16), dtype=dtype, device="meta")
    w = torch.zeros((16, 8), dtype=dtype, device="meta")
    for blocks in takes:
        assert tg.tiled_gemm_contract(
            x, w, block_m=blocks[0], block_k=blocks[1],
            block_n=blocks[2]) == ((8, 8), tg.out_dtype(dtype))
    for blocks in refuses:
        with pytest.raises(ValueError, match="not one the kernel takes"):
            tg.tiled_gemm_contract(x, w, block_m=blocks[0],
                                   block_k=blocks[1], block_n=blocks[2])
        with pytest.raises(ValueError, match="not one the kernel takes"):
            ops.tiled_gemm(x, w, block_m=blocks[0], block_k=blocks[1],
                           block_n=blocks[2])


@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_tiled_planner_picks_legal_tiles(itemsize):
    from repro_torch import hw
    for m, k, n in [(64, 256, 512), (8, 16, 64), (33, 100, 130),
                    (256, 4096, 4096), (8, 320, 320)]:
        api = tiling.plan_tiled(m, k, n, itemsize=itemsize)
        assert tiling.tiled_tile_ok(*api.blocks, itemsize)
        assert api.smem_bytes == tiling.tiled_smem_bytes(*api.blocks,
                                                         itemsize)
        if itemsize == 4:
            assert tiling.dense_tile_ok(*api.blocks)
            assert api.smem_bytes <= 48 * 1024     # no opt-in needed
        else:
            assert api.block_m in tiling.TC_BLOCK_M
            assert api.block_n in tiling.TC_BLOCK_N
            assert api.block_k * itemsize == tiling.TC_ROW_BYTES
            assert api.smem_bytes <= hw.H100_SXM.smem_bytes
    with pytest.raises(ValueError, match="8-byte"):
        tiling.plan_tiled(8, 8, 8, itemsize=8)


def test_tiled_gemm_f32_tiles_are_unchanged():
    """f32 tiled_gemm keeps gemm_tile.cuh's set and its planner's choices;
    fused_dense's own tiles do not reach it."""
    assert (tiling.TILED_BLOCK_M, tiling.TILED_BLOCK_K,
            tiling.TILED_BLOCK_N) == ((8, 16, 32, 64), (16, 32, 64),
                                      (32, 64, 128))
    for m, k, n in [(64, 256, 512), (33, 100, 130), (1, 7, 5),
                    (200, 300, 260), (8, 250, 96)]:
        assert tiling.plan_tiled(m, k, n, itemsize=4) == \
            tiling.plan_dense(m, k, n)
    assert not tiling.tiled_tile_ok(8, 256, 16, 4)
    assert not tiling.dense_tile_ok(8, 256, 16)


@pytest.mark.parametrize("itemsize,rate", [(1, "peak_int8_ops"),
                                           (2, "peak_bf16_ops"),
                                           (4, "f32_fma_ops")])
def test_tiled_planner_charges_the_given_cards_rate(itemsize, rate):
    """The planner charges the rate of the instructions the kernel issues,
    read from the machine model it is given: at a thousandth of it a large
    GEMM is bound by operations, and the estimate follows the rate."""
    from repro_torch import hw
    m, k, n = 256, 4096, 4096
    slow = dataclasses.replace(hw.H100_SXM,
                               **{rate: getattr(hw.H100_SXM, rate) / 1000})
    fast_est = tiling.plan_tiled(m, k, n, itemsize=itemsize).est_s
    slow_est = tiling.plan_tiled(m, k, n, itemsize=itemsize, hw=slow).est_s
    ops_s = 2.0 * m * k * n / getattr(slow, rate)
    assert slow_est >= ops_s > 10 * fast_est


def test_planner_rates_stay_out_of_the_edge_plan_keys():
    """The tiled and fused_dense planners' rates enter no edge plan's key;
    the rate the edge planner reads does."""
    from repro_torch.models import edge
    from repro_torch.plan import plan_deployment
    cfg = edge.edge_config("jet_tagger")
    key = plan_deployment(cfg, device="cpu").key
    assert plan_deployment(cfg, device="cpu", hw=dataclasses.replace(
        hw.H100_SXM, peak_bf16_ops=1.0, f32_fma_ops=1.0,
        dram_round_trip_s=1.0)).key == key
    assert plan_deployment(cfg, device="cpu", hw=dataclasses.replace(
        hw.H100_SXM, peak_int8_ops=1.0)).key != key


# ---------------------------------------------------------------------------
# fused_dense
# ---------------------------------------------------------------------------

def _dense_inputs(seed, m, k, n, residual):
    rng = np.random.default_rng(seed)
    return (_randn(rng, (m, k)), _randn(rng, (k, n)), _randn(rng, (n,)),
            _randn(rng, (m, n)) if residual else None)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("residual", [False, True])
def test_fused_dense_matches_pallas(act, residual):
    x, w, b, r = _dense_inputs(45, 8, 192, 256, residual)
    j = [None if a is None else jnp.asarray(a) for a in (x, w, b, r)]
    want = ref_ops.fused_dense(*j, act=act, block_m=8, block_k=64,
                               block_n=128)
    got = ops.fused_dense(*(None if a is None else torch.from_numpy(a)
                            for a in (x, w, b, r)), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref.fused_dense(*j, act=act)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fused_dense_ragged_bf16_matches_reference(act):
    """Ragged M/K/N with bf16 operands and a bf16 residual: the bias in f32
    before the activation, the residual after it, the cast last."""
    x, w, b, r = _dense_inputs(46, 13, 100, 70, True)
    xj, xt = _pair(x, "bfloat16")
    wj, wt = _pair(w, "bfloat16")
    rj, rt = _pair(r, "bfloat16")
    want = ref.fused_dense(xj, wj, jnp.asarray(b), rj, act=act)
    got = ops.fused_dense(xt, wt, torch.from_numpy(b), rt, act=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2e-2, atol=0.16)


def test_fused_dense_gelu_is_the_tanh_approximation():
    y = torch.linspace(-4, 4, 33)
    x, w = y[:, None], torch.ones((1, 1))
    got = ops.fused_dense(x, w, torch.zeros(1), act="gelu")[:, 0]
    torch.testing.assert_close(
        got, torch.nn.functional.gelu(y, approximate="tanh"))
    assert (got - torch.nn.functional.gelu(y)).abs().max() > 1e-4


def test_fused_dense_refuses_what_the_kernel_does_not_take():
    x, w, b = torch.zeros((8, 16)), torch.zeros((16, 32)), torch.zeros(32)
    with pytest.raises(ValueError, match="act"):
        ops.fused_dense(x, w, b, act="elu")
    with pytest.raises(ValueError, match="not one the kernel takes"):
        ops.fused_dense(x, w, b, block_m=12)
    with pytest.raises(ValueError, match="bias"):
        fd.fused_dense_contract(x, w, b.double(), act="relu", block_m=8,
                                block_k=16, block_n=32)
    for r in (torch.zeros((8, 31)), torch.zeros((8, 32),
                                                dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="residual"):
            fd.fused_dense_contract(x, w, b, r, act="relu", block_m=8,
                                    block_k=16, block_n=32)
    assert fd.fused_dense_contract(
        x, w, b, act="relu", block_m=8, block_k=16, block_n=32,
        out_dtype=torch.bfloat16) == ((8, 32), torch.bfloat16)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _fd_tiles():
    return [t for t in itertools.product(tiling.FD_BLOCK_M, tiling.FD_BLOCK_K,
                                         tiling.FD_BLOCK_N)
            if tiling.fused_dense_tile_ok(*t)]


@pytest.mark.parametrize("m,k,n", DENSE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dense_planner_takes_the_fewest_stages(m, k, n, dtype):
    """The planner's tile is one the contract takes, within one block's
    shared memory, sized as the kernel sizes it, and makes the fewest K
    stages (device-memory round trips) any tile of the set that fits
    makes."""
    dt = getattr(torch, dtype)
    isz = dt.itemsize
    api = tiling.plan_fused_dense(m, k, n, itemsize=isz)
    assert fd.fused_dense_contract(
        _meta((m, k), dt), _meta((k, n), dt), _meta((n,), torch.float32),
        act="relu", block_m=api.block_m, block_k=api.block_k,
        block_n=api.block_n) == ((m, n), dt)
    assert api.smem_bytes == tiling.fused_dense_smem_bytes(*api.blocks, k,
                                                           isz)
    assert api.smem_bytes <= hw.H100_SXM.smem_bytes == 232_448
    fewest = min(tiling.fused_dense_stages(k, bk) for bm, bk, bn
                 in _fd_tiles() if tiling.fused_dense_smem_bytes(
                     bm, bk, bn, k, isz) <= hw.H100_SXM.smem_bytes)
    assert tiling.fused_dense_stages(k, api.block_k) == fewest == 1


def test_fused_dense_planner_charges_each_round_trip():
    """With less shared memory the strip takes more K stages, and the
    estimate grows by one round trip (``dram_round_trip_s``) for each."""
    m, k, n = 8, 2000, 64
    one = tiling.plan_fused_dense(m, k, n)
    assert tiling.fused_dense_stages(k, one.block_k) == 1
    small = dataclasses.replace(hw.H100_SXM, smem_bytes=48 * 1024)
    ring = tiling.plan_fused_dense(m, k, n, hw=small)
    stages = tiling.fused_dense_stages(k, ring.block_k)
    assert stages > 1 and ring.smem_bytes <= 48 * 1024
    slow = dataclasses.replace(small, dram_round_trip_s=1e-3)
    assert tiling.plan_fused_dense(m, k, n, hw=slow).est_s - ring.est_s == \
        pytest.approx(stages * (1e-3 - hw.H100_SXM.dram_round_trip_s))
    with pytest.raises(ValueError, match="no tile fits"):
        tiling.plan_fused_dense(m, k, n, hw=dataclasses.replace(
            hw.H100_SXM, smem_bytes=1024))


@pytest.mark.parametrize("blocks", [
    (8, 16, 128), (16, 64, 64), (32, 64, 16), (8, 8, 16), (8, 48, 16),
    (8, 4096, 16), (64, 64, 128)])
def test_fused_dense_contract_refuses_tiles_outside_its_set(blocks):
    """The contract and ``ops.fused_dense`` refuse a tile outside
    ``fused_dense``'s set (``block_n`` 128, 1024 outputs, ``block_m`` 32,
    ``block_k`` 8, 48 or 4096, the f32 ``tiled_gemm`` tile (64, 64, 128))."""
    x, w = _meta((8, 64), torch.float32), _meta((64, 32), torch.float32)
    b = _meta((32,), torch.float32)
    assert not tiling.fused_dense_tile_ok(*blocks)
    with pytest.raises(ValueError, match="not one the kernel takes"):
        fd.fused_dense_contract(x, w, b, act="relu", block_m=blocks[0],
                                block_k=blocks[1], block_n=blocks[2])
    with pytest.raises(ValueError, match="not one the kernel takes"):
        ops.fused_dense(x, w, b, block_m=blocks[0], block_k=blocks[1],
                        block_n=blocks[2])


def test_fused_dense_contract_refuses_a_strip_over_shared_memory():
    k = 4096
    x, w = _meta((16, k), torch.float32), _meta((k, 32), torch.float32)
    b = _meta((32,), torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        fd.fused_dense_contract(x, w, b, act="relu", block_m=16,
                                block_k=2048, block_n=32)
    assert fd.fused_dense_contract(x, w, b, act="relu", block_m=16,
                                   block_k=512, block_n=32) == \
        ((16, 32), torch.float32)


def _split_k_emulated(x, w, b, residual=None, *, act, block_k,
                      out_dtype=None):
    """``csrc/fused_dense.cu``'s arithmetic in torch, step for step: K in
    chunks of ``block_k``; in each, its length rounded up to 4 and cut into
    ``FD_WARPS`` slices of a multiple of 4, each warp adding its slice in K
    order onto its running partial by FMA (an f64 sum of the exact f64
    product, rounded to f32); the partials added in warp order; then the
    bias, the activation, the residual and the cast."""
    m, k = x.shape
    warps = tiling.FD_WARPS
    # Zero rows and columns past K stand for the kernel's zero-filled pad.
    x64 = torch.cat([x.double(), torch.zeros((m, block_k + 4))], 1)
    w64 = torch.cat([w.double(), torch.zeros((block_k + 4, w.shape[1]))])
    part = torch.zeros((warps, m, w.shape[1]), dtype=torch.float32)
    lanes = torch.arange(warps)
    for k0 in range(0, k, block_k):
        kq = -(-min(block_k, k - k0) // 4) * 4
        step = -(-kq // (4 * warps)) * 4
        for i in range(step):           # every warp's i-th K of its slice
            off = lanes * step + i
            kk = torch.where(off < kq, k0 + off, k + 1)
            prod = x64[:, kk].T[:, :, None] * w64[kk][:, None, :]
            part = (part.double() + prod).float()
    s = part[0]
    for q in range(1, warps):
        s = s + part[q]
    y = fd._ACTIVATE[act](s + b.float())
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype or x.dtype)


@pytest.mark.parametrize("m,k,n", DENSE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dense_split_k_order_matches_pallas(m, k, n, dtype):
    """The kernel's order at the planner's ``block_k`` (one stage) and at
    ``block_k`` 16 (a ring of chunks), every activation with and without a
    residual, against ``ref.fused_dense`` and the Pallas kernel in
    interpret mode (the kernel for every f32 case and for one bf16 case a
    shape, ``ref.fused_dense`` for all)."""
    rtol, atol = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 0.16)
    planned = tiling.plan_fused_dense(m, k, n, itemsize=2 if dtype ==
                                      "bfloat16" else 4).block_k
    for residual in (False, True):
        x, w, b, r = _dense_inputs(49, m, k, n, residual)
        w = w * np.float32(k ** -0.5)
        j = [None if a is None else jnp.asarray(a, getattr(jnp, dtype))
             for a in (x, w)] + [jnp.asarray(b)] + \
            [None if r is None else jnp.asarray(r, getattr(jnp, dtype))]
        t = [None if a is None else torch.from_numpy(a).to(
            getattr(torch, dtype)) for a in (x, w)] + \
            [torch.from_numpy(b)] + \
            [None if r is None else torch.from_numpy(r).to(
                getattr(torch, dtype))]
        for act in ACTS:
            wants = [ref.fused_dense(*j, act=act)]
            if dtype == "float32" or (residual and act == "relu"):
                wants.append(ref_ops.fused_dense(*j, act=act))
            for block_k in dict.fromkeys((planned, 16)):
                got = _split_k_emulated(*t, act=act, block_k=block_k)
                assert got.dtype == getattr(torch, dtype)
                for want in wants:
                    np.testing.assert_allclose(
                        _np(got), np.asarray(want, np.float32), rtol=rtol,
                        atol=atol)


def test_non_cpu_tensors_never_reach_plain(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("plain version reached")
    monkeypatch.setattr(tg, "tiled_gemm_plain", forbidden)
    monkeypatch.setattr(fd, "fused_dense_plain", forbidden)
    ops.reset_launches()
    x = torch.zeros((8, 16), device="meta")
    w = torch.zeros((16, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.tiled_gemm(x, w)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.fused_dense(x, w, torch.zeros(32, device="meta"))
    counts = ops.launch_counts()
    assert counts["tiled_gemm"] == counts["fused_dense"] == 0


# ---------------------------------------------------------------------------
# On a card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: python "
                    "-m pytest -m gpu tests/test_torch_dense_kernels.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GEMM_CASES = [(8, 64, 64), (33, 100, 130), (64, 256, 512), (1, 7, 5),
              (200, 300, 260)]
# Blocks held beside the planner's choice, per operand size: the smallest,
# the largest and one between of each set.
GEMM_BLOCKS = {1: [(64, 128, 64), (128, 128, 256), (64, 128, 128)],
               2: [(64, 64, 64), (128, 64, 256), (128, 64, 128)],
               4: [(8, 16, 32), (64, 64, 128), (16, 32, 64)]}


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", GEMM_CASES)
@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
def test_tiled_gemm_cuda_matches_plain_on_card(cuda_device, m, k, n, dtype):
    rng = np.random.default_rng(47)
    if dtype == "int8":
        x, w = (torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8))
                for s in ((m, k), (k, n)))
    else:
        x, w = (torch.from_numpy(_randn(rng, s)).to(getattr(torch, dtype))
                for s in ((m, k), (k, n)))
    x, w = x.to(cuda_device), w.to(cuda_device)
    size = x.element_size()
    for bm, bk, bn in {tiling.plan_tiled(m, k, n, itemsize=size).blocks,
                       *GEMM_BLOCKS[size]}:
        got = tg.tiled_gemm_cuda(x, w, block_m=bm, block_k=bk, block_n=bn)
        want = tg.tiled_gemm_plain(x, w)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype
        if dtype == "int8":
            assert torch.equal(got, want)
        else:
            tol = TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol * 8)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_fused_dense_cuda_matches_plain_on_card(cuda_device, act, dtype,
                                                residual):
    """Every edge layer shape (the unaligned rows among them), one row,
    M = 13 and 200, K = 0 and a wide (8, 320, 320), at the planner's
    tile."""
    for m, k, n in DENSE_SHAPES + [(1, 27, 2), (1, 250, 5), (8, 0, 16),
                                   (13, 0, 5), (8, 320, 320)]:
        x, w, b, r = _dense_inputs(48, m, k, n, residual)
        dt = getattr(torch, dtype)
        args = [torch.from_numpy(x).to(cuda_device, dt),
                torch.from_numpy(w * max(k, 1) ** -0.5).to(cuda_device, dt),
                torch.from_numpy(b).to(cuda_device),
                None if r is None else torch.from_numpy(r).to(cuda_device,
                                                              dt)]
        got = ops.fused_dense(*args, act=act)
        want = fd.fused_dense_plain(*args, act=act)
        torch.cuda.synchronize()
        assert got.dtype == dt
        rtol, atol = (1e-5, 1e-4) if dtype == "float32" else (2 ** -7, 1e-2)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dense_cuda_every_tile_ring_and_offset_on_card(cuda_device,
                                                             dtype):
    """Every strip of the set at block_k 16 (a ring of chunks), 64 and the
    largest that fits, on ragged and unaligned shapes; and operands whose
    base is one element off a 16-byte boundary (narrower copies)."""
    dt = getattr(torch, dtype)
    rtol, atol = (1e-5, 1e-4) if dtype == "float32" else (2 ** -7, 1e-2)
    for m, k, n in [(13, 100, 70), (8, 27, 5), (200, 300, 260),
                    (17, 250, 2)]:
        x, w, b, r = _dense_inputs(50, m, k, n, True)
        args = [torch.from_numpy(x).to(cuda_device, dt),
                torch.from_numpy(w * k ** -0.5).to(cuda_device, dt),
                torch.from_numpy(b).to(cuda_device),
                torch.from_numpy(r).to(cuda_device, dt)]
        want = fd.fused_dense_plain(*args, act="gelu")
        for bm, bk, bn in _fd_tiles():
            if bk not in (16, 64, 2048) or tiling.fused_dense_smem_bytes(
                    bm, bk, bn, k, dt.itemsize) > hw.H100_SXM.smem_bytes:
                continue
            got = fd.fused_dense_cuda(*args, act="gelu", block_m=bm,
                                      block_k=bk, block_n=bn)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)
        shifted = []
        for t in args[:2] + args[3:]:
            flat = torch.empty(t.numel() + 1, dtype=dt, device=cuda_device)
            view = flat[1:].view(t.shape)
            view.copy_(t)
            shifted.append(view)
        got = ops.fused_dense(shifted[0], shifted[1], args[2], shifted[2],
                              act="gelu")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
