"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode.  Both get the same seeded numpy
inputs.  Tolerances: the fused group at the reference's own 1e-5
(``tests/test_fusion.py``); ``gemm_int8`` exact on the int32 accumulator,
1e-6 on f32 outputs (same arithmetic in the same order) and the reference's
1e-3/1e-2 on bf16 (``tests/test_kernels.py``).  The ``gpu`` test holds the
CUDA kernels to the plain versions on a card and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_mlp as ref_fm
from repro.kernels import gemm_int8 as ref_g8
from repro.models import edge as ref_edge
from repro_torch.core import tiling
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import gemm_int8 as g8
from repro_torch.kernels import ops


def _net_group(name, seed=0):
    """A net's layers quantized in numpy as ``quantize_edge`` does:
    per-channel weight scales, activation scales from a calibration batch."""
    cfg = ref_edge.edge_config(name)
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(cfg.batch, cfg.dims[0])).astype(np.float32)
    ws, scs, bs, xs = [], [], [], []
    for i, (n_in, n_out) in enumerate(cfg.layer_shapes):
        w = (rng.normal(size=(n_in, n_out)) / np.sqrt(n_in)).astype(np.float32)
        b = rng.normal(scale=0.1, size=(n_out,)).astype(np.float32)
        scale = np.abs(w).max(axis=0) / np.float32(127) + np.float32(1e-12)
        ws.append(np.clip(np.round(w / scale), -127, 127).astype(np.int8))
        scs.append(scale.astype(np.float32))
        bs.append(b)
        xs.append(max(float(np.abs(h).max()) / 127.0, 1e-8))
        h = h @ w + b
        if i != len(cfg.layer_shapes) - 1:
            h = np.maximum(h, 0.0)
    return ws, scs, bs, np.asarray(xs, np.float32)


def _random_group(rng, dims):
    ws = [rng.integers(-127, 128, (a, b)).astype(np.int8)
          for a, b in zip(dims[:-1], dims[1:])]
    scs = [rng.uniform(0.01, 0.1, (b,)).astype(np.float32) for b in dims[1:]]
    bs = [rng.normal(size=(b,)).astype(np.float32) for b in dims[1:]]
    xs = rng.uniform(0.02, 0.08, (len(dims) - 1,)).astype(np.float32)
    return ws, scs, bs, xs


def _both_fused(x, group, *, act_last):
    ws, scs, bs, xs = group
    want = ref_fm.fused_mlp_q8(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, scs)), tuple(map(jnp.asarray, bs)),
        jnp.asarray(xs), act="relu", act_last=act_last, interpret=True)
    got = ops.fused_mlp_q8(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(s) for s in scs], [torch.from_numpy(b) for b in bs],
        torch.from_numpy(xs), act="relu", act_last=act_last)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name,m", [(n, 8) for n in ref_edge.EDGE_NETS]
                         + [("jet_tagger", 3), ("jet_tagger", 13)])
def test_fused_plain_matches_pallas_on_net_chains(name, m):
    group = _net_group(name)
    x = np.random.default_rng(1).normal(
        size=(m, group[0][0].shape[0])).astype(np.float32)
    got, want = _both_fused(x, group, act_last=False)
    assert got.shape == (m, group[0][-1].shape[1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act_last", [False, True])
def test_fused_plain_matches_pallas_on_odd_widths(act_last):
    rng = np.random.default_rng(2)
    group = _random_group(rng, [19, 45, 7, 33])
    x = rng.normal(size=(13, 19)).astype(np.float32)
    got, want = _both_fused(x, group, act_last=act_last)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pack_layout_round_trips():
    """The packed (N_i, kp_i) blocks hold each layer's weights transposed,
    with zero padding up to a multiple of 4 of the input width."""
    rng = np.random.default_rng(3)
    ws, scs, bs, xs = _random_group(rng, [19, 45, 7, 33])
    g = ops.pack_group([torch.from_numpy(w) for w in ws],
                       [torch.from_numpy(s) for s in scs],
                       [torch.from_numpy(b) for b in bs], xs)
    assert g.dims == (19, 45, 7, 33)
    for (wt, s, b), w, sc, bias, x_s in zip(g.layer_views(), ws, scs, bs, xs):
        k = w.shape[0]
        assert wt.shape == (w.shape[1], -(-k // 4) * 4)
        np.testing.assert_array_equal(wt[:, :k].numpy(), w.T)
        assert not wt[:, k:].any()
        np.testing.assert_array_equal(s.numpy(), sc * x_s)
        np.testing.assert_array_equal(b.numpy(), bias)
    assert fm.buffer_stride(g.dims) == 48
    assert fm.fused_smem_bytes(g.dims) == 2 * fm.ROWS * 48


def test_pack_group_rejects_bad_groups():
    w = torch.zeros((4, 4), dtype=torch.int8)
    s, b = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="activation"):
        ops.pack_group([w], [s], [b], [0.1], act="gelu")
    with pytest.raises(ValueError, match="1..16"):
        ops.pack_group([w] * 17, [s] * 17, [b] * 17, [0.1] * 17)
    with pytest.raises(ValueError, match="int8"):
        ops.pack_group([w.float()], [s], [b], [0.1])


def _gemm_inputs(rng, m, k, n):
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sw = rng.uniform(0.01, 0.1, (n,)).astype(np.float32)
    return x, w, sw


GEMM_SHAPES = [(8, 16, 64), (8, 250, 96), (8, 136, 8), (24, 250, 300),
               (3, 19, 45)]


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_accumulator_exact(m, k, n):
    x, w, _ = _gemm_inputs(np.random.default_rng(4), m, k, n)
    ones = np.ones((n,), np.float32)
    want = ref_g8.gemm_int8(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(ones), 1.0, out_dtype=jnp.float32,
                            interpret=True)
    got = ops.gemm_int8(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(ones), 1.0, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_gemm_plain_matches_pallas(m, k, n, out_dtype):
    x, w, sw = _gemm_inputs(np.random.default_rng(5), m, k, n)
    want = ref_g8.gemm_int8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sw),
                            0.07, out_dtype=getattr(jnp, out_dtype),
                            interpret=True)
    got = ops.gemm_int8(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(sw), 0.07,
                        out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    tol = (1e-3, 1e-2) if out_dtype == "bfloat16" else (1e-6, 1e-6)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1])


def test_gemm_rejects_tiles_the_kernel_does_not_take():
    x = torch.zeros((8, 16), dtype=torch.int8)
    w = torch.zeros((16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="not one the kernel takes"):
        ops.gemm_int8(x, w, torch.ones(8), block_m=32, block_k=128,
                      block_n=256)
    with pytest.raises(ValueError, match="not one the kernel takes"):
        ops.gemm_int8(x, w, torch.ones(8), block_m=12)


def test_tile_planner_picks_legal_tiles():
    for m, k, n in GEMM_SHAPES + [(256, 1024, 1024)]:
        api = tiling.plan_api(m, k, n)
        assert tiling.tile_ok(*api.blocks)
        assert api.smem_bytes == tiling.smem_bytes(*api.blocks)
        assert api.est_s > 0
    assert tiling.plan_api(8, 64, 32).block_m == 8
    assert tiling.plan_api(256, 1024, 1024).blocks == (64, 128, 128)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    ops.reset_launches()
    x = torch.zeros((8, 16), dtype=torch.int8)
    w = torch.zeros((16, 8), dtype=torch.int8)
    ops.gemm_int8(x, w, torch.ones(8))
    ops.fused_mlp_q8(torch.zeros((8, 16)), [w], [torch.ones(8)],
                     [torch.zeros(8)], [0.1])
    assert ops.launch_counts() == {"fused_mlp_q8": 0, "gemm_int8": 0,
                                   "flash_attention": 0, "linear_scan": 0,
                                   "rwkv6_scan": 0, "tiled_gemm": 0,
                                   "fused_dense": 0}


def test_non_cpu_tensor_never_reaches_plain(monkeypatch):
    """Any tensor off the CPU goes to the kernel wrapper, which refuses a
    tensor that is not on a CUDA device; the plain version is never
    called."""
    def forbidden(*a, **k):
        raise AssertionError("plain version reached")
    monkeypatch.setattr(fm, "fused_mlp_q8_plain", forbidden)
    monkeypatch.setattr(g8, "gemm_int8_plain", forbidden)
    x = torch.zeros((8, 16), dtype=torch.int8, device="meta")
    w = torch.zeros((16, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.gemm_int8(x, w, torch.ones(8, device="meta"), out_dtype=torch.float32)
    g = ops.pack_group([torch.zeros((16, 8), dtype=torch.int8)],
                       [torch.ones(8)], [torch.zeros(8)], [0.1])
    with pytest.raises(ValueError, match="CUDA device"):
        ops.fused_group(torch.zeros((8, 16), device="meta"), g)
    assert ops.launch_counts() == {"fused_mlp_q8": 0, "gemm_int8": 0,
                                   "flash_attention": 0, "linear_scan": 0,
                                   "rwkv6_scan": 0, "tiled_gemm": 0,
                                   "fused_dense": 0}


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m gpu tests/test_torch_kernels.py)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    for dims, m in (((16, 64, 32, 32, 5), 8), ((19, 45, 7, 33), 13)):
        ws, scs, bs, xs = _random_group(rng, list(dims))
        g = ops.pack_group([torch.from_numpy(w).to(dev) for w in ws],
                           [torch.from_numpy(s).to(dev) for s in scs],
                           [torch.from_numpy(b).to(dev) for b in bs], xs)
        x = torch.from_numpy(rng.normal(size=(m, dims[0]))
                             .astype(np.float32)).to(dev)
        torch.testing.assert_close(fm.fused_mlp_q8_cuda(x, g),
                                   fm.fused_mlp_q8_plain(x, g),
                                   rtol=1e-5, atol=1e-5)
    for m, k, n in GEMM_SHAPES + [(256, 1024, 1024)]:
        x, w, sw = (torch.from_numpy(a).to(dev)
                    for a in _gemm_inputs(rng, m, k, n))
        for out_dtype in (torch.float32, torch.bfloat16):
            got = ops.gemm_int8(x, w, sw, 0.07, out_dtype=out_dtype)
            want = g8.gemm_int8_plain(x, w, sw, 0.07, out_dtype=out_dtype)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=1e-5, atol=1e-5)
