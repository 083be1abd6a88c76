"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode.  Both get the same seeded numpy
inputs.  Tolerances: the fused group at the reference's own 1e-5
(``tests/test_fusion.py``); ``gemm_int8`` exact on the int32 accumulator,
1e-6 on f32 outputs (same arithmetic in the same order) and the reference's
1e-3/1e-2 on bf16 (``tests/test_kernels.py``).  The CUDA kernels'
arithmetic, emulated in torch from their packed layouts
(:func:`_fused_emulated`, :func:`_gemm_emulated`), is held equal to the
plain versions bit for bit.  The ``gpu`` test holds the CUDA kernels to the
plain versions on a card and skips without one.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_mlp as ref_fm
from repro.kernels import gemm_int8 as ref_g8
from repro.models import edge as ref_edge
from repro_torch import hw
from repro_torch.core import tiling
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import gemm_int8 as g8
from repro_torch.kernels import ops
from repro_torch.models import edge
from repro_torch.plan import plan_deployment
from test_torch_edge import H100_PLANS


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


def _nan_inf_case(rng):
    """A three-layer group whose scales are powers of two (every epilogue
    product and quotient is exact, so the reference's rounding of the
    multiply-add cannot differ) and a batch with NaN, +inf and -inf entries
    in the input; a NaN quantizes to 0 and +-inf to +-127 in the reference
    (``jnp.clip`` then the int8 cast)."""
    dims = [24, 40, 16, 8]
    ws = [rng.integers(-127, 128, (a, b)).astype(np.int8)
          for a, b in zip(dims[:-1], dims[1:])]
    scs = [np.float32(2.0) ** rng.integers(-9, -5, (b,)).astype(np.float32)
           for b in dims[1:]]
    bs = [rng.normal(size=(b,)).astype(np.float32) for b in dims[1:]]
    xs = np.float32([2.0 ** -4, 2.0 ** 3, 2.0 ** 4])
    x = rng.normal(scale=3.0, size=(13, dims[0])).astype(np.float32)
    x[0, :] = np.nan
    x[1, 3], x[1, 7] = np.inf, -np.inf
    x[2, ::2], x[2, 1::2] = np.nan, np.inf
    x[3, 5], x[3, 6], x[3, 9] = np.nan, -np.inf, np.inf
    x[4, :] = -np.inf
    return (ws, scs, bs, xs), x


@pytest.mark.parametrize("act_last", [False, True])
def test_fused_plain_maps_nan_and_inf_as_the_reference(act_last):
    """NaN quantizes to 0 and +-inf to +-127 at the entry, as the reference
    gives on the CPU: the plain version equals the Pallas kernel bit for
    bit, and the output is finite."""
    group, x = _nan_inf_case(np.random.default_rng(11))
    got, want = _both_fused(x, group, act_last=act_last)
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got, want)
    g = _pack_numpy(group, act_last=act_last)
    np.testing.assert_array_equal(
        _fused_emulated(torch.from_numpy(x), g).numpy(), got)


def test_pack_layout_round_trips():
    """The packed (np_i, kp_i) blocks hold each layer's weights transposed,
    with zero padding up to a multiple of 32 of the input width and of 16
    of the output width, and the scale and bias rows zero past the true
    width."""
    rng = np.random.default_rng(3)
    ws, scs, bs, xs = _random_group(rng, [19, 45, 7, 33])
    g = ops.pack_group([torch.from_numpy(w) for w in ws],
                       [torch.from_numpy(s) for s in scs],
                       [torch.from_numpy(b) for b in bs], xs)
    assert g.dims == (19, 45, 7, 33)
    for (wt, s, b), w, sc, bias, x_s in zip(g.layer_views(), ws, scs, bs, xs):
        k, n = w.shape
        assert wt.shape == (-(-n // 16) * 16, -(-k // 32) * 32)
        np.testing.assert_array_equal(wt[:n, :k].numpy(), w.T)
        assert not wt[:, k:].any() and not wt[n:].any()
        np.testing.assert_array_equal(s[:n].numpy(), sc * x_s)
        np.testing.assert_array_equal(b[:n].numpy(), bias)
        assert not s[n:].any() and not b[n:].any()
    # Widest padded input 64 (45 -> 64), plus the 16-byte skew.
    assert fm.buffer_stride(g.dims) == 64 + 16
    blocks = [48 * (32 + 16 + 8), 16 * (64 + 16 + 8), 48 * (32 + 16 + 8)]
    assert [b.nbytes for b in fm.layer_layout(g.dims)] == blocks
    assert g.pack.numel() == sum(blocks)
    assert fm.fused_smem_bytes(g.dims) == (fm.HEAD_BYTES + 2 * fm.ROWS * 80
                                           + sum(blocks))


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


def _fused_emulated(x, g, seed=0):
    """``csrc/fused_mlp_q8.cu``'s arithmetic, read from the pack: per CTA of
    ``ROWS`` rows, two int8 buffers of ``buffer_stride`` bytes a row whose
    bytes the kernel never writes stay stale (random here), the entry
    quantization into columns below ``kp_0``, then per layer the int32 sum
    of one fragment per 16 output columns and 32 K (the int8 mma), the
    epilogue ``acc * s + b`` as two roundings, ReLU, and the requantization
    into columns below ``np_i`` of the other buffer."""
    gen = torch.Generator().manual_seed(seed)
    layout = fm.layer_layout(g.dims)
    views = list(g.layer_views())
    hs, last = fm.buffer_stride(g.dims), g.n_layers - 1
    m = x.shape[0]
    out = torch.empty((m, g.dims[-1]), dtype=torch.float32)
    for r0 in range(0, m, fm.ROWS):
        rows = min(fm.ROWS, m - r0)
        bufs = [torch.randint(-128, 128, (fm.ROWS, hs), generator=gen,
                              dtype=torch.int8) for _ in range(2)]
        q = torch.zeros((fm.ROWS, layout[0].kp), dtype=torch.int8)
        q[:rows, :g.dims[0]] = fm._quantize(x[r0:r0 + rows], g.xs[0]) \
            .to(torch.int8)
        bufs[0][:, :layout[0].kp] = q
        for i, (blk, (wt, s, b)) in enumerate(zip(layout, views)):
            h_in, h_out = bufs[i % 2], bufs[(i + 1) % 2]
            acc = torch.zeros((blk.np, fm.ROWS), dtype=torch.int32)
            for t in range(0, blk.np, fm.N_MULTIPLE):
                for k in range(0, blk.kp, fm.K_MULTIPLE):
                    a = wt[t:t + 16, k:k + 32].to(torch.int32)
                    acc[t:t + 16] += a @ h_in[:, k:k + 32].to(torch.int32).t()
            y = acc.t().to(torch.float32) * s + b
            if g.relu and (i != last or g.act_last):
                y = torch.clamp_min(y, 0.0)
            if i == last:
                out[r0:r0 + rows] = y[:rows, :blk.n]
            else:
                h_out[:, :blk.np] = fm._quantize(y, g.xs[i + 1]) \
                    .to(torch.int8)
    return out


def _pack_numpy(group, **kw):
    ws, scs, bs, xs = group
    return ops.pack_group([torch.from_numpy(w) for w in ws],
                          [torch.from_numpy(s) for s in scs],
                          [torch.from_numpy(b) for b in bs], xs, **kw)


@pytest.mark.parametrize("name,m,act_last",
                         [(n, 8, False) for n in ref_edge.EDGE_NETS]
                         + [("odd", 13, False), ("odd", 13, True)])
def test_fused_emulation_equals_plain_and_pallas(name, m, act_last):
    """The kernel's fragment sums and stale padding give the plain version's
    output bit for bit, and the Pallas kernel's within its 1e-5 (interpret
    mode on the CPU rounds the epilogue's multiply-add once: up to one f32
    ulp off the plain version)."""
    if name == "odd":
        rng = np.random.default_rng(2)
        group = _random_group(rng, [19, 45, 7, 33])
        x = rng.normal(size=(m, 19)).astype(np.float32)
    else:
        group = _net_group(name)
        x = np.random.default_rng(1).normal(
            size=(m, group[0][0].shape[0])).astype(np.float32)
    g = _pack_numpy(group, act_last=act_last)
    got = _fused_emulated(torch.from_numpy(x), g)
    np.testing.assert_array_equal(
        got.numpy(), fm.fused_mlp_q8_plain(torch.from_numpy(x), g).numpy())
    _, want = _both_fused(x, group, act_last=act_last)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(ref_edge.EDGE_NETS))
def test_fused_smem_is_what_the_kernel_holds(name):
    """``fused_smem_bytes`` is the head, the two activation buffers and the
    pack's blocks (each 16-byte aligned, as the bulk copies need); every
    fusion group the h100 planner makes fits one block's shared memory, and
    the plan keys, tiles and groups stay as pinned."""
    cfg = edge.edge_config(name)
    dims = list(cfg.dims)
    layout = fm.layer_layout(dims)
    assert all(b.offset % 16 == 0 and b.nbytes % 16 == 0 for b in layout)
    assert layout[0].offset == 0
    assert [b.offset for b in layout[1:]] == [
        b.offset + b.nbytes for b in layout[:-1]]
    g = _pack_numpy(_net_group(name))
    assert g.pack.numel() == sum(b.nbytes for b in layout)
    assert fm.buffer_stride(dims) == max(b.kp for b in layout) + fm.SKEW
    assert g.smem_bytes == fm.fused_smem_bytes(dims) == (
        36 * fm.MAX_LAYERS + 2 * fm.ROWS * fm.buffer_stride(dims)
        + g.pack.numel())
    plan = plan_deployment(cfg, device="cpu")
    for group in plan.fusion_groups:
        lo, hi = group.layers[0], group.layers[-1]
        assert group.vmem_bytes == fm.fused_smem_bytes(dims[lo:hi + 2])
        assert group.vmem_bytes <= hw.H100_SXM.smem_bytes
    key, tiles, groups = H100_PLANS[name]
    assert plan.key == key
    assert [l.api_tile for l in plan.layers] == tiles
    assert plan.groups() == groups


def test_fused_contract_refuses_a_group_over_shared_memory():
    x = torch.zeros((8, 512), device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        fm.fused_mlp_q8_contract(x, [512] + [512] * 4)
    assert fm.fused_mlp_q8_contract(x, [512, 64])[0] == (8, 64)


def _gemm_emulated(x, w, sw, x_scale, blocks, out_dtype):
    """``csrc/gemm_int8.cu``'s arithmetic: per (block_m, block_n) tile and
    block_k stage, the x tile and the transposed w tile zero past the
    ragged edge, the int32 sum of one fragment per 32 K (the int8 mma,
    16 columns by 8 rows each), then the flush ``acc * (sx * sw[n])``."""
    bm, bk, bn = blocks
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype)
    scale = torch.full((), x_scale, dtype=torch.float32) * sw
    for m0 in range(0, m, bm):
        for n0 in range(0, n, bn):
            acc = torch.zeros((bn, bm), dtype=torch.int32)
            for k0 in range(0, k, bk):
                xt = torch.zeros((bm, bk), dtype=torch.int32)
                wt = torch.zeros((bn, bk), dtype=torch.int32)
                xb = x[m0:m0 + bm, k0:k0 + bk]
                wb = w[k0:k0 + bk, n0:n0 + bn].t()
                xt[:xb.shape[0], :xb.shape[1]] = xb
                wt[:wb.shape[0], :wb.shape[1]] = wb
                for kk in range(0, bk, 32):
                    acc += wt[:, kk:kk + 32] @ xt[:, kk:kk + 32].t()
            rows, cols = min(bm, m - m0), min(bn, n - n0)
            v = acc.t()[:rows, :cols].to(torch.float32) * \
                scale[n0:n0 + cols]
            out[m0:m0 + rows, n0:n0 + cols] = v.to(out_dtype)
    return out


EDGE_GEMM_SHAPES = sorted({(8, k, n) for name in ref_edge.EDGE_NETS
                           for k, n in ref_edge.edge_config(name)
                           .layer_shapes})


@pytest.mark.parametrize("m,k,n", EDGE_GEMM_SHAPES + [(33, 100, 130)])
def test_gemm_emulation_equals_plain_and_pallas(m, k, n):
    x, w, sw = _gemm_inputs(np.random.default_rng(7), m, k, n)
    tx, tw, tsw = (torch.from_numpy(a) for a in (x, w, sw))
    blocks = tiling.plan_api(m, k, n).blocks
    for out_dtype in ("float32", "bfloat16"):
        got = _gemm_emulated(tx, tw, tsw, 0.07, blocks,
                             getattr(torch, out_dtype))
        plain = g8.gemm_int8_plain(tx, tw, tsw, 0.07,
                                   out_dtype=getattr(torch, out_dtype))
        want = ref_g8.gemm_int8(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(sw), 0.07,
                                out_dtype=getattr(jnp, out_dtype),
                                interpret=True)
        np.testing.assert_array_equal(got.float().numpy(),
                                      plain.float().numpy())
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_gemm_smem_is_the_kernels_ring():
    """Three stages of the x tile and the transposed w tile, every row
    padded by 16 bytes; every tile fits one block (the kernel opts in above
    48 KB)."""
    assert tiling.smem_bytes(8, 32, 32) == 3 * (8 + 32) * (32 + 16)
    assert tiling.smem_bytes(64, 128, 128) == 3 * (64 + 128) * (128 + 16)
    for tile in itertools.product(tiling.BLOCK_M, tiling.BLOCK_K,
                                  tiling.BLOCK_N):
        assert tiling.smem_bytes(*tile) <= hw.H100_SXM.smem_bytes


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
                                   "fused_dense": 0,
                                   "flash_attention_bwd": 0,
                                   "rwkv6_scan_bwd": 0}


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
                                   "fused_dense": 0,
                                   "flash_attention_bwd": 0,
                                   "rwkv6_scan_bwd": 0}


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    """f32 outputs exactly equal to the plain versions (exact int8 sums, the
    same f32 epilogue); bf16 within the plain version's 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m gpu tests/test_torch_kernels.py)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def on_card(group, **kw):
        ws, scs, bs, xs = group
        return ops.pack_group([torch.from_numpy(w).to(dev) for w in ws],
                              [torch.from_numpy(s).to(dev) for s in scs],
                              [torch.from_numpy(b).to(dev) for b in bs], xs,
                              **kw)

    groups = [(name, on_card(_net_group(name)), (1, 8, 13, 40))
              for name in ref_edge.EDGE_NETS]
    odd = _random_group(rng, [19, 45, 7, 33])
    groups += [(f"odd act_last={a}", on_card(odd, act_last=a), (13,))
               for a in (False, True)]
    # Staged weights past 48 KB (the pack is 103,168 bytes).
    wide = on_card(_random_group(rng, [200, 200, 200]))
    assert wide.pack.numel() > 48 * 1024
    groups.append(("wide", wide, (8, 13)))
    for what, g, ms in groups:
        for m in ms:
            x = torch.from_numpy(rng.normal(size=(m, g.dims[0]))
                                 .astype(np.float32)).to(dev)
            torch.testing.assert_close(fm.fused_mlp_q8_cuda(x, g),
                                       fm.fused_mlp_q8_plain(x, g),
                                       rtol=0, atol=0, msg=f"{what} M={m}")
    # NaN quantizes to 0 and +-inf to +-127, as the plain version and the
    # reference give (test_fused_plain_maps_nan_and_inf_as_the_reference).
    group, x = _nan_inf_case(np.random.default_rng(11))
    for act_last in (False, True):
        g, xd = on_card(group, act_last=act_last), torch.from_numpy(x).to(dev)
        torch.testing.assert_close(fm.fused_mlp_q8_cuda(xd, g),
                                   fm.fused_mlp_q8_plain(xd, g), rtol=0,
                                   atol=0, msg=f"NaN/inf act_last={act_last}")
    # The kernel's division against IEEE division: a one-layer identity
    # group (act none, unit weight scales) returns q * xs, so a quotient
    # rounded another way shows.  Inputs: every half-integer quotient
    # (rint's ties) and two f32 steps either side, zeros of both signs,
    # values past the clip, tiny and huge ones, then random ones.
    k = 128
    eye = torch.eye(k, dtype=torch.int8, device=dev)
    for xs0 in rng.uniform(1e-3, 10.0, 16).astype(np.float32):
        g = ops.pack_group([eye], [torch.ones(k, device=dev)],
                           [torch.zeros(k, device=dev)], [float(xs0)],
                           act="none")
        half = (np.arange(-140, 140, dtype=np.float32) + 0.5) * xs0
        up, down = np.nextafter(half, np.inf), np.nextafter(half, -np.inf)
        vals = np.concatenate([
            half, up, down, np.nextafter(up, np.inf),
            np.nextafter(down, -np.inf),
            np.float32([0.0, -0.0, 1e-30, -1e-30, 2.0 ** -61, 1e30, -1e30,
                        np.inf, -np.inf])])
        x = rng.normal(scale=60.0 * xs0, size=40 * k).astype(np.float32)
        x[:vals.size] = vals
        x = torch.from_numpy(x.reshape(40, k)).to(dev)
        torch.testing.assert_close(fm.fused_mlp_q8_cuda(x, g),
                                   fm.fused_mlp_q8_plain(x, g), rtol=0,
                                   atol=0, msg=f"division at xs={xs0}")

    def gemm_case(x, w, sw, blocks, out_dtype):
        got = g8.gemm_int8_cuda(x, w, sw, 0.07, block_m=blocks[0],
                                block_k=blocks[1], block_n=blocks[2],
                                out_dtype=out_dtype)
        want = g8.gemm_int8_plain(x, w, sw, 0.07, out_dtype=out_dtype)
        tol = 0 if out_dtype == torch.float32 else 1e-5
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"{tuple(x.shape)} "
                                   f"@ {tuple(w.shape)} {blocks} {out_dtype}")

    for m, k, n in GEMM_SHAPES + EDGE_GEMM_SHAPES + [(256, 1024, 1024)]:
        x, w, sw = (torch.from_numpy(a).to(dev)
                    for a in _gemm_inputs(rng, m, k, n))
        for out_dtype in (torch.float32, torch.bfloat16):
            gemm_case(x, w, sw, tiling.plan_api(m, k, n).blocks, out_dtype)
    x, w, sw = (torch.from_numpy(a).to(dev)
                for a in _gemm_inputs(rng, 33, 100, 130))
    for blocks in itertools.product(tiling.BLOCK_M, tiling.BLOCK_K,
                                    tiling.BLOCK_N):
        for out_dtype in (torch.float32, torch.bfloat16):
            gemm_case(x, w, sw, blocks, out_dtype)
    # Aligned rows (K % 16 == 0, N % 4 == 0: the cp.async and word paths)
    # over every tile, with ragged M and N edges.
    x, w, sw = (torch.from_numpy(a).to(dev)
                for a in _gemm_inputs(rng, 70, 160, 196))
    for blocks in itertools.product(tiling.BLOCK_M, tiling.BLOCK_K,
                                    tiling.BLOCK_N):
        gemm_case(x, w, sw, blocks, torch.float32)
