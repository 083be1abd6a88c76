"""Gradients through the port's kernels, against the JAX package.

``ops.flash_attention`` and ``ops.linear_scan`` run as autograd Functions
where grad is on; on the CPU their backward is the plain backward
(``flash_attention_bwd_plain``, ``linear_scan_bwd_plain``), the same
Function, saved tensors and formulas as the card runs.  The same seeded
numpy inputs go through ``jax.vjp`` of the reference's oracles
(``repro.kernels.ref.attention``, ``ref.linear_scan``) and through the
port.  Tolerances: f32 gradients within 2e-5 of the largest reference
gradient (both sides sum f32 products in other orders; the backward's
scale is O(1) values over at most 64 keys), the scan's within 1e-5.  The
kernels without a backward raise on grad on every device, and the serve
paths record nothing.  The ``gpu`` cases hold the CUDA backward to the
plain one on a card (1e-5 of the largest value in f32; 2e-2 in bf16, where
the tensor-core path rounds P and dS to bf16 before their products and
every output to bf16) and need no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ops, rglru
from repro_torch.models import api

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref
except ImportError:          # the card's machine has no JAX
    jax = None

needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX package")
TOL_F32 = 2e-5
TOL_SCAN = 1e-5
TOL_CARD = {"float32": 1e-5, "bfloat16": 2e-2}

# (name, (B, Hq, Hkv, S, Sk, D), options)
FLASH_CASES = [
    ("causal", (1, 2, 2, 24, 24, 16), dict(causal=True)),
    ("window", (2, 4, 4, 40, 40, 16), dict(causal=True, window=9)),
    ("softcap", (1, 2, 2, 33, 33, 16), dict(causal=True, softcap=5.0)),
    ("gqa2_window_softcap", (1, 4, 2, 40, 40, 64),
     dict(causal=True, window=16, softcap=2.0)),
    ("gqa4", (1, 8, 2, 20, 20, 16), dict(causal=True)),
    ("mqa", (1, 6, 1, 30, 30, 16), dict(causal=True, window=8)),
    ("noncausal_ragged", (2, 4, 2, 17, 45, 16), dict(causal=False)),
    ("d192_scale", (1, 2, 1, 12, 12, 192), dict(causal=True, scale=0.05)),
    # Rows at or past Sk + window see no key: zero mass, zero gradients.
    ("zero_mass_rows", (1, 2, 2, 30, 8, 16), dict(causal=True, window=4)),
]


def _qkvg(shape, seed=0):
    b, hq, hkv, s, sk, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32) for sh in
            ((b, hq, s, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, s, d))]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|err| {err:.3e} > {tol} * {scale:.3e}"


def _port_grads(q, k, v, g, kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*ts, **kw)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    return out.detach(), [x.numpy() for x in grads]


@needs_reference
@pytest.mark.parametrize("name,shape,kw", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_backward_matches_jax_grad(name, shape, kw):
    q, k, v, g = _qkvg(shape)
    out, grads = _port_grads(q, k, v, g, kw)

    @jax.jit
    def ref_vjp(a, b, c, cot):
        o, vjp = jax.vjp(lambda x, y, z: ref.attention(x, y, z, **kw),
                         a, b, c)
        return o, vjp(cot)
    want_out, want = ref_vjp(*(jnp.asarray(x) for x in (q, k, v, g)))
    _close(out.numpy(), want_out, TOL_F32)
    for got, w in zip(grads, want):
        _close(got, w, TOL_F32)
    if name == "zero_mass_rows":
        assert not out[:, :, 12:].any() and not grads[0][:, :, 12:].any()


@pytest.mark.parametrize("name,shape,kw", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_backward_matches_autograd_of_plain(name, shape, kw):
    """The written-out backward against autograd of the plain forward."""
    q, k, v, g = _qkvg(shape, seed=1)
    _, grads = _port_grads(q, k, v, g, kw)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_plain(*ts, **kw), ts,
                               torch.from_numpy(g))
    for got, w in zip(grads, want):
        _close(got, w.numpy(), TOL_F32)


def test_flash_backward_refuses_a_query_offset():
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg((1, 2, 2, 8, 16, 16)))
    with pytest.raises(ValueError, match="q_offset"):
        fb.flash_attention_bwd_plain(q, k, v, q, g, q_offset=4)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q.requires_grad_(), k, v, q_offset=4)
    with torch.no_grad():       # chunked prefill, as served
        assert ops.flash_attention(q, k, v, q_offset=4).grad_fn is None


def test_flash_backward_work_record():
    """10 D flops a kept pair and query head; five tensors read, three
    written, two f32 statistics."""
    flops, nbytes = fb.work(2, 8, 4, 64, 64, 32, 2, causal=True, window=16)
    pairs = fa.band_pairs(64, 64, causal=True, window=16, q_offset=0)
    assert flops == 10 * 32 * pairs * 2 * 8
    assert nbytes == 2 * (4 * 2 * 8 * 64 * 32 + 4 * 2 * 4 * 64 * 32) \
        + 4 * 2 * 2 * 8 * 64


@needs_reference
@pytest.mark.parametrize("t", [1, 2, 7, 300])
def test_linear_scan_backward_matches_jax_grad(t):
    rng = np.random.default_rng(t)
    a = rng.uniform(0.3, 0.99, (2, t, 24)).astype(np.float32)
    b, g = (rng.standard_normal((2, t, 24)).astype(np.float32)
            for _ in range(2))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    h = ops.linear_scan(ta, tb)
    got = torch.autograd.grad(h, (ta, tb), torch.from_numpy(g))
    want_h, vjp = jax.vjp(ref.linear_scan, jnp.asarray(a), jnp.asarray(b))
    _close(h.detach().numpy(), want_h, TOL_SCAN)
    for x, w in zip(got, vjp(jnp.asarray(g))):
        _close(x.numpy(), w, TOL_SCAN)


def test_linear_scan_backward_is_the_reversed_scan():
    """The card's formulation (the forward scan over flipped (a_{t+1}, g))
    equals the plain reversed loop on the CPU."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.3, 0.99, (3, 50, 8))
                         .astype(np.float32))
    h = rglru.linear_scan_plain(a, torch.from_numpy(
        rng.standard_normal((3, 50, 8)).astype(np.float32)))
    g = torch.from_numpy(rng.standard_normal((3, 50, 8)).astype(np.float32))
    lam = torch.flip(rglru.linear_scan_plain(
        torch.flip(rglru._next(a), [1]), torch.flip(g, [1])), [1])
    da, db = rglru.linear_scan_bwd_plain(a, h, g)
    assert torch.equal(db, lam)
    assert torch.equal(da, rglru._grads(a, h, lam)[0])


def _refusal_calls():
    def f32(*shape):
        return torch.randn(shape, requires_grad=True)
    w8 = torch.randint(-127, 128, (16, 8), dtype=torch.int8)
    return {
        "rwkv6_scan": lambda: ops.rwkv6_scan(
            f32(2, 4, 8), f32(2, 4, 8), f32(2, 4, 8),
            torch.rand(2, 4, 8), torch.randn(1, 8)),
        "fused_mlp_q8": lambda: ops.fused_mlp_q8(
            f32(8, 16), [w8], [torch.ones(8)], [torch.zeros(8)], [0.1]),
        "gemm_int8": lambda: ops.gemm_int8(
            torch.randint(-127, 128, (8, 16), dtype=torch.int8), w8,
            torch.ones(8, requires_grad=True), out_dtype=torch.float32),
        "tiled_gemm": lambda: ops.tiled_gemm(f32(8, 16), torch.randn(16, 8)),
        "fused_dense": lambda: ops.fused_dense(f32(8, 16),
                                               torch.randn(16, 8),
                                               torch.zeros(8)),
    }


@pytest.mark.parametrize("kernel", sorted(_refusal_calls()))
def test_kernels_without_backward_refuse_grad(kernel):
    call = _refusal_calls()[kernel]
    with pytest.raises(RuntimeError, match=f"{kernel}: the kernel has no "
                                           f"backward"):
        call()
    with torch.no_grad():
        call()


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "gemma2_2b",
                                  "whisper_medium", "rwkv6_7b"])
def test_serve_paths_record_no_autograd_graph(arch):
    """Params that do not require grad (as served) record nothing, with
    grad mode on: no output carries a grad_fn, and no Function ran."""
    cfg = configs.get(arch).smoke
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": np.arange(24, dtype=np.int32).reshape(2, 12)
             % cfg.vocab_size}
    if cfg.family == "encdec":
        batch["encoder_frames"] = np.zeros(
            (2, cfg.encdec.encoder_len, cfg.d_model), np.float32)
    assert torch.is_grad_enabled()
    out = api.forward(params, cfg, batch)
    assert all(not t.requires_grad and t.grad_fn is None
               for t in out.values())
    state = api.init_decode_state(cfg, 2, 16, device="cpu")
    logits, new = api.decode_step(params, cfg, batch["tokens"][:, :1],
                                  state, 0)
    assert logits.grad_fn is None


@pytest.mark.parametrize("arch", ["gemma2_2b", "recurrentgemma_2b"])
def test_logit_softcap_is_out_of_place_under_grad(arch):
    """The served logits soft-cap in place; where autograd records, the
    cap is out of place and its gradient flows."""
    cfg = dataclasses.replace(configs.get(arch).smoke, dtype="float32")
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for leaf in [params["emb"]]:
        leaf.requires_grad_()
    out = api.forward(params, cfg, {"tokens": np.ones((1, 5), np.int32)})
    (g,) = torch.autograd.grad(out["logits"].sum(), [params["emb"]])
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    with torch.no_grad():
        ref_logits = api.forward(params, cfg,
                                 {"tokens": np.ones((1, 5), np.int32)})
    assert torch.equal(ref_logits["logits"], out["logits"].detach())


# ---------------------------------------------------------------------------
# On a card: the CUDA backward against the plain backward
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: "
                    "python -m pytest -m gpu "
                    "tests/test_torch_train_kernels.py)")
    return torch.device("cuda")


CARD_CASES = FLASH_CASES + [
    ("d256_gqa_window_softcap", (1, 8, 4, 200, 200, 256),
     dict(causal=True, window=64, softcap=50.0)),
    ("d128_gqa8", (1, 16, 2, 130, 130, 128), dict(causal=True)),
    ("d64_cross", (1, 4, 4, 40, 150, 64), dict(causal=False)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,kw", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_flash_backward_cuda_matches_plain_on_card(cuda_device, name, shape,
                                                   kw, dtype):
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(a).to(cuda_device, dt)
                  for a in _qkvg(shape, seed=2))
    o = fa.flash_attention_cuda(q, k, v, **kw)
    before = fb.launches
    got = fb.flash_attention_bwd_cuda(q, k, v, o, g, **kw)
    want = fb.flash_attention_bwd_plain(q, k, v, o, g, **kw)
    torch.cuda.synchronize()
    assert fb.launches == before + 1
    for x, w in zip(got, want):
        assert x.dtype == dt and x.shape == w.shape
        _close(x.float().cpu().numpy(), w.float().cpu().numpy(),
               TOL_CARD[dtype])


@pytest.mark.gpu
def test_flash_function_on_card_takes_head_transposed_views(cuda_device):
    """The model's (B, S, H, D) projections viewed as (B, H, S, D), through
    the autograd Function, against autograd of the plain forward."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = [torch.randn((2, 70, h, 64), generator=gen, device=cuda_device)
         for h in (4, 2, 2)]
    ts = [t.transpose(1, 2).requires_grad_() for t in
          (a.clone().requires_grad_() for a in x)]
    kw = dict(causal=True, window=20, softcap=30.0)
    g = torch.randn((2, 4, 70, 64), generator=gen, device=cuda_device)
    got = torch.autograd.grad(ops.flash_attention(*ts, **kw), ts, g)
    want = torch.autograd.grad(fa.flash_attention_plain(*ts, **kw), ts, g)
    for a, b in zip(got, want):
        _close(a.cpu().numpy(), b.cpu().numpy(), TOL_CARD["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 100, 300, 2048])
def test_linear_scan_backward_cuda_matches_plain_on_card(cuda_device, t):
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    a = torch.rand((2, t, 256), generator=gen, device=cuda_device) * 0.5 \
        + 0.45
    b = torch.randn((2, t, 256), generator=gen, device=cuda_device)
    h = rglru.linear_scan_cuda(a, b)
    g = torch.randn((2, t, 256), generator=gen, device=cuda_device)
    got = rglru.linear_scan_bwd_cuda(a, h, g)
    want = rglru.linear_scan_bwd_plain(a, h, g)
    for x, w in zip(got, want):
        _close(x.cpu().numpy(), w.cpu().numpy(), 1e-4)
