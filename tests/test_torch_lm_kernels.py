"""The port's LM kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, or the function the model path
actually calls (``layers.chunked_attention``, ``griffin._rglru_assoc``).
Both get the same seeded numpy inputs.  Tolerances are the reference's own
(``tests/test_kernels.py``): attention 2e-3 in f32 and 3e-2 in bf16, the
scan 1e-4.  The ``gpu`` tests hold the CUDA kernels to the plain versions on
a card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.models import griffin as ref_griffin
from repro.models import layers as ref_layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as rg

TOL = {"float32": 2e-3, "bfloat16": 3e-2}


def _qkv(seed, b, hq, hkv, s, d, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.normal(size=(b, hq, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


def _port(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _jax(arrs, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


FLASH_CASES = [
    ("causal", dict(b=2, hq=4, hkv=4, s=128, d=32), dict(causal=True)),
    ("window", dict(b=1, hq=2, hkv=2, s=128, d=32),
     dict(causal=True, window=40)),
    ("softcap", dict(b=1, hq=2, hkv=2, s=128, d=32),
     dict(causal=True, softcap=30.0)),
    ("gqa", dict(b=2, hq=4, hkv=2, s=128, d=32), dict(causal=True)),
    ("gqa_window_softcap", dict(b=1, hq=8, hkv=2, s=128, d=64),
     dict(causal=True, window=48, softcap=50.0)),
    ("ragged_causal", dict(b=1, hq=2, hkv=1, s=100, d=32), dict(causal=True)),
    ("mqa_ragged_window", dict(b=1, hq=10, hkv=1, s=70, d=16),
     dict(causal=True, window=16)),
    # The transformer family's head dim 128: qwen2.5's group of 8 on a
    # global layer, gemma2-27b's global softcap and its local window.
    ("d128_gqa8", dict(b=1, hq=16, hkv=2, s=128, d=128), dict(causal=True)),
    ("d128_global_softcap", dict(b=1, hq=4, hkv=2, s=100, d=128),
     dict(causal=True, softcap=50.0)),
    ("d128_window_softcap", dict(b=1, hq=4, hkv=2, s=160, d=128),
     dict(causal=True, window=64, softcap=50.0)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,kw", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_matches_pallas(name, shape, kw, dtype):
    arrs = _qkv(0, **shape)
    want = ref_ops.flash_attention(*_jax(arrs, dtype), block_q=64,
                                   block_kv=64, interpret=True, **kw)
    got = ops.flash_attention(*_port(arrs, dtype), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("name,shape,kw", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_matches_chunked_attention(name, shape, kw):
    """The function the model path replaces: ``chunked_attention`` at
    ``q_offset = 0``."""
    arrs = _qkv(1, **shape)
    want = ref_layers.chunked_attention(*_jax(arrs, "float32"), chunk=32,
                                        **kw)
    got = ops.flash_attention(*_port(arrs, "float32"), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_flash_plain_longer_keys_matches_chunked_attention():
    """A cache prefill: queries at positions 0..S-1 against a longer,
    partly written key buffer (Sk > S)."""
    arrs = _qkv(2, b=2, hq=4, hkv=1, s=20, d=16, sk=32)
    arrs[1][:, :, 20:] = 0.0
    arrs[2][:, :, 20:] = 0.0
    kw = dict(causal=True, window=8)
    want = ref_layers.chunked_attention(*_jax(arrs, "float32"), chunk=16,
                                        **kw)
    got = ops.flash_attention(*_port(arrs, "float32"), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


# A chunk of a prompt after q_offset cached keys: (shape, options, offsets).
Q_OFFSET_CASES = [
    ("chunk8_window", dict(b=1, hq=4, hkv=1, s=8, d=32, sk=56),
     dict(causal=True, window=24), (0, 1, 23, 24, 48)),
    ("chunk8_softcap_gqa", dict(b=2, hq=4, hkv=2, s=8, d=16, sk=40),
     dict(causal=True, window=16, softcap=30.0), (0, 5, 32)),
    ("chunk13_causal", dict(b=1, hq=2, hkv=2, s=13, d=16, sk=77),
     dict(causal=True), (0, 17, 64)),
    # A transformer prefill over its max_len buffer: group 8 at D = 128,
    # keys past the chunk masked by causal.
    ("chunk8_d128_gqa8_buffer", dict(b=1, hq=16, hkv=2, s=8, d=128, sk=96),
     dict(causal=True), (0, 40, 88)),
]


@pytest.mark.parametrize("name,shape,kw,offsets", Q_OFFSET_CASES,
                         ids=[c[0] for c in Q_OFFSET_CASES])
def test_flash_plain_q_offset_matches_chunked_attention(name, shape, kw,
                                                        offsets):
    """Queries at key positions ``q_offset + i`` against the reference's
    ``chunked_attention(q_offset=...)``, at the model path's 2e-3; keys past
    a query's position are masked by ``causal``, so the buffer may hold
    more keys than the chunk reaches."""
    arrs = _qkv(21, **shape)
    for off in offsets:
        want = ref_layers.chunked_attention(*_jax(arrs, "float32"), chunk=16,
                                            q_offset=off, **kw)
        got = ops.flash_attention(*_port(arrs, "float32"), q_offset=off,
                                  **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=2e-3, err_msg=f"q_offset={off}")


@pytest.mark.parametrize("q_offset", [-1, 1.0, fa.MAX_POSITION - 7,
                                      torch.tensor(3)])
def test_flash_refuses_a_q_offset_it_cannot_honour(q_offset):
    """A negative, non-int or too large offset is refused on every device:
    the CUDA wrapper raises before it launches, as the plain version does."""
    q, k, v = _port(_qkv(22, b=1, hq=2, hkv=1, s=8, d=8), "float32")
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=q_offset)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_cuda(q, k, v, q_offset=q_offset)


@pytest.mark.parametrize("s", [100, 77])
def test_flash_plain_noncausal_ragged_matches_ref(s):
    """Non-causal with a ragged S, against the quadratic oracle.  The Pallas
    kernel is off here: it zero-pads K/V to its block and masks the pad only
    through ``causal``, so padded keys carry mass (max err 0.082 at S=100,
    blocks 64).  The port masks keys past Sk in every mode."""
    arrs = _qkv(3, b=1, hq=2, hkv=1, s=s, d=32)
    want = ref.attention(*_jax(arrs, "float32"), causal=False)
    got = ops.flash_attention(*_port(arrs, "float32"), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_flash_zero_mass_rows_are_zero():
    """Rows whose window holds no key (queries past a short key buffer)
    output 0, not NaN."""
    q, k, v = _port(_qkv(4, b=1, hq=1, hkv=1, s=8, d=8), "float32")
    # Three keys, window 2: rows 4.. see no key.
    out = ops.flash_attention(q, k[:, :, :3], v[:, :, :3], causal=True,
                              window=2)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0, 0, 4:], torch.zeros_like(out[0, 0, 4:]))
    assert out[0, 0, :4].abs().sum() > 0


@pytest.mark.parametrize("kw,match", [
    (dict(window=0), "window"),
    (dict(softcap=0.0), "softcap"),
])
def test_flash_refuses_bad_options_on_every_device(kw, match):
    q, k, v = _port(_qkv(5, b=1, hq=2, hkv=1, s=8, d=8), "float32")
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v, **kw)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; they never fall back."""
    q, k, v = _port(_qkv(6, b=1, hq=2, hkv=1, s=8, d=8), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    a = torch.rand((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        rg.linear_scan_cuda(a, a)


# ---------------------------------------------------------------------------
# The bf16 kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def _load_chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The card's bf16 limit against the plain version (chip_smoke.TOL_FLASH).
TOL_FLASH_CARD = _load_chip_smoke().TOL_FLASH["bfloat16"]


def _flash_tc_emulated(q, k, v, *, causal=True, window=None, softcap=None,
                       q_offset=0, block_kv=64):
    """``csrc/flash_attention.cu``'s bf16 tensor-core arithmetic in torch:
    f32 logits, the online softmax over 64-key tiles, P rounded to bf16
    before P V (f32 accumulation), l summing the unrounded P."""
    b, hq, s_q, d = q.shape
    s_k = k.shape[2]
    group = hq // k.shape[1]
    scale = 1.0 / np.sqrt(d)
    kx = k.float().repeat_interleave(group, dim=1)
    vx = v.float().repeat_interleave(group, dim=1)
    qf = q.float()
    m = torch.full((b, hq, s_q, 1), fa.NEG)
    l = torch.zeros((b, hq, s_q, 1))
    o = torch.zeros((b, hq, s_q, d))
    q_pos = q_offset + torch.arange(s_q)[:, None]
    for k_lo in range(0, s_k, block_kv):
        k_pos = torch.arange(k_lo, min(k_lo + block_kv, s_k))[None, :]
        x = qf @ kx[:, :, k_lo:k_lo + block_kv].transpose(-1, -2) * scale
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        ok = torch.ones_like(x, dtype=torch.bool)
        if causal:
            ok &= k_pos <= q_pos
        if window is not None:
            ok &= k_pos > q_pos - window
        x = torch.where(ok, x, -torch.inf)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True).clamp_min(
            fa.NEG))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vx[
            :, :, k_lo:k_lo + block_kv]
        m = m_new
    return (o / torch.where(l == 0, 1.0, l)).to(q.dtype)


@pytest.mark.parametrize("name,shape,kw", FLASH_CASES + [
    ("served_cut", dict(b=1, hq=10, hkv=1, s=512, d=256),
     dict(causal=True, window=256)),
    ("chunk_at_offset", dict(b=1, hq=10, hkv=1, s=8, d=256, sk=264),
     dict(causal=True, window=256, softcap=30.0, q_offset=256))],
    ids=[c[0] for c in FLASH_CASES] + ["served_cut", "chunk_at_offset"])
def test_flash_bf16_p_rounding_holds_the_card_tolerance(name, shape, kw):
    """The bf16 kernel rounds P to bf16 before P V, as every tensor-core
    flash does.  Its arithmetic, emulated here, stays within the card's
    bf16 limit of the plain version and within the reference's 3e-2 of the
    JAX oracle."""
    arrs = _qkv(13, **shape)
    q, k, v = _port(arrs, "bfloat16")
    got = _flash_tc_emulated(q, k, v, **kw).float()
    want = fa.flash_attention_plain(q, k, v, **kw).float()
    rtol, atol = TOL_FLASH_CARD
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    if "q_offset" in kw:   # ref.attention takes no offset
        oracle = ref_layers.chunked_attention(*_jax(arrs, "bfloat16"),
                                              chunk=64, **kw)
    else:
        oracle = ref.attention(*_jax(arrs, "bfloat16"), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle, np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


# ---------------------------------------------------------------------------
# linear_scan
# ---------------------------------------------------------------------------

def _ab(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.4, 0.999, shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("t,block_t", [(64, 16), (100, 32), (1, 1)])
def test_linear_scan_plain_matches_pallas(t, block_t):
    a, b = _ab(7, (2, t, 128))
    want = ref_ops.linear_scan(jnp.asarray(a), jnp.asarray(b),
                               block_t=block_t, interpret=True)
    got = ops.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("t", [1, 37])
def test_linear_scan_with_fold_matches_rglru_assoc(t, with_h0):
    """The model's use: ``_rglru_assoc``, the state folded into b[:, 0]
    exactly as ``models/griffin.py::rglru`` does before the kernel."""
    a, b = _ab(8, (3, t, 64))
    h0 = np.random.default_rng(9).normal(size=(3, 64)).astype(np.float32)
    want = ref_griffin._rglru_assoc(jnp.asarray(a), jnp.asarray(b),
                                    h0=jnp.asarray(h0) if with_h0 else None)
    bt = torch.from_numpy(b.copy())
    if with_h0:
        bt[:, 0] += torch.from_numpy(a[:, 0]) * torch.from_numpy(h0)
    got = ops.linear_scan(torch.from_numpy(a), bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _two_pass_emulated(a, b, chunk=64):
    """``csrc/linear_scan.cu``'s two-pass chunked scan in f32 torch, in the
    kernel's order: pass 1 walks every chunk but the last from h = 0 and
    keeps (prod a, h at its end); pass 2 folds the earlier chunks'
    aggregates into the carry, h = A h + B in chunk order, then walks its
    chunk from the carry.  Every step multiplies, then adds."""
    a32, b32 = a.float(), b.float()
    bsz, t_len, d = a.shape
    n_chunks = -(-t_len // chunk)
    agg = []
    for c in range(n_chunks - 1):
        prod, h = torch.ones(bsz, d), torch.zeros(bsz, d)
        for t in range(c * chunk, (c + 1) * chunk):
            prod = a32[:, t] * prod
            h = a32[:, t] * h + b32[:, t]
        agg.append((prod, h))
    out = torch.empty_like(a32)
    for c in range(n_chunks):
        h = torch.zeros(bsz, d)
        for prod, end in agg[:c]:
            h = prod * h + end
        for t in range(c * chunk, min((c + 1) * chunk, t_len)):
            h = a32[:, t] * h + b32[:, t]
            out[:, t] = h
    return out.to(a.dtype)


@pytest.mark.parametrize("b,t", [(3, 63), (3, 64), (3, 65), (2, 3000)])
def test_linear_scan_two_pass_matches_pallas(b, t):
    """B > 1 and T below, equal to and one past the chunk, and the ragged
    3000-step prefill: the kernel's carries against the Pallas kernel
    (interpret mode) and the sequential plain version, to the reference's
    1e-4.  The first two chunks equal the sequential walk bit for bit."""
    a, bb = _ab(15, (b, t, 128))
    got = _two_pass_emulated(torch.from_numpy(a), torch.from_numpy(bb))
    want = ref_ops.linear_scan(jnp.asarray(a), jnp.asarray(bb),
                               block_t=min(t, 256), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    plain = rg.linear_scan_plain(torch.from_numpy(a), torch.from_numpy(bb))
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[:, :128], plain[:, :128])


@pytest.mark.parametrize("t", [65, 3000])
def test_linear_scan_two_pass_with_fold_matches_rglru_assoc(t):
    """The model's use, a state folded into b[:, 0], against
    ``griffin._rglru_assoc`` with that state as h0."""
    a, b = _ab(16, (2, t, 64))
    h0 = np.random.default_rng(17).normal(size=(2, 64)).astype(np.float32)
    want = ref_griffin._rglru_assoc(jnp.asarray(a), jnp.asarray(b),
                                    h0=jnp.asarray(h0))
    bt = torch.from_numpy(b.copy())
    bt[:, 0] += torch.from_numpy(a[:, 0]) * torch.from_numpy(h0)
    got = _two_pass_emulated(torch.from_numpy(a), bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_linear_scan_at_one_step_is_b():
    """A decode step (T = 1) from h = 0 returns b exactly."""
    a, b = _ab(10, (4, 1, 32))
    got = ops.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(got, torch.from_numpy(b))


# ---------------------------------------------------------------------------
# On a card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: "
                    "python -m pytest -m gpu tests/test_torch_lm_kernels.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,kw", FLASH_CASES + [
    ("noncausal_ragged", dict(b=1, hq=2, hkv=1, s=100, d=32),
     dict(causal=False)),
    ("d256_gqa", dict(b=1, hq=8, hkv=4, s=300, d=256),
     dict(causal=True, window=128, softcap=50.0))],
    ids=[c[0] for c in FLASH_CASES] + ["noncausal_ragged", "d256_gqa"])
def test_flash_cuda_matches_plain_on_card(cuda_device, name, shape, kw,
                                          dtype):
    q, k, v = [t.to(cuda_device) for t in _port(_qkv(11, **shape), dtype)]
    got = fa.flash_attention_cuda(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,kw,offsets", Q_OFFSET_CASES + [
    ("chunk8_d256_window", dict(b=1, hq=10, hkv=1, s=8, d=256, sk=300),
     dict(causal=True, window=128, softcap=30.0), (0, 1, 127, 128, 292)),
    ("chunk200", dict(b=1, hq=4, hkv=2, s=200, d=64, sk=400),
     dict(causal=True, window=150), (0, 63, 200))],
    ids=[c[0] for c in Q_OFFSET_CASES] + ["chunk8_d256_window", "chunk200"])
def test_flash_cuda_q_offset_matches_plain_on_card(cuda_device, name, shape,
                                                   kw, offsets, dtype):
    """Both kernels with queries at ``q_offset + i``: the band's tile skip
    and the element masks of its edge tiles move with the offset."""
    q, k, v = [t.to(cuda_device) for t in _port(_qkv(23, **shape), dtype)]
    for off in offsets:
        got = fa.flash_attention_cuda(q, k, v, q_offset=off, **kw)
        want = fa.flash_attention_plain(q, k, v, q_offset=off, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=f"q_offset={off}")


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(causal=True, window=100),
                                dict(causal=True, softcap=30.0)])
def test_flash_cuda_takes_head_transposed_views_on_card(cuda_device, kw):
    """bf16 q, k, v as the model passes them: (B, S, H, D) projections
    viewed as (B, H, S, D), read in place through the kernel's tensor
    maps."""
    b, s, hq, hkv, d = 2, 200, 8, 2, 128
    rng = np.random.default_rng(14)
    q, k, v = [torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16).transpose(1, 2)
        for h in (hq, hkv, hkv)]
    assert not q.is_contiguous()
    got = fa.flash_attention_cuda(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("t", [63, 64, 65, 129, rg.CHUNKED_MIN_T - 1,
                               rg.CHUNKED_MIN_T])
def test_linear_scan_chunked_borders_on_card(cuda_device, t, monkeypatch):
    """The two-pass scan at T below, at and one past its 64-step chunk and
    at two chunks and one step, forced below its dispatch threshold, and
    the dispatch itself on each side of ``CHUNKED_MIN_T``."""
    if t < rg.CHUNKED_MIN_T - 1:
        monkeypatch.setattr(rg, "CHUNKED_MIN_T", 2)
    a, b = _ab(18, (2, t, 2560))
    a_t, b_t = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
    got = rg.linear_scan_cuda(a_t, b_t)
    want = rg.linear_scan_plain(a_t, b_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 300, 2560), (4, 1, 2560), (2, 9, 33),
                                   (1, 4096, 2560), (3, 3000, 2560),
                                   (2, 65, 2560)])
def test_linear_scan_cuda_matches_plain_on_card(cuda_device, shape, dtype):
    a, b = _ab(12, shape)
    a_t = torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
    b_t = torch.from_numpy(b).to(cuda_device, getattr(torch, dtype))
    got = rg.linear_scan_cuda(a_t, b_t)
    want = rg.linear_scan_plain(a_t, b_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-4,
                               atol=1e-4)
