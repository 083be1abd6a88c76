"""The port's ``rwkv6_scan`` against the JAX package's RWKV-6 recurrences.

On the CPU the port's wrapper runs its plain PyTorch version.  The JAX side
runs the Pallas kernel in interpret mode (shared ``u``, zero state), the
sequential oracle ``ref.rwkv6_scan``, the chunk-recurrent form the model
calls (``models/rwkv.py::rwkv6_chunked``: per-head ``u``, an initial and a
final state) and the model's one-token decode step written out in jnp.  All
get the same seeded numpy inputs.  ``_chunk_emulated`` writes the CUDA
kernel's chunked arithmetic (anchored sub-chunk factors) in torch and is
held to the same references.  Tolerance: the reference's own 2e-3
(``tests/test_kernels.py``), 3e-2 where outputs are bf16.  The ``gpu``
tests hold the CUDA kernel to the plain version on a card and skip without
one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.models import rwkv as ref_rwkv
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6 as rw

TOL = {"float32": 2e-3, "bfloat16": 3e-2}


def _inputs(seed, shape, *, heads=1, w_range=(0.5, 0.99), with_state=False):
    """r, k, v (scale 0.5), w, u (heads, D) and an optional state0, as the
    reference's kernel test draws them."""
    rng = np.random.default_rng(seed)
    d = shape[-1]
    r, k, v = (rng.normal(size=shape).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(*w_range, size=shape).astype(np.float32)
    u = (rng.normal(size=(heads, d)) * 0.3).astype(np.float32)
    s0 = None
    if with_state:
        lead = shape[:-2]
        s0 = rng.normal(size=lead + (d, d)).astype(np.float32)
    return r, k, v, w, u, s0


def _t(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,block_t", [(64, 16), (96, 32), (37, 16), (1, 1)])
def test_plain_matches_pallas_and_ref(t, block_t, dtype):
    """The TPU kernel's function: shared u of shape (D,), zero state."""
    r, k, v, w, u, _ = _inputs(0, (3, t, 64))
    jr, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (r, k, v))
    want = ref_ops.rwkv6_scan(jr, jk, jv, jnp.asarray(w), jnp.asarray(u[0]),
                              block_t=block_t, interpret=True)
    oracle = ref.rwkv6_scan(jr, jk, jv, jnp.asarray(w), jnp.asarray(u[0]))
    got = ops.rwkv6_scan(_t(r, dtype), _t(k, dtype), _t(v, dtype), _t(w),
                         _t(u[0]))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (3, t, 64)
    for ref_out in (want, oracle):
        np.testing.assert_allclose(got.float().numpy(), _np(ref_out),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [100, 5, 1])
def test_plain_matches_rwkv6_chunked(t, with_state):
    """The function the model path replaces: per-head u (H, D), an initial
    state, and the final state, outputs and state both held."""
    b, h, d = 2, 2, 32
    r, k, v, w, u, s0 = _inputs(1, (b, h, t, d), heads=h,
                                w_range=(0.3, 0.999), with_state=with_state)
    want, want_s = ref_rwkv.rwkv6_chunked(
        *(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=32,
        state0=None if s0 is None else jnp.asarray(s0))
    flat = [_t(a.reshape(b * h, t, d)) for a in (r, k, v, w)]
    s0_t = None if s0 is None else _t(s0.reshape(b * h, d, d))
    got, got_s = ops.rwkv6_scan(*flat, _t(u), state0=s0_t, return_state=True)
    np.testing.assert_allclose(got.reshape(b, h, t, d).numpy(), _np(want),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_s.reshape(b, h, d, d).numpy(),
                               _np(want_s), rtol=2e-3, atol=2e-3)


def test_one_step_matches_reference_decode_branch():
    """A T = 1 launch with the state in and out against the reference's
    one-token decode branch (``models/rwkv.py`` time_mix, ``t == 1``),
    written out in jnp as the reference writes it."""
    b, h, d = 3, 4, 32
    r, k, v, w, u, s0 = _inputs(2, (b, h, 1, d), heads=h, with_state=True)
    s = jnp.asarray(s0)
    kv = jnp.asarray(k)[:, :, 0, :, None] * jnp.asarray(v)[:, :, 0, None, :]
    want = jnp.einsum("bhd,bhde->bhe", jnp.asarray(r)[:, :, 0],
                      s + jnp.asarray(u)[None, :, :, None] * kv)
    want_s = jnp.asarray(w)[:, :, 0, :, None] * s + kv
    got, got_s = ops.rwkv6_scan(
        *(_t(a.reshape(b * h, 1, d)) for a in (r, k, v, w)), _t(u),
        state0=_t(s0.reshape(b * h, d, d)), return_state=True)
    np.testing.assert_allclose(got.reshape(b, h, d).numpy(), _np(want),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_s.reshape(b, h, d, d).numpy(),
                               _np(want_s), rtol=2e-3, atol=2e-3)


def test_shared_u_is_one_head():
    """A (D,) u equals the same row given as (1, D) and repeated per head."""
    r, k, v, w, u, _ = _inputs(3, (4, 9, 32))
    args = [_t(a) for a in (r, k, v, w)]
    one = ops.rwkv6_scan(*args, _t(u[0]))
    assert torch.equal(one, ops.rwkv6_scan(*args, _t(u)))
    assert torch.equal(one, ops.rwkv6_scan(*args, _t(np.repeat(u, 2, 0))))


def test_fast_decay_stays_finite_where_chunked_form_overflows():
    """At w = 0.01 the sequential recurrence is finite and equals the
    oracle, while the reference's chunk-recurrent form returns NaN: it
    scales k by exp(-cumsum(log w)), which leaves the f32 range once
    32 * -ln(w) > 88.7 (w < 0.063).  A reference fault (ROADMAP queue 3);
    the port never takes the chunked form."""
    r, k, v, _, u, _ = _inputs(4, (1, 64, 32))
    w = np.full_like(r, 0.01)
    want = ref.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w)),
                          jnp.asarray(u[0]))
    got = ops.rwkv6_scan(*(_t(a) for a in (r, k, v, w)), _t(u[0]))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-3, atol=2e-3)
    chunked, _ = ref_rwkv.rwkv6_chunked(
        *(jnp.asarray(a[None]) for a in (r, k, v, w)), jnp.asarray(u),
        chunk=32)
    assert np.isnan(_np(chunked)).any()


# ---------------------------------------------------------------------------
# The chunked kernel's arithmetic (csrc/rwkv6_scan.cu, rwkv6_chunk_kernel)
# ---------------------------------------------------------------------------

def _chunk_emulated(r, k, v, w, u, *, state0=None, sub=16):
    """The CUDA chunked form in f32 torch, step for step: per sub-chunk J
    the factors r_i P_{n,i} (forward from the anchor n) and k_j P_{j+1,e_J}
    (backward from the sub-chunk's end) and its product gam_J; diagonal
    blocks with P_{j+1,i} carried along i; off-diagonal blocks as products
    times the whole sub-chunks between; r_i P_{0,i}, k_j P_{j+1,C} and
    P_{0,C} as running products from the chunk's ends.  Steps past T pad
    with r = k = v = 0, w = 1.  Returns (output in r's dtype, final
    state)."""
    bh, t_len, d = r.shape
    chunk = rw.CHUNK[d]
    h = 1 if u.dim() == 1 else u.shape[0]
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    u32 = u.float().reshape(h, d).repeat(bh // h, 1)
    s = (torch.zeros(bh, d, d) if state0 is None
         else state0.float().clone())
    n_chunks = -(-t_len // chunk)
    pad = n_chunks * chunk - t_len

    def padded(x, val):
        return torch.cat([x, torch.full((bh, pad, d), val)], 1) if pad else x
    r32, k32, v32, w32 = (padded(x, val) for x, val in (
        (r32, 0.0), (k32, 0.0), (v32, 0.0), (w32, 1.0)))
    ns = chunk // sub
    out = torch.empty(bh, n_chunks * chunk, d)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, wc = r32[:, sl], k32[:, sl], v32[:, sl], w32[:, sl]
        rt, kb = torch.empty_like(rc), torch.empty_like(kc)
        gam = torch.empty(bh, ns, d)
        a = torch.zeros(bh, chunk, chunk)
        for big_j in range(ns):
            n = big_j * sub
            p = torch.ones(bh, d)
            for x in range(sub):
                rt[:, n + x] = rc[:, n + x] * p
                p = p * wc[:, n + x]
            gam[:, big_j] = p
            q = torch.ones(bh, d)
            for x in reversed(range(sub)):
                kb[:, n + x] = kc[:, n + x] * q
                q = q * wc[:, n + x]
            for j in range(sub):           # the diagonal block, i >= j
                p = torch.zeros(bh, d)
                for i in range(sub):
                    f = u32 * kc[:, n + j] if i == j else kc[:, n + j] * p
                    a[:, n + i, n + j] = (rc[:, n + i] * f).sum(-1)
                    p = torch.ones(bh, d) if i == j else p * wc[:, n + i]

        def gprod(lo, hi):
            g = torch.ones(bh, d)
            for m in range(lo, hi):
                g = g * gam[:, m]
            return g
        for big_i in range(1, ns):
            rows = slice(big_i * sub, (big_i + 1) * sub)
            for big_j in range(big_i):
                cols = slice(big_j * sub, (big_j + 1) * sub)
                kg = kb[:, cols] * gprod(big_j + 1, big_i)[:, None]
                a[:, rows, cols] = torch.bmm(rt[:, rows], kg.transpose(1, 2))
        rh, kh = torch.empty_like(rc), torch.empty_like(kc)
        p, q = torch.ones(bh, d), torch.ones(bh, d)
        for x in range(chunk):
            rh[:, x] = rc[:, x] * p
            p = p * wc[:, x]
            y = chunk - 1 - x
            kh[:, y] = kc[:, y] * q
            q = q * wc[:, y]
        out[:, sl] = torch.bmm(rh, s) + torch.bmm(a, vc)
        s = p[:, :, None] * s + torch.bmm(kh.transpose(1, 2), vc)
    return out[:, :t_len].to(r.dtype), s


def _fast_decay_w(shape, *, fast_steps):
    """w = exp(-e^4), the model's fastest decay, for the first steps, then
    0.99."""
    w = np.full(shape, 0.99, np.float32)
    w[..., :fast_steps, :] = np.float32(np.exp(-np.exp(4.0)))
    return w


def _exact_0_1_w(w):
    """Every 7th step w = 0 exactly and every 11th (from 3) w = 1."""
    w = w.copy()
    w[..., ::7, :] = 0.0
    w[..., 3::11, :] = 1.0
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [rw.CHUNK[32] - 1, rw.CHUNK[32],
                               rw.CHUNK[32] + 1, 37, 1001])
def test_chunk_emulation_matches_pallas_and_ref(t, dtype):
    """T below, equal to and one past the chunk, and ragged T: the kernel's
    chunked arithmetic against the Pallas kernel (interpret mode) and the
    sequential oracle, shared u and zero state."""
    r, k, v, w, u, _ = _inputs(20, (2, t, 32))
    jr, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (r, k, v))
    got, _ = _chunk_emulated(_t(r, dtype), _t(k, dtype), _t(v, dtype), _t(w),
                             _t(u[0]))
    assert got.dtype == getattr(torch, dtype)
    oracle = ref.rwkv6_scan(jr, jk, jv, jnp.asarray(w), jnp.asarray(u[0]))
    refs = [oracle]
    if t <= 128:                      # interpret mode is slow at long T
        refs.append(ref_ops.rwkv6_scan(jr, jk, jv, jnp.asarray(w),
                                       jnp.asarray(u[0]), block_t=16,
                                       interpret=True))
    for want in refs:
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("t", [rw.CHUNK[32] + 1, 100, 1001])
def test_chunk_emulation_matches_rwkv6_chunked_with_state(t):
    """Per-head u, a carried state0 and the final state, against the
    model's chunk-recurrent form (at decays where it stays finite)."""
    b, h, d = 1, 3, 32
    r, k, v, w, u, s0 = _inputs(21, (b, h, t, d), heads=h,
                                w_range=(0.3, 0.999), with_state=True)
    want, want_s = ref_rwkv.rwkv6_chunked(
        *(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=32,
        state0=jnp.asarray(s0))
    got, got_s = _chunk_emulated(
        *(_t(a.reshape(b * h, t, d)) for a in (r, k, v, w)), _t(u),
        state0=_t(s0.reshape(b * h, d, d)))
    np.testing.assert_allclose(got.reshape(b, h, t, d).numpy(), _np(want),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_s.reshape(b, h, d, d).numpy(),
                               _np(want_s), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_emulation_stays_finite_at_the_fastest_decay(dtype):
    """First steps at w = exp(-e^4) (a step's log-decay -54.6, the model's
    floor), later steps at 0.99: the anchored factors never exceed 1, so
    the output and state stay finite and hold the oracle's tolerance, where
    the model's chunk-recurrent form (exp(-cumsum log w) on k) gives NaN."""
    t = 2 * rw.CHUNK[32] + 5
    r, k, v, _, u, s0 = _inputs(22, (2, t, 32), heads=2, with_state=True)
    w = _fast_decay_w(r.shape, fast_steps=40)
    got, got_s = _chunk_emulated(_t(r, dtype), _t(k, dtype), _t(v, dtype),
                                 _t(w), _t(u), state0=_t(s0))
    assert torch.isfinite(got.float()).all() and torch.isfinite(got_s).all()
    want, want_s = rw.rwkv6_scan_plain(_t(r, dtype), _t(k, dtype),
                                       _t(v, dtype), _t(w), _t(u),
                                       state0=_t(s0), return_state=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(got_s, want_s, rtol=2e-3, atol=2e-3)
    jr, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (r, k, v))
    oracle = ref.rwkv6_scan(jr, jk, jv, jnp.asarray(w), jnp.asarray(u[0]))
    shared, _ = _chunk_emulated(_t(r, dtype), _t(k, dtype), _t(v, dtype),
                                _t(w), _t(u[0]))
    np.testing.assert_allclose(shared.float().numpy(), _np(oracle),
                               rtol=TOL[dtype], atol=TOL[dtype])
    chunked, _ = ref_rwkv.rwkv6_chunked(
        *(jnp.asarray(a[None]) for a in (r, k, v, w)), jnp.asarray(u),
        chunk=32)
    assert np.isnan(_np(chunked)).any()


def test_chunk_emulation_takes_exact_zero_and_one_decays():
    """w = 0 (log-decay -inf) and w = 1 steps: products from the anchor
    give 0 and 1 exactly, with no -inf - (-inf)."""
    r, k, v, w, u, s0 = _inputs(23, (3, 2 * rw.CHUNK[32] + 9, 32), heads=3,
                                with_state=True)
    w = _exact_0_1_w(w)
    got, got_s = _chunk_emulated(*(_t(a) for a in (r, k, v, w, u)),
                                 state0=_t(s0))
    assert torch.isfinite(got).all()
    want, want_s = rw.rwkv6_scan_plain(*(_t(a) for a in (r, k, v, w, u)),
                                       state0=_t(s0), return_state=True)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(got_s, want_s, rtol=2e-3, atol=2e-3)
    oracle = ref.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w)),
                            jnp.asarray(u[0]))
    shared, _ = _chunk_emulated(*(_t(a) for a in (r, k, v, w)), _t(u[0]))
    np.testing.assert_allclose(shared.numpy(), _np(oracle), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("kw,match", [
    (dict(r_shape=(2, 8, 16), u_shape=(16,)), "one shape"),
    (dict(u_shape=(3, 16)), "H dividing"),
    (dict(u_shape=(2, 8)), "H dividing"),
    (dict(s_shape=(4, 16, 8)), "state0"),
    (dict(r_shape=(4, 0, 16), k_shape=(4, 0, 16)), "empty"),
])
def test_refuses_bad_shapes_on_every_device(kw, match):
    r = torch.zeros(kw.get("r_shape", (4, 8, 16)))
    k = torch.zeros(kw.get("k_shape", (4, 8, 16)))
    u = torch.zeros(kw.get("u_shape", (2, 16)))
    s0 = torch.zeros(kw["s_shape"]) if "s_shape" in kw else None
    with pytest.raises(ValueError, match=match):
        ops.rwkv6_scan(r, k, k, k, u, state0=s0)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches or raises; it never falls back."""
    r, k, v, w, u, _ = _inputs(5, (2, 4, 32))
    with pytest.raises(ValueError, match="CUDA"):
        rw.rwkv6_scan_cuda(*(_t(a) for a in (r, k, v, w)), _t(u))


def test_non_cpu_tensor_never_reaches_plain(monkeypatch):
    """A tensor off the CPU goes to the kernel wrapper, which refuses one
    that is not on a CUDA device; the plain version is never called and
    nothing is counted."""
    def forbidden(*a, **k):
        raise AssertionError("plain version reached")
    monkeypatch.setattr(rw, "rwkv6_scan_plain", forbidden)
    ops.reset_launches()
    x = torch.zeros((2, 4, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.rwkv6_scan(x, x, x, x, torch.zeros(32, device="meta"))
    assert ops.launch_counts()["rwkv6_scan"] == 0


# ---------------------------------------------------------------------------
# On a card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: python "
                    "-m pytest -m gpu tests/test_torch_rwkv_kernels.py)")
    return torch.device("cuda")


# (label, BH, T, D, heads, dtype, with_state).  T = CHUNK and CHUNK + 1
# border the chunk; the two "threshold" cases sit on each side of
# rw.CHUNKED_MIN_T (the sequential kernel below it, the chunked one from it).
CUDA_CASES = [
    ("forward_bf16", 8, 300, 64, 8, "bfloat16", False),
    ("forward_f32", 8, 300, 64, 8, "float32", False),
    ("ragged_state", 6, 37, 64, 3, "float32", True),
    ("decode_tick", 16, 1, 64, 4, "float32", True),
    ("d32", 4, 50, 32, 2, "float32", True),
    ("d128_bf16", 2, 70, 128, 1, "bfloat16", True),
    ("fast_decay", 8, 300, 64, 4, "float32", True),
    ("fast_decay_bf16", 8, 300, 64, 4, "bfloat16", True),
    ("exact_0_1", 8, 300, 64, 4, "float32", True),
    ("t_chunk", 6, rw.CHUNK[64], 64, 3, "float32", True),
    ("t_chunk_plus_1", 6, rw.CHUNK[64] + 1, 64, 3, "float32", True),
    ("below_threshold", 16, rw.CHUNKED_MIN_T - 1, 64, 4, "float32", True),
    ("at_threshold", 16, rw.CHUNKED_MIN_T, 64, 4, "float32", True),
    ("d128_ragged_f32", 4, 1001, 128, 2, "float32", True),
]
# The decays of the cases that do not draw w from (0.5, 0.99).
_CUDA_W = {"fast_decay": lambda w: _fast_decay_w(w.shape, fast_steps=100),
           "fast_decay_bf16": lambda w: _fast_decay_w(w.shape,
                                                      fast_steps=100),
           "exact_0_1": _exact_0_1_w}


@pytest.mark.gpu
@pytest.mark.parametrize("label,bh,t,d,heads,dtype,with_state", CUDA_CASES,
                         ids=[c[0] for c in CUDA_CASES])
def test_cuda_matches_plain_on_card(cuda_device, label, bh, t, d, heads,
                                    dtype, with_state):
    r, k, v, w, u, s0 = _inputs(6, (bh, t, d), heads=heads,
                                with_state=with_state)
    w = _CUDA_W.get(label, lambda x: x)(w)
    dev = cuda_device
    args = [_t(a, dtype).to(dev) for a in (r, k, v)] + [_t(w).to(dev),
                                                        _t(u).to(dev)]
    s0_t = None if s0 is None else _t(s0).to(dev)
    got, got_s = rw.rwkv6_scan_cuda(*args, state0=s0_t, return_state=True)
    want, want_s = rw.rwkv6_scan_plain(*args, state0=s0_t, return_state=True)
    torch.cuda.synchronize()
    tol = 2 ** -7 if dtype == "bfloat16" else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got_s, want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_takes_strided_head_views_on_card(cuda_device):
    """The model's (B,T,H*D) projections viewed as (B*H, T, D) at B = 1:
    strides (D, H*D, 1), no copy."""
    h, t, d = 4, 40, 64
    r, k, v, w, u, _ = _inputs(7, (1, t, h * d), heads=1)
    dev = cuda_device

    def heads(a):
        return _t(a).to(dev).reshape(1, t, h, d).transpose(1, 2) \
            .reshape(h, t, d)
    args = [heads(a) for a in (r, k, v, w)]
    assert not args[0].is_contiguous()
    uu = _t(u.reshape(h, d)).to(dev)
    got = rw.rwkv6_scan_cuda(*args, uu)
    want = rw.rwkv6_scan_plain(*[a.contiguous() for a in args], uu)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_takes_unaligned_state_on_card(cuda_device):
    """A state0 view 4 bytes off a 16-byte boundary (the kernel reads the
    state as 16-byte vectors) gives the same result as an aligned copy."""
    r, k, v, w, u, s0 = _inputs(8, (4, 9, 64), heads=2, with_state=True)
    dev = cuda_device
    args = [_t(a).to(dev) for a in (r, k, v, w, u)]
    buf = torch.zeros(s0.size + 1, device=dev)
    buf[1:] = _t(s0.reshape(-1)).to(dev)
    odd = buf[1:].view(s0.shape)
    assert odd.data_ptr() % 16
    got, got_s = rw.rwkv6_scan_cuda(*args, state0=odd, return_state=True)
    want, want_s = rw.rwkv6_scan_plain(*args, state0=odd, return_state=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_s, want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_refuses_unbuilt_head_dim_on_card(cuda_device):
    r = torch.zeros((2, 4, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        rw.rwkv6_scan_cuda(r, r, r, r, torch.zeros(48, device=cuda_device))
