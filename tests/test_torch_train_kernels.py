"""Gradients through the port's kernels, against the JAX package.

``ops.flash_attention``, ``ops.linear_scan`` and ``ops.rwkv6_scan`` run as
autograd Functions where grad is on; on the CPU their backward is the
plain backward (``flash_attention_bwd_plain``, ``linear_scan_bwd_plain``,
``rwkv6_scan_bwd_plain``), the same Function, saved tensors and formulas
as the card runs.  The same seeded numpy inputs go through ``jax.vjp`` of
the reference's oracles (``repro.kernels.ref.attention``,
``ref.linear_scan``, ``ref.rwkv6_scan``, and the model's
``rwkv6_chunked``) and through the port.  Tolerances: f32 gradients within
2e-5 of the largest reference gradient (both sides sum f32 products in
other orders; the backward's scale is O(1) values over at most 64 keys or
steps' worth of state), the linear scan's within 1e-5.  The RWKV
gradient's bf16 case is held to autograd of the plain forward at the
card's bf16 2e-2: both round the same f32 values to bf16 once, one bf16
ulp (2^-8 of a value) apart at most.  The kernels without a backward raise
on grad on every device, and the serve paths record nothing.  The ``gpu``
cases hold the CUDA backward to the plain one on a card (1e-5 of the
largest value in f32; 2e-2 in bf16, where the tensor-core path rounds P
and dS to bf16 before their products and every output to bf16) and need no
JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ops, rglru
from repro_torch.kernels import rwkv6 as rw
from repro_torch.models import api

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.models import rwkv as ref_rwkv
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
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="q_offset"):
        fb.flash_attention_bwd_plain(q, k, v, q, g, lse, q_offset=4)
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
@pytest.mark.parametrize("name,shape,kw", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_forward_statistics_match_jax_logsumexp(name, shape, kw):
    """The plain forward's row statistics against ``jax.nn.logsumexp`` of
    the masked, capped logits as ``ref.attention`` forms them; a row with
    zero mass is +inf in the port (no probability) and -inf in JAX (no
    mass)."""
    q, k, v, _ = _qkvg(shape, seed=3)
    out, lse = fa.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), return_lse=True, **kw)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    assert torch.equal(out, fa.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw))
    b, hq, hkv, s, sk, d = shape
    scale = kw.get("scale") or 1.0 / np.sqrt(d)
    kx = jnp.repeat(jnp.asarray(k), hq // hkv, axis=1)
    x = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kx) * scale
    if kw.get("softcap") is not None:
        x = kw["softcap"] * jnp.tanh(x / kw["softcap"])
    q_pos, k_pos = jnp.arange(s)[:, None], jnp.arange(sk)[None, :]
    mask = jnp.ones((s, sk), dtype=bool)
    if kw.get("causal", True):
        mask &= k_pos <= q_pos
    if kw.get("window") is not None:
        mask &= k_pos > q_pos - kw["window"]
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, x, -jnp.inf), axis=-1))
    got = lse.numpy()
    assert np.array_equal(np.isposinf(got), np.isneginf(want))
    finite = np.isfinite(want)
    _close(got[finite], want[finite], TOL_F32)
    if name == "zero_mass_rows":
        assert np.isposinf(got[:, :, 12:]).all()


# The tensor-core kernels' formulation in plain torch, tile by tile, as
# csrc/flash_attention_bwd.cu runs it: 64-row tiles, P = exp2(x log2 e -
# lse log2 e) from the forward's statistics, only the band's tiles, masks
# only on edge tiles, the statistics of rows past S read flat from the next
# head's (or zeros past the end, as TMA's bounds give them), a KV head's
# query heads split as ``dkdv_splits`` says and the splits' f32 dK and dV
# summed in split order, and bf16 rounding (``bf16=True``) of dS before
# dQ, of P before dV and of dS before dK, and of the outputs.
BT = 64
LOG2E = 1.4426950408889634


def _dkdv_keys(d):
    """The keys of one dkdv CTA at head dim ``d`` on the tensor cores, as
    the library's ``repro_flash_bwd_keys`` gives them."""
    return 64 if d > 128 else 128


def _tile_bands(s, sk, kw):
    causal, window = kw.get("causal", True), kw.get("window")

    def key_band(q0):
        n = -(-sk // BT)
        lo, hi = 0, n
        if causal:
            hi = min(n, (q0 + BT - 1) // BT + 1)
        if window is not None and q0 - window + 1 > 0:
            lo = (q0 - window + 1) // BT
        return lo, hi

    def query_band(k0):
        n = -(-s // BT)
        lo, hi = (min(n, k0 // BT) if causal else 0), n
        if window is not None:
            hi = min(n, (k0 + BT - 2 + window) // BT + 1)
        return lo, hi

    def edge(q0, k0):
        return (k0 + BT > sk or q0 + BT > s
                or (causal and k0 + BT - 1 > q0)
                or (window is not None and k0 <= q0 + BT - 1 - window))

    def kept(q0, k0):
        qi = q0 + torch.arange(BT)[:, None]
        kj = k0 + torch.arange(BT)[None, :]
        ok = (qi < s) & (kj < sk)
        if causal:
            ok &= kj <= qi
        if window is not None:
            ok &= kj > qi - window
        return ok

    return key_band, query_band, edge, kept


def _emulate_bwd(q, k, v, o, do, lse, kw, nsplit, bf16):
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = kw.get("scale") or 1.0 / np.sqrt(d)
    cap = kw.get("softcap")
    key_band, query_band, edge, kept = _tile_bands(s, sk, kw)
    sp, skp = -(-s // BT) * BT, -(-sk // BT) * BT

    def pad(t, n):        # rows past the edge read as zeros
        return torch.nn.functional.pad(t.float(), (0, 0, 0, n - t.shape[2]))

    qp, op_, gp = pad(q, sp), pad(o, sp), pad(do, sp)
    kp, vp = pad(k, skp), pad(v, skp)
    di = (gp * op_).sum(-1)[:, :, :s]
    flat = {"lse": torch.cat([lse.reshape(-1), torch.zeros(BT)]),
            "di": torch.cat([di.reshape(-1), torch.zeros(BT)])}

    def logits(dot):
        x = dot * scale
        chain = torch.ones_like(x)
        if cap is not None:
            t = torch.tanh(x / cap)
            x, chain = cap * t, 1.0 - t * t
        return x * LOG2E, chain

    dq = torch.zeros((b, hq, sp, d))
    for bi in range(b):
        for h in range(hq):
            hk = h // group
            for q0 in range(0, sp, BT):
                rows = slice(q0, q0 + BT)
                inside = q0 + torch.arange(BT) < s
                lse2 = torch.where(inside, torch.nn.functional.pad(
                    lse[bi, h], (0, sp - s))[rows] * LOG2E, torch.inf)
                dir_ = torch.where(inside, torch.nn.functional.pad(
                    di[bi, h], (0, sp - s))[rows], 0.0)
                lo, hi = key_band(q0)
                for t in range(lo, hi):
                    keys = slice(t * BT, t * BT + BT)
                    x2, chain = logits(qp[bi, h, rows] @ kp[bi, hk, keys].T)
                    pr = torch.exp2(x2 - lse2[:, None])
                    if edge(q0, t * BT):
                        pr = torch.where(kept(q0, t * BT), pr, 0.0)
                    dp = gp[bi, h, rows] @ vp[bi, hk, keys].T
                    ds = pr * (dp - dir_[:, None]) * chain
                    dq[bi, h, rows] += rnd(ds) @ kp[bi, hk, keys]
    dq = dq[:, :, :s] * scale

    parts = torch.zeros((nsplit, 2, b, hkv, skp, d))
    for split in range(nsplit):
        g_lo, g_hi = split * group // nsplit, (split + 1) * group // nsplit
        for bi in range(b):
            for hk in range(hkv):
                for k0 in range(0, skp, BT):
                    keys = slice(k0, k0 + BT)
                    lo, hi = query_band(k0)
                    for g in range(g_lo, g_hi):
                        h = hk * group + g
                        row0 = (bi * hq + h) * s
                        for t in range(lo, hi):
                            q0 = t * BT
                            rows = slice(q0, q0 + BT)
                            l2 = flat["lse"][row0 + q0:row0 + q0 + BT] * LOG2E
                            d2 = flat["di"][row0 + q0:row0 + q0 + BT]
                            x2, chain = logits(kp[bi, hk, keys]
                                               @ qp[bi, h, rows].T)
                            pr = torch.exp2(x2 - l2[None, :])
                            if edge(q0, k0):
                                pr = torch.where(kept(q0, k0).T, pr, 0.0)
                            dp = vp[bi, hk, keys] @ gp[bi, h, rows].T
                            ds = pr * (dp - d2[None, :]) * chain
                            parts[split, 0, bi, hk, keys] += \
                                rnd(ds) @ qp[bi, h, rows]
                            parts[split, 1, bi, hk, keys] += \
                                rnd(pr) @ gp[bi, h, rows]
    parts[:, 0] *= scale
    total = parts[0]
    for split in range(1, nsplit):
        total = total + parts[split]
    dk, dv = total[0, :, :, :sk], total[1, :, :, :sk]
    return tuple(rnd(x) for x in (dq, dk, dv))


EMULATED_CASES = FLASH_CASES + [
    # Griffin's MQA with a window over three query tiles: ten splits.
    ("mqa_split", (1, 10, 1, 150, 150, 32), dict(causal=True, window=70)),
]


def _emulation_inputs(shape, kw, bf16):
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(shape, seed=4))
    if bf16:
        q, k, v, g = (t.bfloat16().float() for t in (q, k, v, g))
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    if bf16:
        out = out.bfloat16().float()
    b, hq, hkv, s, sk, d = shape
    nsplit = fb.dkdv_splits(b, hq, hkv, sk, _dkdv_keys(d), sms=132)
    return (q, k, v, out, g, lse), nsplit


@needs_reference
@pytest.mark.parametrize("name,shape,kw", EMULATED_CASES,
                         ids=[c[0] for c in EMULATED_CASES])
def test_flash_backward_kernel_formulation_matches_plain_and_jax(name, shape,
                                                                 kw):
    """The kernels' formulation in f32 against the plain backward and
    ``jax.vjp`` of ``ref.attention`` at 1e-5 of the largest value."""
    args, nsplit = _emulation_inputs(shape, kw, bf16=False)
    if name == "mqa_split":
        assert nsplit == 10
    got = _emulate_bwd(*args, kw, nsplit, bf16=False)
    plain = fb.flash_attention_bwd_plain(*args, **kw)
    q, k, v, _, g, _ = args
    _, vjp = jax.vjp(lambda x, y, z: ref.attention(x, y, z, **kw),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(g.numpy()))
    for x, p, w in zip(got, plain, want):
        _close(x.numpy(), p.numpy(), 1e-5)
        _close(x.numpy(), np.asarray(w), 1e-5)


@pytest.mark.parametrize("name,shape,kw", EMULATED_CASES,
                         ids=[c[0] for c in EMULATED_CASES])
def test_flash_backward_kernel_bf16_rounding_matches_plain(name, shape, kw):
    """The same with the kernels' bf16 roundings, on bf16 inputs, against
    the plain backward in f32 at the card's bf16 2e-2."""
    args, nsplit = _emulation_inputs(shape, kw, bf16=True)
    got = _emulate_bwd(*args, kw, nsplit, bf16=True)
    for x, p in zip(got, fb.flash_attention_bwd_plain(*args, **kw)):
        _close(x.numpy(), p.numpy(), TOL_CARD["bfloat16"])


@pytest.mark.parametrize("shape,sms,want", [
    ((2, 8, 4, 4096, 64), 132, 1),       # gemma2-2b: 512 CTAs
    ((1, 10, 1, 2048, 64), 132, 10),     # recurrentgemma-2b: 32 -> 320
    ((1, 16, 2, 4096, 128), 132, 8),     # qwen2.5-3b: 64 -> 512
    ((1, 16, 16, 1500, 128), 132, 1),    # whisper: a group of one
    ((1, 12, 4, 1024, 128), 132, 3),     # 32 CTAs, group 3: all of it
    ((1, 12, 2, 4096, 128), 132, 6),     # 64 CTAs want 5: 6 divides 6
    ((1, 12, 2, 4096, 128), 16, 1),      # a small card is full
])
def test_dkdv_splits(shape, sms, want):
    assert fb.dkdv_splits(*shape, sms=sms) == want


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


# ---------------------------------------------------------------------------
# The gradient of rwkv6_scan
# ---------------------------------------------------------------------------

def _rwkv_np(shape, *, heads=1, w_range=(0.1, 1.0), seed=0):
    """r, k, v, do (scale 0.5), w in ``w_range`` and u (heads, D) x 0.3."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.normal(size=shape).astype(np.float32) * 0.5
                   for _ in range(4))
    w = rng.uniform(*w_range, size=shape).astype(np.float32)
    u = (rng.normal(size=(heads, shape[-1])) * 0.3).astype(np.float32)
    return r, k, v, w, u, do


def _rwkv_port_grads(r, k, v, w, u, do, dtype=torch.float32):
    """The Function's output and (dr, dk, dv, dw, du) on the CPU; r, k, v
    and do in ``dtype``."""
    ts = [torch.from_numpy(a).to(dt).requires_grad_() for a, dt in zip(
        (r, k, v, w, u), (dtype, dtype, dtype, torch.float32,
                          torch.float32))]
    out = ops.rwkv6_scan(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do).to(dtype))
    return out.detach(), grads


# (bh, t, d): one step, 16 steps and one past them, several sub-chunks.
RWKV_REF_CASES = [(2, 1, 8), (3, 16, 16), (2, 17, 16), (2, 53, 32)]


@needs_reference
@pytest.mark.parametrize("shape", RWKV_REF_CASES,
                         ids=["x".join(map(str, c)) for c in RWKV_REF_CASES])
def test_rwkv6_backward_matches_jax_grad_of_ref_scan(shape):
    """u of shape (D,): the TPU kernel's function and its sequential
    oracle, differentiated by jax.vjp."""
    r, k, v, w, u, do = _rwkv_np(shape, seed=shape[1])
    u = u[0]
    out, grads = _rwkv_port_grads(r, k, v, w, u, do)
    want_out, vjp = jax.vjp(ref.rwkv6_scan,
                            *(jnp.asarray(a) for a in (r, k, v, w, u)))
    _close(out.numpy(), want_out, TOL_F32)
    plain = rw.rwkv6_scan_bwd_plain(*(torch.from_numpy(a) for a in
                                      (r, k, v, w, u, do)))
    for got, again, want in zip(grads, plain, vjp(jnp.asarray(do))):
        assert got.shape == want.shape
        assert torch.equal(got, again)
        _close(got.numpy(), want, TOL_F32)


@needs_reference
@pytest.mark.parametrize("b,h,t", [(1, 2, 45), (2, 3, 70)])
def test_rwkv6_backward_matches_jax_grad_of_rwkv6_chunked(b, h, t):
    """The model's chunk-recurrent form (chunk 32: T not a multiple of it)
    with per-head u (H, D), in its (B, H, T, D) layout, against the port's
    (B H, T, D) rows.  Decays in [0.1, 1), where the reference's exp(-L)
    factors stay finite; it clamps w at 1e-12 inside its log, so the two
    are held together only where w >= 1e-12 (every w here)."""
    d = 16
    r, k, v, w, u, do = _rwkv_np((b * h, t, d), heads=h, seed=t)
    out, grads = _rwkv_port_grads(r, k, v, w, u, do)

    def chunked(*xs):
        heads = [a.reshape(b, h, t, d) for a in xs[:4]]
        return ref_rwkv.rwkv6_chunked(*heads, xs[4])[0].reshape(b * h, t, d)
    want_out, vjp = jax.vjp(chunked,
                            *(jnp.asarray(a) for a in (r, k, v, w, u)))
    _close(out.numpy(), want_out, TOL_F32)
    for got, want in zip(grads, vjp(jnp.asarray(do))):
        assert np.isfinite(np.asarray(want)).all()
        _close(got.numpy(), want, TOL_F32)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_backward_matches_autograd_of_plain(dtype, d):
    """The written-out backward against autograd of the plain forward, at
    each head dim the kernel takes, with two heads, decays that include
    exact 0 and 1 (dw is taken from G and S directly: finite at w = 0)."""
    dt = getattr(torch, dtype)
    r, k, v, w, u, do = _rwkv_np((4, 21, d), heads=2, w_range=(0.0, 1.0),
                                 seed=d)
    w[0, 3, :4], w[1, 7, 4:9] = 0.0, 1.0
    _, grads = _rwkv_port_grads(r, k, v, w, u, do, dt)
    ts = [torch.from_numpy(a).to(x).requires_grad_() for a, x in zip(
        (r, k, v, w, u), (dt, dt, dt, torch.float32, torch.float32))]
    want = torch.autograd.grad(rw.rwkv6_scan_plain(*ts), ts,
                               torch.from_numpy(do).to(dt))
    tol = TOL_F32 if dt == torch.float32 else TOL_CARD["bfloat16"]
    for got, w_ in zip(grads, want):
        assert got.dtype == w_.dtype and torch.isfinite(got).all()
        _close(got.float().numpy(), w_.float().numpy(), tol)


SUB = 16          # the backward's sub-chunk, as in the forward


def _chunk_formulation(r, k, v, w, u, do, chunk):
    """``csrc/rwkv6_scan_bwd.cu``'s arithmetic in f32 on the CPU, every
    (row, chunk) at once: the forward's chunk states (``rwkv6_scan_plain``,
    ``return_chunk_states``), G's carry over chunks backwards (launch 1),
    then per chunk the anchored factors r~ (from each sub-chunk's start),
    k~ (to its end), k^ (to the chunk's end) and the sub-chunk products
    gam; M = V O^T, A from its diagonal blocks (P carried along i) and
    off-diagonal ones (r~ k~ times the whole sub-chunks between); S_in do,
    G_out v, G_out^T k^ and sigma = rowsum(S_in G_out); Yb and Za (what
    reaches a row from before and after its sub-chunk); the Phi pair sums
    and X_K; then per sub-chunk the steps with dr, dk and dw (the direct
    sum on anchored factors) from running products, and du's ordered
    sum.  Steps past T read r = k = v = do = 0, w = 1."""
    bh, t_len, d = r.shape
    h = u.shape[0]
    _, states = rw.rwkv6_scan_plain(*(torch.from_numpy(a) for a in
                                      (r, k, v, w, u)),
                                    return_chunk_states=True)
    r, k, v, w, do = (torch.from_numpy(a).float() for a in (r, k, v, w, do))
    uu = torch.from_numpy(u).float().repeat(bh // h, 1)[:, None]  # (BH,1,D)
    n, c_len, ns = -(-t_len // chunk), chunk, chunk // SUB
    pad = n * c_len - t_len

    def chunks(x, fill=0.0):
        x = torch.cat([x, torch.full((bh, pad, d), fill)], 1)
        return x.reshape(bh, n, c_len, d)
    R, K, V, O, W = chunks(r), chunks(k), chunks(v), chunks(do), chunks(w, 1.)
    ones = torch.ones((bh, n, d))
    s_in = torch.cat([torch.zeros((bh, 1, d, d)), states], 1)

    def blk(x, j):                        # sub-chunk j of a (.., C, ..) axis
        return x[:, :, j * SUB:(j + 1) * SUB]
    # The anchored factors.
    rt, kb, kh, p0 = (torch.empty_like(W) for _ in range(4))
    gam = torch.empty((bh, n, ns, d))
    p = ones
    for j in range(ns):
        q = ones
        for s in range(j * SUB, (j + 1) * SUB):
            p0[:, :, s], rt[:, :, s] = p, R[:, :, s] * q
            q, p = q * W[:, :, s], p * W[:, :, s]
        gam[:, :, j] = q
    gall, p = p, ones
    for j in reversed(range(ns)):
        q = ones
        for s in reversed(range(j * SUB, (j + 1) * SUB)):
            kb[:, :, s], kh[:, :, s] = K[:, :, s] * q, K[:, :, s] * p
            q, p = q * W[:, :, s], p * W[:, :, s]

    def between(lo, hi, skip=None):       # prod gam_m, lo < m < hi, m != skip
        g = ones
        for m in range(lo + 1, hi):
            if m != skip:
                g = g * gam[:, :, m]
        return g
    # Launch 1: G's carry, G_in = P_{0,C} G_out + sum_i (r_i P_{0,i}) do_i^T.
    g_out = torch.zeros((bh, n, d, d))
    g = torch.zeros((bh, d, d))
    for c in reversed(range(1, n)):
        g = gall[:, c, :, None] * g + torch.einsum(
            "xid,xie->xde", R[:, c] * p0[:, c], O[:, c])
        g_out[:, c - 1] = g
    # The products.
    m_ = torch.einsum("xnae,xnbe->xnab", V, O)
    sd = torch.einsum("xnde,xnbe->xnbd", s_in, O)
    gv = torch.einsum("xnde,xnae->xnad", g_out, V)
    dvx = torch.einsum("xnad,xnde->xnae", kh, g_out)
    sig = (s_in * g_out).sum(-1)
    a_ = torch.zeros((bh, n, c_len, c_len))           # A[b][a], b > a
    for i in range(ns):
        for j in range(i):
            a_[:, :, i * SUB:(i + 1) * SUB, j * SUB:(j + 1) * SUB] = \
                torch.einsum("xnbd,xnad->xnba", blk(rt, i),
                             blk(kb, j) * between(j, i)[:, :, None])
        for a in range(SUB):
            pa = torch.zeros((bh, n, d))
            for b in range(SUB):
                if b > a:
                    a_[:, :, i * SUB + b, i * SUB + a] = (
                        R[:, :, i * SUB + b] * K[:, :, i * SUB + a]
                        * pa).sum(-1)
                pa = pa * W[:, :, i * SUB + b] + (1.0 if b == a else 0.0)
    z = (R * uu[:, None] * K).sum(-1, keepdim=True)
    dv = dvx + torch.einsum("xnba,xnbe->xnae", a_.tril(-1), O) + z * O
    yb, za = torch.empty_like(W), torch.empty_like(W)
    for i in range(ns):
        y = between(-1, i)[:, :, None] * blk(sd, i)
        for j in range(i):
            y = y + between(j, i)[:, :, None] * torch.einsum(
                "xnab,xnad->xnbd", blk(blk(m_, j).transpose(2, 3), i)
                .transpose(2, 3), blk(kb, j))
        yb[:, :, i * SUB:(i + 1) * SUB] = y
    phi = {}
    for j in range(ns):
        zz = between(j, ns)[:, :, None] * blk(gv, j)
        for i in range(j + 1, ns):
            q = torch.einsum("xnab,xnbd->xnad", blk(blk(m_, j).transpose(2, 3),
                                                    i).transpose(2, 3),
                             blk(rt, i))
            phi[j, i] = (blk(kb, j) * q).sum(2)
            zz = zz + between(j, i)[:, :, None] * q
        za[:, :, j * SUB:(j + 1) * SUB] = zz
        phi[-1, j] = (blk(rt, j) * blk(sd, j)).sum(2)
        phi[j, ns] = (blk(kb, j) * blk(gv, j)).sum(2)
    phi[-1, ns] = sig
    dr, dk, dw = (torch.empty_like(W) for _ in range(3))
    vdo = torch.diagonal(m_, dim1=2, dim2=3)[..., None]
    for kk in range(ns):
        x = sum(between(j, i, kk) * phi[j, i] for j in range(-1, kk)
                for i in range(kk + 1, ns + 1))
        n0 = kk * SUB
        lb = [yb[:, :, n0 + b] for b in range(SUB)]
        for t in range(SUB):
            mt = m_[:, :, n0 + t, n0:n0 + SUB, None]
            dr[:, :, n0 + t] = lb[t]
            pp, a4, ak = ones, torch.zeros_like(ones), torch.zeros_like(ones)
            for b in range(t + 1, SUB):
                rp = R[:, :, n0 + b] * pp
                a4, ak = a4 + rp * lb[b], ak + rp * mt[:, :, b]
                pp = pp * W[:, :, n0 + b]
            dw[:, :, n0 + t] = a4 + pp * x
            dk[:, :, n0 + t] = ak + pp * za[:, :, n0 + t]
            for b in range(t + 1, SUB):
                lb[b] = W[:, :, n0 + t] * lb[b] + K[:, :, n0 + t] * mt[:, :, b]
            x = W[:, :, n0 + t] * x + K[:, :, n0 + t] * za[:, :, n0 + t]
    du = torch.zeros((bh, d))
    for c in range(n):
        du = du + (R[:, c] * K[:, c] * vdo[:, c]).sum(1)

    def rows(y):
        return y.reshape(bh, n * c_len, d)[:, :t_len]
    return (rows(dr + uu[:, None] * K * vdo), rows(dk + uu[:, None] * R * vdo),
            rows(dv), rows(dw), du.reshape(bh // h, h, d).sum(0))


def _identity_dw(r, k, v, w, u, do):
    """dw through the cumulative-decay identity, which the kernel avoids:
    S forward keeping every S_{t-1}, G backwards, dlogw_t = X_t - k_t
    (G_t v_t) with X carried back over T, dw = dlogw / w."""
    r, k, v, w, do = (torch.from_numpy(a).float() for a in (r, k, v, w, do))
    bh, t_len, d = r.shape
    hist, s = [], torch.zeros((bh, d, d))
    for t in range(t_len):
        hist.append(s)
        s = w[:, t, :, None] * s + k[:, t, :, None] * v[:, t, None, :]
    dw = torch.zeros((bh, t_len, d))
    g, x = torch.zeros((bh, d, d)), torch.zeros((bh, d))
    for t in reversed(range(t_len)):
        dl = x - k[:, t] * (g * v[:, t, None, :]).sum(-1)
        dw[:, t] = dl / w[:, t]
        x = dl + r[:, t] * (hist[t] * do[:, t, None, :]).sum(-1)
        g = w[:, t, :, None] * g + r[:, t, :, None] * do[:, t, None, :]
    return dw


def _exact_zeros(w):
    """Exact zeros and ones in the decays of rows 0-3 (T >= 128), on a
    numpy array or a tensor: zeros over five steps inside a sub-chunk, a
    whole step of zeros on the first step of a chunk (64) and on the last
    (127), ones over three steps."""
    w[0, 70:75, :5] = 0.0
    w[1, 64, :] = 0.0
    w[2, 100:103, 7:20] = 1.0
    w[3, 127, :] = 0.0
    return w


# (label, (bh, t, d), decay range): slow decay, fast decay down to 0.01
# and every decay 0.01 (where the reference's chunked form overflows:
# exp(-L) over a chunk of 32 is 0.01^-32) over 200 steps (3 chunks of 64
# and 8 steps); a ragged T; D = 128 with its chunk of 32; exact zeros (and
# ones) in a chunk's decays (``_exact_zeros``).
RWKV_FORMULATION_CASES = [
    ("slow", (4, 200, 32), (0.45, 0.95)),
    ("fast_to_0.01", (4, 200, 32), (0.01, 1.0)),
    ("all_0.01", (4, 200, 32), (0.01, 0.01)),
    ("ragged", (2, 147, 64), (0.45, 0.95)),
    ("d128_chunk32", (2, 75, 128), (0.45, 0.95)),
    ("exact_zeros", (4, 150, 32), (0.01, 1.0)),
]


@pytest.mark.parametrize("label,shape,w_range", RWKV_FORMULATION_CASES,
                         ids=[c[0] for c in RWKV_FORMULATION_CASES])
def test_rwkv6_backward_kernel_formulation_matches_plain(label, shape,
                                                         w_range):
    """The card's chunked backward (chunk states from the forward, G's
    carry over chunks, every chunk's terms from anchored factors, dw's
    direct sum expanded on them) against the plain loop at f32."""
    r, k, v, w, u, do = _rwkv_np(shape, heads=2, w_range=w_range, seed=7)
    if label == "exact_zeros":
        _exact_zeros(w)
    got = _chunk_formulation(r, k, v, w, u, do, rw.CHUNK[shape[-1]])
    want = rw.rwkv6_scan_bwd_plain(*(torch.from_numpy(a) for a in
                                     (r, k, v, w, u, do)))
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        _close(g_.numpy(), w_.numpy(), TOL_F32)


def test_rwkv6_decay_identity_loses_digits_at_fast_decay():
    """Why the kernel takes dw as the direct sum of G and S of one step:
    through the cumulative-decay identity it cancels to w dw and divides
    by w, so at decays down to 0.01 over 512 steps it misses the plain
    loop by more than the f32 tolerance, which the direct sum (expanded
    on anchored factors, as the kernel takes it) meets."""
    r, k, v, w, u, do = _rwkv_np((2, 512, 32), w_range=(0.01, 1.0), seed=3)
    want = rw.rwkv6_scan_bwd_plain(*(torch.from_numpy(a) for a in
                                     (r, k, v, w, u, do)))[3].numpy()
    direct = _chunk_formulation(r, k, v, w, u, do, rw.CHUNK[32])[3]
    ident = _identity_dw(r, k, v, w, u, do).numpy()
    scale = np.abs(want).max()
    _close(direct.numpy(), want, TOL_F32)
    assert np.abs(ident - want).max() > TOL_F32 * scale


@needs_reference
@pytest.mark.parametrize("d,t", [(32, 200), (128, 100), (64, 150)])
def test_rwkv6_plain_chunk_states_match_rwkv6_chunked(d, t):
    """The plain forward's chunk-start states (the state after each c C
    steps, C = ``CHUNK[D]``) against the reference's ``rwkv6_chunked``
    run through JAX on each prefix of c C steps, its final state; decays
    in [0.1, 1), where its exp(-L) factors stay finite."""
    b, h = 1, 2
    r, k, v, w, u, _ = _rwkv_np((b * h, t, d), heads=h, w_range=(0.1, 1.0),
                                seed=d)
    out, states = rw.rwkv6_scan_plain(*(torch.from_numpy(a) for a in
                                        (r, k, v, w, u)),
                                      return_chunk_states=True)
    c_len = rw.CHUNK[d]
    assert states.shape == (b * h, -(-t // c_len) - 1, d, d)
    assert states.dtype == torch.float32
    for c in range(1, states.shape[1] + 1):
        heads = [jnp.asarray(a[:, :c * c_len].reshape(b, h, c * c_len, d))
                 for a in (r, k, v, w)]
        _, fin = ref_rwkv.rwkv6_chunked(*heads, jnp.asarray(u))
        _close(states[:, c - 1].numpy(), np.asarray(fin).reshape(b * h, d, d),
               TOL_F32)
    again = rw.rwkv6_scan_plain(*(torch.from_numpy(a) for a in
                                  (r, k, v, w, u)))
    assert torch.equal(out, again)


def test_rwkv6_backward_refuses_a_state_under_grad():
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in
                        _rwkv_np((2, 5, 8), heads=2))
    s0 = torch.zeros((2, 8, 8))
    rg = r.clone().requires_grad_()
    with pytest.raises(ValueError, match="state0 and return_state"):
        ops.rwkv6_scan(rg, k, v, w, u, state0=s0)
    with pytest.raises(ValueError, match="state0 and return_state"):
        ops.rwkv6_scan(rg, k, v, w, u, return_state=True)
    with torch.no_grad():       # a carried state, as served
        out, s = ops.rwkv6_scan(rg, k, v, w, u, state0=s0,
                                return_state=True)
    assert out.grad_fn is None and s.shape == (2, 8, 8)


def test_rwkv6_backward_work_record():
    """10 D^2 + 12 D flops a row and step; r, k, v, do read and dr, dk, dv
    written at the item size, w and dw in f32, u and du once a head."""
    flops, nbytes = rw.work_bwd(64, 4096, 64, 64, 2)
    n = 64 * 4096 * 64
    assert flops == 64 * 4096 * (10 * 64 * 64 + 12 * 64)
    assert nbytes == 7 * 2 * n + 8 * n + 8 * 64 * 64
    # About 0.16 ms at 67 TFLOP/s, above the bytes' 0.11 ms at 3.35 TB/s.
    assert 0.16e-3 < flops / 67e12 < 0.17e-3
    assert nbytes / 3.35e12 < flops / 67e12


def test_rwkv_grad_witness_agrees_at_smoke_size():
    """``scripts/rwkv_grad_witness.py`` at rwkv6-7b's smoke width on the
    CPU: every f32 variant of the step's gradient (the plain versions
    here) within ``TOL_F32`` of its f64 witness, the witness's own loss
    the f32 step's, and the witness restoring what it patched."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parent.parent / "scripts"
            / "rwkv_grad_witness.py")
    spec = importlib.util.spec_from_file_location("rwkv_grad_witness", path)
    witness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(witness)
    real = (torch.Tensor.float, ops.rwkv6_scan)
    out = witness.run(configs.get("rwkv6-7b").smoke, "float32", 2, 24,
                      torch.device("cpu"), list(witness.VARIANTS))
    assert (torch.Tensor.float, ops.rwkv6_scan) == real
    assert set(out["variants"]) == {"f64", *witness.VARIANTS}
    for label, row in out["variants"].items():
        assert np.isfinite(row["grad_norm"]) and row["grad_norm"] > 0
        if label != "f64":
            assert row["global_rel_dist_to_f64"] < TOL_F32, label
            assert row["loss_rel_to_f64"] < TOL_F32, label
            assert len(row["pos0_layer_rel_to_f64"]) == 2


def _refusal_calls():
    def f32(*shape):
        return torch.randn(shape, requires_grad=True)
    w8 = torch.randint(-127, 128, (16, 8), dtype=torch.int8)
    return {
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
    # Griffin's MQA shape cut in S: the dkdv launch splits its ten query
    # heads over CTAs.
    ("griffin_mqa_window", (1, 10, 1, 300, 300, 256),
     dict(causal=True, window=128)),
    ("d192_gqa_window", (2, 6, 2, 190, 190, 192),
     dict(causal=True, window=70)),
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
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    before = fb.launches
    got = fb.flash_attention_bwd_cuda(q, k, v, o, g, lse, **kw)
    want = fb.flash_attention_bwd_plain(q, k, v, o, g, lse, **kw)
    torch.cuda.synchronize()
    assert fb.launches == before + 1
    for x, w in zip(got, want):
        assert x.dtype == dt and x.shape == w.shape
        _close(x.float().cpu().numpy(), w.float().cpu().numpy(),
               TOL_CARD[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,kw", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_flash_forward_statistics_on_card(cuda_device, name, shape, kw,
                                          dtype):
    """The kernel's row statistics against the plain forward's at 1e-5 of
    the largest finite value (in bf16 too: the logits are f32 sums of
    exact products, and the sums of probabilities are never rounded), +inf
    on the same rows, and the output bit for bit the one without
    statistics."""
    dt = getattr(torch, dtype)
    q, k, v, _ = (torch.from_numpy(a).to(cuda_device, dt)
                  for a in _qkvg(shape, seed=5))
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)[1]
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, **kw))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), inf) and (lse[inf] > 0).all()
    _close(lse[~inf].cpu().numpy(), want[~inf].cpu().numpy(), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,kw", [
    ("one_split", (1, 4, 4, 200, 200, 64), dict(causal=True)),
    ("ten_splits", (1, 10, 1, 300, 300, 256), dict(causal=True, window=128)),
])
def test_flash_backward_cuda_is_deterministic_on_card(cuda_device, name,
                                                      shape, kw):
    """Two bf16 calls on the same inputs give the same bits for dq, dk
    and dv, with the query heads split over CTAs and without."""
    q, k, v, g = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                  for a in _qkvg(shape, seed=6))
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    b, hq, hkv, _, sk, d = shape
    assert (fb.card_splits(b, hq, hkv, sk, d, cuda_device) > 1) == (
        name == "ten_splits")
    first = fb.flash_attention_bwd_cuda(q, k, v, o, g, lse, **kw)
    second = fb.flash_attention_bwd_cuda(q, k, v, o, g, lse, **kw)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


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


# (name, (bh, t, d), decay range): one step, one sub-chunk of 16, ragged
# T, each head dim, fast decay and decay near 1, the forward's shape, T an
# exact multiple of the chunk (64 at D = 64), one step past a chunk, and
# exact zeros and ones in the decays (``_exact_zeros``).
RWKV_CARD_CASES = [
    ("t1", (4, 1, 64), (0.45, 0.95)),
    ("one_chunk", (4, 16, 64), (0.45, 0.95)),
    ("ragged", (4, 117, 64), (0.45, 0.95)),
    ("d32", (6, 70, 32), (0.45, 0.95)),
    ("d128", (4, 50, 128), (0.45, 0.95)),
    ("fast_decay", (4, 300, 64), (0.01, 1.0)),
    ("near_one", (4, 300, 64), (0.999, 1.0)),
    ("forward_shape", (64, 1024, 64), (0.45, 0.95)),
    ("chunk_multiple", (4, 256, 64), (0.45, 0.95)),
    ("chunk_plus_one", (4, 65, 64), (0.45, 0.95)),
    ("exact_zeros", (4, 150, 64), (0.01, 1.0)),
]


def _rwkv_card(device, shape, w_range, dtype, seed, zeros=False):
    """r, k, v, w, u, do on the card and the forward kernel's chunk states
    on them, as training's forward stores them; with ``zeros``, w holds
    ``_exact_zeros``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r, k, v, do = (torch.randn(shape, generator=gen, device=device)
                   .mul(0.5).to(dtype) for _ in range(4))
    lo, hi = w_range
    w = torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo
    if zeros:
        _exact_zeros(w)
    u = torch.randn((2, shape[-1]), generator=gen, device=device) * 0.3
    _, states = rw.rwkv6_scan_cuda(r, k, v, w, u, return_chunk_states=True)
    return (r, k, v, w, u, do), states


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,w_range", RWKV_CARD_CASES,
                         ids=[c[0] for c in RWKV_CARD_CASES])
def test_rwkv6_backward_cuda_matches_plain_on_card(cuda_device, name, shape,
                                                   w_range, dtype):
    args, states = _rwkv_card(cuda_device, shape, w_range,
                              getattr(torch, dtype), seed=len(name),
                              zeros=name == "exact_zeros")
    before = rw.bwd.launches
    got = rw.rwkv6_scan_bwd_cuda(*args, states)
    want = rw.rwkv6_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    assert rw.bwd.launches == before + 1
    for x, w_ in zip(got, want):
        assert x.dtype == w_.dtype and x.shape == w_.shape
        assert torch.isfinite(x).all()
        _close(x.float().cpu().numpy(), w_.float().cpu().numpy(),
               TOL_CARD[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_backward_cuda_is_deterministic_on_card(cuda_device, dtype):
    """Two calls on the same inputs give the same bits in all five
    gradients: no atomics, every sum in a fixed order."""
    args, states = _rwkv_card(cuda_device, (8, 300, 64), (0.01, 1.0),
                              getattr(torch, dtype), seed=3)
    first = rw.rwkv6_scan_bwd_cuda(*args, states)
    again = rw.rwkv6_scan_bwd_cuda(*args, states)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [20, 64, 200])
def test_rwkv6_forward_is_unchanged_by_its_chunk_states(cuda_device, dtype,
                                                        t):
    """The served forward (no states asked) and training's (the states
    stored) give the same output bits; the states match the plain
    forward's."""
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    dt = getattr(torch, dtype)
    r, k, v = (torch.randn((4, t, 64), generator=gen, device=cuda_device)
               .mul(0.5).to(dt) for _ in range(3))
    w = torch.rand((4, t, 64), generator=gen, device=cuda_device) * 0.5 + 0.45
    u = torch.randn((2, 64), generator=gen, device=cuda_device) * 0.3
    served = rw.rwkv6_scan_cuda(r, k, v, w, u)
    out, states = rw.rwkv6_scan_cuda(r, k, v, w, u, return_chunk_states=True)
    assert torch.equal(served, out)
    _, want = rw.rwkv6_scan_plain(r, k, v, w, u, return_chunk_states=True)
    assert states.shape == want.shape == (4, rw.n_chunk_states(t, 64), 64, 64)
    if states.numel():
        _close(states.cpu().numpy(), want.cpu().numpy(), TOL_CARD["float32"])


@pytest.mark.gpu
def test_rwkv6_function_on_card_takes_head_transposed_views(cuda_device):
    """The model's (1, T, H, D) projections viewed as (H, T, D), through
    the autograd Function, against autograd of the plain forward."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = [torch.randn((1, 90, 4, 64), generator=gen, device=cuda_device) * 0.5
         for _ in range(3)]
    w = torch.rand((1, 90, 4, 64), generator=gen, device=cuda_device) * 0.5 \
        + 0.45
    ts = [t.transpose(1, 2).reshape(4, 90, 64) for t in
          (a.clone().requires_grad_() for a in x + [w])]
    u = (torch.randn((4, 64), generator=gen, device=cuda_device) * 0.3
         ).requires_grad_()
    g = torch.randn((4, 90, 64), generator=gen, device=cuda_device)
    before = rw.bwd.launches
    got = torch.autograd.grad(ops.rwkv6_scan(*ts, u), ts + [u], g)
    assert rw.bwd.launches == before + 1
    want = torch.autograd.grad(rw.rwkv6_scan_plain(*ts, u), ts + [u], g)
    for a, b in zip(got, want):
        _close(a.cpu().numpy(), b.cpu().numpy(), TOL_CARD["float32"])


# ---------------------------------------------------------------------------
# layers.mm: a bf16 product keeps its f32 result, forward and backward
# ---------------------------------------------------------------------------

def _mm_operands(device, w_shape):
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn((3, 37, w_shape[-2]), generator=gen, device=device)
    if len(w_shape) == 3:
        x = torch.randn((w_shape[0], 37, w_shape[1]), generator=gen,
                        device=device)
    w = torch.randn(w_shape, generator=gen, device=device) * 0.1
    return x.bfloat16(), w.bfloat16()


@pytest.mark.parametrize("w_shape", [(96, 80), (4, 96, 80)],
                         ids=["dense", "expert_bank"])
def test_mm_keeps_the_f32_product_on_cpu(w_shape):
    """On the CPU the bf16 operands are widened first: bit-equal to the
    f32 product, never rounded to bf16."""
    from repro_torch.models.layers import mm
    x, w = _mm_operands(torch.device("cpu"), w_shape)
    got = mm(x, w)
    want = torch.matmul(x.float(), w.float())
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert not torch.equal(got, torch.matmul(x, w).float())


@pytest.mark.gpu
@pytest.mark.parametrize("w_shape", [(96, 80), (4, 96, 80)],
                         ids=["dense", "expert_bank"])
def test_mm_keeps_the_f32_product_on_card(cuda_device, w_shape):
    """On the card the bf16 GEMM writes its f32 accumulator
    (``out_dtype``): within f32 summation order of the f32 product of the
    same operands, far inside a bf16 rounding; its gradients are the bf16
    casts of the f32 products of the cotangent."""
    from repro_torch.models.layers import mm
    x, w = _mm_operands(cuda_device, w_shape)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = mm(xg, wg)
    want = torch.matmul(x.float(), w.float())
    assert got.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    g = torch.randn_like(got)
    dx, dw = torch.autograd.grad(got, (xg, wg), g)
    gb = g.bfloat16().float()
    want_dx = torch.matmul(gb, w.float().transpose(-1, -2)).bfloat16()
    lead = x.float().reshape(-1, x.shape[-1]) if len(w_shape) == 2 \
        else x.float()
    want_dw = (torch.matmul(lead.transpose(-1, -2), gb.reshape(
        lead.shape[:-1] + (gb.shape[-1],))) if len(w_shape) == 3
        else lead.t() @ gb.reshape(-1, gb.shape[-1])).bfloat16()
    assert dx.dtype == dw.dtype == torch.bfloat16
    for a, b in ((dx, want_dx), (dw, want_dw)):
        assert float((a.float() - b.float()).abs().max()) \
            <= 8e-3 * float(b.float().abs().max())


# ---------------------------------------------------------------------------
# remat "dots": the f32 products of 16-bit GEMMs are kept
# ---------------------------------------------------------------------------

def test_remat_dots_saves_the_products_of_mm():
    """``dots`` keeps the outputs of ``mm`` in both overloads (the card's
    16-bit GEMM writes its f32 result through ``aten.mm.dtype``) and of
    ``addmm``; a batched ``bmm`` is recomputed, the reference's
    no-batch-dims rule."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch import runtime
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.mm.dtype, aten.addmm.default):
        assert runtime._dots_saveable(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.bmm.dtype):
        assert runtime._dots_saveable(None, op) \
            == CheckpointPolicy.PREFER_RECOMPUTE


@pytest.mark.gpu
def test_remat_dots_saves_the_bf16_products_on_card(cuda_device,
                                                    monkeypatch):
    """gemma2-2b's bf16 smoke loss and gradients under ``remat="dots"``:
    the card's products go through ``aten.mm.dtype``, and each is saved,
    none recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch import runtime
    from repro_torch.train import step as step_lib
    real, seen = runtime._dots_saveable, []

    def counting(ctx, op, *args, **kwargs):
        policy = real(ctx, op, *args, **kwargs)
        seen.append((op, policy))
        return policy
    monkeypatch.setattr(runtime, "_dots_saveable", counting)
    cfg = configs.get("gemma2_2b").smoke
    assert cfg.dtype == "bfloat16"
    params = api.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                      device=cuda_device)
    rng = np.random.default_rng(0)
    batch = step_lib._batch_on(
        {k: rng.integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
         for k in ("tokens", "labels")}, cuda_device)
    loss_fn = step_lib.make_loss_fn(cfg, step_lib.TrainOptions(remat="dots"))
    leaves = step_lib._trainable(params)
    loss, _ = loss_fn(params, batch)
    grads = step_lib._grad(loss, leaves)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)
    mm_f32 = [policy for op, policy in seen if op == torch.ops.aten.mm.dtype]
    assert mm_f32 and all(p == CheckpointPolicy.MUST_SAVE for p in mm_f32)
