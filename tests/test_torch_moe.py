"""The port's MoE transformers (``mixtral-8x22b``, ``deepseek-v3-671b``)
against the JAX package: the router, the capacity dispatch, the MoE block,
MLA (expanded prefill, absorbed decode, its cache), the dense prefix, the
multi-token-prediction head, and the model on every LM entry point.

The same JAX-initialised weights go through ``transformer.params_from_numpy``
(deepseek's zero router bias is drawn from a numpy seed first, so the
selection bias carries weight); tokens and activations come from numpy
seeds.  Tolerances are PR 25's: 2e-3 in float32; the reference's own rtol
3e-2 / atol 3e-1 in bfloat16 (``tests/test_archs.py``).

Routing ids are held exactly.  In float32 the two packages route every
token alike.  In bfloat16 both keep each GEMM's f32 product
(``layers.mm``), so they differ only in summation order, and
``test_bf16_deepseek_routes_as_the_reference_unpinned`` holds the smoke
deepseek forward's ids equal to the reference's with no pinning.  The
other bf16 model tests still give the port the reference's ids (recorded
from its eager run) and allow a flip only at a near tie (``NEAR_TIE``), so
that the rest of the model is held at the bf16 tolerance whatever the
summation order does to a tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro.serve import engine as ref_engine
from repro_torch import configs, runtime
from repro_torch.kernels import ops
from repro_torch.models import api, mla, moe, transformer, tree
from repro_torch.serve import engine

ARCHS = ["mixtral_8x22b", "deepseek_v3_671b"]
TOKENS = 20          # past mixtral's smoke window of 16
F32_TOL = dict(rtol=2e-3, atol=2e-3)
# The largest selection-score gap a bf16 routing flip may span.
NEAR_TIE = 1e-2


def _tol(dtype):
    return F32_TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-1)


def _np(x):
    return np.asarray(x, np.float32)


def _with_bias(ref_params, seed=5):
    """The reference tree with its zero router biases replaced by seeded
    normals (a no-op on mixtral)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if str(getattr(path[-1], "key", "")) == "router_bias":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.05,
                               leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, ref_params)


def _cfgs(arch, dtype="float32", **moe_kw):
    ref_cfg = dataclasses.replace(ref_configs.get(arch).smoke, dtype=dtype)
    cfg = dataclasses.replace(configs.get(arch).smoke, dtype=dtype)
    if moe_kw:
        ref_cfg = dataclasses.replace(
            ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe_kw))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return ref_cfg, cfg


def _models(arch, dtype="float32", **moe_kw):
    ref_cfg, cfg = _cfgs(arch, dtype, **moe_kw)
    ref_params = _with_bias(ref_api.init(ref_cfg, jax.random.PRNGKey(0)))
    params = transformer.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref_cfg, ref_params, cfg, params


def _tokens(cfg, b=2, s=TOKENS, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_trees_close(ref_tree, port_tree, tol):
    ref_leaves = jax.tree.leaves(ref_tree)
    leaves = jax.tree.leaves(port_tree)      # the same (sorted) key order
    assert len(ref_leaves) == len(leaves)
    for want, got in zip(ref_leaves, leaves):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


class _Routing:
    """The reference's routing ids, recorded in call order (a host callback
    of its ``_route``, ordered, so a jitted run records them too), handed
    to the port's ``_top_k`` in the same order.  Each port decision that
    differs from the reference's must be a near tie of the port's own
    scores; ``flips`` counts them."""

    def __init__(self, monkeypatch):
        self.ids, self.at, self.flips, self.eager = [], 0, 0, False
        route, top_k = ref_moe._route, moe._top_k

        def record(p, x2d, mo):
            out = route(p, x2d, mo)
            jax.debug.callback(lambda i: self.ids.append(np.array(i)),
                               out[1], ordered=True)
            return out

        def replay(scores, k):
            mine = top_k(scores, k)
            want = torch.from_numpy(self.ids[self.at]).long()
            self.at += 1
            differ = (mine.sort(1)[0] != want.sort(1)[0]).any(1)
            for t in torch.nonzero(differ).flatten().tolist():
                gap = float(scores[t, mine[t]].min()
                            - scores[t, want[t]].min())
                assert 0.0 <= gap < NEAR_TIE, (t, gap)
            self.flips += int(differ.sum())
            return want
        monkeypatch.setattr(ref_moe, "_route", record)
        monkeypatch.setattr(moe, "_top_k", replay)

    def reference(self, fn, *args, **kw):
        """``fn`` of the reference, its recorded ids delivered on return;
        with ``self.eager`` op by op, as the port runs (XLA's fusions of a
        whole jitted forward round some bf16 intermediates elsewhere)."""
        if self.eager:
            with jax.disable_jit():
                return fn(*args, **kw)
        out = fn(*args, **kw)
        jax.effects_barrier()
        return out


def _reference_runner(dtype, monkeypatch, *, eager=False):
    """(run the reference, routing or None): bf16 pins the port to the
    reference's ids; f32 routes on its own (and must agree)."""
    if dtype == "float32":
        return (lambda fn, *a, **kw: fn(*a, **kw)), None
    routing = _Routing(monkeypatch)
    routing.eager = eager
    return routing.reference, routing


# ---------------------------------------------------------------------------
# The router, the dispatch, the MoE block
# ---------------------------------------------------------------------------

def _moe_params(arch, **moe_kw):
    ref_cfg, cfg = _cfgs(arch, **moe_kw)
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(3), ref_cfg)
    if "router_bias" in ref_p:
        ref_p["router_bias"] = jnp.asarray(np.random.default_rng(4).normal(
            size=ref_p["router_bias"].shape) * 0.05, jnp.float32)
    p = tree.tree_map(lambda a: tree.from_numpy(np.asarray(a)),
                      jax.tree.map(np.asarray, ref_p))
    return ref_cfg, ref_p, cfg, p


def _x2d(cfg, t=64, seed=2):
    return np.random.default_rng(seed).normal(
        size=(t, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS, ids=["softmax", "sigmoid"])
def test_route_matches_reference(arch):
    """The same tokens through both routers: the ids equal, the weights
    and the aux within the f32 tolerance."""
    ref_cfg, ref_p, cfg, p = _moe_params(arch)
    x = _x2d(cfg, t=256)
    w_want, i_want, aux_want = ref_moe._route(ref_p, jnp.asarray(x),
                                              ref_cfg.moe)
    w_got, i_got, aux_got = moe._route(p, torch.from_numpy(x), cfg.moe)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(w_got.numpy(), _np(w_want), **F32_TOL)
    np.testing.assert_allclose(float(aux_got), float(aux_want), **F32_TOL)


def test_top_k_breaks_ties_toward_the_lower_index():
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1],
                           [0.2, 0.2, 0.2, 0.2, 0.2]])
    want = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)[1]
    got = moe._top_k(scores, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[1, 3, 0], [0, 1, 2]]


def _kept(tok4slot, t):
    """The (token, expert) assignments a dispatch table keeps."""
    e_idx, _ = np.nonzero(tok4slot < t)
    return set(zip(tok4slot[tok4slot < t].tolist(), e_idx.tolist()))


@pytest.mark.parametrize("capacity_factor", [None, 0.5],
                         ids=["smoke", "dropping"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_indices_match_reference(arch, capacity_factor):
    """The reference's routing through both dispatches at the smoke capacity
    (nothing drops) and at capacity factor 0.5: the token and weight of
    every slot, and so the same dropped (token, expert) assignments."""
    kw = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    ref_cfg, ref_p, cfg, p = _moe_params(arch, **kw)
    t = 64
    w, i, _ = ref_moe._route(ref_p, jnp.asarray(_x2d(cfg, t)), ref_cfg.moe)
    mo = cfg.moe
    cap = moe._capacity(t, mo)
    assert cap == ref_moe._capacity(t, ref_cfg.moe)
    kw = dict(num_experts=mo.num_experts, e_start=0,
              e_count=mo.num_experts, capacity=cap)
    tok_want, w_want = ref_moe._dispatch_indices(i, w, **kw)
    tok_got, w_got = moe._dispatch_indices(
        torch.from_numpy(np.array(i)).long(),
        torch.from_numpy(np.array(w)), **kw)
    np.testing.assert_array_equal(tok_got.numpy(), np.asarray(tok_want))
    np.testing.assert_array_equal(w_got.numpy(), np.asarray(w_want))
    assigned = {(tok, int(e)) for tok, row in enumerate(np.asarray(i))
                for e in row}
    dropped = assigned - _kept(np.asarray(tok_want), t)
    assert assigned - _kept(tok_got.numpy(), t) == dropped
    assert bool(dropped) == (capacity_factor is not None), len(dropped)


def test_dispatch_of_an_expert_slice_matches_reference():
    """``e_start``/``e_count``: the slice of experts one device of the
    reference's expert-parallel layout owns."""
    ref_cfg, ref_p, cfg, p = _moe_params("deepseek_v3_671b",
                                         capacity_factor=0.5)
    w, i, _ = ref_moe._route(ref_p, jnp.asarray(_x2d(cfg, 32)), ref_cfg.moe)
    kw = dict(num_experts=8, e_start=2, e_count=4, capacity=3)
    want = ref_moe._dispatch_indices(i, w, **kw)
    got = moe._dispatch_indices(torch.from_numpy(np.array(i)).long(),
                                torch.from_numpy(np.array(w)), **kw)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


@pytest.mark.parametrize("capacity_factor", [None, 0.5],
                         ids=["smoke", "dropping"])
@pytest.mark.parametrize("arch", ARCHS, ids=["no_shared", "shared"])
def test_moe_block_matches_reference(arch, capacity_factor):
    """``moe_block`` on (2, 16) tokens: output and aux at the f32
    tolerance, with and without the shared expert, with and without
    drops."""
    kw = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    ref_cfg, ref_p, cfg, p = _moe_params(arch, **kw)
    assert ("shared" in p) == (arch == "deepseek_v3_671b")
    x = _x2d(cfg, 32).reshape(2, 16, cfg.d_model)
    y_want, aux_want = ref_moe.moe_block(ref_p, jnp.asarray(x), ref_cfg)
    y_got, aux_got = moe.moe_block(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y_got.numpy(), _np(y_want), **F32_TOL)
    np.testing.assert_allclose(float(aux_got), float(aux_want), **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_rows_alone_routes_each_row_by_itself(arch):
    """``rows_alone``: (4, 1) tokens at the published capacity factor 1.25
    equal each row through the block alone (the reference batcher's
    per-slot step, capacity top_k, which never drops), while joint routing
    of the same four tokens (capacity 2) drops some and differs."""
    ref_cfg, ref_p, cfg, p = _moe_params(arch, capacity_factor=1.25)
    x = torch.from_numpy(_x2d(cfg, 4, seed=7).reshape(4, 1, cfg.d_model))
    x[2:] = x[1]                 # three rows route alike: joint drops
    alone, _ = moe.moe_block(p, x, cfg, rows_alone=True)
    for r in range(4):
        want, _ = ref_moe.moe_block(ref_p, jnp.asarray(x[r:r + 1].numpy()),
                                    ref_cfg)
        np.testing.assert_allclose(alone[r:r + 1].numpy(), _np(want),
                                   **F32_TOL)
    joint, _ = moe.moe_block(p, x, cfg)
    want, _ = ref_moe.moe_block(ref_p, jnp.asarray(x.numpy()), ref_cfg)
    np.testing.assert_allclose(joint.numpy(), _np(want), **F32_TOL)
    gap = float((joint - alone).abs().max())
    print(f"{arch}: joint routing of 4 slots differs from per-row routing "
          f"by {gap}")
    assert gap > 10 * F32_TOL["atol"]


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_params():
    ref_cfg, cfg = _cfgs("deepseek_v3_671b")
    ref_p = ref_mla.init_mla(jax.random.PRNGKey(3), ref_cfg)
    p = tree.tree_map(lambda a: tree.from_numpy(np.asarray(a)),
                      jax.tree.map(np.asarray, ref_p))
    return ref_cfg, ref_p, cfg, p


def test_mla_matches_reference_at_prefill_cache_and_decode():
    """The expanded form over 12 tokens (no cache, and a prefill at 0 into
    a 24-token cache: the same output), the compressed cache it publishes
    (``c_kv``, ``k_rope``), and three absorbed decode steps after it, each
    at the f32 tolerance."""
    ref_cfg, ref_p, cfg, p = _mla_params()
    ref_attention = jax.jit(ref_mla.mla_attention, static_argnums=2)
    x = np.random.default_rng(2).normal(
        size=(2, 15, cfg.d_model)).astype(np.float32)
    y_want, _ = ref_attention(ref_p, jnp.asarray(x[:, :12]), ref_cfg)
    y_got, _ = mla.mla_attention(p, torch.from_numpy(x[:, :12]), cfg)
    np.testing.assert_allclose(y_got.numpy(), _np(y_want), **F32_TOL)
    ref_cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                             ref_mla.mla_cache_shape(ref_cfg, 2, 24))
    cache = tree.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                          mla.mla_cache_shape(cfg, 2, 24))
    y_want, ref_cache = ref_attention(
        ref_p, jnp.asarray(x[:, :12]), ref_cfg, cache=ref_cache,
        cache_pos=0)
    y_got, cache = mla.mla_attention(p, torch.from_numpy(x[:, :12]), cfg,
                                     cache=cache, cache_pos=0)
    np.testing.assert_allclose(y_got.numpy(), _np(y_want), **F32_TOL)
    assert set(cache) == {"c_kv", "k_rope"}
    _assert_trees_close(ref_cache, cache, F32_TOL)
    for t in range(12, 15):
        y_want, ref_cache = ref_attention(
            ref_p, jnp.asarray(x[:, t:t + 1]), ref_cfg, cache=ref_cache,
            cache_pos=t)
        y_got, cache = mla.mla_attention(p, torch.from_numpy(x[:, t:t + 1]),
                                         cfg, cache=cache, cache_pos=t)
        np.testing.assert_allclose(y_got.numpy(), _np(y_want), **F32_TOL)
    _assert_trees_close(ref_cache, cache, F32_TOL)


def test_mla_decode_takes_per_row_positions():
    """One absorbed step with a (B,) position tensor equals each row stepped
    alone at its own position (the batcher's slots)."""
    _, _, cfg, p = _mla_params()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 10, cfg.d_model)).astype(np.float32))
    cache = tree.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                          mla.mla_cache_shape(cfg, 2, 16))
    _, cache = mla.mla_attention(p, x[:, :9], cfg, cache=cache, cache_pos=0)
    lengths = torch.tensor([9, 5])
    nxt = x[:, 9:10]
    got, _ = mla.mla_attention(p, nxt, cfg, cache=cache, cache_pos=lengths)
    for r in range(2):
        row = tree.tree_map(lambda t: t[r:r + 1], cache)
        want, _ = mla.mla_attention(p, nxt[r:r + 1], cfg, cache=row,
                                    cache_pos=int(lengths[r]))
        np.testing.assert_allclose(got[r:r + 1].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_mla_prefill_pads_v_to_the_query_width(monkeypatch):
    """The expanded prefill runs flash once, with q, k and v all
    qk_nope + qk_rope wide (v zero-padded) and MLA's scale."""
    _, _, cfg, p = _mla_params()
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     kw["scale"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    x = torch.zeros((1, 6, cfg.d_model))
    mla.mla_attention(p, x, cfg)
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert seen == [((1, cfg.num_heads, 6, qk),) * 3
                    + (pytest.approx(qk ** -0.5),)]


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_init_has_the_references_layout():
    """``api.init``: the reference's tree (the dense prefix, the MoE blocks,
    the MTP head), leaf for leaf in shape and dtype."""
    for arch in ARCHS:
        ref_cfg, cfg = _cfgs(arch)
        want = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
        got = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert jax.tree.structure(want) == jax.tree.structure(
            tree.tree_map(lambda t: 0, got))
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert (tuple(g.shape), str(g.dtype)) == (
                w.shape, f"torch.{w.dtype}"), arch


def test_bf16_deepseek_routes_as_the_reference_unpinned(monkeypatch):
    """The bf16 smoke deepseek forward picks the reference's experts for
    every token of every routed layer and of the MTP head, the port
    routing on its own scores.  A flip left over must be a summation-order
    tie (a selection-score gap under 1e-5); its gap is printed."""
    ref_cfg, ref_params, cfg, params = _models("deepseek_v3_671b",
                                               "bfloat16")
    ref_ids, mine = [], []
    route, top_k = ref_moe._route, moe._top_k

    def record(p, x2d, mo):
        out = route(p, x2d, mo)
        ref_ids.append(np.asarray(out[1]))
        return out

    def own(scores, k):
        ids = top_k(scores, k)
        mine.append((scores, ids))
        return ids
    monkeypatch.setattr(ref_moe, "_route", record)
    monkeypatch.setattr(moe, "_top_k", own)
    toks = _tokens(cfg)
    with jax.disable_jit():
        ref_api.forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)})
    api.forward(params, cfg, {"tokens": toks})
    assert len(ref_ids) == len(mine) > 0
    gaps = []
    for want, (scores, got) in zip(ref_ids, mine):
        want = torch.from_numpy(want).long()
        assert got.shape == want.shape
        differ = (got.sort(1)[0] != want.sort(1)[0]).any(1)
        for t in torch.nonzero(differ).flatten().tolist():
            gaps.append(float(scores[t, got[t]].min()
                              - scores[t, want[t]].min()))
    print(f"deepseek bf16 unpinned: {len(gaps)} flips in "
          f"{sum(len(w) for w in ref_ids)} tokens, gaps {gaps}")
    assert all(abs(g) < 1e-5 for g in gaps), gaps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype, monkeypatch):
    """Logits, ``aux_loss`` and (deepseek) ``mtp_hidden``, then
    ``mtp_logits`` on the hidden state and the next tokens."""
    ref_cfg, ref_params, cfg, params = _models(arch, dtype)
    run_ref, routing = _reference_runner(dtype, monkeypatch, eager=True)
    toks = _tokens(cfg)
    want = run_ref(jax.jit(ref_api.forward, static_argnums=1), ref_params,
                   ref_cfg, {"tokens": jnp.asarray(toks)})
    got = api.forward(params, cfg, {"tokens": toks})
    assert set(got) == set(want)
    assert tuple(got["logits"].shape) == (2, TOKENS, cfg.padded_vocab)
    np.testing.assert_allclose(got["logits"].numpy(), _np(want["logits"]),
                               **_tol(dtype))
    np.testing.assert_allclose(float(got["aux_loss"]),
                               float(want["aux_loss"]), **F32_TOL)
    assert float(got["aux_loss"]) > 0
    if cfg.mtp:
        np.testing.assert_allclose(got["mtp_hidden"].float().numpy(),
                                   _np(want["mtp_hidden"]), **_tol(dtype))
        nxt = _tokens(cfg, seed=2)
        want_l = run_ref(jax.jit(ref_transformer.mtp_logits,
                                 static_argnums=1), ref_params, ref_cfg,
                         want["mtp_hidden"], jnp.asarray(nxt))
        got_l = transformer.mtp_logits(params, cfg, got["mtp_hidden"], nxt)
        assert tuple(got_l.shape) == (2, TOKENS, cfg.padded_vocab)
        np.testing.assert_allclose(got_l.numpy(), _np(want_l), **_tol(dtype))
    if routing is not None:
        assert routing.at == len(routing.ids)
        print(f"{arch} bf16: {routing.flips} near-tie routing flips")


def test_forward_and_mtp_launch_flash_once_a_layer(monkeypatch):
    """deepseek's forward calls flash once a layer (the dense prefix
    included), the MTP head once more; a decode step never."""
    ref_cfg, ref_params, cfg, params = _models("deepseek_v3_671b")
    calls = {"n": 0}
    real = ops.flash_attention

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    toks = _tokens(cfg, b=1, s=8)
    out = api.forward(params, cfg, {"tokens": toks})
    assert calls["n"] == cfg.num_layers
    transformer.mtp_logits(params, cfg, out["mtp_hidden"], toks)
    assert calls["n"] == cfg.num_layers + 1
    state = api.init_decode_state(cfg, 1, 16, device="cpu")
    api.decode_step(params, cfg, toks[:, :1], state, 0)
    assert calls["n"] == cfg.num_layers + 1


def _ref_decode(ref_cfg):
    return jax.jit(lambda p, t, s, pos: ref_api.decode_step(p, ref_cfg, t,
                                                            s, pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype, monkeypatch):
    """Token by token over 20 tokens (past mixtral's window of 16) into
    caches of 24: logits at every step and the whole cache tree (deepseek:
    the dense prefix's and the blocks' compressed caches)."""
    ref_cfg, ref_params, cfg, params = _models(arch, dtype)
    run_ref, routing = _reference_runner(dtype, monkeypatch)
    toks = _tokens(cfg)
    ref_state = ref_api.init_decode_state(ref_cfg, 2, 24)
    state = api.init_decode_state(cfg, 2, 24, device="cpu")
    step = _ref_decode(ref_cfg)
    for t in range(TOKENS):
        want, ref_state = run_ref(step, ref_params,
                                  jnp.asarray(toks[:, t:t + 1]), ref_state, t)
        got, state = api.decode_step(params, cfg, toks[:, t:t + 1], state, t)
        np.testing.assert_allclose(got.numpy(), _np(want), **_tol(dtype))
    _assert_trees_close(ref_state, state, _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_prefill_matches_lm_prefill(arch, dtype, monkeypatch):
    """``lm_prefill``: the prompt as one step at position 0 into fresh caches
    of 32 (MLA: the expanded form over the chunk, its compressed cache
    published): every position's logits and the caches."""
    ref_cfg, ref_params, cfg, params = _models(arch, dtype)
    run_ref, _ = _reference_runner(dtype, monkeypatch)
    toks = _tokens(cfg, s=14)
    want, ref_cache = run_ref(
        jax.jit(ref_transformer.lm_prefill, static_argnums=(1, 3)),
        ref_params, ref_cfg, jnp.asarray(toks), 32)
    got, cache = transformer.lm_prefill(params, cfg, toks, 32)
    np.testing.assert_allclose(got.numpy(), _np(want), **_tol(dtype))
    _assert_trees_close(ref_cache, cache, _tol(dtype))


class _Plan:
    """The one field ``build_serve_steps`` reads off a plan."""
    def __init__(self, chunk):
        self.serve = {"prefill_chunk": chunk}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_prefill_on_a_linear_cache_matches_reference(dtype,
                                                             monkeypatch):
    """mixtral, chunks of 8 of a 20-token prompt on a linear cache of 48
    (past the window): each chunk runs flash over the buffer with
    ``q_offset``; then three decode steps."""
    ref_cfg, ref_params, cfg, params = _models("mixtral_8x22b", dtype)
    run_ref, _ = _reference_runner(dtype, monkeypatch)
    prompt = _tokens(cfg, b=1, seed=3)
    ref_prefill, ref_decode = map(jax.jit, ref_engine.build_serve_steps(
        ref_cfg, max_len=48, plan=_Plan(8)))
    prefill, decode = engine.build_serve_steps(cfg, max_len=48,
                                               plan=_Plan(8))
    want, ref_state = run_ref(ref_prefill, ref_params, jnp.asarray(prompt),
                              ref_api.init_decode_state(ref_cfg, 1, 48))
    got, state = prefill(params, prompt,
                         api.init_decode_state(cfg, 1, 48, device="cpu"))
    np.testing.assert_allclose(got.numpy(), _np(want), **_tol(dtype))
    for i, tok in enumerate((3, 17, 255)):
        t = np.array([[tok]], np.int32)
        want, ref_state = run_ref(ref_decode, ref_params, jnp.asarray(t),
                                  ref_state, TOKENS + i)
        got, state = decode(params, t, state, TOKENS + i)
        np.testing.assert_allclose(got.numpy(), _np(want), **_tol(dtype))
    _assert_trees_close(ref_state, state, _tol(dtype))


# The reference's chunked prefill against its own token-by-token decode on
# deepseek's smoke config (prompt from numpy seed 3, chunks of 8): the gap
# its last logits show, bounded from below by the test.
MLA_REF_GAP = {12: 0.908, 20: 0.799}


@pytest.mark.parametrize("s", [12, 20])
def test_mla_chunked_prefill_holds_where_the_reference_loses_context(s):
    """deepseek served with ``prefill_chunk`` 8 on a cache of 32: the port
    expands the cached latents of the earlier chunks in front of each
    chunk, and holds its chunked prefill, the caches and two decode steps
    to its own token-by-token decode at 2e-3.  The reference expands only
    the chunk's own latents (``models/mla.py:91-101``), so its second chunk
    loses the first: its last logits miss its own token-by-token decode."""
    ref_cfg, ref_params, cfg, params = _models("deepseek_v3_671b")
    prompt = _tokens(cfg, b=1, s=s, seed=3)
    prefill, decode = engine.build_serve_steps(cfg, max_len=32,
                                               plan=_Plan(8))

    def token_by_token(step, state):
        for t in range(s):
            logits, state = step(prompt[:, t:t + 1], state, t)
        return logits, state

    got, state = prefill(params, prompt,
                         api.init_decode_state(cfg, 1, 32, device="cpu"))
    want, want_state = token_by_token(
        lambda t, st, p: decode(params, t, st, p),
        api.init_decode_state(cfg, 1, 32, device="cpu"))
    port_tbt = want.numpy()
    np.testing.assert_allclose(got.numpy(), port_tbt, **F32_TOL)
    for a, b in zip(tree.leaves(state), tree.leaves(want_state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32_TOL)
    for i, tok in enumerate((3, 17)):
        t = np.array([[tok]], np.int32)
        got, state = decode(params, t, state, s + i)
        want, want_state = decode(params, t, want_state, s + i)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)

    ref_prefill, ref_decode = map(jax.jit, ref_engine.build_serve_steps(
        ref_cfg, max_len=32, plan=_Plan(8)))
    ref_chunked, _ = ref_prefill(ref_params, jnp.asarray(prompt),
                                 ref_api.init_decode_state(ref_cfg, 1, 32))
    ref_tbt, _ = token_by_token(
        lambda t, st, p: ref_decode(ref_params, jnp.asarray(t), st, p),
        ref_api.init_decode_state(ref_cfg, 1, 32))
    err = float(np.abs(_np(ref_chunked) - _np(ref_tbt)[:, -1:]).max())
    print(f"reference MLA chunked vs token-by-token gap at s={s}: {err}")
    assert err > max(F32_TOL["atol"], 0.5 * MLA_REF_GAP[s]), err
    # Token by token, the two packages agree.
    np.testing.assert_allclose(port_tbt, _np(ref_tbt), **F32_TOL)


# ---------------------------------------------------------------------------
# The batcher
# ---------------------------------------------------------------------------

def test_batch_axes_of_the_compressed_and_dense_caches():
    cfg = configs.get("deepseek-v3-671b").smoke
    axes = engine._batch_axes(cfg, 32)
    want = {"c_kv": 1, "k_rope": 1}
    assert axes == {"dense": want, "blocks": {"slot0": want}}
    state = api.init_decode_state(cfg, 3, 32, device="cpu")
    assert tuple(state["dense"]["c_kv"].shape) == (1, 3, 32, 32)
    assert tuple(state["blocks"]["slot0"]["k_rope"].shape) == (2, 3, 1, 32, 8)


def _recorded(batcher):
    log = []
    step = batcher._decode_masked

    def rec(tok, live):
        out = step(tok, live)
        log.append(out.float().numpy() if torch.is_tensor(out)
                   else _np(out))
        return out
    batcher._decode_masked = rec
    return log


def _staggered(arch, port_kw=None):
    """Both batchers, f32, 4 slots at the published capacity factor 1.25,
    over requests arriving at ticks 0, 2 and 3; yields after every tick
    (ref batcher, port batcher, the tick's ref and port logits)."""
    ref_cfg, ref_params, cfg, params = _models(arch, capacity_factor=1.25)
    ref_b = ref_engine.ContinuousBatcher(ref_cfg, ref_params, slots=4,
                                         max_len=32)
    port_b = engine.ContinuousBatcher(cfg, params, slots=4, max_len=32)
    ref_log, port_log = _recorded(ref_b), _recorded(port_b)
    shapes = {"A": (10, 5), "B": (5, 3), "C": (3, 3), "D": (6, 4),
              "E": (4, 3)}
    pairs = {}
    for i, (name, (n, max_new)) in enumerate(shapes.items()):
        prompt = np.random.default_rng(i).integers(
            1, cfg.vocab_size, n).astype(np.int32)
        pairs[name] = (
            ref_engine.Request(rid=i, prompt=prompt, max_new=max_new),
            engine.Request(rid=i, prompt=prompt.copy(), max_new=max_new))
    arrivals = {0: ["A"], 2: ["B", "C"], 3: ["D", "E"]}
    for tick in range(40):
        for name in arrivals.get(tick, []):
            ref_b.submit(pairs[name][0])
            port_b.submit(pairs[name][1])
        ref_b.step()
        port_b.step()
        yield ref_b, port_b, list(ref_log), list(port_log)
        ref_log.clear()
        port_log.clear()
        for ref_req, port_req in pairs.values():
            assert len(port_req.out) == len(ref_req.out)
            port_req.out[:] = ref_req.out
        if tick > 3 and ref_b.queue.empty() and not any(ref_b.active):
            break
    assert all(p.done and len(p.out) == p.max_new for _, p in pairs.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_matches_reference_with_staggered_admissions(arch):
    """Five requests over 4 slots (E waits for a slot) at the published
    capacity factor, where joint routing of the slots would drop: every
    tick's logits, positions, slots and state at 2e-3 and the sampled
    tokens equal (the reference's copied in, so both feed the same
    inputs)."""
    for ref_b, port_b, ref_log, port_log in _staggered(arch):
        assert len(port_log) == len(ref_log)
        for want, got in zip(ref_log, port_log):
            np.testing.assert_allclose(got, want, **F32_TOL)
            np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                          want[:, -1].argmax(-1))
        np.testing.assert_array_equal(port_b.pos, ref_b.pos)
        assert [r is None for r in port_b.active] == \
            [r is None for r in ref_b.active]
        _assert_trees_close(ref_b.state, port_b.state, F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_joint_routing_of_the_slots_differs(arch, monkeypatch):
    """The same run with the batcher's tick routing all slots as one token
    set: some tick's logits leave the reference's tolerance, so the
    batcher's per-row routing is what holds it."""
    real = api.decode_step
    monkeypatch.setattr(api, "decode_step", lambda *a, **kw: real(
        *a, **{**kw, "rows_alone": False}))
    worst = 0.0
    for _, _, ref_log, port_log in _staggered(arch):
        for want, got in zip(ref_log, port_log):
            worst = max(worst, float(np.abs(got - want).max()))
    print(f"{arch}: joint routing of the slots misses the reference batcher "
          f"by {worst}")
    assert worst > 10 * F32_TOL["atol"]


# ---------------------------------------------------------------------------
# The parameter tree, int8 weights, the launcher
# ---------------------------------------------------------------------------

def test_params_from_numpy_refuses_a_misfit_prefix_or_head():
    _, ref_params, cfg, _ = _models("deepseek_v3_671b")
    good = jax.tree.map(np.asarray, ref_params)
    no_head = {k: v for k, v in good.items() if k != "mtp"}
    bad_proj = {**good, "mtp": {**good["mtp"],
                                "proj": good["mtp"]["proj"][:, :8]}}
    no_prefix = {k: v for k, v in good.items() if k != "dense_blocks"}
    deep_prefix = {**good, "dense_blocks": jax.tree.map(
        lambda a: np.concatenate([a, a]), good["dense_blocks"])}
    dense_blocks = {**good, "blocks": {"slot0": good["dense_blocks"]}}
    for bad in (no_head, bad_proj, no_prefix, deep_prefix, dense_blocks):
        with pytest.raises(ValueError, match="fit|leading axis|FFN"):
            transformer.params_from_numpy(cfg, bad, device="cpu")
    _, mixtral_params, mcfg, _ = _models("mixtral_8x22b")
    with pytest.raises(ValueError, match="MTP head"):
        transformer.params_from_numpy(
            mcfg, {**jax.tree.map(np.asarray, mixtral_params),
                   "mtp": good["mtp"]}, device="cpu")
    transformer.params_from_numpy(cfg, good, device="cpu")


def _nodes(node, path=()):
    if isinstance(node, dict) and set(node) != {"q8", "scale"}:
        for k, v in node.items():
            yield from _nodes(v, path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _nodes(v, path + (str(i),))
    else:
        yield path, node


def _bits(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a) \
        .view(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_is_bit_exact(arch, dtype):
    """Both smoke trees at ``min_size`` 16: every leaf both packages
    quantize (the expert banks per output channel on axis -2, the f32
    router, MLA's projections, the MTP head) has the reference's q8 and
    scale bit for bit; deepseek's stacked (2, 8) ``router_bias`` is the
    only leaf the reference quantizes and the port keeps; the router comes
    back in the model's dtype, as the reference's does."""
    ref_cfg, ref_params, cfg, params = _models(arch, dtype)
    want = dict(_nodes(jax.tree.map(np.asarray, ref_engine.quantize_params(
        ref_params, min_size=16))))
    got = dict(_nodes(engine.quantize_params(params, min_size=16)))
    assert set(got) == set(want)
    kept, quantized = set(), set()
    for path, g in got.items():
        w = want[path]
        if runtime.is_q8(g):
            assert runtime.is_q8(w), path
            for k in ("q8", "scale"):
                assert np.array_equal(_bits(g[k]), _bits(w[k])), path
            quantized.add(path)
        elif runtime.is_q8(w):
            kept.add(path)
        else:
            assert np.array_equal(_bits(g), _bits(w)), path
    bias = ("blocks", "slot0", "moe", "router_bias")
    assert kept == ({bias} if cfg.mtp else set())
    for leaf in ("w_gate", "w_up", "w_down", "router"):
        assert ("blocks", "slot0", "moe", leaf) in quantized
    router = runtime.maybe_dequant(engine.quantize_params(
        params, min_size=16)["blocks"]["slot0"]["moe"]["router"],
        getattr(torch, dtype))
    assert router.dtype == getattr(torch, dtype)


def test_router_bias_stays_where_the_reference_breaks():
    """The reference's quantized deepseek tree fails its own layer scan (the
    stacked router bias's scale spans the layer axis); the port's runs,
    its forward equal to the reference model's on the port's tree."""
    ref_cfg, ref_params, cfg, params = _models("deepseek_v3_671b")
    toks = _tokens(cfg, b=1, s=8, seed=3)
    with pytest.raises(ValueError, match="leading axis"):
        ref_api.forward(ref_engine.quantize_params(ref_params, min_size=16),
                        ref_cfg, {"tokens": jnp.asarray(toks)})
    q = engine.quantize_params(params, min_size=16)
    got = api.forward(q, cfg, {"tokens": toks})["logits"]
    want = ref_api.forward(tree.tree_map(lambda t: jnp.asarray(t.numpy()), q),
                           ref_cfg, {"tokens": jnp.asarray(toks)})["logits"]
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)
