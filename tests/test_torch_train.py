"""The port's training path (``repro_torch.train``, ``data``,
``launch.train``) against the JAX package's.

The same seeded numpy inputs, or one carried state (the reference's
``init_fn(key)`` as numpy, through ``train_state_from_numpy``), go through
both packages.  Tolerances: the data, the schedule's values and the
checkpoint bytes are equal; optimizer updates within 1e-6 of the largest
value (the same f32 arithmetic, ``pow`` and ``sqrt`` rounded by two
libraries); losses and gradients of the f32 smoke models within 2e-3 of
the largest value of each leaf, as the forward parity tests hold the
models (``tests/test_torch_transformer.py``), with that value taken as at
least 1e-4 (a leaf of smaller gradients, deepseek-v3's MTP and router
among them, carries the f32 rounding of O(1) sums, ~1e-7); the params'
change after two SGD steps within 2e-3 of its largest value, taken as at
least 1e-4 too (the change of a leaf of small gradients is near the
rounding of its O(1) values).  Gradients are compared, not
AdamW steps: AdamW's first update is +-lr wherever |g| >> eps, which
amplifies f32 noise in near-zero gradients.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as ref_pipeline
from repro.train import checkpoint as ref_ckpt
from repro.train import loss as ref_loss
from repro.train import optimizer as ref_opt
from repro.train import schedule as ref_schedule
from repro.train import step as ref_step
from repro.models import api as ref_api
from repro.models import transformer as ref_transformer
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer, tree
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import fault, loss as loss_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import schedule, step as step_lib

TOL_OPT = 1e-6
TOL_MODEL = 2e-3
GRAD_FLOOR = 1e-4


def _close(got, want, tol, floor=1e-7):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), floor)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"max|err| {err:.3e} > {tol} * {scale:.3e}"


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


# ---------------------------------------------------------------------------
# Data and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2_2b", "qwen2_vl_72b",
                                  "whisper_medium", "recurrentgemma_2b",
                                  "rwkv6_7b", "deepseek_v3_671b"])
@pytest.mark.parametrize("step,seed", [(0, 0), (7, 3)])
def test_synth_batch_equals_reference(arch, step, seed):
    want = ref_pipeline.synth_batch(ref_configs.get(arch).smoke, batch=3,
                                    seq=10, step=step, seed=seed)
    got = pipeline.synth_batch(configs.get(arch).smoke, batch=3, seq=10,
                               step=step, seed=seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_yields_the_steps_batches():
    cfg = configs.get("qwen2_vl_72b").smoke
    pf = pipeline.Prefetcher(cfg, batch=2, seq=8, seed=1, start_step=5)
    try:
        it = iter(pf)
        for want_step in (5, 6, 7):
            step, batch = next(it)
            assert step == want_step
            ref = pipeline.synth_batch(cfg, batch=2, seq=8, step=step,
                                       seed=1)
            for k in ref:
                np.testing.assert_array_equal(batch[k], ref[k])
    finally:
        pf.close()


@pytest.mark.parametrize("kw", [dict(warmup_steps=10, total_steps=100),
                                dict(warmup_steps=200, total_steps=10_000,
                                     final_frac=0.05)])
def test_schedules_equal_reference(kw):
    want_fn = ref_schedule.warmup_cosine(3e-4, **kw)
    got_fn = schedule.warmup_cosine(3e-4, **kw)
    for step in (0, 1, 9, 10, 11, 50, 99, 100, 199, 200, 5000, 20_000):
        assert float(got_fn(step)) == float(want_fn(step)), step
        assert float(got_fn(torch.tensor(step, dtype=torch.int32))) == \
            float(want_fn(jnp.asarray(step, jnp.int32)))
    assert float(schedule.constant(0.5)(3)) == \
        float(ref_schedule.constant(0.5)(3))


# ---------------------------------------------------------------------------
# Optimizers, losses, norms
# ---------------------------------------------------------------------------

OPTS = [("adamw", {"state_dtype": "float32", "weight_decay": 0.1}),
        ("adamw", {"state_dtype": "bfloat16"}),
        ("adamw", {"state_dtype": "int8"}),
        ("adafactor", {"weight_decay": 0.01}),
        ("sgd", {}),
        ("sgd", {"nesterov": True})]


def _opt_params(rng):
    return {"w": rng.standard_normal((40, 24)).astype(np.float32),
            "stack": rng.standard_normal((3, 8, 300)).astype(np.float32),
            "b": rng.standard_normal((24,)).astype(np.float32)}


@pytest.mark.parametrize("name,kw", OPTS,
                         ids=[f"{n}-{'-'.join(map(str, k.values()))}"
                              for n, k in OPTS])
def test_optimizers_equal_reference(name, kw):
    """Equal params and state from equal grads over 3 steps (the clip's
    scale on the last), bf16 params among them."""
    rng = np.random.default_rng(0)
    p0 = _opt_params(rng)
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_p["b"] = ref_p["b"].astype(jnp.bfloat16)
    got_p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    got_p["b"] = got_p["b"].to(torch.bfloat16)
    sched = dict(lr=0.05)
    want_opt = ref_opt.make(name, **sched, **kw)
    got_opt = opt_lib.make(name, **sched, **kw)
    want_s, got_s = want_opt.init(ref_p), got_opt.init(got_p)
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in p0.items()}
        scale = 0.5 if step == 2 else None
        ref_p, want_s = want_opt.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, want_s, ref_p,
            jnp.asarray(step, jnp.int32),
            scale=None if scale is None else jnp.float32(scale))
        got_p, got_s = got_opt.update(
            {k: torch.from_numpy(g) for k, g in grads.items()}, got_s,
            got_p, torch.tensor(step, dtype=torch.int32),
            scale=None if scale is None else torch.tensor(scale))
    assert got_p["b"].dtype == torch.bfloat16
    for k in p0:
        _close(got_p[k], ref_p[k], TOL_OPT)
    want_leaves = jax.tree.leaves(want_s)
    got_leaves = _flat_sorted(got_s)
    assert len(want_leaves) == len(got_leaves)
    for w, g in zip(want_leaves, got_leaves):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        _close(g.float(), np.asarray(w, np.float32), TOL_OPT)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_takes_a_leaf_in_chunks_bit_for_bit(monkeypatch, state_dtype):
    """AdamW over a leaf ``_CHUNK`` elements at a time (here 512, two int8
    blocks: leaves of 960, 7200 and 24 elements end mid-chunk and
    mid-block) gives the whole-leaf update's params and moments exactly."""
    def run():
        rng = np.random.default_rng(1)
        params = {k: torch.from_numpy(v.copy())
                  for k, v in _opt_params(rng).items()}
        params["b"] = params["b"].to(torch.bfloat16)
        opt = opt_lib.make("adamw", lr=0.05, state_dtype=state_dtype,
                           weight_decay=0.1)
        state = opt.init(params)
        for step in range(3):
            grads = {k: torch.from_numpy(rng.standard_normal(
                tuple(v.shape)).astype(np.float32))
                for k, v in params.items()}
            params, state = opt.update(grads, state, params,
                                       torch.tensor(step), scale=None
                                       if step < 2 else torch.tensor(0.5))
        return tree.leaves(params) + _flat_sorted(state)
    whole = run()
    monkeypatch.setattr(opt_lib, "_CHUNK", 512)
    for a, b in zip(run(), whole):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _flat_sorted(t):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat_sorted(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _flat_sorted(v)]
    return [t]


def test_int8_moment_blocks_are_the_reference_layout():
    x = np.random.default_rng(1).standard_normal((37, 11)).astype(np.float32)
    want = ref_opt._q8_encode(jnp.asarray(x))
    got = opt_lib._q8_encode(torch.from_numpy(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(
        opt_lib._q8_decode(got, (37, 11)).numpy(),
        np.asarray(ref_opt._q8_decode(want, (37, 11))))


@functools.lru_cache(maxsize=None)
def _gemma_f32():
    ref_cfg = dataclasses.replace(ref_configs.get("gemma2_2b").smoke,
                                  dtype="float32")
    cfg = dataclasses.replace(configs.get("gemma2_2b").smoke,
                              dtype="float32")
    ref_params = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    return ref_cfg, ref_params, cfg


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_losses_equal_reference(z_loss):
    """softmax_xent and chunked_xent (a ragged last chunk), values and
    gradients (w.r.t. the hidden states and the tied embedding)."""
    ref_cfg, ref_params, cfg = _gemma_f32()
    params = transformer.params_from_numpy(cfg, _np_tree(ref_params),
                                           device="cpu")
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)

    def ref_fn(h, emb):
        p = dict(ref_params, emb=emb)
        return ref_loss.chunked_xent(p, ref_cfg, h, labels, chunk=8,
                                     z_loss=z_loss)
    want, want_g = jax.value_and_grad(ref_fn, argnums=(0, 1))(
        jnp.asarray(hidden), ref_params["emb"])
    h = torch.from_numpy(hidden).requires_grad_()
    emb = params["emb"].requires_grad_()
    got = loss_lib.chunked_xent(params, cfg, h, torch.from_numpy(labels),
                                chunk=8, z_loss=z_loss)
    got_g = torch.autograd.grad(got, (h, emb))
    _close(got, want, 1e-6)
    for g, w in zip(got_g, want_g):
        _close(g, w, 1e-5)
    logits = rng.standard_normal((2, 20, 50)).astype(np.float32) * 3
    lab = labels % 50
    want = ref_loss.softmax_xent(jnp.asarray(logits), jnp.asarray(lab),
                                 z_loss=z_loss)
    got = loss_lib.softmax_xent(torch.from_numpy(logits),
                                torch.from_numpy(lab), z_loss=z_loss)
    _close(got, want, 1e-6)


def test_global_norm_equals_reference():
    rng = np.random.default_rng(4)
    leaves = {"a": rng.standard_normal((30, 7)).astype(np.float32),
              "b": [rng.standard_normal((5,)).astype(np.float32)]}
    want = ref_step.global_norm(jax.tree.map(jnp.asarray, leaves))
    got = step_lib.global_norm(tree.tree_map(torch.from_numpy, leaves))
    _close(got, want, 1e-6)
    bf = torch.from_numpy(leaves["a"]).to(torch.bfloat16)
    assert step_lib.global_norm({"x": bf}).dtype == torch.float32
    clipped, norm = step_lib.clip_by_global_norm(
        tree.tree_map(torch.from_numpy, leaves), 1.0)
    want_c, want_n = ref_step.clip_by_global_norm(
        jax.tree.map(jnp.asarray, leaves), 1.0)
    _close(norm, want_n, 1e-6)
    _close(clipped["a"], want_c["a"], 1e-6)


# ---------------------------------------------------------------------------
# The train step, from one carried state
# ---------------------------------------------------------------------------

# (id, arch, TrainOptions fields)
STEP_CASES = [
    ("gemma2_2b-remat_none", "gemma2_2b",
     dict(remat="none", chunked_loss=True)),
    ("gemma2_2b-remat_block", "gemma2_2b",
     dict(remat="block", chunked_loss=True)),
    ("gemma2_2b-remat_dots", "gemma2_2b",
     dict(remat="dots", chunked_loss=True)),
    ("qwen2_5_3b", "qwen2_5_3b", dict(remat="block")),
    ("qwen2_vl_72b-mb2", "qwen2_vl_72b",
     dict(remat="block", microbatches=2, chunked_loss=True)),
    ("mixtral_8x22b-aux", "mixtral_8x22b", dict(remat="block")),
    ("deepseek_v3_671b-mtp", "deepseek_v3_671b",
     dict(remat="block", chunked_loss=True)),
    ("whisper_medium", "whisper_medium", dict(remat="block")),
    ("recurrentgemma_2b", "recurrentgemma_2b", dict(remat="block")),
    ("rwkv6_7b", "rwkv6_7b", dict(remat="block")),
]
SEQ = 24          # past the smoke windows of 16


@functools.lru_cache(maxsize=None)
def _reference_run(arch, opts_items):
    """The reference's state, loss, gradients and params after 2 SGD steps
    (memoized: the remat cases share one reference, whose values remat
    does not change)."""
    kw = dict(opts_items)
    ref_cfg = dataclasses.replace(ref_configs.get(arch).smoke,
                                  dtype="float32")
    opts = ref_step.TrainOptions(**kw)
    opt = ref_opt.make("sgd", lr=0.1, momentum=0.9)
    init_fn, step_fn = ref_step.build_train_step(ref_cfg, opt, opts)
    state = jax.jit(init_fn)(jax.random.PRNGKey(0))
    batches = [ref_pipeline.synth_batch(ref_cfg, batch=2, seq=SEQ, step=s)
               for s in range(2)]
    loss_fn = ref_step.make_loss_fn(ref_cfg, opts)
    mb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state["params"], mb0)
    state0 = _np_tree(state)
    jstep = jax.jit(step_fn)
    metrics = []
    for b in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append(_np_tree(m))
    return (state0, float(loss), _np_tree(grads), metrics,
            _np_tree(state["params"]), batches)


@pytest.mark.parametrize("case,arch,kw", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_train_step_equals_reference(case, arch, kw):
    ref_kw = {k: v for k, v in kw.items() if k != "remat"}
    state0, want_loss, want_grads, want_metrics, want_params, batches = \
        _reference_run(arch, tuple(sorted(ref_kw.items())))
    cfg = dataclasses.replace(configs.get(arch).smoke, dtype="float32")
    opts = step_lib.TrainOptions(**kw)
    state = step_lib.train_state_from_numpy(cfg, state0, device="cpu")
    params = state["params"]
    loss, _ = step_lib.make_loss_fn(cfg, opts)(
        params, {k: torch.from_numpy(v) for k, v in batches[0].items()})
    grads = step_lib._grad(loss, tree.leaves(params))
    _close(loss, want_loss, TOL_MODEL)
    want_leaves = jax.tree.leaves(want_grads)
    assert len(grads) == len(want_leaves)
    for g, w in zip(grads, want_leaves):
        _close(g, w, TOL_MODEL, floor=GRAD_FLOOR)
    p0 = [p.detach().clone() for p in tree.leaves(params)]
    _, step_fn = step_lib.build_train_step(
        cfg, opt_lib.make("sgd", lr=0.1, momentum=0.9), opts, device="cpu")
    for b, want_m in zip(batches, want_metrics):
        state, m = step_fn(state, b)
        _close(m["loss"], want_m["loss"], TOL_MODEL)
        _close(m["grad_norm"], want_m["grad_norm"], TOL_MODEL)
    assert int(state["step"]) == 2
    for got, start, want in zip(tree.leaves(state["params"]), p0,
                                jax.tree.leaves(want_params)):
        _close(got.detach() - start, np.asarray(want) - start.numpy(),
               TOL_MODEL, floor=GRAD_FLOOR)


def test_lm_forward_want_hidden_equals_reference():
    ref_cfg, ref_params, cfg = _gemma_f32()
    params = transformer.params_from_numpy(cfg, _np_tree(ref_params),
                                           device="cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    want = ref_transformer.lm_forward(ref_params, ref_cfg,
                                      jnp.asarray(toks), want_hidden=True)
    got = transformer.lm_forward(params, cfg, toks, want_hidden=True)
    assert set(got) == set(want) == {"hidden", "aux_loss"}
    _close(got["hidden"], want["hidden"], TOL_MODEL)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _mixed_state():
    """A state with f32, bf16, int8 (AdamW's q8 moments) and int32
    leaves, in a dict, a list and nested dicts."""
    rng = np.random.default_rng(6)
    params = {"w": torch.from_numpy(rng.standard_normal((4, 8))
                                    .astype(np.float32)).to(torch.bfloat16),
              "tail": [torch.from_numpy(rng.standard_normal(300)
                                        .astype(np.float32))]}
    opt = opt_lib.make("adamw", lr=1e-3, state_dtype="int8")
    st = opt.init(params)
    opt.update(tree.tree_map(torch.ones_like, params), st, params,
               torch.tensor(0, dtype=torch.int32))
    return {"params": params, "opt": st,
            "step": torch.tensor(3, dtype=torch.int32)}


def _as_torch(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else tree.from_numpy(x)


def _assert_equal_states(a, b):
    la, lb = _flat_sorted(a), _flat_sorted(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = _as_torch(x), _as_torch(y)
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip_with_bf16_and_int8_leaves(tmp_path):
    state = _mixed_state()
    path = ckpt_lib.save(str(tmp_path), state, 3)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    like = tree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device="meta"), state)
    restored, step = ckpt_lib.restore(str(tmp_path), like, device="cpu")
    assert step == 3
    _assert_equal_states(restored, state)
    assert restored["opt"]["m"]["w"]["q"].dtype == torch.int8


def test_checkpoints_cross_between_packages(tmp_path):
    """The port reads the reference's checkpoint and the reverse: the same
    manifest and files."""
    state = _mixed_state()
    ref_state = jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), state)
    ref_ckpt.save(str(tmp_path / "ref"), ref_state, 3)
    ckpt_lib.save(str(tmp_path / "port"), state, 3)
    for name in ("manifest.json", "leaf_00000.npy", "leaf_00004.npy"):
        assert (tmp_path / "ref" / "step_00000003" / name).read_bytes() \
            == (tmp_path / "port" / "step_00000003" / name).read_bytes()
    got, _ = ckpt_lib.restore(str(tmp_path / "ref"), state, device="cpu")
    _assert_equal_states(got, state)
    abstract = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype),
                            ref_state)
    want, step = ref_ckpt.restore(str(tmp_path / "port"), abstract)
    assert step == 3
    _assert_equal_states(jax.tree.map(np.asarray, want), state)


def test_interrupted_checkpoint_is_never_restored(tmp_path):
    state = _mixed_state()
    ckpt_lib.save(str(tmp_path), state, 2)
    later = tree.tree_map(lambda t: t.clone(), state)
    later["step"] = torch.tensor(4, dtype=torch.int32)
    ckpt_lib.save(str(tmp_path), later, 4)
    os.rename(tmp_path / "step_00000004", tmp_path / "step_00000004.tmp")
    assert ckpt_lib.latest_steps(str(tmp_path)) == [2]
    restored, step = ckpt_lib.restore(str(tmp_path), state, device="cpu")
    assert step == 2 and int(restored["step"]) == 3


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ck = ckpt_lib.AsyncCheckpointer(str(tmp_path), keep=2)
    state = {"w": torch.arange(8.0), "step": torch.tensor(0)}
    for s in (1, 2, 3, 4):
        ck.save_async(dict(state, step=torch.tensor(s)), s)
    ck.wait()
    assert ckpt_lib.latest_steps(str(tmp_path)) == [3, 4]


# ---------------------------------------------------------------------------
# The driver and the launcher
# ---------------------------------------------------------------------------

def _tiny_run(tmp_path, hook=None, n=8, ckpt_every=4):
    cfg = dataclasses.replace(configs.get("qwen2_5_3b").smoke,
                              dtype="float32")
    opt = opt_lib.make("sgd", lr=1e-2, momentum=0.9)
    init_fn, step_fn = step_lib.build_train_step(cfg, opt, device="cpu")
    driver = fault.TrainDriver(
        cfg=fault.DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every),
        step_fn=step_fn,
        batch_fn=lambda s: pipeline.synth_batch(cfg, batch=2, seq=12,
                                                step=s),
        state=init_fn(torch.Generator().manual_seed(0)))
    losses = []
    driver.on_step = lambda s, m: losses.append((s, float(m["loss"])))
    driver.run(n, failure_hook=hook)
    return driver, losses


def test_driver_survives_failures_and_replays_the_same_state(tmp_path):
    clean, clean_losses = _tiny_run(tmp_path / "clean")
    fails = {6: True, 3: True}

    def hook(step):
        if fails.pop(step, None):
            raise fault.SimulatedNodeFailure(f"node died at step {step}")

    driver, losses = _tiny_run(tmp_path / "faulty", hook)
    assert driver.step == 8
    kinds = [e[0] for e in driver.events]
    assert kinds.count("failure") == 2
    assert ("restart_from_init", 0) in driver.events   # before step 4's
    assert [e[:2] for e in driver.events if e[0] == "restored"] == [
        ("restored", 4)]
    # Steps 4 and 5 ran twice, the second time as the first.
    assert [s for s, _ in losses] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    assert losses[4:6] == losses[6:8]
    assert [l for _, l in losses[6:]] == [l for _, l in clean_losses[4:]]
    for a, b in zip(tree.leaves(driver.state["params"]),
                    tree.leaves(clean.state["params"])):
        assert torch.equal(a, b)


def test_driver_flags_a_straggler_on_a_fake_clock(tmp_path):
    ticks = iter([0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 4.0, 4.0, 5.0,
                  5.0, 9.0, 9.0, 10.0])
    driver = fault.TrainDriver(
        cfg=fault.DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                               straggler_factor=2.5),
        step_fn=lambda st, b: (dict(st, step=st["step"] + 1),
                               {"loss": torch.zeros(())}),
        batch_fn=lambda s: None, state={"step": torch.tensor(0)},
        clock=lambda: next(ticks))
    driver.run(7)
    assert [e[:2] for e in driver.events if e[0] == "straggler"] == [
        ("straggler", 5)]
    assert driver.step_ms == [1e3, 1e3, 1e3, 1e3, 1e3, 4e3, 1e3]


def test_launcher_trains_the_smoke_model_on_the_cpu(tmp_path, capsys):
    out = launch_train.run(["--arch", "gemma2-2b", "--smoke", "--device",
                            "cpu", "--steps", "3", "--ckpt-dir",
                            str(tmp_path), "--ckpt-every", "2",
                            "--fail-at", "2"])
    assert [s for s, *_ in out["steps"]] == [1, 2, 3]
    assert all(np.isfinite(l) and np.isfinite(g)
               for _, l, g, _ in out["steps"])
    assert [e[:2] for e in out["events"]] == [
        ("checkpoint", 2), ("failure", 2), ("restored", 2)]
    assert ckpt_lib.latest_steps(str(tmp_path)) == [2]
    text = capsys.readouterr().out
    assert "[train] step 3 loss" in text and "done at step 3" in text
    assert launch_train.main(["--arch", "gemma2-2b", "--smoke", "--device",
                              "cpu", "--steps", "3", "--state-dtype", "int8",
                              "--ckpt-dir", str(tmp_path / "again")]) == 0


def test_launcher_trains_the_rwkv_smoke_model_on_the_cpu(tmp_path, capsys):
    """rwkv6-7b through the launcher's driver: the gradient of every
    time-mix recurrence is ``rwkv6_scan``'s backward (its plain version
    on the CPU)."""
    out = launch_train.run(["--arch", "rwkv6-7b", "--smoke", "--device",
                            "cpu", "--steps", "3", "--batch", "2", "--seq",
                            "40", "--ckpt-every", "100", "--ckpt-dir",
                            str(tmp_path)])
    assert [s for s, *_ in out["steps"]] == [1, 2, 3]
    assert all(np.isfinite(l) and np.isfinite(g) and g > 0
               for _, l, g, _ in out["steps"])
    assert "[train] arch=rwkv6_7b smoke=True" in capsys.readouterr().out
