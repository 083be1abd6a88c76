"""The continuous batcher under a plan's batch policy, against the JAX
package.

``BatchPolicy`` validates and reads a plan's serve section as the
reference's does.  A port batcher and a reference batcher under the same
policy (``prefill_chunk``, ``admit_per_tick``, ``max_new_cap``) and the
same JAX-initialised float32 weights admit, prefill, decode and evict in
the same ticks; their logits agree at 2e-3 (float32: the algorithm).
Token ids are argmax over near-ties and are not compared: the reference's
sampled tokens are copied into the port's requests after every tick.  The
RWKV-6 chunked prefill continues from the carried state, so chunks equal
the whole prompt.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro.serve import engine as ref_engine
from repro_torch import configs
from repro_torch.models import api, griffin, rwkv, tree
from repro_torch.plan import PlanCache, plan_fleet
from repro_torch.serve import engine
from test_torch_lm_serve import _assert_states_close, _prompt, _recorded

TOL = dict(rtol=2e-3, atol=2e-3)


def _plan(**serve):
    return types.SimpleNamespace(serve=serve)


@pytest.mark.parametrize("field", ["prefill_chunk", "admit_per_tick",
                                   "max_new_cap"])
@pytest.mark.parametrize("value", [0, -1])
def test_policy_validation_matches_reference(field, value):
    with pytest.raises(ValueError, match=field):
        ref_engine.BatchPolicy(**{field: value})
    with pytest.raises(ValueError, match=field):
        engine.BatchPolicy(**{field: value})
    assert engine.BatchPolicy(**{field: None}) == engine.BatchPolicy()


def _lm_plan(**kw):
    fleet = plan_fleet([configs.get("recurrentgemma-2b").smoke],
                       device="cpu", cache=PlanCache(), **kw)
    return fleet.tenants[0].plan


@pytest.mark.parametrize("plan,overrides", [
    (None, {}),
    ("fleet", {}),
    ("fleet", {"slots": 3, "max_new_cap": 2}),
    (_plan(slots=6, prefill_chunk=None, admit_per_tick=2), {}),
    (_plan(), {"prefill_chunk": 5}),
], ids=["no_plan", "fleet_plan", "overrides", "serve_dict", "empty_serve"])
def test_from_plan_matches_reference(plan, overrides):
    plan = _lm_plan() if plan == "fleet" else plan
    got = engine.BatchPolicy.from_plan(plan, **overrides)
    want = ref_engine.BatchPolicy.from_plan(plan, **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if plan is not None and "slots" in plan.serve and "slots" not in overrides:
        assert got.slots == plan.serve["slots"]


def test_from_plan_refuses_what_the_reference_refuses():
    for mod in (engine, ref_engine):
        with pytest.raises(TypeError, match="unknown BatchPolicy"):
            mod.BatchPolicy.from_plan(_plan(), chunk=3)
        with pytest.raises(ValueError, match="slots"):
            mod.BatchPolicy.from_plan(_plan(slots=0))
        with pytest.raises(ValueError, match="prefill_chunk"):
            mod.BatchPolicy.from_plan(_plan(prefill_chunk=0))


def test_batcher_reads_its_policy_from_the_plan():
    plan = _lm_plan(serve_slots_total=3, prefill_chunk=5)
    cfg = configs.get("recurrentgemma-2b").smoke
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = engine.ContinuousBatcher(cfg, params, plan=plan, max_len=16)
    assert (b.slots, b.policy.prefill_chunk, b.policy.admit_per_tick) == \
        (3, 5, 1) and b.plan is plan
    assert engine.ContinuousBatcher(cfg, params, plan=plan, slots=2,
                                    max_len=16).slots == 2
    assert engine.ContinuousBatcher(
        cfg, params, policy=engine.BatchPolicy(slots=5), plan=plan,
        max_len=16).slots == 5


def _pair(family):
    if family == "griffin":
        ref_cfg = dataclasses.replace(
            ref_configs.get("recurrentgemma_2b").smoke, num_layers=5,
            dtype="float32")
        cfg = dataclasses.replace(configs.get("recurrentgemma-2b").smoke,
                                  num_layers=5, dtype="float32")
        convert = griffin.params_from_numpy
    else:
        ref_cfg = dataclasses.replace(ref_configs.get("rwkv6_7b").smoke,
                                      dtype="float32")
        cfg = dataclasses.replace(configs.get("rwkv6-7b").smoke,
                                  dtype="float32")
        convert = rwkv.params_from_numpy
    ref_params = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    params = convert(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref_cfg, ref_params, cfg, params


@pytest.fixture(scope="module", params=["griffin", "rwkv"])
def pair(request):
    return request.param, _pair(request.param)


@pytest.mark.parametrize("serve,shapes,arrivals", [
    (dict(slots=2, prefill_chunk=3, admit_per_tick=1, max_new_cap=4),
     {"A": (20, 6), "B": (5, 3), "C": (2, 5)}, {}),
    (dict(slots=3, prefill_chunk=8, admit_per_tick=2),
     {"A": (11, 3), "B": (17, 2), "C": (4, 4), "D": (9, 2)}, {"D": 3}),
], ids=["chunk3_admit1_cap4", "chunk8_admit2_deferred"])
def test_batcher_under_the_plan_policy_matches_reference(pair, serve, shapes,
                                                         arrivals):
    """``arrivals`` maps a request to the tick it is submitted at (default
    0); requests past ``admit_per_tick`` or the free slots wait in the
    queue.  Each tick both batchers run the same decode steps (logits at
    2e-3), hold the same positions and slots, and emit the same number of
    tokens; the evicted requests stop at ``max_new_cap``."""
    family, (ref_cfg, ref_params, cfg, params) = pair
    plan = _plan(**serve)
    ref_b = ref_engine.ContinuousBatcher(ref_cfg, ref_params, plan=plan,
                                         max_len=32)
    port_b = engine.ContinuousBatcher(cfg, params, plan=plan, max_len=32)
    assert dataclasses.asdict(port_b.policy) == \
        dataclasses.asdict(ref_b.policy)
    ref_log, port_log = _recorded(ref_b), _recorded(port_b)
    pairs = {}
    for i, (name, (n, max_new)) in enumerate(shapes.items()):
        prompt = _prompt(10 + i, n, cfg.vocab_size)
        pairs[name] = (
            ref_engine.Request(rid=i, prompt=prompt, max_new=max_new),
            engine.Request(rid=i, prompt=prompt.copy(), max_new=max_new))
    for tick in range(60):
        for name, (ref_req, port_req) in pairs.items():
            if arrivals.get(name, 0) == tick:
                ref_b.submit(ref_req)
                port_b.submit(port_req)
        assert port_b.step() == ref_b.step()
        assert len(port_log) == len(ref_log)
        for want, got in zip(ref_log, port_log):
            np.testing.assert_allclose(got, want, **TOL)
        ref_log.clear()
        port_log.clear()
        np.testing.assert_array_equal(port_b.pos, ref_b.pos)
        assert [r and r.rid for r in port_b.active] == \
            [r and r.rid for r in ref_b.active]
        for ref_req, port_req in pairs.values():
            assert (len(port_req.out), port_req.filled, port_req.done) == \
                (len(ref_req.out), ref_req.filled, ref_req.done)
            port_req.out[:] = ref_req.out
        if tick >= max(arrivals.values(), default=0) and \
                ref_b.queue.empty() and not any(ref_b.active):
            break
    _assert_states_close(ref_b.state, port_b.state)
    cap = serve.get("max_new_cap")
    for _, req in pairs.values():
        assert req.done and req.error is None
        assert len(req.out) == (req.max_new if cap is None
                                else min(req.max_new, cap))
    stats, ref_stats = port_b.span_stats(), ref_b.span_stats()
    for kind in ("prefill_chunk", "decode_step", "queue"):
        assert stats[kind]["count"] == ref_stats[kind]["count"], kind


def test_admit_per_tick_bounds_each_tick(pair):
    """Three requests at tick 0 under ``admit_per_tick`` 1: one is admitted
    a tick, an idle tick admits nothing, and every request finishes."""
    _, (_, _, cfg, params) = pair
    b = engine.ContinuousBatcher(cfg, params, plan=_plan(slots=3,
                                                         admit_per_tick=1),
                                 max_len=16)
    assert b.step() == 0                      # idle: nothing to admit
    reqs = [engine.Request(rid=i, prompt=_prompt(i, 3, cfg.vocab_size),
                           max_new=8) for i in range(3)]
    for req in reqs:
        b.submit(req)
    for n_active in (1, 2, 3):
        assert b.step() == n_active and b.queue.qsize() == 3 - n_active
    b.run_until_drained()
    assert all(r.done and len(r.out) == 8 for r in reqs)


@pytest.mark.parametrize("chunk", [4, 8])
def test_rwkv_chunked_prefill_equals_whole_prompt(chunk):
    """An RWKV-6 chunk at a position > 0 continues from the carried state:
    chunked prefill equals the whole prompt's (1e-5, the same f32 scan),
    and the reference's chunked prefill at 2e-3."""
    ref_cfg, ref_params, cfg, params = _pair("rwkv")
    prompt = _prompt(5, 21, cfg.vocab_size)[None]
    whole, _ = engine.build_serve_steps(cfg)
    chunked, _ = engine.build_serve_steps(cfg, max_len=32,
                                          plan=_plan(prefill_chunk=chunk))
    want, want_state = whole(params, prompt,
                             api.init_decode_state(cfg, 1, 32, device="cpu"))
    got, state = chunked(params, prompt,
                         api.init_decode_state(cfg, 1, 32, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(tree.leaves(state), tree.leaves(want_state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    ref_prefill, _ = ref_engine.build_serve_steps(
        ref_cfg, max_len=32, plan=_plan(prefill_chunk=chunk))
    ref_got, _ = jax.jit(ref_prefill)(
        ref_params, jnp.asarray(prompt),
        ref_api.init_decode_state(ref_cfg, 1, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_got), **TOL)
