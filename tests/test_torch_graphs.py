"""The served steps as CUDA graphs (``repro_torch.kernels.graph``): what
the CPU can check of them, and their ``gpu`` cases on the card.

On the CPU the steps run eagerly, so the checks here are the ones graphs
depend on: the batcher's step reads static inputs and writes its state in
place (never rebinding it) and still serves what the rebinding step served;
graphs are refused off the card; the launch counters add what a replay
runs; the finiteness guard.  The ``gpu`` cases hold a replayed edge forward
and a replayed decode tick to their eager runs bit for bit and count their
launches:

    python -m pytest -q -m gpu tests/test_torch_graphs.py
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import graph, ops
from repro_torch.models import api, edge, tree
from repro_torch.serve import engine
from repro_torch.serve.engine import ContinuousBatcher, EdgeEngine, Request


def _smoke(arch):
    cfg = configs.get(arch).smoke
    return cfg, api.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")


def _prompts(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, int(rng.integers(2, 7)))
            .astype(np.int32) for _ in range(n)]


class _RebindingBatcher(ContinuousBatcher):
    """The decode step as the batcher ran it before its state became
    static: fresh input tensors each step and the state rebound to
    ``torch.where(live, new, old)``."""

    def _decode_masked(self, tok, live):
        dev = self.device
        tokens = torch.as_tensor(tok, dtype=torch.long).to(dev)
        pos = torch.as_tensor(self.pos, dtype=torch.long).to(dev)
        live_t = torch.as_tensor(live).to(dev)
        logits, new_state = api.decode_step(self.params, self.cfg, tokens,
                                            self.state, pos)

        def keep_idle(old, new, ax):
            mask = live_t.reshape((-1,) + (1,) * (old.dim() - ax - 1))
            return torch.where(mask, new, old)

        self.state = tree.tree_map(keep_idle, self.state, new_state,
                                   self._axes)
        return logits


def _serve(batcher, prompts, max_new=4):
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)
    batcher.run_until_drained()
    assert all(r.done and not r.error for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b",
                                  "gemma2-9b", "qwen2.5-3b",
                                  "whisper-medium"])
def test_static_state_batcher_serves_what_the_rebinding_one_did(arch):
    cfg, params = _smoke(arch)
    prompts = _prompts(cfg)
    b = ContinuousBatcher(cfg, params, slots=2, max_len=32)
    leaves = tree.leaves(b.state)
    ptrs = [t.data_ptr() for t in leaves]
    inputs = b._inputs
    got = _serve(b, prompts)
    old = _RebindingBatcher(cfg, params, slots=2, max_len=32)
    assert got == _serve(old, prompts)
    for a, c in zip(tree.leaves(b.state), tree.leaves(old.state)):
        assert torch.equal(a, c)
    # The state and the inputs were written in place, never rebound.
    assert all(x is y for x, y in zip(tree.leaves(b.state), leaves))
    assert [t.data_ptr() for t in tree.leaves(b.state)] == ptrs
    assert b._inputs is inputs
    assert b._graph is None and b.graph_report() is None


def test_step_reads_the_static_inputs():
    cfg, params = _smoke("rwkv6-7b")
    b = ContinuousBatcher(cfg, params, slots=3, max_len=16)
    b.pos[:] = [4, 0, 7]
    tok = np.array([[5], [6], [7]], np.int32)
    b._decode_masked(tok, np.array([True, False, True]))
    assert b._inputs.tolist() == [[5, 6, 7], [4, 0, 7], [1, 0, 1]]
    # The idle slot's state stayed zero.
    for leaf, ax in zip(tree.leaves(b.state), tree.leaves(b._axes)):
        assert not bool(leaf.select(ax, 1).any())
        assert bool(leaf.select(ax, 0).any())


def test_graphs_are_refused_off_the_card():
    cfg = edge.edge_config("tau_select")
    with pytest.raises(ValueError, match="CUDA device"):
        EdgeEngine(cfg, device="cpu", graphs=True)
    lm, params = _smoke("rwkv6-7b")
    with pytest.raises(ValueError, match="CUDA device"):
        ContinuousBatcher(lm, params, slots=1, max_len=8, graphs=True)
    with pytest.raises(ValueError, match="CUDA device"):
        graph.StepGraph(lambda: None, torch.device("cpu"))
    assert not EdgeEngine(cfg, device="cpu").graphs
    assert not EdgeEngine(cfg, device="cpu", graphs=False).graphs
    assert EdgeEngine(cfg, device="cpu").graph_report() == {}


def test_launch_counters_take_a_replays_counts():
    ops.reset_launches()
    assert set(ops.launch_counts().values()) == {0}
    ops.add_launches({"fused_mlp_q8": 2, "linear_scan": 18})
    ops.add_launches({"fused_mlp_q8": 1})
    counts = ops.launch_counts()
    assert counts["fused_mlp_q8"] == 3 and counts["linear_scan"] == 18
    ops.set_launches(dict.fromkeys(counts, 5))
    assert set(ops.launch_counts().values()) == {5}
    ops.reset_launches()
    assert set(ops.launch_counts().values()) == {0}


def test_kernel_launches_read_the_graphs_own_nodes():
    """A graph's launches per replay are its kernel nodes of each counted
    kernel, by mangled function name; torch's own kernels count nothing."""
    kernels = {
        "_ZN12_GLOBAL__N_119fused_mlp_q8_kernelEPKfPKhPfiii": 1,
        "_ZN12_GLOBAL__N_116gemm_int8_kernelILi8ELi32ELi32EEEvPKaS2_": 4,
        "_ZN12_GLOBAL__N_118linear_scan_kernelIfEEvPKT_S3_PS1_ii": 18,
        "_ZN12_GLOBAL__N_122chunk_aggregate_kernelIfEEvPKT_S3_Pfiii": 2,
        "_ZN12_GLOBAL__N_117chunk_scan_kernelIfEEvPKT_S3_PKfPS1_iii": 2,
        "_ZN12_GLOBAL__N_112rwkv6_kernelIfLi64EEEvPKT_": 32,
        "_ZN12_GLOBAL__N_114tc_gemm_kernelI13__nv_bfloat16Li64ELi128EEEvv": 3,
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>>(int, T2_, T3_)": 7,
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize64x64x64": 5,
        "fused_dense_kernel": 1,
        # A backward call is two nodes, of which the dkdv one counts.
        "_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelI13__nv_bfloat16Li32E"
        "Li256EEEvNS_4ArgsE": 2,
        "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelI13__nv_bfloat16Li32E"
        "Li256EEEvNS_4ArgsE": 2,
    }
    assert graph.kernel_launches(kernels) == {
        "fused_mlp_q8": 1, "gemm_int8": 4, "flash_attention": 0,
        "linear_scan": 20, "rwkv6_scan": 32, "tiled_gemm": 3,
        "fused_dense": 1, "flash_attention_bwd": 2, "rwkv6_scan_bwd": 0}
    assert set(graph.KERNEL_FUNCTIONS) == set(ops.launch_counts())


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"),
                                 -float("inf")])
def test_finite_guard(bad):
    y = torch.randn((8, 5), generator=torch.Generator().manual_seed(0))
    if bad is not None:
        y[3, 2] = bad
    assert np.isfinite(float(graph.finite_guard(y))) == (bad is None)
    assert float(graph.finite_guard(torch.tensor([[-3.0, 2.0]]))) == 3.0


def test_non_finite_output_fails_on_the_eager_path():
    """A NaN input quantizes to 0 at the fused group's entry, as in the
    reference, so the output stays finite; a NaN bias in the last layer
    poisons the output, and the guard fails the request."""
    cfg = edge.edge_config("tau_select")
    eng = EdgeEngine(cfg, device="cpu")
    x = torch.ones((8, 27))
    eng.infer(x)
    x[0, 0] = float("nan")
    assert torch.isfinite(eng.infer(x)).all()
    qparams = [dict(q) for q in eng.qparams]
    qparams[-1]["b"] = torch.full_like(qparams[-1]["b"], float("nan"))
    bad = EdgeEngine(cfg, qparams=qparams, device="cpu")
    with pytest.raises(engine.NonFiniteOutput):
        bad.infer(torch.ones((8, 27)))
    assert bad.faults == 1 and bad.calls == 0
    assert eng.faults == 0 and eng.calls == 2


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m "
                    "pytest -m gpu tests/test_torch_graphs.py)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["jet_tagger", "tau_select", "qubit"])
def test_graphed_edge_rungs_equal_eager_and_count_replays(name):
    dev = _card()
    cfg = edge.edge_config(name)
    g = EdgeEngine(cfg, seed=1, device=dev)
    e = EdgeEngine(cfg, qparams=g.qparams, plan=g.plan, device=dev,
                   graphs=False)
    x = torch.randn((cfg.batch, cfg.dims[0]),
                    generator=torch.Generator().manual_seed(2)).to(dev)
    for rung in (0, 1):
        if rung:
            g.degrade()
            e.degrade()
        counts = []
        for eng in (g, e):
            ops.reset_launches()
            ys = [eng.infer(x) for _ in range(4)]
            counts.append(ops.launch_counts())
            assert all(torch.equal(y, ys[0]) for y in ys)
        assert counts[0] == counts[1]
        assert torch.equal(g.infer(x), e.infer(x))
    # Each graph's own kernel nodes: one fused_mlp_q8 per multi-layer
    # group and one gemm_int8 per singleton on the fused rung, one
    # gemm_int8 per layer on the per-layer rung.
    groups = g.plan.groups()
    fused = sum(1 for grp in groups if len(grp) > 1)
    shape = [cfg.batch, cfg.dims[0]]
    report = g.graph_report()
    assert set(report) == {f"fused {shape}", f"per_layer {shape}"}
    for key, want in ((f"fused {shape}", (fused, len(groups) - fused)),
                      (f"per_layer {shape}", (0, len(cfg.dims) - 1))):
        r = report[key]
        assert (r["launches"]["fused_mlp_q8"],
                r["launches"]["gemm_int8"]) == want, key
        assert r["replays"] == 4


@pytest.mark.gpu
def test_graph_cache_keeps_the_latest_shapes():
    """Ragged batch sizes each capture a graph; the engine keeps the
    ``MAX_GRAPHS`` it used last, and every size still answers as the eager
    forward does."""
    dev = _card()
    cfg = edge.edge_config("tau_select")
    g = EdgeEngine(cfg, seed=4, device=dev)
    e = EdgeEngine(cfg, qparams=g.qparams, plan=g.plan, device=dev,
                   graphs=False)
    gen = torch.Generator().manual_seed(5)
    sizes = list(range(1, EdgeEngine.MAX_GRAPHS + 3)) + [1]
    for m in sizes:
        x = torch.randn((m, cfg.dims[0]), generator=gen).to(dev)
        assert torch.equal(g.infer(x), e.infer(x)), m
    report = g.graph_report()
    assert len(report) == EdgeEngine.MAX_GRAPHS
    kept = sizes[-EdgeEngine.MAX_GRAPHS:]
    assert set(report) == {f"fused {[m, cfg.dims[0]]}" for m in kept}


@pytest.mark.gpu
def test_graphed_guard_fails_a_poisoned_output():
    dev = _card()
    cfg = edge.edge_config("tau_select")
    src = EdgeEngine(cfg, seed=3, device=dev)
    poisoned = [dict(q) for q in src.qparams]
    poisoned[-1]["b"] = poisoned[-1]["b"].clone()
    poisoned[-1]["b"][1] = float("inf")
    bad = EdgeEngine(cfg, qparams=poisoned, plan=src.plan, device=dev)
    x = torch.ones((cfg.batch, cfg.dims[0]), device=dev)
    for _ in range(3):                     # eager capture, then replays
        with pytest.raises(engine.NonFiniteOutput):
            bad.infer(x)
    assert bad.faults == 3 and bad.calls == 0
    assert torch.isfinite(src.infer(x)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b",
                                  "gemma2-9b", "qwen2.5-3b",
                                  "mixtral-8x22b", "deepseek-v3-671b",
                                  "whisper-medium"])
def test_graphed_tick_equals_eager_tick(arch):
    dev = _card()
    cfg = configs.get(arch).smoke
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompts = _prompts(cfg, n=6)
    outs, counts = [], []
    for graphs in (None, False):
        b = ContinuousBatcher(cfg, params, slots=2, max_len=64,
                              graphs=graphs)
        ops.reset_launches()
        outs.append(_serve(b, prompts))
        counts.append(ops.launch_counts())
    assert outs[0] == outs[1] and counts[0] == counts[1]
    b = ContinuousBatcher(cfg, params, slots=2, max_len=64)
    for i, p in enumerate(prompts[:2]):
        b.submit(Request(rid=i, prompt=p, max_new=16))
    for _ in range(2):
        b.step()
    before = tree.tree_map(torch.clone, b.state)
    tok = np.array([[r.out[-1]] for r in b.active], np.int32)
    logits = b._decode_masked(tok, np.ones((2,), bool)).clone()
    after = tree.tree_map(torch.clone, b.state)
    tree.tree_map(lambda s, v: s.copy_(v), b.state, before)
    assert torch.equal(logits, b._step())
    assert all(tree.leaves(tree.tree_map(torch.equal, after, b.state)))
    report = b.graph_report()
    assert report["replays"] > 0
    assert dev.type == "cuda"
