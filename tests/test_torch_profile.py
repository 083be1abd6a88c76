"""The roofline profile, the plans' work and the served steps' FLOP count
against the JAX package's (``repro_torch.obs.profile``,
``DeploymentPlan.work``, ``repro_torch.launch.graph_analysis``), and the
kernels' work records.

Plans: each reference plan of a Table-I net, and the port's plan built from
its layers and groups.  Ceilings: one stand-in carrying the same values
under both packages' names.  Windows: numpy-seeded aggregates.  The rows,
the snapshots and the plan work must equal the reference's; the port's own
additions (the unclamped fraction, the H100 ceilings, the refused
collective term) are checked on their own.  The kernels' work records are
held to the arithmetic PERF.md's bound column uses; on the CPU no wrapper
records anything, and the ``gpu`` cases hold each CUDA launch's record to
its formula and a replayed graph's to its eager step's:

    python -m pytest -q -m gpu tests/test_torch_profile.py
"""

import dataclasses
import importlib
import json
import math

import numpy as np
import pytest
import torch

from repro.models import edge as ref_edge
from repro.plan import get_or_plan
from repro_torch import hw
from repro_torch.deploy import Deployment
from repro_torch.kernels import (flash_attention, fused_dense, fused_mlp,
                                 gemm_int8, ops, rglru, rwkv6, tiled_gemm)
from repro_torch.launch import graph_analysis
from repro_torch.models import edge
from repro_torch.serve.engine import EdgeEngine

from test_torch_obs import HW, port_plan

ref_profile = importlib.import_module("repro.obs.profile")
profile = importlib.import_module("repro_torch.obs.profile")

NETS = ("jet_tagger", "tau_select", "vae", "qubit", "autoencoder")
REL = 1e-12


@pytest.fixture(scope="module")
def plans():
    out = {}
    for net in NETS:
        rp = get_or_plan(ref_edge.edge_config(net), target="tpu")
        out[net] = (rp, port_plan(rp))
    return out


def _stats(seed: int, tenant: str, kind: str = "infer", *, p50=None,
           tokens: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    p50 = float(rng.random() * 1e-4) if p50 is None else p50
    count = int(rng.integers(1, 200))
    return {(tenant, kind): {"count": count, "total_s": p50 * count,
                             "mean_s": p50, "p50_s": p50,
                             "p95_s": 2 * p50, "tokens": tokens}}


def _close(a, b) -> bool:
    if a is None or b is None or isinstance(a, str):
        return a == b
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# the plans' work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("kind", ["edge", "lm"])
def test_plan_work_is_the_references(plans, net, kind):
    rp, pp = plans[net]
    if kind == "lm":
        rp, pp = (dataclasses.replace(p, kind="lm", batch=1)
                  for p in (rp, pp))
    assert pp.itemsize == rp.itemsize == (1 if kind == "edge" else 2)
    assert pp.work() == rp.work()
    # no fusion_groups section: both fall back to the layers' fuse_group
    rp0, pp0 = (dataclasses.replace(p, fusion_groups=()) for p in (rp, pp))
    assert pp0.work() == rp0.work()
    assert pp0.groups() == rp0.groups()


def test_port_plans_work_counts_the_planned_gemms():
    """The port's own h100 plan: FLOPs of every layer at the plan's batch,
    one launch a fusion group (the served forward's launches)."""
    plan = edge.deployment_plan(edge.edge_config("jet_tagger"),
                                device="cpu")
    w = plan.work()
    assert w["flops"] == sum(2.0 * plan.batch * l.n_in * l.n_out
                             for l in plan.layers)
    assert w["launches"] == len(plan.groups())
    assert w["bytes"] == w["weight_bytes"] + w["act_bytes"]


# ---------------------------------------------------------------------------
# profile rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("case", ["infer", "decode_step", "prefill_chunk",
                                  "zero", "clamp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_profile_rows_are_the_references(plans, net, case, seed):
    rp, pp = plans[net]
    kind = {"zero": "infer", "clamp": "infer"}.get(case, case)
    p50 = {"zero": 0.0, "clamp": 1e-12}.get(case)
    if kind != "infer":
        rp, pp = (dataclasses.replace(p, kind="lm") for p in (rp, pp))
    stats = _stats(seed, net, kind, p50=p50,
                   tokens=96 if kind == "prefill_chunk" else 0)
    got = profile.profile({net: pp}, stats, hw=HW)
    want = ref_profile.profile({net: rp}, stats, hw=HW)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert gd.keys() == wd.keys()
        assert all(_close(gd[k], wd[k]) for k in gd), (gd, wd)
        for prop in ("achieved_flops", "achieved_bytes_per_s",
                     "roofline_fraction"):
            assert _close(getattr(g, prop), getattr(w, prop)), prop
    assert profile.format_profile(got) == ref_profile.format_profile(want)


def test_clamp_and_raw_fraction(plans):
    _, pp = plans["jet_tagger"]
    (fast,) = [r for r in profile.profile(
        {"jet_tagger": pp}, _stats(0, "jet_tagger", p50=1e-9), hw=HW)
        if r.group is None]
    assert fast.roofline_fraction == 1.0
    assert fast.raw_fraction == pytest.approx(fast.ceiling_s / 1e-9)
    assert fast.raw_fraction > 1.0
    (slow,) = [r for r in profile.profile(
        {"jet_tagger": pp}, _stats(0, "jet_tagger", p50=1.0), hw=HW)
        if r.group is None]
    assert slow.raw_fraction == slow.roofline_fraction == slow.ceiling_s
    (zero,) = [r for r in profile.profile(
        {"jet_tagger": pp}, _stats(0, "jet_tagger", p50=0.0), hw=HW)
        if r.group is None]
    assert zero.raw_fraction is zero.roofline_fraction is None
    assert zero.achieved_flops is None and zero.measured_lare is None


def test_prefill_scales_by_tokens_per_chunk(plans):
    _, pp = plans["tau_select"]
    lm = dataclasses.replace(pp, kind="lm")
    stats = _stats(3, "t", "prefill_chunk", tokens=40)
    count = stats[("t", "prefill_chunk")]["count"]
    (r,) = profile.profile({"t": lm}, stats, hw=HW)
    assert r.flops == pytest.approx(lm.work()["flops"] * 40 / count)


def test_roofline_terms_read_the_cards_ceilings():
    card = hw.H100_SXM
    t8 = profile.roofline_terms(1e9, 1e6, 2, itemsize=1)
    assert t8["peak_flops"] == card.peak_int8_ops
    assert t8["t_compute_s"] == 1e9 / card.peak_int8_ops
    assert t8["t_memory_s"] == 1e6 / card.hbm_bw
    assert t8["t_launch_s"] == 2 * card.kernel_overhead_s
    assert t8["t_collective_s"] == 0.0
    t16 = profile.roofline_terms(1e9, 1e6, 2, itemsize=2)
    assert t16["peak_flops"] == card.peak_bf16_ops
    fitted = dataclasses.replace(card, kernel_overhead_s=2.8e-5)
    assert profile.roofline_terms(1.0, 1.0, 1, hw=fitted)["bound"] == \
        "launch"
    ref = ref_profile.roofline_terms(1e9, 1e6, 2, itemsize=1, hw=HW)
    assert profile.roofline_terms(1e9, 1e6, 2, itemsize=1, hw=HW) == ref
    with pytest.raises(ValueError, match="collective"):
        profile.roofline_terms(1.0, 1.0, 1, collective_bytes=64)


def test_profile_snapshots_are_byte_identical(plans, tmp_path):
    for seed, net in enumerate(NETS):
        rp, pp = plans[net]
        for p50 in (None, 0.0):
            stats = _stats(seed, net, p50=p50)
            got = profile.write_profile_snapshots(
                profile.profile({net: pp}, stats, hw=HW),
                tmp_path / "port" / str(p50), meta={"source": "test"})
            want = ref_profile.write_profile_snapshots(
                ref_profile.profile({net: rp}, stats, hw=HW),
                tmp_path / "ref" / str(p50), meta={"source": "test"})
            assert [p.name for p in got] == [p.name for p in want]
            assert [p.read_bytes() for p in got] == \
                [p.read_bytes() for p in want]
    payload = json.loads(got[0].read_text())
    assert not any(r["name"].endswith("/p50") for r in payload["rows"])


def test_measured_lare_is_the_references(plans):
    for seed, net in enumerate(NETS):
        rp, pp = plans[net]
        for p50 in (1e-6, 4e-5, 1e-3, 0.0, math.inf):
            assert profile._measured_lare(pp, p50) == \
                ref_profile._measured_lare(rp, p50), (net, p50)


# ---------------------------------------------------------------------------
# the deployment's ceilings and the served steps' FLOPs
# ---------------------------------------------------------------------------

def test_profile_hw_is_the_plans_ceilings():
    stock = Deployment.build(["jet_tagger"], machine_model="stock",
                             device="cpu", stop_after="plan")
    assert stock.profile_hw() is hw.H100_SXM
    fitted = dataclasses.replace(hw.H100_SXM, kernel_overhead_s=2.8e-5)
    given = Deployment.build(["jet_tagger"], machine_model=fitted,
                             device="cpu", stop_after="plan")
    assert given.profile_hw() is fitted


def test_graph_overhead_model_flops_are_the_references():
    """``model_flops`` as the reference's ``hlo_overhead`` gives it for
    ``jet_tagger``, and the CPU edge engine's eager forward runs exactly
    the planned GEMMs (the plain versions' aten matmuls, counted once)."""
    from repro.deploy import Deployment as RefDeployment
    ref = RefDeployment.build(["jet_tagger"], machine_model=None)
    want = ref.hlo_overhead()["jet_tagger"]
    dep = Deployment.build(["jet_tagger"], machine_model="stock",
                           device="cpu", trace=True)
    got = dep.graph_overhead()["jet_tagger"]
    assert got["model_flops"] == want["model_flops"]
    assert got["graph_flops"] == got["model_flops"]
    assert got["useful_fraction"] == 1.0
    assert got["graph_bytes"] > 0
    assert set(got) == {"model_flops", "graph_flops", "graph_bytes",
                        "useful_fraction"}


@pytest.mark.parametrize("net", ["tau_select", "autoencoder"])
def test_cpu_engine_steps_count_the_planned_flops(net):
    cfg = edge.edge_config(net)
    eng = EdgeEngine(cfg, seed=0, device="cpu")
    flops = eng.plan.work()["flops"]
    before = ops.work_counts()
    got = graph_analysis.analyze_engine(eng)
    assert ops.work_counts() == before        # nothing recorded on the CPU
    assert got["step"] == f"fused {[cfg.batch, cfg.dims[0]]}"
    assert got["flops"] == flops
    assert got["steps"][got["step"]]["kernel_flops"] == 0
    eng.degrade()
    per_layer = graph_analysis.analyze_engine(eng)
    assert per_layer["step"] == f"per_layer {[cfg.batch, cfg.dims[0]]}"
    assert per_layer["flops"] == flops


def test_batcher_step_leaves_the_state():
    from repro_torch import configs
    from repro_torch.models import api, tree
    from repro_torch.serve.engine import ContinuousBatcher
    cfg = configs.get("recurrentgemma-2b").smoke
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = ContinuousBatcher(cfg, params, slots=2, max_len=32)
    b.state = tree.tree_map(lambda t: t.normal_(), b.state)
    before = tree.tree_map(torch.clone, b.state)
    inputs = b._inputs.clone()
    got = graph_analysis.analyze_engine(b)
    assert got["step"] == "decode_tick" and got["flops"] > 0
    assert torch.equal(b._inputs, inputs)
    assert all(tree.leaves(tree.tree_map(torch.equal, before, b.state)))


# ---------------------------------------------------------------------------
# the kernels' work records
# ---------------------------------------------------------------------------

def test_work_records_are_the_bound_arithmetic():
    """Each record's formula is the arithmetic PERF.md's bound column
    divides by the peak rate (``chip_smoke.py``'s ``bound`` rows)."""
    dims = (16, 64, 32, 32, 5)
    shapes = list(zip(dims[:-1], dims[1:]))
    m = 8
    assert fused_mlp.work(m, dims) == (
        2.0 * m * sum(k * n for k, n in shapes),
        m * dims[0] * 4 + sum(k * n for k, n in shapes)
        + sum(2 * 4 * n for n in dims[1:]) + 4 * len(shapes)
        + m * dims[-1] * 4)
    m, k, n = 256, 1024, 1024
    assert gemm_int8.work(m, k, n, 4) == (
        2.0 * m * k * n, m * k + k * n + 4 * n + 4 * m * n)
    assert tiled_gemm.work(m, k, n, 1, 4) == (
        2.0 * m * k * n, m * k + k * n + 4 * m * n)
    assert tiled_gemm.work(m, k, n, 2, 2) == (
        2.0 * m * k * n, 2 * (m * k + k * n + m * n))
    assert fused_dense.work(m, k, n, 4, 4, 4, False) == (
        2.0 * m * k * n, 4 * (m * k + k * n + n + m * n))
    n_el = 1 * 4096 * 2560
    assert rglru.work(n_el, 4) == (2.0 * n_el, 3 * 4 * n_el)
    bh, t, d, heads = 64, 4096, 64, 64
    for io, state in ((2, False), (4, True)):
        nbytes = 4 * bh * t * d * io + 4 * bh * t * d + 4 * heads * d
        if state:
            nbytes += 2 * 4 * bh * d * d
        assert rwkv6.work(bh, t, d, heads, io, state_in=state,
                          state_out=state) == (
            bh * t * (5.0 * d * d + 5.0 * d), nbytes)
    # flash: 4 D a kept (query, key) pair and query head, the band of the
    # served shape and of the chunk past the window
    for (b, hq, hkv, s, sk, d), kw in (
            ((1, 10, 1, 4096, 4096, 256), {"causal": True, "window": 2048,
                                           "q_offset": 0}),
            ((1, 10, 1, 8, 2056, 256), {"causal": True, "window": 2048,
                                        "q_offset": 2048})):
        q_pos = kw["q_offset"] + torch.arange(s)[:, None]
        k_pos = torch.arange(sk)[None, :]
        band = (k_pos <= q_pos) & (k_pos > q_pos - kw["window"])
        pairs = int(band.sum()) * b * hq
        numel = (b * hq * s * d, b * hkv * sk * d)
        assert flash_attention.work(b, hq, hkv, s, sk, d, 2, **kw) == (
            4.0 * d * pairs, 2 * (2 * numel[0] + 2 * numel[1]))


@pytest.mark.parametrize("causal,window,q_offset",
                         [(True, None, 0), (False, None, 0), (True, 3, 0),
                          (False, 4, 2), (True, 5, 9), (True, 1, 0)])
def test_band_pairs_count_the_mask(causal, window, q_offset):
    s, sk = 7, 12
    q_pos = q_offset + torch.arange(s)[:, None]
    k_pos = torch.arange(sk)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    assert flash_attention.band_pairs(s, sk, causal=causal, window=window,
                                      q_offset=q_offset) == int(mask.sum())


def test_cpu_wrappers_record_nothing():
    ops.reset_launches()
    gen = torch.Generator().manual_seed(0)
    x8 = torch.randint(-127, 128, (8, 64), generator=gen, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (64, 32), generator=gen, dtype=torch.int8)
    ops.gemm_int8(x8, w8, torch.rand(32, generator=gen))
    ops.tiled_gemm(torch.randn(8, 16, generator=gen),
                   torch.randn(16, 32, generator=gen))
    ops.fused_dense(torch.randn(8, 16, generator=gen),
                    torch.randn(16, 8, generator=gen),
                    torch.randn(8, generator=gen))
    ops.linear_scan(torch.rand(1, 5, 4, generator=gen),
                    torch.rand(1, 5, 4, generator=gen))
    q = torch.randn(1, 2, 5, 8, generator=gen)
    ops.flash_attention(q, q[:, :1], q[:, :1])
    assert all(w == {"flops": 0.0, "bytes": 0.0}
               for w in ops.work_counts().values())
    assert all(n == 0 for n in ops.launch_counts().values())


def test_graph_records_follow_the_launch_counters():
    """A capture puts the records back and a replay adds them, as for the
    launch counters (the CPU side of ``kernels/graph.py``'s arithmetic)."""
    ops.reset_launches()
    work = {name: {"flops": 2.0 * i, "bytes": 3.0 * i}
            for i, name in enumerate(ops.launch_counts())}
    before = ops.work_counts()
    ops.add_work(work)
    assert ops.work_since(before) == work
    ops.add_work(work)
    ops.set_work(before)
    assert ops.work_counts() == before
    ops.add_work(work)
    ops.reset_launches()
    assert all(w == {"flops": 0.0, "bytes": 0.0}
               for w in ops.work_counts().values())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m "
                    "pytest -m gpu tests/test_torch_profile.py)")
    return torch.device("cuda", torch.cuda.current_device())


def _one_record(name: str) -> dict:
    counts = ops.work_counts()
    assert ops.launch_counts()[name] == 1
    assert all(w == {"flops": 0.0, "bytes": 0.0}
               for k, w in counts.items() if k != name)
    return counts[name]


@pytest.mark.gpu
def test_each_launch_records_its_formula():
    dev = _card()
    gen = torch.Generator().manual_seed(0)

    def rec(name, fn):
        ops.reset_launches()
        fn()
        torch.cuda.synchronize()
        w = _one_record(name)
        return w["flops"], w["bytes"]

    cfg = edge.edge_config("jet_tagger")
    eng = EdgeEngine(cfg, seed=0, device=dev, graphs=False)
    g = fused_mlp.pack_group([q["w_q"] for q in eng.qparams],
                             [q["w_scale"] for q in eng.qparams],
                             [q["b"] for q in eng.qparams],
                             [0.05] * len(eng.qparams))
    x = torch.randn((8, cfg.dims[0]), generator=gen).to(dev)
    assert rec("fused_mlp_q8", lambda: ops.fused_group(x, g)) == \
        fused_mlp.work(8, cfg.dims)
    x8 = torch.randint(-127, 128, (8, 64), generator=gen,
                       dtype=torch.int8).to(dev)
    w8 = torch.randint(-127, 128, (64, 32), generator=gen,
                       dtype=torch.int8).to(dev)
    sw = torch.rand(32, generator=gen).to(dev)
    assert rec("gemm_int8", lambda: ops.gemm_int8(
        x8, w8, sw, out_dtype=torch.float32)) == gemm_int8.work(8, 64, 32, 4)
    assert rec("tiled_gemm", lambda: ops.tiled_gemm(x8, w8)) == \
        tiled_gemm.work(8, 64, 32, 1, 4)
    xf = torch.randn(8, 64, generator=gen).to(dev)
    wf = torch.randn(64, 32, generator=gen).to(dev)
    bf = torch.randn(32, generator=gen).to(dev)
    assert rec("fused_dense", lambda: ops.fused_dense(xf, wf, bf, xf[:, :32]
                                                      .contiguous())) == \
        fused_dense.work(8, 64, 32, 4, 4, 4, True)
    a = torch.rand(2, 300, 64, generator=gen).to(dev)
    assert rec("linear_scan", lambda: ops.linear_scan(a, a)) == \
        rglru.work(a.numel(), 4)
    q = torch.randn(1, 4, 40, 64, generator=gen).to(dev).to(torch.bfloat16)
    kv = torch.randn(1, 2, 48, 64, generator=gen).to(dev).to(torch.bfloat16)
    assert rec("flash_attention", lambda: ops.flash_attention(
        q, kv, kv, window=16, q_offset=8)) == flash_attention.work(
        1, 4, 2, 40, 48, 64, 2, causal=True, window=16, q_offset=8)
    r = torch.randn(4, 40, 64, generator=gen).to(dev)
    w = torch.rand(4, 40, 64, generator=gen).to(dev)
    u = torch.randn(2, 64, generator=gen).to(dev)
    s0 = torch.randn(4, 64, 64, generator=gen).to(dev)
    assert rec("rwkv6_scan", lambda: ops.rwkv6_scan(
        r, r, r, w, u, state0=s0, return_state=True)) == rwkv6.work(
        4, 40, 64, 2, 4, state_in=True, state_out=True)


@pytest.mark.gpu
@pytest.mark.parametrize("rung", [0, 1])
def test_a_replayed_graph_records_its_eager_step(rung):
    """A graphed edge forward's replays add exactly what its eager forward
    records, and ``graph_overhead`` reads the planned FLOPs off the graph
    (``useful_fraction`` 1)."""
    dev = _card()
    cfg = edge.edge_config("tau_select")
    g = EdgeEngine(cfg, seed=1, device=dev)
    e = EdgeEngine(cfg, qparams=g.qparams, plan=g.plan, device=dev,
                   graphs=False)
    x = torch.randn((cfg.batch, cfg.dims[0]),
                    generator=torch.Generator().manual_seed(2)).to(dev)
    records = []
    for eng in (g, e):
        if rung:
            eng.degrade()
        eng.infer(x)                   # the capture (graphed) or warm-up
        ops.reset_launches()
        for _ in range(3):
            eng.infer(x)
        records.append({k: w for k, w in ops.work_counts().items()
                        if w["flops"]})
    assert records[0] == records[1]
    (graph,) = g.graph_report().values()
    assert {k: {f: 3 * v for f, v in w.items()}
            for k, w in graph["work"].items()} == records[0]
    assert sum(w["flops"] for w in graph["work"].values()) == \
        g.plan.work()["flops"]
    ov = graph_analysis.graph_overhead(g.plan.work()["flops"], g)
    assert ov["useful_fraction"] == 1.0


@pytest.mark.gpu
def test_a_replayed_tick_records_its_eager_step():
    dev = _card()
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serve.engine import ContinuousBatcher, Request
    cfg = configs.get("recurrentgemma-2b").smoke
    params = api.init(cfg, torch.Generator().manual_seed(0), device=dev)
    records = []
    for graphs in (None, False):
        b = ContinuousBatcher(cfg, params, slots=2, max_len=32,
                              graphs=graphs)
        b.submit(Request(rid=0, prompt=np.array([3, 4, 5], np.int32),
                         max_new=4))
        b.step()                        # capture (graphed)
        ops.reset_launches()
        for _ in range(3):
            b.step()
        records.append(ops.work_counts())
    assert records[0] == records[1]
    assert records[0]["linear_scan"]["flops"] > 0
