"""The dry run's tables against the JAX package's: shape cells, parameter
counts, model FLOPs, the roofline rows, each collective's operand and wire
bytes, and the spatial planner with the LARE core-equivalence built on it.

Every check is exact (integers, labels) or to 1e-12 relative (times).  The
roofline and planner comparisons give both packages one ceilings object
(:data:`CEIL`) whose link rates make the two models' terms the same
arithmetic: the reference reduces a K group at ``ici_bw * ici_links / 2``
and charges a spilled band 1.5x; the port runs a group that fits the fast
axis on ``nvlink_bw`` and a spilled one on ``net_bw`` (``nvlink_bw / 1.5``
here, so a two-band spill costs the same).  The API level is one stand-in
(:func:`_api`) in both packages.
"""

import dataclasses
import math
import types

import pytest

from repro import configs as ref_configs
from repro.core import lare as ref_lare
from repro.core import tiling as ref_tiling
from repro.launch import roofline as ref_roofline
from repro.launch.hlo_analysis import analyze_hlo
from repro.obs.profile import roofline_terms as ref_roofline_terms
from repro_torch import configs, hw
from repro_torch.core import lare, tiling
from repro_torch.launch import graph_analysis, roofline
from repro_torch.obs.profile import roofline_terms

REL = 1e-12
LINK = 50e9
CEIL = types.SimpleNamespace(
    peak_bf16_flops=197e12, peak_bf16_ops=197e12, peak_int8_ops=394e12,
    hbm_bw=819e9, hbm_bytes=16 * 2**30, kernel_overhead_s=2.2e-6,
    ici_bw=LINK, ici_links=2, nvlink_bw=LINK, net_bw=LINK / 1.5)


def _close(a, b) -> bool:
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ref_configs.all_archs())
def test_shapes_and_parameter_counts_are_the_references(name):
    mine, ref = configs.get(name), ref_configs.get(name)
    assert list(mine.shapes) == list(ref.shapes)
    for key, spec in ref.shapes.items():
        assert dataclasses.asdict(mine.shapes[key]) == \
            dataclasses.asdict(spec)
    for which in ("config", "smoke"):
        c, r = getattr(mine, which), getattr(ref, which)
        assert c.param_count() == r.param_count()
        assert c.active_param_count() == r.active_param_count()
    assert sorted(configs.all_archs()) == sorted(ref_configs.all_archs())


def test_subquadratic_archs_take_the_long_cell():
    long = {n for n in configs.all_archs()
            if configs.get(n).shapes["long_500k"].skip is None}
    assert long == {"recurrentgemma_2b", "rwkv6_7b"}


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ref_configs.all_archs())
def test_model_flops_are_the_references(name):
    for shape, spec in ref_configs.get(name).shapes.items():
        assert roofline.model_flops_for(name, shape, phase=spec.phase) == \
            ref_roofline.model_flops_for(name, shape, phase=spec.phase)


def _cell(arch, shape, phase, **kw):
    cell = {"arch": arch, "shape": shape, "phase": phase,
            "mesh_kind": "single", "flops": 3.1e14, "hlo_bytes": 2.2e11,
            "collective_operand_bytes": 4.0e9,
            "collectives": {"all-gather": {"groups": {"8": 3}}},
            "temp_size_in_bytes": 9 * 2**30,
            "argument_size_in_bytes": 5 * 2**30, "alias_size_in_bytes": 0}
    cell.update(kw)
    return cell


CELLS = [
    _cell("gemma2_27b", "train_4k", "train"),
    _cell("gemma2_2b", "prefill_32k", "prefill", flops=1e12, hlo_bytes=4e12),
    _cell("rwkv6_7b", "long_500k", "decode", flops=2e9, hlo_bytes=3e10,
          collective_operand_bytes=9e11, temp_size_in_bytes=20 * 2**30),
    _cell("mixtral_8x22b", "decode_32k", "decode",
          collective_operand_bytes=0.0, collectives={}),
]


def test_analyze_cell_and_table_are_the_references():
    mine = [roofline.analyze_cell(c, hw=CEIL) for c in CELLS]
    ref = [ref_roofline.analyze_cell(c, hw=CEIL) for c in CELLS]
    for m, r in zip(mine, ref):
        assert m.keys() == r.keys()
        for k in r:
            if isinstance(r[k], float):
                assert _close(m[k], r[k]), k
            else:
                assert m[k] == r[k], k
    assert roofline.fmt_table(mine) == ref_roofline.fmt_table(ref)
    for c in ({"skipped": "x"}, {"error": "y"}):
        assert roofline.analyze_cell(c) is None


def test_collectives_past_one_node_run_on_the_network():
    cell = _cell("gemma2_27b", "train_4k", "train",
                 collectives={"all-gather": {"groups": {"16": 2}}})
    row = roofline.analyze_cell(cell)
    assert roofline.link_bw(cell, hw.H100_SXM) == hw.H100_SXM.net_bw
    assert row["t_collective_s"] == 4.0e9 / hw.H100_SXM.net_bw
    assert roofline.link_bw(CELLS[0], hw.H100_SXM) == hw.H100_SXM.nvlink_bw
    # The multi mesh's model FLOPs divide over its 512 ranks.
    multi = dict(cell, mesh_kind="multi", ranks=512)
    assert roofline.analyze_cell(multi)["model_flops_per_dev"] == \
        roofline.model_flops_for("gemma2_27b", "train_4k",
                                 phase="train") / 512


def test_roofline_terms_price_collectives_only_at_a_link_rate():
    with pytest.raises(ValueError):
        roofline_terms(1e12, 1e9, 3, collective_bytes=1e6)
    one = roofline_terms(1e12, 1e9, 3)
    assert one["t_collective_s"] == 0.0 and one["bound"] != "collective"
    t = roofline_terms(1e9, 1e6, 0, hw=CEIL, collective_bytes=1e12,
                               link_bw=CEIL.ici_bw)
    r = ref_roofline_terms(1e9, 1e6, 0, hw=CEIL, collective_bytes=1e12)
    assert t == r


# ---------------------------------------------------------------------------
# Collective bytes against the reference's HLO analysis
# ---------------------------------------------------------------------------

_OPS = {"all-reduce": "all-reduce(%p), to_apply=%add",
        "all-gather": "all-gather(%p), dimensions={0}",
        "reduce-scatter": "reduce-scatter(%p), dimensions={0}, "
                          "to_apply=%add",
        "all-to-all": "all-to-all(%p), dimensions={0}",
        "collective-permute": "collective-permute(%p), "
                              "source_target_pairs={{0,1}}"}


def _hlo(kind: str, group: int, dims=(512, 128)) -> str:
    shape = "f32[" + ",".join(map(str, dims)) + "]"
    groups = ("replica_groups={{" + ",".join(map(str, range(group)))
              + "}}") if group <= 16 else f"replica_groups=[1,{group}]<=[{group}]"
    return (f"HloModule m\n\nENTRY %main (p: {shape}) -> {shape} {{\n"
            f"  %p = {shape}{{1,0}} parameter(0)\n"
            f"  ROOT %c = {shape}{{1,0}} {_OPS[kind]}, {groups}\n}}\n")


@pytest.mark.parametrize("kind", graph_analysis.COLLECTIVES)
@pytest.mark.parametrize("group", [1, 2, 16, 256])
def test_collective_bytes_are_the_hlo_analysis(kind, group):
    dims = (512, 128)
    ref = analyze_hlo(_hlo(kind, group, dims))["collectives"][kind]
    assert ref["count"] == 1
    operand, wire = graph_analysis.collective_bytes(
        kind, 4 * math.prod(dims), group)
    assert (operand, wire) == (ref["operand_bytes"], ref["wire_bytes"])


# ---------------------------------------------------------------------------
# The spatial planner and the core-equivalence
# ---------------------------------------------------------------------------

def _api(m, k, n, **_):
    """One block plan for both packages: a roofline of this model."""
    t = max(2.0 * m * k * n / 100e12, (m * k + k * n + 4 * m * n) / 1e12)
    bn = 128 if n % 128 == 0 else n
    return types.SimpleNamespace(block_m=8, block_k=64, block_n=bn,
                                 blocks=(8, 64, bn), est_s=t + 4e-6)


@pytest.fixture
def same_api(monkeypatch):
    monkeypatch.setattr(ref_tiling, "plan_api", _api)
    monkeypatch.setattr(tiling, "plan_api", _api)


def _same_spatial(a, b) -> bool:
    return ((a.p_k, a.p_n, a.q_k, a.q_n, a.bands)
            == (b.p_k, b.p_n, b.q_k, b.q_n, b.bands)
            and _close(a.est_collective_s, b.est_collective_s))


GEMMS = [(8, 512, 512), (8, 4096, 4096), (64, 2048, 8192),
         (256, 16384, 1024), (8, 1024, 65536), (1, 128, 128)]
AXES = [((1,), 1), ((2,), 2), ((4,), 4), ((8,), 8), ((8, 2), 16),
        ((4, 2), 8), ((8,), 4)]


@pytest.mark.parametrize("m,k,n", GEMMS)
def test_collective_time_and_plans_are_the_references(same_api, m, k, n):
    for kind in ("all_reduce", "reduce_scatter", "all_gather", "all_to_all"):
        for g in (1, 2, 8, 16):
            assert tiling.collective_time(m * n * 4, g, axis_bw=LINK,
                                          kind=kind) == \
                ref_tiling.collective_time(m * n * 4, g, axis_bw=LINK,
                                           kind=kind)
    for axes, cap in AXES:
        for floors in ((512, 512), (1, 1)):
            mine = tiling.plan_spatial(m, k, n, itemsize=2, axis_sizes=axes,
                                       hw=CEIL, max_tiles=cap,
                                       q_k_floor=floors[0],
                                       q_n_floor=floors[1])
            ref = ref_tiling.plan_spatial(m, k, n, itemsize=2,
                                          axis_sizes=axes, tpu=CEIL,
                                          max_tiles=cap, q_k_floor=floors[0],
                                          q_n_floor=floors[1])
            assert _same_spatial(mine, ref), (axes, cap, floors)
        mine = tiling.plan_gemm(m, k, n, itemsize=2, axis_sizes=axes,
                                hw=CEIL, max_tiles=cap)
        ref = ref_tiling.plan_gemm(m, k, n, itemsize=2, axis_sizes=axes,
                                   tpu=CEIL, max_tiles=cap)
        assert _same_spatial(mine.spatial, ref.spatial)
        assert mine.rules == ref.rules and _close(mine.est_s, ref.est_s)


def test_a_spilled_reduction_runs_on_the_network(same_api):
    ceil = dataclasses.replace(hw.H100_SXM)
    spill = tiling.plan_spatial(8, 1 << 20, 128, axis_sizes=(8, 4),
                                hw=ceil, max_tiles=32, q_k_floor=1,
                                q_n_floor=1)
    assert spill.p_k == 32 and spill.bands == 4
    assert spill.est_collective_s == tiling.collective_time(
        8 * 128 * 4, 32, axis_bw=ceil.net_bw)
    fits = tiling.plan_spatial(8, 1 << 20, 128, axis_sizes=(8, 4), hw=ceil,
                               max_tiles=8, q_k_floor=1, q_n_floor=1)
    assert fits.bands == 1 and fits.est_collective_s == \
        tiling.collective_time(8 * 128 * 4, fits.p_k, axis_bw=ceil.nvlink_bw)


@pytest.mark.parametrize("n_in,n_out", [(16, 64), (64, 64), (256, 1024),
                                        (1024, 4096), (4096, 4096)])
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_core_equivalence_is_lare_tpus(same_api, n_in, n_out, batch):
    for kernel_cores in (1, 2):
        mine = lare.lare_spatial(n_in, n_out, batch=batch, itemsize=2,
                                 kernel_cores=kernel_cores, max_cores=8,
                                 hw=CEIL)
        ref = ref_lare.lare_tpu(n_in, n_out, batch=batch, itemsize=2,
                                kernel_cores=kernel_cores, max_cores=8,
                                tpu=CEIL)
        assert _close(mine.tiled_latency_s, ref.tiled_latency_s)
        assert [c for c, _ in mine.pipeline_curve] == \
            [c for c, _ in ref.pipeline_curve]
        assert all(_close(a, b) for (_, a), (_, b) in
                   zip(mine.pipeline_curve, ref.pipeline_curve))
        assert mine.core_eq == ref.core_eq or _close(mine.core_eq,
                                                     ref.core_eq)
        for budget in (1, 4, 64):
            assert mine.decide(budget) == ref.decide(budget)
    measured = lare.lare_spatial(n_in, n_out, batch=batch,
                                 tiled_latency_s=1e-5, max_cores=8, hw=CEIL,
                                 pipeline_latency_fn=lambda c: 4e-5 / c)
    assert measured.core_eq == ref_lare.lare_tpu(
        n_in, n_out, batch=batch, tiled_latency_s=1e-5, max_cores=8,
        tpu=CEIL, pipeline_latency_fn=lambda c: 4e-5 / c).core_eq


def test_lare_spatial_on_the_stock_card():
    """The port's own block plan and the card's constants: a wider layer
    needs more cards of a pipeline to match one card's tiled GEMM."""
    small = lare.lare_spatial(64, 64, batch=8)
    big = lare.lare_spatial(4096, 4096, batch=8, max_cores=64)
    assert small.kernel_cores == 1 and len(big.pipeline_curve) == 7
    assert all(t > 0 for _, t in big.pipeline_curve)
    assert big.tiled_latency_s == tiling.plan_gemm(
        8, 4096, 4096, axis_sizes=(1,), max_tiles=1).est_s
