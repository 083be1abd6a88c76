"""LARE (the paper's Algorithm 1), the AIE-ML single-tile model and the two
fabric models it prices against, against the JAX package's
(``repro_torch.core.lare``, ``repro_torch.core.tiling``'s ``aie_*``,
``repro_torch.hw.{AieMl,PlFabric}``).

Shapes: every layer of the five Table-I nets, at batch 8 and others;
intervals: the default single-tile model's (``aie_interval_s=None``) and a
grid injected across and beyond the PL curve, as the profiler injects the
card's measured time.  Every value agrees to 1e-12 relative.  The card's
own model, ``hw.H100``, keeps every field (the plans' keys are pinned in
``tests/test_torch_edge.py``).
"""

import dataclasses

import numpy as np
import pytest

from repro import hw as ref_hw
from repro.core import lare as ref_lare
from repro.core import tiling as ref_tiling
from repro.models import edge as ref_edge
from repro_torch import hw
from repro_torch.core import lare, tiling

REL = 1e-12
SHAPES = sorted({s for net in ref_edge.EDGE_NETS
                 for s in ref_edge.edge_config(net).layer_shapes})
BATCHES = (1, 8, 16)


def _close(a, b) -> bool:
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def _same_points(got, want) -> bool:
    return len(got) == len(want) and all(
        g.rf == w.rf and g.fits == w.fits and _close(g.interval_s,
                                                     w.interval_s)
        and _close(g.latency_s, w.latency_s)
        and _close(g.resource, w.resource) for g, w in zip(got, want))


def test_fabric_models_are_the_references():
    assert dataclasses.asdict(hw.AIE_ML) == dataclasses.asdict(ref_hw.AIE_ML)
    assert dataclasses.asdict(hw.PL_FABRIC) == \
        dataclasses.asdict(ref_hw.PL_FABRIC)
    for s in hw.AIE_ML.legal_api_tiles_i8 + ((2, 2, 2),):
        assert hw.AIE_ML.api_efficiency(*s) == \
            ref_hw.AIE_ML.api_efficiency(*s)
    for n_in, n_out in SHAPES:
        rfs = hw.PL_FABRIC.legal_reuse_factors(n_in, n_out)
        assert rfs == ref_hw.PL_FABRIC.legal_reuse_factors(n_in, n_out)
        for rf in rfs[:: max(1, len(rfs) // 5)]:
            for strategy in ("resource", "latency"):
                res = hw.PL_FABRIC.resources(n_in, n_out, rf,
                                             strategy=strategy)
                assert res == ref_hw.PL_FABRIC.resources(
                    n_in, n_out, rf, strategy=strategy)
                assert hw.PL_FABRIC.fits(res) == ref_hw.PL_FABRIC.fits(res)
                assert hw.PL_FABRIC.resource_scalar(res) == \
                    ref_hw.PL_FABRIC.resource_scalar(res)


def test_the_card_model_keeps_its_fields():
    """The fabric models sit apart from the card's: ``H100`` gains no
    field a plan key reads (one would change every plan key).  The dry
    run's memory size and link rates stay out of the keys."""
    assert [f.name for f in dataclasses.fields(hw.H100)] == [
        "sms", "hbm_bw", "peak_int8_ops", "smem_bytes", "kernel_overhead_s",
        "fused_epilogue_s", "peak_bf16_ops", "f32_fma_ops",
        "dram_round_trip_s", "hbm_bytes", "nvlink_bw", "net_bw"]
    assert [f.name for f in dataclasses.fields(hw.H100)
            if f.metadata.get("plan_key", True)] == [
        "sms", "hbm_bw", "peak_int8_ops", "smem_bytes", "kernel_overhead_s",
        "fused_epilogue_s"]


@pytest.mark.parametrize("batch", BATCHES)
def test_aie_single_tile_model_is_the_references(batch):
    for n_in, n_out in SHAPES:
        for s in hw.AIE_ML.legal_api_tiles_i8:
            assert tiling.aie_api_legal(s, batch, n_in, n_out) == \
                ref_tiling.aie_api_legal(s, batch, n_in, n_out)
            assert _close(tiling.aie_tile_latency(batch, n_in, n_out, s),
                          ref_tiling.aie_tile_latency(batch, n_in, n_out, s))
            assert _close(tiling.aie_tile_interval(batch, n_in, n_out, s),
                          ref_tiling.aie_tile_interval(batch, n_in, n_out,
                                                       s))
        got = tiling.aie_best_single_tile(batch, n_in, n_out)
        want = ref_tiling.aie_best_single_tile(batch, n_in, n_out)
        assert got[0] == want[0] and _close(got[1], want[1])


@pytest.mark.parametrize("strategy", ["resource", "latency"])
@pytest.mark.parametrize("batch", BATCHES)
def test_pl_curve_is_the_references(strategy, batch):
    for n_in, n_out in SHAPES:
        assert _same_points(
            lare.pl_curve(n_in, n_out, batch=batch, strategy=strategy),
            ref_lare.pl_curve(n_in, n_out, batch=batch, strategy=strategy))


def _same_result(got, want) -> bool:
    return (got.n_in == want.n_in and got.n_out == want.n_out
            and _close(got.aie_interval_s, want.aie_interval_s)
            and _close(got.rf_eq, want.rf_eq) and _close(got.lare, want.lare)
            and _close(got.aie_favorable_below, want.aie_favorable_below)
            and _close(got.aie_efficiency, want.aie_efficiency)
            and _same_points(got.pl_curve, want.pl_curve))


@pytest.mark.parametrize("batch", BATCHES)
def test_lare_with_the_tile_models_interval_is_the_references(batch):
    for n_in, n_out in SHAPES:
        got = lare.lare(n_in, n_out, batch=batch)
        want = ref_lare.lare(n_in, n_out, batch=batch)
        assert _same_result(got, want), (n_in, n_out)
        for budget in (0.0, got.lare, 2 * got.lare, 1e9):
            assert got.decide(budget) == want.decide(budget)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lare_with_injected_intervals_is_the_references(seed):
    """Intervals across the PL curve (interpolated), below its first point
    and past its last (clamped), as measured card times land."""
    rng = np.random.default_rng(seed)
    for n_in, n_out in SHAPES:
        curve = ref_lare.pl_curve(n_in, n_out)
        lo, hi = curve[0].interval_s, curve[-1].interval_s
        grid = [lo / 10, lo, hi, hi * 10, *(
            float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            for _ in range(6))]
        for interval in grid:
            got = lare.lare(n_in, n_out, aie_interval_s=interval)
            want = ref_lare.lare(n_in, n_out, aie_interval_s=interval)
            assert _same_result(got, want), (n_in, n_out, interval)
