"""The port's characterization (``repro_torch.characterize``) and
calibration feedback (``repro_torch.plan.calibrate``) against the JAX
package's on the same numbers.

Fits run on synthetic samples (a known linear cost, optionally with seeded
noise), so nothing here judges wall time.  The harness's real points run
once on the CPU (plain kernels) for their shape, never for their speed.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.characterize import fit as ref_fit
from repro.characterize import model as ref_model
from repro.characterize.harness import Sample as RefSample
from repro.plan import PlanCache as RefPlanCache
from repro.plan import calibrate as ref_calibrate
from repro.plan.artifact import DeploymentPlan as RefDeploymentPlan
from repro.plan.multinet import FleetPlan as RefFleetPlan
from repro_torch import hw
from repro_torch import characterize as ch
from repro_torch.characterize import harness, sweeps
from repro_torch.core import tiling
from repro_torch.kernels import fused_mlp
from repro_torch.models import edge
from repro_torch.plan import PlanCache, calibrate, plan_deployment, plan_fleet

# Constants the synthetic timer encodes; fits must recover them.
_TRUE = {
    "overhead_s": 9e-6,
    "inv_peak_int8": 1e-13,
    "fused_const": 2e-5,
    "fused_epilogue_s": 4e-7,
    "boundary_const": 2e-5,
    "boundary_dispatch": 2e-6,
    "boundary_per_byte": 6e-13,
    "contention_base": 1.5e-7,
    "band2_penalty": 0.085,
}


def _synthetic_timer(term, regs):
    if term == "gemm_int8":
        return (_TRUE["overhead_s"] * regs["launches"]
                + _TRUE["inv_peak_int8"] * regs["padded_ops"])
    if term == "fused_chain":
        return (_TRUE["fused_const"]
                + _TRUE["inv_peak_int8"] * regs["padded_ops"]
                + _TRUE["fused_epilogue_s"] * regs["inner_layers"])
    if term == "boundary":
        return (_TRUE["boundary_const"]
                + _TRUE["boundary_dispatch"] * regs["launches"]
                + _TRUE["boundary_per_byte"] * regs["launch_bytes"])
    if term == "contention":
        return _TRUE["contention_base"] * (
            1.0 + _TRUE["band2_penalty"] * regs["n_band2"])
    raise AssertionError(term)


def _model(**kw):
    return ch.characterize(sweep="quick", timer=_synthetic_timer, **kw)


def _noisy_samples(sweep, seed):
    """The sweep's synthetic samples with seeded multiplicative noise, so
    the fits are not exact."""
    rng = np.random.default_rng(seed)
    return [dataclasses.replace(s, seconds=s.seconds
                                * float(rng.uniform(0.7, 1.3)))
            for s in sweeps.run_sweep(sweep=sweep, timer=_synthetic_timer)]


def _ref_sample(s):
    return RefSample(term=s.term, inputs=dict(s.inputs),
                     regressors=dict(s.regressors), seconds=s.seconds)


def _ref_machine_model(mm):
    return ref_model.MachineModel(
        fits={t: ref_fit.TermFit.from_dict(f.to_dict())
              for t, f in mm.fits.items()},
        provenance=dict(mm.provenance))


# ---------------------------------------------------------------------------
# The fit against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sweep,seed", [("quick", None), ("quick", 1),
                                        ("full", 2), ("calibrate", 3)])
def test_fit_all_matches_reference(sweep, seed):
    samples = (sweeps.run_sweep(sweep=sweep, timer=_synthetic_timer)
               if seed is None else _noisy_samples(sweep, seed))
    got = ch.fit_all(samples)
    want = ref_fit.fit_all([_ref_sample(s) for s in samples])
    assert list(got) == list(want) == list(sweeps.TERMS)
    for term, g in got.items():
        w = want[term]
        np.testing.assert_allclose(g.coefficients, w.coefficients,
                                   rtol=1e-12, atol=0)
        assert g.residual_rel_rms == pytest.approx(w.residual_rel_rms,
                                                   rel=1e-12, abs=1e-15)
        # The port drops an epilogue its fit does not resolve (see
        # test_unresolved_epilogue_keeps_the_stock_constant); every
        # constant it keeps is the reference's.
        dropped = w.constants.keys() - g.constants.keys()
        assert dropped <= {"fused_epilogue_s"}, term
        if dropped:
            assert not _epilogue_resolved(samples, w.coefficients[2])
        for k, v in g.constants.items():
            assert v == pytest.approx(w.constants[k], rel=1e-12), (term, k)
    if seed is None:
        assert "fused_epilogue_s" in got["fused_chain"].constants


def _epilogue_resolved(samples, epilogue):
    rows = [s for s in samples if s.term == "fused_chain"]
    a = np.array([[1.0, s.regressors["padded_ops"],
                   s.regressors["inner_layers"]] for s in rows])
    t = np.array([s.seconds for s in rows])
    coef, *_ = np.linalg.lstsq(a, t, rcond=None)
    rms = float(np.sqrt(np.mean((a @ coef - t) ** 2)))
    return epilogue * np.ptp(a[:, 2]) > 2 * rms


# fused_chain points of the quick grid on the card (NVIDIA H100 80GB HBM3,
# 700 W), as chip_smoke.py recorded them: the host seconds of one run, the
# device seconds of another.
_CARD_FUSED = [  # (depth, width, seconds, device_seconds)
    (2, 64, 41.48e-6, 14.36e-6), (6, 64, 40.65e-6, 18.44e-6),
    (2, 256, 37.67e-6, 17.00e-6), (3, 256, 53.43e-6, 16.48e-6)]


def _card_fused_samples(device=True):
    return [harness.Sample(
        "fused_chain", {"depth": d, "width": w},
        harness.fused_chain_regressors(w, d, 8), t,
        t_dev if device else None) for d, w, t, t_dev in _CARD_FUSED]


def test_unresolved_epilogue_keeps_the_stock_constant():
    """Host time whose epilogue slope is under twice the fit's RMS residual
    fits no ``fused_epilogue_s``: the stock constant stands."""
    tf = ch.fit_term("fused_chain", _card_fused_samples(device=False))
    assert tf.source == "measured"
    assert tf.constants == {}
    ref = ref_fit.fit_term("fused_chain", [
        _ref_sample(s) for s in _card_fused_samples(device=False)])
    np.testing.assert_allclose(tf.coefficients, ref.coefficients,
                               rtol=1e-12)
    mm = ch.MachineModel(fits={"fused_chain": tf}, provenance={})
    assert mm.h100().fused_epilogue_s == hw.H100_SXM.fused_epilogue_s


def test_fused_chain_fits_the_device_time():
    """Where every sample has a device time, the fused chain is fitted on
    it, and the epilogue it resolves there is kept."""
    samples = _card_fused_samples()
    tf = ch.fit_term("fused_chain", samples)
    assert tf.source == "device"
    a = np.array([[1.0, s.regressors["padded_ops"],
                   s.regressors["inner_layers"]] for s in samples])
    coef, *_ = np.linalg.lstsq(a, np.array([s.device_seconds
                                            for s in samples]), rcond=None)
    np.testing.assert_allclose(tf.coefficients, coef, rtol=1e-12)
    assert tf.constants["fused_epilogue_s"] == pytest.approx(coef[2])
    assert 0 < coef[2] < 2e-6
    # One sample without a device time: the host clock, as the reference.
    mixed = samples[:-1] + _card_fused_samples(device=False)[-1:]
    assert ch.fit_term("fused_chain", mixed).source == "measured"
    # The gemm term stays on the host clock, device times or not.
    g = [dataclasses.replace(s, device_seconds=s.seconds / 2)
         for s in sweeps.run_term("gemm_int8", timer=_synthetic_timer)]
    assert ch.fit_term("gemm_int8", g).source == "measured"


def test_int8_rate_clamp_keeps_the_datasheet_where_the_slope_is_noise():
    """Where the reference clamps to 1e12 OP/s (slope <= 1e-15 s/OP, a rate
    above this card's datasheet), the port keeps the datasheet rate."""
    rows = [harness.Sample("gemm_int8", {}, {"launches": float(d),
                                             "padded_ops": float(o)},
                           d * 1e-5)
            for d, o in ((2, 1e7), (6, 3e7), (2, 2e8))]
    got = ch.fit_term("gemm_int8", rows).constants
    want = ref_fit.fit_term("gemm_int8", [_ref_sample(s) for s in rows])
    assert got["kernel_overhead_s"] == pytest.approx(
        want.constants["kernel_overhead_s"], rel=1e-9)
    assert want.constants["peak_int8_ops"] == 1e12
    assert got["peak_int8_ops"] == hw.H100_SXM.peak_int8_ops


def test_fit_recovers_synthetic_constants_deterministically():
    mm = _model()
    assert _model().version == mm.version
    g = mm.fits["gemm_int8"].constants
    assert g["kernel_overhead_s"] == pytest.approx(_TRUE["overhead_s"],
                                                   rel=1e-6)
    assert g["peak_int8_ops"] == pytest.approx(1 / _TRUE["inv_peak_int8"],
                                               rel=1e-6)
    assert mm.fits["fused_chain"].constants["fused_epilogue_s"] == \
        pytest.approx(_TRUE["fused_epilogue_s"], rel=1e-6)
    b = mm.fits["boundary"].constants
    assert b["dispatch_s"] == pytest.approx(_TRUE["boundary_dispatch"],
                                            rel=1e-6)
    assert b["hbm_bw"] == pytest.approx(2 / _TRUE["boundary_per_byte"],
                                        rel=1e-6)
    assert all(r < 1e-9 for r in mm.residuals().values())
    assert mm.provenance["timer"] == "synthetic"
    assert mm.provenance["grids"]["gemm_int8"] == [
        list(p) for p in sweeps.grid("gemm_int8", "quick")]


def test_fit_requires_enough_samples():
    samples = sweeps.run_term("gemm_int8", timer=_synthetic_timer)[:1]
    with pytest.raises(ValueError):
        ch.fit_term("gemm_int8", samples)
    with pytest.raises(ValueError):
        ch.fit_term("gemm_f32", samples)
    with pytest.raises(ValueError):
        sweeps.run_term("gemm_f32", timer=_synthetic_timer)
    with pytest.raises(ValueError):
        sweeps.run_term("gemm_int8", sweep="no_such_sweep")


# ---------------------------------------------------------------------------
# The artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [None, 4])
def test_version_matches_reference(seed):
    mm = (_model() if seed is None else ch.MachineModel(
        fits=ch.fit_all(_noisy_samples("quick", seed)), provenance={}))
    assert mm.version == _ref_machine_model(mm).version
    other = ch.MachineModel(fits=mm.fits,
                            provenance={**mm.provenance, "host": "x"})
    assert other.version == mm.version
    tf = mm.fits["gemm_int8"]
    bumped = dict(mm.fits)
    bumped["gemm_int8"] = dataclasses.replace(
        tf, constants={**tf.constants, "kernel_overhead_s": 1.0})
    assert ch.MachineModel(fits=bumped, provenance={}).version != mm.version


def test_artifact_json_roundtrip(tmp_path):
    mm = _model()
    path = mm.save(tmp_path / "sub" / "model.json")
    back = ch.MachineModel.load(path)
    assert back.version == mm.version
    assert back.to_dict() == mm.to_dict()
    d = json.loads(path.read_text())
    d["fits"]["gemm_int8"]["constants"]["kernel_overhead_s"] *= 2
    path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="version mismatch"):
        ch.MachineModel.load(path)
    d["schema"] = 99
    with pytest.raises(ValueError, match="schema"):
        ch.MachineModel.from_dict(d)


def test_h100_substitution():
    mm = _model()
    card = mm.h100()
    assert card.kernel_overhead_s == pytest.approx(_TRUE["overhead_s"])
    assert card.peak_int8_ops == pytest.approx(1 / _TRUE["inv_peak_int8"])
    assert card.fused_epilogue_s == pytest.approx(_TRUE["fused_epilogue_s"])
    assert card.hbm_bw == pytest.approx(2 / _TRUE["boundary_per_byte"])
    for f in ("sms", "smem_bytes", "peak_bf16_ops", "f32_fma_ops",
              "dram_round_trip_s"):
        assert getattr(card, f) == getattr(hw.H100_SXM, f)
    only_gemm = ch.MachineModel(fits={"gemm_int8": mm.fits["gemm_int8"]},
                                provenance={})
    assert only_gemm.h100().fused_epilogue_s == hw.H100_SXM.fused_epilogue_s
    assert ch.MachineModel(fits={}, provenance={}).h100() is hw.H100_SXM
    # The fitted constants enter the plan key, and the plan is costed
    # under them.
    cfg = edge.edge_config("jet_tagger")
    stock = plan_deployment(cfg, device="cpu")
    fitted = plan_deployment(cfg, device="cpu", hw=card)
    assert fitted.key != stock.key
    assert fitted.est_latency_s > 2 * _TRUE["overhead_s"]


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,width", sweeps.grid("gemm_int8", "full"))
def test_gemm_regressors_are_the_planners_compute_term(depth, width):
    """``padded_ops / peak`` is exactly the compute term ``plan_api``
    charges a layer at its tile: the port's tiles and waves over the SMs,
    not the TPU's 128-wide blocks."""
    card = dataclasses.replace(hw.H100_SXM, hbm_bw=1e30)   # compute-bound
    regs = harness.int8_pipeline_regressors(width, depth, 8, hw=card)
    api = tiling.plan_api(8, width, width, hw=card)
    assert regs["launches"] == depth
    assert regs["padded_ops"] / depth / card.peak_int8_ops == pytest.approx(
        api.est_s - card.kernel_overhead_s, rel=1e-12)
    bm, bk, bn = api.blocks
    per_cta = 2 * bm * bn * -(-width // bk) * bk
    assert regs["padded_ops"] == depth * per_cta * card.sms
    if width < 128:                     # the TPU's blocks would pad to 128
        assert -(-width // bk) * bk == width


@pytest.mark.parametrize("sweep", sweeps.SWEEPS)
def test_fused_grid_fits_one_blocks_shared_memory(sweep):
    for depth, width in sweeps.grid("fused_chain", sweep):
        assert fused_mlp.fused_smem_bytes([width] * (depth + 1)) \
            <= fused_mlp.MAX_SMEM
    assert len({w for _, w in sweeps.grid("fused_chain", sweep)}) >= 2


def test_fused_regressors_use_the_kernels_padding():
    regs = harness.fused_chain_regressors(100, 3, 13)
    rows = 16                                      # two row tiles of 8
    kp, np_ = 128, 112                             # k to 32, n to 16
    assert fused_mlp.ROWS == 8
    assert regs == {"one": 1.0, "padded_ops": 3 * 2.0 * rows * kp * np_,
                    "inner_layers": 2.0}


@pytest.mark.parametrize("term", sweeps.TERMS)
def test_real_points_run_the_plain_path_on_the_cpu(term):
    """One real point of each term on the CPU: the step runs through the
    plain kernels, the sample carries its regressors and a host time, and
    no device time (there is no card)."""
    cpu = torch.device("cpu")
    if term == "gemm_int8":
        s = harness.time_int8_pipeline(64, 2, iters=3, device=cpu)
    elif term == "fused_chain":
        s = harness.time_fused_chain(64, 2, iters=3, device=cpu)
    elif term == "contention":
        s = harness.model_band2_point(2)
    else:
        s = harness.time_unfused_chain(2, 1 << 12, iters=3, device=cpu)
    assert s.term == term and s.seconds > 0 and s.device_seconds is None
    assert harness.Sample.from_dict(json.loads(json.dumps(s.to_dict()))) == s


def test_characterize_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ch.characterize(sweep="calibrate")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.calibrated_device_model()


def test_cli_writes_a_loadable_artifact(tmp_path, capsys):
    from repro_torch.characterize.__main__ import main
    out = tmp_path / "m.json"
    assert main(["--sweep", "calibrate", "--terms", "gemm_int8", "--iters",
                 "3", "--device", "cpu", "--out", str(out)]) == 0
    mm = ch.MachineModel.load(out)
    assert list(mm.fits) == ["gemm_int8"]
    assert mm.provenance["device"] == "cpu" and mm.provenance["card"] is None
    assert len(mm.provenance["samples"]) == 3
    assert "kernel_overhead_s=" in capsys.readouterr().out


def test_cli_without_a_card_exits_1(monkeypatch, capsys):
    from repro_torch.characterize.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--sweep", "calibrate"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Calibration feedback against the reference's, on the same numbers
# ---------------------------------------------------------------------------

def _as_ref_plan(plan):
    d = json.loads(plan.to_json())
    d["target"] = "tpu"
    return RefDeploymentPlan.from_dict(d)


def _as_ref_fleet(fleet):
    d = json.loads(fleet.to_json())
    d["target"] = "tpu"
    for t in d["tenants"]:
        t.update(col_offset=0, cols=0)
        t["plan"]["target"] = "tpu"
    return RefFleetPlan.from_dict(d)


@pytest.mark.parametrize("name", ["jet_tagger", "qubit", "autoencoder"])
@pytest.mark.parametrize("factor", [0.5, 3.0, 40.0])
def test_feedback_matches_reference(name, factor):
    plan = plan_deployment(edge.edge_config(name), device="cpu")
    measured = plan.est_latency_s * factor
    got = calibrate.feedback(plan, measured, cache=PlanCache())
    want = ref_calibrate.feedback(_as_ref_plan(plan), measured,
                                  cache=RefPlanCache())
    assert got.est_latency_s == want.est_latency_s == measured
    assert got.serve["calibration"] == want.serve["calibration"]
    for g, w in zip(got.layers, want.layers):
        assert g.est_latency_s == pytest.approx(w.est_latency_s, rel=1e-12)
    for g, w in zip(got.boundaries, want.boundaries):
        assert g.crossing_s == pytest.approx(w.crossing_s, rel=1e-12)
    # est == parts + overhead, the overhead kept: only the parts scaled.
    parts = sum(l.est_latency_s * l.repeat for l in got.layers) \
        + sum(b.crossing_s for b in got.boundaries)
    before = sum(l.est_latency_s * l.repeat for l in plan.layers) \
        + sum(b.crossing_s for b in plan.boundaries)
    assert got.est_latency_s - parts == pytest.approx(
        plan.est_latency_s - before, rel=1e-9, abs=1e-18)
    # The group estimates keep summing to the layers' parts.
    assert sum(g.est_latency_s for g in got.fusion_groups) == pytest.approx(
        sum(l.est_latency_s * l.repeat for l in got.layers), rel=1e-12)
    assert got.key == plan.key and got.groups() == plan.groups()


def test_recalibrate_fleet_matches_reference():
    cache = PlanCache()
    fleet = plan_fleet([edge.edge_config(n) for n in
                        ("jet_tagger", "tau_select", "vae")],
                       cache=cache, device="cpu")
    measured = {"jet_tagger": fleet.tenants[0].plan.est_latency_s * 4.0,
                "vae": fleet.tenants[2].plan.est_latency_s * 0.7}
    got = calibrate.recalibrate_fleet(fleet, measured, cache=cache)
    want = ref_calibrate.recalibrate_fleet(_as_ref_fleet(fleet), measured,
                                           cache=RefPlanCache())
    for g, w in zip(got.tenants, want.tenants):
        assert g.plan.est_latency_s == pytest.approx(w.plan.est_latency_s,
                                                     rel=1e-12)
        assert g.latency_budget_s == pytest.approx(w.latency_budget_s,
                                                   rel=1e-12)
    assert got.est_latency_s == pytest.approx(want.est_latency_s, rel=1e-12)
    assert got.tenants[1] == fleet.tenants[1]            # unmeasured
    assert cache.get(got.tenants[0].plan.key).est_latency_s == \
        measured["jet_tagger"]
    assert calibrate.measurements_from_engines({}) == {}
