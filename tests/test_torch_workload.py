"""The port's scenario generators, trace files, replay statuses and replay
snapshots against the JAX package's, on the same inputs.

Generators are seeded as ``random.Random(f"{seed}:{scenario}:{net_id}")``
in both packages, so the traces compare exactly, to the float.  Snapshot
rows and the ``format_replay`` text are built from the same records and the
same SLO observations in both packages and compared exactly.  The replay
loop runs against stub routers that refuse or fail on a script, and
``Deployment.replay`` on the CPU edge fleet; nothing here judges wall time.
Files are written under pytest's ``tmp_path`` only.
"""

import dataclasses
import json
import types

import pytest

from repro.obs import slo as ref_slo
from repro.obs import workload as ref_wl
from repro.serve import metrics as ref_metrics
from repro.serve import router as ref_router_lib
from repro_torch import faults
from repro_torch.deploy import Deployment
from repro_torch.obs import slo, workload
from repro_torch.serve import metrics
from repro_torch.serve import router as router_lib

TENANTS = {"jet_tagger": "edge", "tau_select": "edge",
           "recurrentgemma-2b": "lm"}


def _dicts(trace):
    return [r.to_dict() for r in trace]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", sorted(ref_wl.SCENARIOS))
def test_scenarios_equal_the_references(name, seed):
    assert sorted(workload.SCENARIOS) == sorted(ref_wl.SCENARIOS)
    for kw in ({}, dict(duration_s=0.6, rate_hz=350.0, lm_rate_hz=9.0,
                        prompt_tokens=5, new_tokens=2)):
        got = workload.make_scenario(name, TENANTS, seed=seed, **kw)
        want = ref_wl.make_scenario(name, TENANTS, seed=seed, **kw)
        assert _dicts(got) == _dicts(want)
        assert got and [r.rid for r in got] == list(range(len(got)))
        assert {"jet_tagger", "tau_select"} <= {r.tenant for r in got}


@pytest.mark.parametrize("name,kw", [
    ("bursty", dict(burst_factor=3.0, dwell_s=0.01)),
    ("diurnal", dict(depth=0.3)),
    ("flash_crowd", dict(spike_factor=4.0, spike_start=0.1,
                         spike_frac=0.5)),
    ("steady", dict(rate_hz=0.0)),
])
def test_scenario_knobs_equal_the_references(name, kw):
    got = workload.make_scenario(name, TENANTS, seed=3, **kw)
    want = ref_wl.make_scenario(name, TENANTS, seed=3, **kw)
    assert _dicts(got) == _dicts(want)


@pytest.mark.parametrize("call", [
    lambda lib: lib.make_scenario("tsunami", TENANTS),
    lambda lib: lib.steady(TENANTS, duration_s=0.0),
    lambda lib: lib.diurnal(TENANTS, depth=1.5),
    lambda lib: lib.steady({"x": "batch"}),
], ids=["name", "duration", "depth", "kind"])
def test_scenario_errors_equal_the_references(call):
    with pytest.raises(ValueError) as got:
        call(workload)
    with pytest.raises(ValueError) as want:
        call(ref_wl)
    assert str(got.value) == str(want.value)


def test_trace_files_round_trip_across_packages(tmp_path):
    trace = workload.make_scenario("bursty", TENANTS, seed=2)
    p = workload.save_trace(trace, tmp_path / "t" / "port.jsonl")
    ref_p = ref_wl.save_trace(ref_wl.make_scenario("bursty", TENANTS,
                                                   seed=2),
                              tmp_path / "ref.jsonl")
    assert p.read_text() == ref_p.read_text()
    assert workload.load_trace(p) == trace
    assert _dicts(workload.load_trace(ref_p)) == \
        _dicts(ref_wl.load_trace(p))
    for line in p.read_text().splitlines():
        json.loads(line)                     # strict JSON, one per line
    assert workload.save_trace([], tmp_path / "empty.jsonl").read_text() \
        == ""
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"arrival_s": 0.1, "tenant": "a"}\n\n{"tenant": "b"}\n')
    with pytest.raises(ValueError) as got:
        workload.load_trace(bad)
    with pytest.raises(ValueError) as want:
        ref_wl.load_trace(bad)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Snapshots and the printed table
# ---------------------------------------------------------------------------

STATUSES = ("ok", "ok", "ok", "shed", "queue_full", "fault", "breaker",
            "stuck", "ok")


def _records(lib):
    recs = []
    for i in range(60):
        nid = list(TENANTS)[i % 3]
        status = STATUSES[i % len(STATUSES)]
        e2e = (1e-5 * (1 + (i * 7) % 13) if status == "ok" else None)
        recs.append(lib.RequestRecord(i, nid, TENANTS[nid], i * 1e-3,
                                      (i % 5) * 1e-6, e2e, status))
    return recs


def _monitor(lib):
    mon = lib.SloMonitor([lib.SloBudget("jet_tagger", p95_s=5e-5),
                          lib.SloBudget("tau_select", p95_s=1e-3),
                          lib.SloBudget("recurrentgemma-2b", p95_s=1e-4,
                                        priority="standard")],
                         min_samples=3)
    for i in range(30):
        for nid in TENANTS:
            mon.observe(nid, 1e-5 * (1 + (i * 5) % 11))
    return mon


@pytest.mark.parametrize("speed", [1.0, 2.0])
def test_replay_snapshots_and_table_equal_the_references(tmp_path, speed):
    rep = workload.ReplayReport(_records(workload), wall_s=0.0123,
                                speed=speed, scenario="bursty")
    ref = ref_wl.ReplayReport(_records(ref_wl), wall_s=0.0123, speed=speed,
                              scenario="bursty")
    assert rep.summary() == ref.summary()
    mon, ref_mon = _monitor(slo), _monitor(ref_slo)
    assert workload.format_replay(rep, slo=mon) == \
        ref_wl.format_replay(ref, slo=ref_mon)
    assert workload.format_replay(rep) == ref_wl.format_replay(ref)
    assert "VIOLATION" in workload.format_replay(rep, slo=mon)
    meta = {"source": "test", "seed": 0}
    got = workload.write_replay_snapshots(rep, tmp_path / "port", slo=mon,
                                          meta=meta)
    want = ref_wl.write_replay_snapshots(ref, tmp_path / "ref", slo=ref_mon,
                                         meta=meta)
    assert [p.name for p in got] == [p.name for p in want]
    assert len(got) == 3
    for p, q in zip(got, want):
        assert p.read_text() == q.read_text()
        json.loads(p.read_text())
    names = [r["name"] for r in json.loads(got[0].read_text())["rows"]]
    assert "serve/jet_tagger/bursty/offered" in names


def test_serve_snapshots_equal_the_references(tmp_path):
    report = {
        "jet_tagger": {"count": 3, "p50_s": 1e-5, "p95_s": 2e-5,
                       "p99_s": 3e-5, "mean_s": 1.5e-5,
                       "budget_violations": 1, "failures": 0,
                       "kind": "edge", "planned_latency_s": 9e-6,
                       "spans": {"infer": {"count": 3, "p50_s": 1e-5,
                                           "p95_s": float("inf")}}},
        "lm#1": {"count": 0, "p50_s": 0.0, "p95_s": 0.0, "mean_s": 0.0,
                 "budget_violations": 0, "kind": "lm",
                 "planned_latency_s": 2e-3,
                 "spans": {"decode_step": {"count": 4, "p50_s": 2e-3,
                                           "p95_s": 3e-3},
                           "queue": {"count": 0}}}}
    got = metrics.write_serve_snapshots(report, tmp_path / "port",
                                        meta={"m": 1})
    want = ref_metrics.write_serve_snapshots(report, tmp_path / "ref",
                                             meta={"m": 1})
    assert [p.name for p in got] == [p.name for p in want] == [
        "BENCH_serve_jet_tagger.json", "BENCH_serve_lm_1.json"]
    for p, q in zip(got, want):
        assert p.read_text() == q.read_text()


@pytest.mark.parametrize("name", ["jet_tagger", "vae#2", "../../etc", "",
                                  "..", "___", "a/b\\c d", "ünï"])
def test_safe_net_name_is_the_references(name):
    assert metrics._safe_net_name(name) == ref_metrics._safe_net_name(name)


# ---------------------------------------------------------------------------
# The replay's statuses
# ---------------------------------------------------------------------------

class _Router:
    """A router stub: each call takes the next scripted outcome, raising
    that package's refusal or failure for it."""

    def __init__(self, lib, script):
        self.lib, self.script = lib, list(script)
        self.pending = []

    def _outcome(self):
        what = self.script.pop(0)
        exc = {"shed": self.lib.TenantOverBudget,
               "queue_full": self.lib.TenantQueueFull,
               "fault": self.lib.TenantFaulted,
               "breaker": self.lib.TenantBreakerOpen}.get(what)
        if exc is not None:
            raise exc(what)
        return what

    def default_inputs(self):
        return {nid: 0 for nid, k in TENANTS.items() if k == "edge"}

    def tenant(self, nid):
        return types.SimpleNamespace(engine=types.SimpleNamespace(
            cfg=types.SimpleNamespace(vocab_size=40)))

    def infer(self, nid, x):
        self._outcome()

    def submit(self, nid, req):
        what = self._outcome()
        req.done = what in ("ok", "lm_fault")
        req.t_done = 0.0 if req.done else None
        req.error = "non_finite_output" if what == "lm_fault" else None
        return req

    def lm_pending(self):
        return False

    def step(self):
        return 0

    def run_until_drained(self, max_ticks=10_000):
        pass


def test_replay_records_refusals_and_faults_as_the_reference():
    """Every outcome a router can give, on both paths: the same status per
    request (the most specific refusal first), and no exception."""
    trace = [workload.TraceRequest(0.0, nid, kind, rid=i)
             for i, (nid, kind) in enumerate(
                 [("jet_tagger", "edge")] * 5
                 + [("recurrentgemma-2b", "lm")] * 7)]
    script = ["ok", "shed", "queue_full", "fault", "breaker",
              "ok", "shed", "queue_full", "fault", "breaker", "lm_fault",
              "stuck"]
    got = workload.replay(_Router(router_lib, script), trace)
    want = ref_wl.replay(_Router(ref_router_lib, script),
                         [ref_wl.TraceRequest(**r.to_dict()) for r in trace])
    assert [r.status for r in got.records] == \
        [r.status for r in want.records] == [
            "ok", "shed", "queue_full", "fault", "breaker", "ok", "shed",
            "queue_full", "fault", "breaker", "fault", "stuck"]
    summary = got.summary()
    for nid in ("jet_tagger", "recurrentgemma-2b"):
        for k in ("count", "ok", "shed", "queue_full", "fault", "breaker",
                  "stuck"):
            assert summary[nid][k] == want.summary()[nid][k]


# ---------------------------------------------------------------------------
# Deployment.replay on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dep():
    return Deployment.build(["jet_tagger", "tau_select"],
                            machine_model=None, device="cpu")


@pytest.mark.parametrize("name", sorted(ref_wl.SCENARIOS))
def test_deployment_replay_offers_the_generators_trace(dep, name, tmp_path):
    """Each scenario through the served fleet: the generator's offered
    count per tenant, every record ``ok`` or a refusal recorded as data,
    the SLO monitor attached (``slo=True``, the default) and fed, and one
    snapshot per tenant."""
    report = dep.replay(name, duration_s=0.05, seed=1, json_dir=tmp_path)
    want = ref_wl.make_scenario(name, {"jet_tagger": "edge",
                                       "tau_select": "edge"},
                                duration_s=0.05, seed=1)
    assert [r.rid for r in report.records] == [r.rid for r in want]
    for nid, s in report.summary().items():
        assert s["count"] == sum(1 for r in want if r.tenant == nid)
    assert {r.status for r in report.records} <= {
        "ok", "shed", "queue_full", "breaker", "fault"}
    assert report.scenario == name
    assert dep.slo is not None and dep.slo is dep.serve().slo
    assert sum(v["count"] for v in dep.slo.snapshot().values()) > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"BENCH_serve_jet_tagger__{name}.json",
        f"BENCH_serve_tau_select__{name}.json"]


def test_deployment_replay_arms_faults_after_the_warmup(dep):
    """A burst armed by ``replay(faults=)`` starts counting after the
    warmup: the breaker opens and recloses, the co-resident serves."""
    router = dep.serve(fresh=True)
    plan = faults.FaultPlan.burst("jet_tagger", after=4, count=6)
    report = dep.replay("steady", duration_s=0.1, seed=0, faults=plan)
    assert dep.serve() is router
    h = router.health()["tenants"]["jet_tagger"]
    assert h["failures"] > 0 and h["breaker_opens"] >= 1
    assert h["breaker_recloses"] >= h["breaker_opens"]
    assert h["state"] == "closed"
    statuses = [r.status for r in report.records if r.tenant == "jet_tagger"]
    assert statuses[:4] == ["ok"] * 4
    assert "fault" in statuses and "breaker" in statuses
    assert report.summary()["tau_select"]["ok"] == \
        report.summary()["tau_select"]["count"]
    router.arm_faults(None)


def test_serve_slo_argument(dep):
    """``slo=False`` serves without a monitor; a ready monitor is used as
    it is; ``defer_limit`` is memoized with the rest."""
    assert dep.serve(slo=False, fresh=True).slo is None and dep.slo is None
    mon = slo.SloMonitor.from_fleet(dep.fleet, min_samples=2)
    r = dep.serve(slo=mon)
    assert r.slo is mon and dep.slo is mon
    assert dep.serve(slo=mon) is r
    assert dep.serve(slo=mon, defer_limit=2) is not r
    assert dep.serve(slo=mon, defer_limit=2).defer_limit == 2
    assert "slo:" in dep.summary()
