"""Traffic traces, scenario generators, and open-loop replay.

Port of the JAX package's ``obs/workload.py``:

* **Trace format** -- a :class:`TraceRequest` is one arrival (relative
  arrival time, tenant, kind, prompt/new token counts).  Traces serialize
  as JSONL (:func:`save_trace` / :func:`load_trace`): one strict-JSON
  object per line.
* **Scenario generators** -- deterministic arrival processes per tenant,
  seeded as ``random.Random(f"{seed}:{scenario}:{net_id}")``, so a seed
  gives the same trace as the reference's, to the float: ``steady``
  (homogeneous Poisson), ``bursty`` (a two-state Markov-modulated rate),
  ``diurnal`` (a sinusoidal rate, one "day" a trace), ``flash_crowd`` (a
  rate spike in the middle of the trace).  The non-homogeneous processes
  are sampled by thinning, so a scenario's offered count is a function of
  the seed and the knobs alone.
* **Open-loop replay** -- :func:`replay` submits a trace against a
  wall-clock schedule through a live :class:`~repro_torch.serve.Router`:
  arrivals fire at their time whether or not earlier requests finished, LM
  batchers tick while the replay waits for the next arrival, and every
  request records its end-to-end latency and how late it was fired.
* **Snapshots** -- :func:`write_replay_snapshots` writes per-tenant
  ``BENCH_serve_<net>__<scenario>.json`` tail rows, and
  :func:`format_replay` the table the CLI prints.

Nothing here touches the card itself: a replay reaches engines
only through the router it is handed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import random
import time
from typing import Callable, Iterable

from repro_torch.obs.trace import percentile

_KINDS = ("edge", "lm")


# ---------------------------------------------------------------------------
# Trace format
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival in a workload trace (times relative to trace start)."""
    arrival_s: float
    tenant: str
    kind: str = "edge"            # "edge" (sync infer) | "lm" (batched)
    prompt_tokens: int = 3        # LM prompt length (ignored for edge)
    new_tokens: int = 4           # LM generation budget (ignored for edge)
    rid: int = 0                  # request id; doubles as the trace id

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if self.arrival_s < 0:
            raise ValueError(f"arrival_s must be >= 0, got {self.arrival_s}")

    def to_dict(self) -> dict:
        return {"arrival_s": self.arrival_s, "tenant": self.tenant,
                "kind": self.kind, "prompt_tokens": self.prompt_tokens,
                "new_tokens": self.new_tokens, "rid": self.rid}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRequest":
        return cls(arrival_s=float(d["arrival_s"]), tenant=str(d["tenant"]),
                   kind=d.get("kind", "edge"),
                   prompt_tokens=int(d.get("prompt_tokens", 3)),
                   new_tokens=int(d.get("new_tokens", 4)),
                   rid=int(d.get("rid", 0)))


def save_trace(requests: Iterable[TraceRequest], path) -> pathlib.Path:
    """Write a trace as JSONL (one strict-JSON object per line)."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    lines = [json.dumps(r.to_dict(), sort_keys=True, allow_nan=False)
             for r in requests]
    p.write_text("\n".join(lines) + ("\n" if lines else ""))
    return p


def load_trace(path) -> list[TraceRequest]:
    """Read a JSONL trace back; blank lines are skipped."""
    out = []
    for lineno, line in enumerate(
            pathlib.Path(path).read_text().splitlines(), 1):
        if not line.strip():
            continue
        try:
            out.append(TraceRequest.from_dict(json.loads(line)))
        except (KeyError, ValueError) as e:
            raise ValueError(f"malformed trace line {lineno}: {e}") from e
    return out


# ---------------------------------------------------------------------------
# Scenario generators
# ---------------------------------------------------------------------------

def _thin(rng: random.Random, rate_fn: Callable[[float], float],
          rate_max: float, duration_s: float) -> list[float]:
    """Non-homogeneous Poisson arrivals by thinning: draw a homogeneous
    process at ``rate_max``, keep each point with prob rate(t)/rate_max."""
    out, t = [], 0.0
    while True:
        t += rng.expovariate(rate_max)
        if t >= duration_s:
            return out
        if rng.random() * rate_max <= rate_fn(t):
            out.append(t)


def _number(reqs: list[TraceRequest]) -> list[TraceRequest]:
    """Merge-sort by arrival and assign sequential rids — rid order IS
    arrival order, so replay logs read chronologically."""
    reqs = sorted(reqs, key=lambda r: (r.arrival_s, r.tenant))
    return [dataclasses.replace(r, rid=i) for i, r in enumerate(reqs)]


def _per_tenant(name: str, tenants, duration_s: float, rate_hz: float,
                lm_rate_hz: float, seed: int, prompt_tokens: int,
                new_tokens: int,
                shape: Callable[[random.Random, float],
                                tuple[Callable[[float], float], float]]
                ) -> list[TraceRequest]:
    """Shared generator scaffolding: per-tenant seeded rng + thinning.
    ``shape(rng, base_rate) -> (rate_fn, rate_max)`` is the scenario."""
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    reqs = []
    for nid, kind in sorted(dict(tenants).items()):
        if kind not in _KINDS:
            raise ValueError(f"tenant {nid!r}: kind must be one of "
                             f"{_KINDS}, got {kind!r}")
        base = lm_rate_hz if kind == "lm" else rate_hz
        if base <= 0:
            continue
        rng = random.Random(f"{seed}:{name}:{nid}")
        rate_fn, rate_max = shape(rng, base)
        for t in _thin(rng, rate_fn, rate_max, duration_s):
            reqs.append(TraceRequest(
                arrival_s=t, tenant=nid, kind=kind,
                prompt_tokens=prompt_tokens, new_tokens=new_tokens))
    return _number(reqs)


def steady(tenants, *, duration_s: float = 0.25, rate_hz: float = 200.0,
           lm_rate_hz: float = 16.0, seed: int = 0, prompt_tokens: int = 3,
           new_tokens: int = 4) -> list[TraceRequest]:
    """Homogeneous Poisson arrivals per tenant (the null scenario)."""
    def shape(rng, base):
        return (lambda t: base), base
    return _per_tenant("steady", tenants, duration_s, rate_hz, lm_rate_hz,
                       seed, prompt_tokens, new_tokens, shape)


def bursty(tenants, *, duration_s: float = 0.25, rate_hz: float = 200.0,
           lm_rate_hz: float = 16.0, seed: int = 0, prompt_tokens: int = 3,
           new_tokens: int = 4, burst_factor: float = 6.0,
           dwell_s: float = 0.03) -> list[TraceRequest]:
    """Two-state MMPP: the rate alternates between ``base`` and
    ``burst_factor * base`` with exponential dwell times (mean
    ``dwell_s``), the standard Markov-modulated burst model."""
    def shape(rng, base):
        segs, t, hi = [], 0.0, False
        while t < duration_s:
            d = rng.expovariate(1.0 / dwell_s)
            segs.append((t, t + d, base * burst_factor if hi else base))
            t += d
            hi = not hi

        def rate(tq: float) -> float:
            for a, b, r in segs:
                if a <= tq < b:
                    return r
            return base
        return rate, base * burst_factor
    return _per_tenant("bursty", tenants, duration_s, rate_hz, lm_rate_hz,
                       seed, prompt_tokens, new_tokens, shape)


def diurnal(tenants, *, duration_s: float = 0.25, rate_hz: float = 200.0,
            lm_rate_hz: float = 16.0, seed: int = 0, prompt_tokens: int = 3,
            new_tokens: int = 4, depth: float = 0.8) -> list[TraceRequest]:
    """Sinusoidally modulated rate — one "day" compressed into the trace:
    rate(t) = base * (1 + depth * sin(2*pi*t / duration))."""
    if not 0.0 <= depth <= 1.0:
        raise ValueError(f"depth must be in [0, 1], got {depth}")

    def shape(rng, base):
        def rate(t: float) -> float:
            return base * (1.0 + depth * math.sin(
                2.0 * math.pi * t / duration_s))
        return rate, base * (1.0 + depth)
    return _per_tenant("diurnal", tenants, duration_s, rate_hz, lm_rate_hz,
                       seed, prompt_tokens, new_tokens, shape)


def flash_crowd(tenants, *, duration_s: float = 0.25,
                rate_hz: float = 200.0, lm_rate_hz: float = 16.0,
                seed: int = 0, prompt_tokens: int = 3, new_tokens: int = 4,
                spike_factor: float = 8.0, spike_start: float = 0.4,
                spike_frac: float = 0.2) -> list[TraceRequest]:
    """Baseline Poisson with a ``spike_factor``x rate spike over
    ``[spike_start, spike_start + spike_frac] * duration`` — the triggered
    burst an extreme-edge deployment must absorb without blowing p99."""
    t_lo = spike_start * duration_s
    t_hi = (spike_start + spike_frac) * duration_s

    def shape(rng, base):
        def rate(t: float) -> float:
            return base * spike_factor if t_lo <= t < t_hi else base
        return rate, base * spike_factor
    return _per_tenant("flash_crowd", tenants, duration_s, rate_hz,
                       lm_rate_hz, seed, prompt_tokens, new_tokens, shape)


SCENARIOS: dict[str, Callable] = {
    "steady": steady,
    "bursty": bursty,
    "diurnal": diurnal,
    "flash_crowd": flash_crowd,
}


def make_scenario(name: str, tenants, **kw) -> list[TraceRequest]:
    """Generate a named scenario's trace for a tenant map
    (``{net_id: kind}``)."""
    try:
        gen = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; choose from "
                         f"{sorted(SCENARIOS)}") from None
    return gen(tenants, **kw)


def smoke_trace(tenants, *, edge_iters: int = 10, lm_requests: int = 3,
                edge_interval_s: float = 5e-4, lm_interval_s: float = 2e-3,
                prompt_tokens: int = 3,
                new_tokens: int = 4) -> list[TraceRequest]:
    """The CLI's fixed-interval smoke trace: ``edge_iters`` evenly-spaced
    inferences per edge tenant and ``lm_requests`` per LM tenant — the
    deterministic replacement for the old hand-rolled submit/drain loop."""
    reqs = []
    for nid, kind in sorted(dict(tenants).items()):
        n, dt = ((lm_requests, lm_interval_s) if kind == "lm"
                 else (edge_iters, edge_interval_s))
        for i in range(n):
            reqs.append(TraceRequest(
                arrival_s=i * dt, tenant=nid, kind=kind,
                prompt_tokens=prompt_tokens, new_tokens=new_tokens))
    return _number(reqs)


# ---------------------------------------------------------------------------
# Open-loop replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestRecord:
    """One replayed request's outcome."""
    rid: int
    tenant: str
    kind: str
    arrival_s: float              # scheduled (trace) arrival
    lag_s: float                  # how late it was fired
    e2e_s: float | None           # end-to-end latency; None if not completed
    status: str                   # "ok" | "shed" | "queue_full" | "fault"
                                  # | "breaker" | "stuck"
    tokens: list | None = None    # an LM request's generated tokens


@dataclasses.dataclass
class ReplayReport:
    """All records from one replay, plus per-tenant tail summaries."""
    records: list[RequestRecord]
    wall_s: float
    speed: float = 1.0
    scenario: str = ""

    def tenants(self) -> list[str]:
        return sorted({r.tenant for r in self.records})

    def summary(self) -> dict[str, dict]:
        """Per-tenant: counts by status, e2e tail percentiles, scheduling
        lag percentiles.  Every value finite (empty windows read 0.0)."""
        out = {}
        for nid in self.tenants():
            recs = [r for r in self.records if r.tenant == nid]
            ok = [r.e2e_s for r in recs
                  if r.status == "ok" and r.e2e_s is not None]
            lags = [r.lag_s for r in recs]
            out[nid] = {
                "kind": recs[0].kind,
                "count": len(recs),
                "ok": len(ok),
                "shed": sum(1 for r in recs if r.status == "shed"),
                "queue_full": sum(1 for r in recs
                                  if r.status == "queue_full"),
                "fault": sum(1 for r in recs if r.status == "fault"),
                "breaker": sum(1 for r in recs if r.status == "breaker"),
                "stuck": sum(1 for r in recs if r.status == "stuck"),
                "p50_s": percentile(ok, 0.50),
                "p95_s": percentile(ok, 0.95),
                "p99_s": percentile(ok, 0.99),
                "max_s": max(ok) if ok else 0.0,
                "lag_p50_s": percentile(lags, 0.50),
                "lag_p95_s": percentile(lags, 0.95),
                "lag_max_s": max(lags) if lags else 0.0,
            }
        return out


def _lm_prompt(tr: TraceRequest, vocab: int):
    """Deterministic prompt tokens (ids in [2, 2+13) mod vocab): replay
    measures scheduling, not language modeling, so cheap and reproducible
    beats random."""
    import numpy as np
    n = max(1, tr.prompt_tokens)
    lo = 2 if vocab > 2 else 0
    span = max(1, min(13, vocab - lo))
    return np.array([lo + (tr.rid + i) % span for i in range(n)], np.int32)


def _refusal_status(exc) -> str:
    """The record status of a refusal or failure the router raised: the
    most specific first, since the serve exceptions form a hierarchy under
    ``TenantOverBudget``."""
    from repro_torch.serve.router import (TenantBreakerOpen, TenantFaulted,
                                          TenantQueueFull)
    for cls, status in ((TenantBreakerOpen, "breaker"),
                        (TenantQueueFull, "queue_full"),
                        (TenantFaulted, "fault")):
        if isinstance(exc, cls):
            return status
    return "shed"


def replay(router, requests: Iterable[TraceRequest], *,
           inputs: dict | None = None, speed: float = 1.0,
           max_drain_ticks: int = 10_000,
           idle_sleep_s: float = 2e-4) -> ReplayReport:
    """Replay a trace open-loop through a live router.

    Arrivals fire at ``arrival_s / speed`` on the wall clock regardless of
    whether earlier requests completed (``speed > 1`` time-compresses a
    trace).  While waiting for the next arrival the replay ticks the LM
    batchers if they hold work, else sleeps in short slices: an idle
    replay must not spin.  After the last arrival the LM tenants are
    drained (at most ``max_drain_ticks``); a request still unfinished then
    is ``"stuck"``.

    An edge request runs ``router.infer`` on ``inputs[tenant]``
    (``router.default_inputs()`` when not given: warm the router first, or
    the first request pays the graph capture); an LM request is submitted
    as an ``engine.Request`` and its latency is submit to ``t_done``.
    Refusals and failures are recorded, not raised: under open loop,
    back-pressure is data.  A shed tenant records ``"shed"``, a full queue
    ``"queue_full"``, an open breaker ``"breaker"``, a request the engine
    failed ``"fault"``."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.router import TenantOverBudget
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    requests = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    if inputs is None and any(r.kind == "edge" for r in requests):
        inputs = router.default_inputs()
    records: list[RequestRecord] = []
    inflight: list[tuple] = []
    start = time.perf_counter()
    for tr in requests:
        target = tr.arrival_s / speed
        while True:
            now = time.perf_counter() - start
            if now >= target:
                break
            if router.lm_pending():
                router.step()
            else:
                time.sleep(min(target - now, idle_sleep_s))
        lag = (time.perf_counter() - start) - target
        t0 = time.perf_counter()
        try:
            if tr.kind == "edge":
                router.infer(tr.tenant, inputs[tr.tenant])
            else:
                vocab = router.tenant(tr.tenant).engine.cfg.vocab_size
                req = Request(rid=tr.rid, prompt=_lm_prompt(tr, vocab),
                              max_new=max(1, tr.new_tokens))
                router.submit(tr.tenant, req)
        except TenantOverBudget as exc:
            records.append(RequestRecord(tr.rid, tr.tenant, tr.kind,
                                         tr.arrival_s, lag, None,
                                         _refusal_status(exc)))
            continue
        if tr.kind == "edge":
            records.append(RequestRecord(
                tr.rid, tr.tenant, tr.kind, tr.arrival_s, lag,
                time.perf_counter() - t0, "ok"))
        else:
            inflight.append((tr, lag, t0, req))
    router.run_until_drained(max_ticks=max_drain_ticks)
    for tr, lag, t0, req in inflight:
        if req.done and req.error:
            status, e2e = "fault", None
        elif req.done and req.t_done is not None:
            status, e2e = "ok", req.t_done - t0
        else:
            status, e2e = "stuck", None
        records.append(RequestRecord(tr.rid, tr.tenant, tr.kind,
                                     tr.arrival_s, lag, e2e, status,
                                     tokens=list(req.out)))
    records.sort(key=lambda r: r.rid)
    return ReplayReport(records=records,
                        wall_s=time.perf_counter() - start, speed=speed)


# ---------------------------------------------------------------------------
# Snapshots + human-readable report
# ---------------------------------------------------------------------------

def write_replay_snapshots(report: ReplayReport, json_dir, *,
                           scenario: str | None = None, slo=None,
                           meta: dict | None = None) -> list[pathlib.Path]:
    """Per-tenant ``BENCH_serve_<net>__<scenario>.json`` tail snapshots.

    Measured rows (``src=measured``):
    ``serve/<net>/<scenario>/{p50,p95,p99,max}`` end-to-end latency and
    ``.../lag/{p50,p95}`` scheduling lag; ``derived`` carries the
    shed/queue_full/stuck counters and the tenant's SLO violation count.
    Model rows (``src=model``, deterministic): ``.../offered`` (the seeded
    generator's arrival count, a function of the seed and the knobs) and
    ``.../slo_p95_budget`` (the plan's budget, exact under
    ``--machine-model stock``)."""
    from repro_torch.serve.metrics import _safe_net_name
    scenario = scenario or report.scenario or "replay"
    out_dir = pathlib.Path(json_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    slo_snap = slo.snapshot() if slo is not None else {}
    paths = []
    for nid, s in report.summary().items():
        prefix = f"serve/{nid}/{scenario}"
        violations = slo_snap.get(nid, {}).get("violations", 0)
        derived = (f"src=measured;scenario={scenario};count={s['count']};"
                   f"ok={s['ok']};shed={s['shed']};"
                   f"queue_full={s['queue_full']};"
                   f"fault={s.get('fault', 0)};"
                   f"breaker={s.get('breaker', 0)};stuck={s['stuck']};"
                   f"violations={violations};kind={s['kind']}")
        rows = []
        if s["ok"]:
            rows += [{"name": f"{prefix}/{pct}",
                      "us_per_call": round(s[f"{pct}_s"] * 1e6, 3),
                      "derived": derived}
                     for pct in ("p50", "p95", "p99", "max")]
        if s["count"]:
            rows += [{"name": f"{prefix}/lag/{pct}",
                      "us_per_call": round(s[f"lag_{pct}_s"] * 1e6, 3),
                      "derived": derived}
                     for pct in ("p50", "p95")]
        rows.append({"name": f"{prefix}/offered",
                     "us_per_call": float(s["count"]),
                     "derived": f"src=model;scenario={scenario};"
                                f"unit=requests"})
        budget = slo_snap.get(nid, {}).get("p95_budget_s")
        if budget is not None:
            rows.append({"name": f"{prefix}/slo_p95_budget",
                         "us_per_call": round(budget * 1e6, 3),
                         "derived": f"src=model;scenario={scenario}"})
        payload = {"meta": {"net_id": nid, "scenario": scenario,
                            "speed": report.speed, **(meta or {})},
                   "rows": rows}
        p = out_dir / (f"BENCH_serve_{_safe_net_name(nid)}__"
                       f"{_safe_net_name(scenario)}.json")
        p.write_text(json.dumps(payload, indent=2, sort_keys=True,
                                allow_nan=False) + "\n")
        paths.append(p)
    return paths


def format_replay(report: ReplayReport, *, slo=None) -> str:
    """Human-readable per-tenant tail + scheduling-lag table, with SLO
    verdict lines when a monitor is given (the word ``VIOLATION`` marks a
    flagged tenant)."""
    lines = [f"replay: {len(report.records)} requests in "
             f"{report.wall_s * 1e3:.1f}ms wall"
             + (f" (speed={report.speed:g}x)" if report.speed != 1.0
                else "")]
    hdr = (f"  {'tenant':<14}{'kind':<5}{'n':>5}{'ok':>5}{'shed':>5}"
           f"{'full':>5}{'flt':>5}{'brk':>5}  "
           f"{'p50':>9}{'p95':>9}{'p99':>9}{'max':>9}")
    lines.append(hdr)
    summary = report.summary()
    for nid, s in summary.items():
        lines.append(
            f"  {nid:<14}{s['kind']:<5}{s['count']:>5}{s['ok']:>5}"
            f"{s['shed']:>5}{s['queue_full']:>5}"
            f"{s.get('fault', 0):>5}{s.get('breaker', 0):>5}  "
            f"{s['p50_s'] * 1e6:>7.1f}us{s['p95_s'] * 1e6:>7.1f}us"
            f"{s['p99_s'] * 1e6:>7.1f}us{s['max_s'] * 1e6:>7.1f}us")
    lines.append("scheduling lag (how late arrivals fired — open-loop "
                 "measurement error):")
    for nid, s in summary.items():
        lines.append(f"  {nid:<14} lag_p50={s['lag_p50_s'] * 1e6:8.1f}us "
                     f"lag_p95={s['lag_p95_s'] * 1e6:8.1f}us "
                     f"lag_max={s['lag_max_s'] * 1e6:8.1f}us")
    if slo is not None:
        lines.append("slo:")
        for nid, st in sorted(slo.snapshot().items()):
            budget = st["p95_budget_s"]
            budget_txt = (f"{budget * 1e6:.1f}us" if budget is not None
                          else "none")
            verdict = ""
            if st["violations"] or st["in_violation"]:
                verdict = (f"  VIOLATION x{st['violations']}"
                           f"{' (active)' if st['in_violation'] else ''}")
            lines.append(
                f"  {nid:<14} prio={st['priority']:<9} "
                f"p95={st['p95_s'] * 1e6:8.1f}us vs budget {budget_txt:<10} "
                f"burn fast={st['burn_fast']:.2f} "
                f"slow={st['burn_slow']:.2f}{verdict}")
    return "\n".join(lines)
