"""Traffic traces and the open-loop replay driver.

Port of the part of the JAX package's ``obs/workload.py`` that the CLI
drives: the trace record (:class:`TraceRequest`), the fixed-interval
:func:`smoke_trace`, and :func:`replay`, which submits a trace against a
wall-clock schedule through a live :class:`~repro_torch.serve.Router`.
Arrivals fire at their scheduled time whether or not earlier requests have
finished (open loop); LM batchers tick while the driver waits for the next
arrival; every request records its end-to-end latency and how late the
driver fired it.  The scenario generators and snapshots come with the
SLO work of the router.

Nothing here touches the card itself: the replay driver reaches engines
only through the router it is handed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable

from repro_torch.obs.trace import percentile

_KINDS = ("edge", "lm")


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


def _number(reqs: list[TraceRequest]) -> list[TraceRequest]:
    """Sort by arrival and number sequentially: rid order is arrival
    order."""
    reqs = sorted(reqs, key=lambda r: (r.arrival_s, r.tenant))
    return [dataclasses.replace(r, rid=i) for i, r in enumerate(reqs)]


def smoke_trace(tenants, *, edge_iters: int = 10, lm_requests: int = 3,
                edge_interval_s: float = 5e-4, lm_interval_s: float = 2e-3,
                prompt_tokens: int = 3,
                new_tokens: int = 4) -> list[TraceRequest]:
    """A fixed-interval trace: ``edge_iters`` evenly spaced inferences per
    edge tenant and ``lm_requests`` per LM tenant (``tenants`` maps a net id
    to its kind)."""
    reqs = []
    for nid, kind in sorted(dict(tenants).items()):
        n, dt = ((lm_requests, lm_interval_s) if kind == "lm"
                 else (edge_iters, edge_interval_s))
        for i in range(n):
            reqs.append(TraceRequest(
                arrival_s=i * dt, tenant=nid, kind=kind,
                prompt_tokens=prompt_tokens, new_tokens=new_tokens))
    return _number(reqs)


@dataclasses.dataclass
class RequestRecord:
    """One replayed request's outcome."""
    rid: int
    tenant: str
    kind: str
    arrival_s: float              # scheduled (trace) arrival
    lag_s: float                  # how late the driver fired it
    e2e_s: float | None           # end-to-end latency; None if not completed
    status: str                   # "ok" | "fault" | "stuck"
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
        """Per tenant: counts by status, end-to-end tail percentiles and
        scheduling-lag percentiles (every value finite; an empty window
        reads 0.0)."""
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
                "fault": sum(1 for r in recs if r.status == "fault"),
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
    measures scheduling, not language modelling."""
    import numpy as np
    n = max(1, tr.prompt_tokens)
    lo = 2 if vocab > 2 else 0
    span = max(1, min(13, vocab - lo))
    return np.array([lo + (tr.rid + i) % span for i in range(n)], np.int32)


def replay(router, requests: Iterable[TraceRequest], *,
           inputs: dict | None = None, speed: float = 1.0,
           max_drain_ticks: int = 10_000,
           idle_sleep_s: float = 2e-4) -> ReplayReport:
    """Replay a trace open-loop through a live router.

    Arrivals fire at ``arrival_s / speed`` on the wall clock; while waiting
    for the next one the driver ticks the LM batchers if they hold work,
    else sleeps in short slices.  After the last arrival the LM tenants are
    drained (at most ``max_drain_ticks``); a request still unfinished then
    is ``"stuck"``.  An edge request runs ``router.infer`` on
    ``inputs[tenant]`` (``router.default_inputs()`` when not given: warm the
    router first, or the first request pays the graph capture); an LM
    request is submitted as an ``engine.Request`` and its latency is submit
    to ``t_done``.  A failure the router reports (:class:`TenantFaulted`)
    or a request the batcher failed is recorded as ``"fault"``, not
    raised."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.router import TenantFaulted
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
        if tr.kind == "edge":
            t0 = time.perf_counter()
            try:
                router.infer(tr.tenant, inputs[tr.tenant])
            except TenantFaulted:
                records.append(RequestRecord(tr.rid, tr.tenant, tr.kind,
                                             tr.arrival_s, lag, None,
                                             "fault"))
                continue
            records.append(RequestRecord(
                tr.rid, tr.tenant, tr.kind, tr.arrival_s, lag,
                time.perf_counter() - t0, "ok"))
        else:
            eng = router.tenant(tr.tenant).engine
            req = Request(rid=tr.rid,
                          prompt=_lm_prompt(tr, eng.cfg.vocab_size),
                          max_new=max(1, tr.new_tokens))
            inflight.append((tr, lag, time.perf_counter(), req))
            router.submit(tr.tenant, req)
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
