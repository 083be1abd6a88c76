"""Per-tenant serving metrics: a latency window, percentiles, budget
accounting and (LM tenants) slot occupancy, updated by the router on every
request and tick; and their export as ``BENCH_serve_<net>.json`` rows
(:func:`write_serve_snapshots`)."""

from __future__ import annotations

import collections
import hashlib
import json
import math
import pathlib
import re

from repro_torch.obs.trace import percentile


def _finite(x, default=None):
    """Finite floats pass through; NaN/inf become ``default`` (strict
    JSON)."""
    if isinstance(x, float) and not math.isfinite(x):
        return default
    return x


class TenantMetrics:
    """Latency, budget and occupancy counters for one tenant over a
    bounded window."""

    def __init__(self, net_id: str, *, latency_budget_s: float = math.inf,
                 window: int = 256):
        self.net_id = net_id
        self.latency_budget_s = latency_budget_s
        self.window = window
        self.reset()

    def reset(self):
        self.count = 0
        self.total_s = 0.0
        self.budget_violations = 0
        # Violations since the last request within budget: the router's
        # shedding reads it.
        self.consecutive_violations = 0
        self.invalid_observations = 0
        self.failures = 0
        self._occ_sum, self._occ_n = 0.0, 0
        self._latencies = collections.deque(maxlen=self.window)

    def observe_latency(self, dt_s: float) -> bool:
        """Record one request's latency; True when within budget.  A
        non-finite sample is counted apart and never enters the window."""
        if not math.isfinite(dt_s):
            self.invalid_observations += 1
            return False
        self.count += 1
        self.total_s += dt_s
        self._latencies.append(dt_s)
        within = dt_s <= self.latency_budget_s
        if within:
            self.consecutive_violations = 0
        else:
            self.budget_violations += 1
            self.consecutive_violations += 1
        return within

    def observe_failure(self):
        """Record one failed request (it has no latency)."""
        self.failures += 1

    def observe_occupancy(self, active: int, capacity: int):
        """Record one scheduling tick's slot occupancy."""
        self._occ_sum += active / capacity if capacity else 0.0
        self._occ_n += 1

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots busy across observed ticks."""
        return self._occ_sum / self._occ_n if self._occ_n else 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    @property
    def p50_s(self) -> float:
        if not self._latencies:
            return 0.0
        xs = sorted(self._latencies)
        return xs[len(xs) // 2]

    @property
    def p95_s(self) -> float:
        return percentile(self._latencies, 0.95)

    @property
    def p99_s(self) -> float:
        return percentile(self._latencies, 0.99)

    def snapshot(self) -> dict:
        return {
            "net_id": self.net_id,
            "count": self.count,
            "mean_s": self.mean_s,
            "p50_s": self.p50_s,
            "p95_s": self.p95_s,
            "p99_s": self.p99_s,
            "latency_budget_s": _finite(self.latency_budget_s),
            "budget_violations": self.budget_violations,
            "invalid_observations": self.invalid_observations,
            "failures": self.failures,
            "occupancy": self.occupancy,
        }


def _safe_net_name(net_id: str) -> str:
    """Filesystem-safe tenant name (duplicate nets carry a '#index').

    Every character outside ``[A-Za-z0-9._-]`` maps to ``_`` (this covers
    path separators on both platforms, so a hostile net id can never walk
    out of ``json_dir``).  A net id that sanitizes to nothing but filler —
    empty, all underscores, or all dots (``"."``/``".."`` would otherwise
    yield the directory entries) — falls back to a short content hash so
    the file still gets a unique, stable name."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", net_id)
    if not safe or set(safe) <= {".", "_", "-"}:
        digest = hashlib.sha256(net_id.encode()).hexdigest()[:8]
        return f"net_{digest}"
    return safe


def write_serve_snapshots(report: dict, json_dir, *,
                          meta: dict | None = None) -> list:
    """Export a router ``report()`` as per-tenant ``BENCH_serve_<net>.json``.

    One file per tenant, ``{"meta": ..., "rows": [...]}``, each row the
    reference's benchmark row shape (``name``/``us_per_call``/``derived``),
    so serving latency diffs across runs as a benchmark does.  Returns the
    written paths.

    Request-grain percentile rows are skipped for tenants with no completed
    requests (a 0.0 "latency" row would read as a regression-to-zero in the
    trend diff).  When the snapshot carries per-span-kind aggregates (the
    router's ``report()`` attaches ``engine.span_stats()``), each kind gets
    its own ``serve/<net>/<kind>/p50|p95`` rows so trend gating covers
    decode-step service time and queue wait separately from end-to-end
    request latency.  LM tenants additionally emit a
    ``serve/<net>/decode_step/planned`` model row: an LM plan's graph models
    one decode step, so ``plan.est_latency_s`` is the planned analogue of
    the measured decode-step row, not of request latency.
    """
    out_dir = pathlib.Path(json_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for nid, snap in report.items():
        derived = (f"src=measured;count={snap['count']};"
                   f"violations={snap['budget_violations']};"
                   f"failures={snap.get('failures', 0)};"
                   f"kind={snap.get('kind', '?')}")
        rows = []
        if snap["count"]:
            rows += [
                {"name": f"serve/{nid}/p50", "us_per_call":
                 round(snap["p50_s"] * 1e6, 3), "derived": derived},
                {"name": f"serve/{nid}/p95", "us_per_call":
                 round(snap["p95_s"] * 1e6, 3), "derived": derived},
                {"name": f"serve/{nid}/p99", "us_per_call":
                 round(snap.get("p99_s", snap["p95_s"]) * 1e6, 3),
                 "derived": derived},
                {"name": f"serve/{nid}/mean", "us_per_call":
                 round(snap["mean_s"] * 1e6, 3), "derived": derived},
            ]
        if snap.get("planned_latency_s"):
            rows.append({"name": f"serve/{nid}/planned", "us_per_call":
                         round(snap["planned_latency_s"] * 1e6, 3),
                         "derived": "src=model"})
        for kind, agg in sorted((snap.get("spans") or {}).items()):
            if not agg.get("count"):
                continue
            span_derived = (f"src=measured;count={agg['count']};"
                            f"span={kind}")
            for pct in ("p50", "p95"):
                v = agg.get(f"{pct}_s", 0.0)
                if not math.isfinite(v):
                    continue
                rows.append({"name": f"serve/{nid}/{kind}/{pct}",
                             "us_per_call": round(v * 1e6, 3),
                             "derived": span_derived})
        if snap.get("kind") == "lm" and snap.get("planned_latency_s"):
            rows.append({"name": f"serve/{nid}/decode_step/planned",
                         "us_per_call":
                         round(snap["planned_latency_s"] * 1e6, 3),
                         "derived": "src=model"})
        payload = {"meta": {"net_id": nid, **(meta or {})}, "rows": rows}
        p = out_dir / f"BENCH_serve_{_safe_net_name(nid)}.json"
        p.write_text(json.dumps(payload, indent=2, sort_keys=True,
                                allow_nan=False) + "\n")
        paths.append(p)
    return paths
