"""Per-tenant serving metrics: a latency window, percentiles, budget
accounting and (LM tenants) slot occupancy, updated by the router on every
request and tick."""

from __future__ import annotations

import collections
import math

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
