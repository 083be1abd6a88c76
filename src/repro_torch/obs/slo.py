"""SLO monitor: per-tenant tail-latency budgets, burn rates, priorities.

Port of the JAX package's ``obs/slo.py``.  The router enforces a mean-style
budget (``TenantMetrics`` violation streaks and shedding); this module adds
the tail contract: an :class:`SloBudget` per tenant (p95/p99 ceilings from
the plan's serve section, and a priority class), and an
:class:`SloMonitor` that watches every completed request and answers three
questions for the scheduler and the reports:

* *is this tenant violating its p95/p99 SLO?* -- edge-triggered
  :class:`SloViolation` events (each also a zero-duration
  ``slo/violation`` audit span when a tracer is attached);
* *how fast is it burning error budget?* -- a short *fast* burn window
  that reacts within tens of requests and a long *slow* one that filters
  one-off spikes: burn rate 1.0 means violating exactly the allowed
  fraction, and ``burn_alert`` (default 2.0) on the fast window marks the
  tenant :meth:`SloMonitor.at_risk`;
* *who should yield?* -- :data:`PRIORITY_CLASSES` orders tenants
  (``critical`` < ``standard`` < ``batch``); :meth:`SloMonitor.pressure_rank`
  is the best rank among at-risk tenants, and the router defers admission
  for strictly lower-priority tenants while pressure holds (bounded by an
  aging limit, so deferral never starves a drain).

Host logic only: nothing here touches the card.  Each latency window is
also kept sorted as samples enter and leave, so the percentiles the router
reads on every edge request need no full sort; they are the nearest-rank
values :func:`~repro_torch.obs.trace.percentile` gives over the window.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math
import time
from typing import Iterable

from repro_torch.obs.trace import NULL_TRACER

# Lower rank = more important.  The names are the values plans/tenants use
# in their serve sections — keep them boring and stable.
PRIORITY_CLASSES = ("critical", "standard", "batch")


def priority_rank(name: str) -> int:
    """Numeric rank for a priority class (0 = most important)."""
    try:
        return PRIORITY_CLASSES.index(name)
    except ValueError:
        raise ValueError(f"unknown priority class {name!r}; choose from "
                         f"{PRIORITY_CLASSES}") from None


def _ranked(xs: list, q: float) -> float:
    """Nearest-rank percentile of an already sorted sample (the value
    :func:`~repro_torch.obs.trace.percentile` gives); 0.0 when empty."""
    if not xs:
        return 0.0
    if q <= 0:
        return xs[0]
    return xs[min(len(xs) - 1, int(math.ceil(q * len(xs))) - 1)]


def _finite_or_none(x):
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


@dataclasses.dataclass
class SloBudget:
    """One tenant's tail-latency contract: p95/p99 ceilings + priority."""
    tenant: str
    p95_s: float = math.inf
    p99_s: float = math.inf
    priority: str = "standard"

    def __post_init__(self):
        priority_rank(self.priority)          # validate early
        if self.p95_s <= 0 or self.p99_s <= 0:
            raise ValueError(f"SLO budgets must be > 0 "
                             f"(tenant {self.tenant!r}: p95={self.p95_s}, "
                             f"p99={self.p99_s})")

    @property
    def rank(self) -> int:
        return priority_rank(self.priority)

    @classmethod
    def from_plan(cls, tenant: str, plan,
                  latency_budget_s: float | None = None) -> "SloBudget":
        """Derive the contract from a plan's serve section.

        ``serve["slo"]`` (written by the fleet planner) wins; absent that —
        older cached plans, hand-built fleets — the mean-style
        ``latency_budget_s`` seeds p95 with p99 at 1.5x, so every tenant
        always has *some* tail contract."""
        serve = getattr(plan, "serve", None) or {}
        slo = serve.get("slo") or {}
        p95 = slo.get("p95_s", latency_budget_s)
        if p95 is None:
            p95 = math.inf
        p99 = slo.get("p99_s", 1.5 * p95 if math.isfinite(p95) else math.inf)
        priority = serve.get("priority")
        if priority is None:
            kind = getattr(plan, "kind", "edge")
            priority = "critical" if kind == "edge" else "standard"
        return cls(tenant=tenant, p95_s=p95, p99_s=p99, priority=priority)


@dataclasses.dataclass(frozen=True)
class SloViolation:
    """One edge-triggered violation event (entering the violating state)."""
    tenant: str
    slo: str                  # "p95" | "p99"
    measured_s: float
    budget_s: float
    count: int                # window samples when the event fired
    at_s: float               # perf_counter stamp


class SloMonitor:
    """Rolling per-tenant SLO evaluation over completed-request latencies.

    Feed it with :meth:`observe` (the router does, for every edge inference
    and every drained LM request); read :meth:`at_risk` /
    :meth:`pressure_rank` from the scheduler and :meth:`snapshot` /
    :attr:`violations` from the reports.  ``burn rate`` follows the SRE
    convention: (fraction of window samples over the p95 budget) divided by
    the 5% the p95 contract allows — 1.0 is "exactly at contract", and the
    fast window crossing ``burn_alert`` marks the tenant at risk.
    """

    #: Error budget of a p95 contract: 5% of requests may exceed it.
    P95_ERROR_BUDGET = 0.05

    def __init__(self, budgets: Iterable[SloBudget], *, window: int = 256,
                 fast_window: int = 32, slow_window: int = 128,
                 min_samples: int = 20, burn_alert: float = 2.0,
                 tracer=None):
        self.budgets: dict[str, SloBudget] = {}
        for b in budgets:
            if b.tenant in self.budgets:
                raise ValueError(f"duplicate SLO budget for {b.tenant!r}")
            self.budgets[b.tenant] = b
        self.window = window
        self.fast_window = fast_window
        self.slow_window = slow_window
        self.min_samples = min_samples
        self.burn_alert = burn_alert
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.reset()

    @classmethod
    def from_fleet(cls, fleet, *, tracer=None, **kw) -> "SloMonitor":
        """One budget per fleet tenant, from each plan's serve section."""
        budgets = [SloBudget.from_plan(tp.net_id, tp.plan,
                                       latency_budget_s=tp.latency_budget_s)
                   for tp in fleet.tenants]
        return cls(budgets, tracer=tracer, **kw)

    def reset(self):
        """Drop observations and events (e.g. after jit warmup); the
        budgets themselves are configuration and survive."""
        self._lat = {t: collections.deque(maxlen=self.window)
                     for t in self.budgets}
        self._sorted = {t: [] for t in self.budgets}   # _lat, in order
        # Burn windows hold booleans: "was this sample over the p95 budget".
        self._fast = {t: collections.deque(maxlen=self.fast_window)
                      for t in self.budgets}
        self._slow = {t: collections.deque(maxlen=self.slow_window)
                      for t in self.budgets}
        self._in_violation = {t: set() for t in self.budgets}
        self.violations: list[SloViolation] = []

    def set_budget(self, tenant: str, *, p95_s: float | None = None,
                   p99_s: float | None = None,
                   priority: str | None = None):
        """Tighten/relax one tenant's contract at runtime — or add a tenant
        the monitor was not built with (the CLI's ``--underbudget`` fault
        injection uses this)."""
        b = self.budgets.get(tenant) or SloBudget(tenant)
        self.budgets[tenant] = dataclasses.replace(
            b,
            p95_s=b.p95_s if p95_s is None else p95_s,
            p99_s=b.p99_s if p99_s is None else p99_s,
            priority=b.priority if priority is None else priority)
        self._ensure(tenant)

    def _ensure(self, tenant: str):
        """Window state for a tenant added after construction (budgets are
        a dict on purpose: fault injection and tests extend them live)."""
        if tenant in self._lat:         # the common case: nothing to build
            return
        self._lat[tenant] = collections.deque(maxlen=self.window)
        self._sorted[tenant] = []
        self._fast[tenant] = collections.deque(maxlen=self.fast_window)
        self._slow[tenant] = collections.deque(maxlen=self.slow_window)
        self._in_violation[tenant] = set()

    # -- feeding ----------------------------------------------------------
    def observe(self, tenant: str, latency_s: float):
        """One completed request.  Unknown tenants and non-finite samples
        are ignored (the metrics layer already counts poisoned timers)."""
        b = self.budgets.get(tenant)
        if b is None or not math.isfinite(latency_s):
            return
        self._ensure(tenant)
        lat, srt = self._lat[tenant], self._sorted[tenant]
        if len(lat) == lat.maxlen:       # the oldest sample leaves
            del srt[bisect.bisect_left(srt, lat[0])]
        lat.append(latency_s)
        bisect.insort(srt, latency_s)
        over = latency_s > b.p95_s
        self._fast[tenant].append(over)
        self._slow[tenant].append(over)
        self._check(tenant, b)

    def _check(self, tenant: str, b: SloBudget):
        lat = self._sorted[tenant]
        if len(lat) < self.min_samples:
            return
        for slo, q, budget in (("p95", 0.95, b.p95_s),
                               ("p99", 0.99, b.p99_s)):
            if not math.isfinite(budget):
                continue
            measured = _ranked(lat, q)
            state = self._in_violation[tenant]
            if measured > budget:
                if slo in state:        # still violating: no new event
                    continue
                state.add(slo)
                now = time.perf_counter()
                ev = SloViolation(tenant=tenant, slo=slo,
                                  measured_s=measured, budget_s=budget,
                                  count=len(lat), at_s=now)
                self.violations.append(ev)
                if self.tracer.enabled:
                    # Zero-duration audit span: the violation edge is an
                    # event, not an interval.
                    self.tracer.add("slo/violation", now, now,
                                    tenant=tenant, slo=slo,
                                    measured_us=round(measured * 1e6, 3),
                                    budget_us=round(budget * 1e6, 3))
            else:
                state.discard(slo)      # re-arm once back under budget

    # -- scheduler queries -------------------------------------------------
    def burn_rate(self, tenant: str, window: str = "fast") -> float:
        """Error-budget burn over the named window (0.0 with no signal)."""
        win = (self._fast if window == "fast" else self._slow).get(tenant)
        if not win:
            return 0.0
        return (sum(win) / len(win)) / self.P95_ERROR_BUDGET

    def at_risk(self, tenant: str) -> bool:
        """True while the tenant's fast burn window says the p95 contract
        is being actively burned (both windows must agree once the slow one
        has signal, the multiwindow rule that keeps one spike from flapping
        the scheduler)."""
        win = self._fast.get(tenant)
        if win is None or len(win) < min(self.fast_window, self.min_samples):
            return False
        if self.burn_rate(tenant, "fast") < self.burn_alert:
            return False
        slow = self._slow[tenant]
        if len(slow) >= self.slow_window:
            return self.burn_rate(tenant, "slow") >= 1.0
        return True

    def pressure_rank(self) -> int | None:
        """The best (lowest) priority rank among at-risk tenants — the bar
        the router's deferral policy compares lower priorities against.
        None when nobody is at risk."""
        ranks = [b.rank for t, b in self.budgets.items() if self.at_risk(t)]
        return min(ranks) if ranks else None

    # -- reporting ---------------------------------------------------------
    def violation_counts(self) -> dict[str, int]:
        out: dict[str, int] = {t: 0 for t in self.budgets}
        for ev in self.violations:
            out[ev.tenant] = out.get(ev.tenant, 0) + 1
        return out

    def snapshot(self) -> dict[str, dict]:
        """Per-tenant state for exporters: budgets, measured tails, burn
        rates, event counts.  Every value is finite or None (strict-JSON
        safe)."""
        counts = self.violation_counts()
        out = {}
        for tenant, b in self.budgets.items():
            self._ensure(tenant)
            lat = self._sorted[tenant]
            out[tenant] = {
                "priority": b.priority,
                "p95_budget_s": _finite_or_none(b.p95_s),
                "p99_budget_s": _finite_or_none(b.p99_s),
                "p95_s": _ranked(lat, 0.95),
                "p99_s": _ranked(lat, 0.99),
                "count": len(lat),
                "burn_fast": self.burn_rate(tenant, "fast"),
                "burn_slow": self.burn_rate(tenant, "slow"),
                "violations": counts.get(tenant, 0),
                "in_violation": bool(self._in_violation[tenant]),
                "at_risk": self.at_risk(tenant),
            }
        return out
