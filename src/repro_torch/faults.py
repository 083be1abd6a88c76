"""Deterministic fault taxonomy and injection for the serving stack.

Port of the JAX package's ``faults.py``, whole.  Fleets fail partially:
one tenant's engine throws, a cached artifact reads corrupt, a model emits
NaN.  This module makes those failures injectable on purpose, so the
resilience machinery of :mod:`repro_torch.serve.resilience` can be tested.

A :class:`FaultPlan` is a small JSON-serializable schedule, optionally
drawn from ``random.Random(seed)``, so the same seed always gives the same
faults.  A :class:`FaultInjector` runs the schedule by counting the calls of
named hook sites threaded through the runtime (``Router``, ``EdgeEngine``,
``ContinuousBatcher``, ``PlanCache``, ``Deployment.build`` and the verify
stage) and answering "does a fault fire on THIS call?".  An unarmed runtime
(``injector is None``) pays one attribute check per site.

=================== =================== =====================================
kind                default site        effect at the hook
=================== =================== =====================================
engine_exception    engine.infer        raise :class:`InjectedFault`
latency_spike       engine.infer        sleep ``magnitude_s`` inside the call
non_finite_output   engine.infer        poison the output tensor with NaN
batcher_stall       batcher.tick        the batcher skips this tick entirely
replan_failure      replan              drift-watcher replan raises
cache_corruption    cache.read          cached plan artifact reads corrupt
=================== =================== =====================================

Pure stdlib, so the plan layer imports the resilience defaults without
touching the runtime.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import random

FAULT_KINDS = ("engine_exception", "latency_spike", "non_finite_output",
               "batcher_stall", "replan_failure", "cache_corruption")

HOOK_SITES = ("engine.infer", "batcher.tick", "batcher.decode", "replan",
              "cache.read", "build")

#: The hook site each fault kind targets when the spec doesn't name one.
DEFAULT_SITE = {
    "engine_exception": "engine.infer",
    "latency_spike": "engine.infer",
    "non_finite_output": "engine.infer",
    "batcher_stall": "batcher.tick",
    "replan_failure": "replan",
    "cache_corruption": "cache.read",
}

#: Per-tenant resilience knobs the fleet planner writes into
#: ``serve["resilience"]`` (and the Supervisor falls back to for plans
#: without the section).  ``breaker_k``: consecutive failures that open
#: the circuit;
#: ``breaker_cooldown``: refusals while open before a half-open probe is
#: admitted (count-based, like the router's shed probe, so tests and replays
#: are deterministic); ``retries``/``backoff_s``: bounded retry for transient
#: engine faults; ``deadline_factor``: per-request deadline as a multiple of
#: the plan's ``serve["slo"]["p95_s"]`` budget (the reference's deadline
#: audit; the port's plans carry no SLO yet, so it reads no deadline).
RESILIENCE_DEFAULTS = {
    "breaker_k": 3,
    "breaker_cooldown": 8,
    "retries": 1,
    "backoff_s": 0.0,
    "deadline_factor": 4.0,
}


class InjectedFault(RuntimeError):
    """A fault fired by a :class:`FaultInjector` (deliberate, for tests)."""


class NonFiniteOutput(RuntimeError):
    """An engine produced NaN/inf: the request fails instead of returning
    garbage."""


def fault_kind(exc: BaseException) -> str:
    """Short classification label for a caught fault, used in
    ``fault/<kind>`` span names and health counters."""
    if isinstance(exc, NonFiniteOutput):
        return "non_finite"
    if isinstance(exc, InjectedFault):
        return "injected"
    return "exception"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``count`` times at a hook site, starting
    on the ``after``-th invocation of that (site, tenant) hook.

    ``tenant=None`` matches any tenant at the site.  ``magnitude_s`` is
    the spike duration for ``latency_spike`` and ignored otherwise.
    """

    kind: str
    site: str = ""
    tenant: str | None = None
    after: int = 0
    count: int = 1
    magnitude_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if not self.site:
            object.__setattr__(self, "site", DEFAULT_SITE[self.kind])
        if self.site not in HOOK_SITES:
            raise ValueError(f"unknown hook site {self.site!r}; "
                             f"expected one of {HOOK_SITES}")
        if self.after < 0 or self.count < 1:
            raise ValueError(f"need after >= 0 and count >= 1, got "
                             f"after={self.after} count={self.count}")

    def matches(self, site: str, tenant: str | None, n: int) -> bool:
        """Does this spec fire on invocation ``n`` of (site, tenant)?"""
        return (self.site == site
                and (self.tenant is None or self.tenant == tenant)
                and self.after <= n < self.after + self.count)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(**{k: d[k] for k in
                      ("kind", "site", "tenant", "after", "count",
                       "magnitude_s") if k in d})


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A JSON-serializable fault schedule.

    Build one by hand from :class:`FaultSpec`, as a targeted
    :meth:`burst` (N consecutive engine faults on one tenant), or draw a
    randomized-but-reproducible schedule with
    :meth:`generate` — same seed, same faults, always.
    """

    faults: tuple = ()
    seed: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(
            f if isinstance(f, FaultSpec) else FaultSpec.from_dict(f)
            for f in self.faults))

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)

    def scheduled(self, tenant: str | None = None,
                  kind: str | None = None) -> int:
        """Total faults this plan can fire — a pure function of the plan
        (deterministic: safe to trend-gate as a model row)."""
        return sum(f.count for f in self.faults
                   if (tenant is None or f.tenant in (None, tenant))
                   and (kind is None or f.kind == kind))

    # -- construction -----------------------------------------------------
    @classmethod
    def burst(cls, tenant: str, *, kind: str = "engine_exception",
              after: int = 8, count: int = 6,
              magnitude_s: float = 0.0) -> "FaultPlan":
        """N consecutive faults of one kind on one tenant — enough to
        open its breaker, then stop so the half-open probe re-closes it."""
        return cls(faults=(FaultSpec(kind=kind, tenant=tenant, after=after,
                                     count=count, magnitude_s=magnitude_s),))

    @classmethod
    def generate(cls, tenants, *, seed: int = 0, n_faults: int = 6,
                 kinds=("engine_exception", "latency_spike",
                        "non_finite_output", "batcher_stall"),
                 window: tuple = (4, 64),
                 magnitude_s: float = 0.002) -> "FaultPlan":
        """Draw a reproducible random schedule over ``tenants``.

        Seeded as ``random.Random(f"{seed}:faults")``, as the reference
        seeds it, so schedules are stable across hosts, runs and
        packages.
        """
        rng = random.Random(f"{seed}:faults")
        tenants = list(tenants)
        faults = []
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            faults.append(FaultSpec(
                kind=kind, tenant=rng.choice(tenants),
                after=rng.randrange(window[0], window[1]),
                magnitude_s=magnitude_s if kind == "latency_spike" else 0.0))
        return cls(faults=tuple(faults), seed=seed)

    # -- (de)serialization ------------------------------------------------
    def to_dict(self) -> dict:
        return {"version": 1, "seed": self.seed,
                "faults": [f.to_dict() for f in self.faults]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(faults=tuple(FaultSpec.from_dict(f)
                                for f in d.get("faults", ())),
                   seed=d.get("seed"))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json() + "\n")
        return p

    @classmethod
    def load(cls, path) -> "FaultPlan":
        return cls.from_json(pathlib.Path(path).read_text())


class FaultInjector:
    """Executes a :class:`FaultPlan` against the runtime's hook sites.

    Each hook calls :meth:`fire(site, tenant)` once per event; the
    injector counts invocations per (site, tenant) and returns the
    matching :class:`FaultSpec` when the schedule says this call faults
    (else ``None``).  Every fired fault is appended to :attr:`log`, so a
    caller knows exactly what happened.
    """

    def __init__(self, plan: FaultPlan | None = None):
        self.plan = plan if plan is not None else FaultPlan()
        self.calls: dict = {}          # (site, tenant) -> invocation count
        self.log: list = []            # fired events, in order

    def fire(self, site: str, tenant: str | None = None):
        key = (site, tenant)
        n = self.calls.get(key, 0)
        self.calls[key] = n + 1
        for spec in self.plan.faults:
            if spec.matches(site, tenant, n):
                self.log.append({"kind": spec.kind, "site": site,
                                 "tenant": tenant, "call": n})
                return spec
        return None

    def fired(self, tenant: str | None = None,
              kind: str | None = None) -> int:
        """How many faults actually fired (optionally filtered)."""
        return sum(1 for e in self.log
                   if (tenant is None or e["tenant"] == tenant)
                   and (kind is None or e["kind"] == kind))
