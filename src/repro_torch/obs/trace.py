"""Span/trace primitives: the measurement substrate under the serving stack.

A :class:`Span` is one named host-side interval on the ``perf_counter``
clock with an optional trace id (the request id) and free-form attributes.
A :class:`Tracer` is an append-only, bounded, thread-safe span sink.  Every
emit site guards on ``tracer.enabled``, and the shared :data:`NULL_TRACER`
default is permanently disabled, so tracing off costs one branch.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from typing import Any, Iterable


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    t0_s: float
    dur_s: float
    trace_id: int | str | None = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def t1_s(self) -> float:
        return self.t0_s + self.dur_s

    def to_dict(self) -> dict:
        return {"name": self.name, "t0_s": self.t0_s, "dur_s": self.dur_s,
                "trace_id": self.trace_id, "attrs": dict(self.attrs)}


class _SpanCtx:
    """Context manager recording one span on exit, exceptions included."""
    __slots__ = ("_tracer", "_name", "_trace", "_attrs", "_t0")

    def __init__(self, tracer, name, trace, attrs):
        self._tracer, self._name = tracer, name
        self._trace, self._attrs = trace, attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.add(self._name, self._t0, time.perf_counter(),
                         trace=self._trace, **self._attrs)
        return False


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_CTX = _NoopCtx()


class Tracer:
    """Bounded, thread-safe span sink; spans past ``maxlen`` are counted in
    :attr:`dropped` instead of kept."""

    def __init__(self, *, enabled: bool = True, maxlen: int = 100_000):
        self.enabled = enabled
        self.maxlen = maxlen
        self.dropped = 0
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._trace_ids = itertools.count(1)

    def span(self, name: str, *, trace=None, **attrs):
        """Context manager timing the enclosed block (a shared no-op when
        the tracer is disabled)."""
        if not self.enabled:
            return _NOOP_CTX
        return _SpanCtx(self, name, trace, attrs)

    def add(self, name: str, t0_s: float, t1_s: float, *, trace=None,
            **attrs) -> None:
        """Record an explicit interval."""
        if not self.enabled:
            return
        s = Span(name=name, t0_s=t0_s, dur_s=max(t1_s - t0_s, 0.0),
                 trace_id=trace, attrs=attrs)
        with self._lock:
            if len(self._spans) >= self.maxlen:
                self.dropped += 1
                return
            self._spans.append(s)

    def next_trace_id(self) -> int:
        """A fresh trace id of this tracer (for callers without a request
        id)."""
        return next(self._trace_ids)

    @property
    def spans(self) -> list[Span]:
        """A snapshot copy."""
        with self._lock:
            return list(self._spans)

    def by_trace(self, trace_id) -> list[Span]:
        return [s for s in self.spans if s.trace_id == trace_id]

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def __len__(self) -> int:
        return len(self._spans)

    def __bool__(self) -> bool:            # "if tracer:" is "tracing on"
        return self.enabled


class _NullTracer(Tracer):
    """The permanently disabled default (writes to ``enabled`` are
    ignored)."""

    def __init__(self):
        super().__init__(enabled=False, maxlen=0)

    @property
    def enabled(self) -> bool:
        return False

    @enabled.setter
    def enabled(self, _value) -> None:
        pass


NULL_TRACER = _NullTracer()


def percentile(xs: Iterable[float], q: float) -> float:
    """Nearest-rank percentile over a finite sample; 0.0 on empty input."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    if q <= 0:
        return xs[0]
    return xs[min(len(xs) - 1, int(math.ceil(q * len(xs))) - 1)]


def summarize(durs: Iterable[float]) -> dict[str, Any]:
    """count/mean/p50/p95/total over a duration sample (seconds)."""
    xs = sorted(durs)
    n = len(xs)
    total = sum(xs)
    return {
        "count": n,
        "total_s": total,
        "mean_s": total / n if n else 0.0,
        "p50_s": xs[n // 2] if n else 0.0,
        "p95_s": percentile(xs, 0.95),
    }
