"""What the port's copies of the state machine and the model checker call
from outside ``state/``, and nothing more.

The exceptions, ``iso_ms`` and ``Backoff`` behave as the control plane's
own.  The observation surface (trace and span binding, the journal, the
metrics registry, the span store, the hybrid logical clock) is an
observation-only stand-in: it records nothing, and a span or trace id is
a fresh string from a process counter.

The machine's asyncio task interleaving decides which states the model
checker reaches, so nothing here may add or remove an ``await`` that
suspends.  With nothing armed the control plane's failpoint and its HLC
merge return without suspending; ``fault_point`` and ``merge_remote``
are coroutines that return at once, as those do.
"""

from __future__ import annotations

import asyncio
import contextlib
import datetime as _dt
import itertools
import random
import time

# -- coordination errors (the control plane's coord/api.py) -----------------


class BadVersionError(Exception):
    """A CAS write named a version the store no longer holds."""


class NodeExistsError(Exception):
    """A create found the node already there."""


class ConnectionLossError(Exception):
    """The coordination session is gone (partitioned, expired)."""


# -- time and retry -----------------------------------------------------------


def iso_ms(when: _dt.datetime | float | None = None) -> str:
    """Millisecond-precision UTC ISO timestamp ('...T...%.3fZ')."""
    if when is None:
        dt = _dt.datetime.now(_dt.timezone.utc)
    elif isinstance(when, (int, float)):
        dt = _dt.datetime.fromtimestamp(when, _dt.timezone.utc)
    else:
        dt = when
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


class Backoff:
    """Exponential backoff with equal jitter: ``await sleep()`` before a
    retry, ``reset()`` on success.  *sleep_fn* lets the state machine
    route its sleeps through its swappable ``_sleep``."""

    def __init__(self, op: str, *, base: float = 0.5, cap: float = 10.0,
                 factor: float = 2.0, sleep_fn=None):
        if base <= 0 or cap < base or factor < 1.0:
            raise ValueError("need 0 < base <= cap and factor >= 1")
        self.op = op
        self.base, self.cap, self.factor = base, cap, factor
        self.attempts = 0
        self._sleep_fn = sleep_fn or asyncio.sleep

    def reset(self) -> None:
        self.attempts = 0

    async def sleep(self) -> float:
        self.attempts += 1
        raw = min(self.cap, self.base * self.factor ** (self.attempts - 1))
        d = random.uniform(raw / 2.0, raw)
        await self._sleep_fn(d)
        return d


# -- failpoints ------------------------------------------------------------------


async def fault_point(name: str) -> str:
    """The failpoint seam with nothing armed: proceed, without
    suspending."""
    return "ok"


# -- observation stand-ins ---------------------------------------------------------

_ids = itertools.count(1)


def new_trace_id() -> str:
    return "%016x" % next(_ids)


@contextlib.contextmanager
def bind_trace(trace_id: str | None):
    yield trace_id


@contextlib.contextmanager
def bind_parent(span_id: str | None):
    yield span_id


class _Span:
    def __init__(self):
        self.span_id = "%016x" % next(_ids)

    def end(self, **_attrs) -> None:
        pass


class _SpanStore:
    def start(self, _name: str, **_attrs) -> _Span:
        return _Span()


_SPANS = _SpanStore()


def get_span_store() -> _SpanStore:
    return _SPANS


@contextlib.contextmanager
def span(_name: str, **_attrs):
    """Yields a span with a fresh id; exceptions pass through."""
    yield _Span()


class _Journal:
    def record(self, _event: str, **_fields) -> None:
        pass


_JOURNAL = _Journal()


def get_journal() -> _Journal:
    return _JOURNAL


class _Metric:
    def inc(self, *_a, **_kw) -> None:
        pass

    def observe(self, *_a, **_kw) -> None:
        pass

    @contextlib.contextmanager
    def time(self):
        yield


class _Registry:
    def counter(self, *_a, **_kw) -> _Metric:
        return _Metric()

    def histogram(self, *_a, **_kw) -> _Metric:
        return _Metric()


_REGISTRY = _Registry()


def get_registry() -> _Registry:
    return _REGISTRY


def hlc_now() -> str:
    """A hybrid-clock stamp: a string, as the state object carries it."""
    return "%d.%d" % (time.time_ns() // 1_000_000, next(_ids))


async def merge_remote(stamp, *, source: str | None = None) -> str | None:
    """Fold a piggybacked stamp: nothing to fold here, and no
    suspension."""
    return None
