"""Span tracing for the staged render pipeline.

A `Tracer` records a tree of host-side spans — named wall-clock intervals
with structured attributes — around the stage calls of
`RenderPlan.render_with_stats` / `render_batch_with_stats` and the serving
engine's dispatches. The active tracer is process-global (thread-safe,
with a thread-local span stack so concurrent serving threads each build
their own tree) and defaults to a `NoopTracer`, which makes
instrumentation free when disabled:

* a no-op span is a shared singleton whose __enter__/__exit__ do nothing;
* `NoopTracer.block` returns its argument untouched;
* attribute computation in instrumented code is guarded on
  `tracer.enabled`, so no extra reductions or device->host copies run.

Every render of the port is eager: there is no tracing compiler, so no
span ever observes abstract values. `Tracer.block` is
`torch.cuda.synchronize` on the devices of the CUDA tensors it is given
(a no-op on CPU tensors), the fence that makes a span's wall mean "this
stage's device work finished". The `traced` attribute the reference sets
on spans recorded while a compiler traces the program is therefore always
False here, and the reference's `is_traced` has no counterpart.

Usage:

    tracer = Tracer()
    with use_tracer(tracer):
        out, counters = plan.render_with_stats(scene, camera)
    for root in tracer.roots:
        ...                     # Span tree: render -> preprocess, ...

Export the collected spans with `repro_torch.obs.export` (JSONL / Chrome
trace-event JSON for Perfetto).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator, Optional

import torch


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in a nest of tuples, lists, dicts,
    NamedTuples and dataclasses."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            _cuda_devices(getattr(x, name), out)
    return out


class Span:
    """One named wall-clock interval with attributes and child spans."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "span_id",
                 "parent_id", "tid")

    def __init__(self, name: str, attrs: Optional[dict] = None, *,
                 span_id: int = 0, parent_id: Optional[int] = None,
                 tid: int = 0):
        self.name = name
        self.t0 = 0.0
        self.t1 = 0.0
        self.attrs: dict[str, Any] = dict(attrs) if attrs else {}
        self.children: list[Span] = []
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        """Attach attributes to an open (or closed) span."""
        self.attrs.update(attrs)
        return self

    def walk(self) -> Iterator["Span"]:
        """This span and all descendants, depth-first in start order."""
        yield self
        for child in self.children:
            yield from child.walk()

    def find(self, name: str) -> list["Span"]:
        """All descendant spans (including self) with the given name."""
        return [s for s in self.walk() if s.name == name]

    def __repr__(self):
        return (f"Span({self.name!r}, {1e3 * self.wall_s:.2f}ms, "
                f"attrs={self.attrs}, children={len(self.children)})")


class _NoopSpan:
    """Shared do-nothing span/context manager (the disabled-tracing path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP_SPAN = _NoopSpan()


class _OpenSpan:
    """Context manager that opens/closes one real span on the tracer."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        self._span.t0 = time.perf_counter()
        return self._span

    def __exit__(self, *exc):
        self._span.t1 = time.perf_counter()
        self._tracer._pop(self._span)
        return False


class Tracer:
    """Thread-safe span collector.

    Each thread nests spans on its own stack; completed *root* spans are
    appended to the shared `roots` list under a lock. `mark_first(key)` is
    the first-call detector: it returns True exactly once per hashable key
    (e.g. a `RenderPlan`) per tracer.
    """

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seen: set = set()
        self._next_id = 0
        self.roots: list[Span] = []

    # -- span lifecycle -----------------------------------------------------

    def span(self, name: str, attrs: Optional[dict] = None) -> _OpenSpan:
        """Open a span as a context manager; yields the `Span` so callers
        can `.set(...)` attributes while it is open."""
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        stack = self._stack()
        parent = stack[-1] if stack else None
        span = Span(name, attrs, span_id=span_id,
                    parent_id=parent.span_id if parent else None,
                    tid=threading.get_ident())
        return _OpenSpan(self, span)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, span: Span):
        stack = self._stack()
        if stack:
            span.parent_id = stack[-1].span_id
            stack[-1].children.append(span)
        stack.append(span)

    def _pop(self, span: Span):
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        if span.parent_id is None:
            with self._lock:
                self.roots.append(span)

    # -- helpers used by instrumented code ----------------------------------

    def block(self, x):
        """Wait for the device work behind `x`: `torch.cuda.synchronize`
        on each CUDA device its tensors live on, nothing for CPU tensors.
        Returns `x`."""
        for device in _cuda_devices(x, set()):
            torch.cuda.synchronize(device)
        return x

    def mark_first(self, key) -> bool:
        """True exactly once per hashable `key` for this tracer's lifetime
        (first-call-per-RenderPlan detection)."""
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            return True

    # -- results ------------------------------------------------------------

    def spans(self) -> list[Span]:
        """All completed spans, depth-first from each root."""
        with self._lock:
            roots = list(self.roots)
        return [s for r in roots for s in r.walk()]

    def clear(self):
        with self._lock:
            self.roots.clear()
            self._seen.clear()


class NoopTracer:
    """The default, disabled tracer: every operation is free and records
    nothing."""

    enabled = False
    roots: list = []

    def span(self, name: str, attrs: Optional[dict] = None) -> _NoopSpan:
        return _NOOP_SPAN

    def block(self, x):
        return x

    def mark_first(self, key) -> bool:
        return False

    def spans(self) -> list:
        return []

    def clear(self):
        pass


_NOOP_TRACER = NoopTracer()
_active: "Tracer | NoopTracer" = _NOOP_TRACER
_active_lock = threading.Lock()


def current() -> "Tracer | NoopTracer":
    """The process-wide active tracer (a NoopTracer unless one was
    installed with `set_tracer`/`use_tracer`)."""
    return _active


def set_tracer(tracer: "Tracer | NoopTracer | None") -> "Tracer | NoopTracer":
    """Install `tracer` (None restores the NoopTracer); returns the previous
    active tracer."""
    global _active
    with _active_lock:
        prev = _active
        _active = tracer if tracer is not None else _NOOP_TRACER
    return prev


@contextlib.contextmanager
def use_tracer(tracer: "Tracer | NoopTracer"):
    """Scoped tracer activation:

        with use_tracer(Tracer()) as t:
            plan.render_with_stats(scene, camera)
        roots = t.roots
    """
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
