"""Exporters for the observability subsystem.

Three output shapes, one source of truth each, with the reference's record
schema:

* **JSONL span log** (`write_jsonl`): one JSON object per completed span —
  the canonical machine-readable trace artifact.
* **Chrome trace-event JSON** (`chrome_trace` / `write_chrome_trace`):
  loads directly in Perfetto (https://ui.perfetto.dev — "Open trace file")
  or chrome://tracing. Spans become complete ("X") events; attributes land
  in `args` and show in the Perfetto details pane.
* **Prometheus text exposition** (`prometheus_text` / `write_metrics`): the
  registry's scrape-format dump (`MetricsRegistry.expose` does the real
  work; this module only adds the file plumbing).

* **Device profile** (`torch_profiler_trace`): the counterpart of the
  reference's `jax_profiler_trace`, a `torch.profiler` session around a
  block that writes its Chrome trace under a log directory.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Iterable, Sequence, Union

from repro_torch.obs.trace import NoopTracer, Span, Tracer
from repro_torch.obs.metrics import MetricsRegistry

TracerOrSpans = Union[Tracer, NoopTracer, Sequence[Span]]


def _roots(source: TracerOrSpans) -> list[Span]:
    if isinstance(source, (Tracer, NoopTracer)):
        return list(source.roots)
    return list(source)


def _jsonable_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = repr(v)
    return out


def span_records(source: TracerOrSpans) -> list[dict]:
    """Flatten the span trees into per-span dicts (depth-first, start
    order). Times are `time.perf_counter` seconds; `dur_s` is the span
    wall."""
    records = []
    for root in _roots(source):
        for s in root.walk():
            records.append(dict(
                id=s.span_id,
                parent=s.parent_id,
                name=s.name,
                t0=s.t0,
                dur_s=s.wall_s,
                tid=s.tid,
                attrs=_jsonable_attrs(s.attrs),
            ))
    return records


def write_jsonl(source: TracerOrSpans, path) -> int:
    """Write one JSON object per span; returns the span count."""
    records = span_records(source)
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return len(records)


def read_jsonl(path) -> list[dict]:
    """Load a span log written by `write_jsonl`."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def chrome_trace(source: Union[TracerOrSpans, Iterable[dict]]) -> dict:
    """Chrome trace-event JSON (the `{"traceEvents": [...]}` envelope).

    Accepts a Tracer, a span list, or pre-flattened `span_records` dicts
    (what `read_jsonl` returns). Timestamps are rebased to the earliest
    span so traces start at t=0; units are microseconds per the format.
    """
    if not isinstance(source, (Tracer, NoopTracer)) and source and \
            isinstance(next(iter(source)), dict):
        records = list(source)
    else:
        records = span_records(source)
    t_base = min((r["t0"] for r in records), default=0.0)
    events = [
        dict(name=r["name"], ph="X", pid=1, tid=r["tid"],
             ts=round(1e6 * (r["t0"] - t_base), 3),
             dur=round(1e6 * r["dur_s"], 3),
             args=r["attrs"])
        for r in records
    ]
    return dict(traceEvents=events, displayTimeUnit="ms")


def write_chrome_trace(source: Union[TracerOrSpans, Iterable[dict]],
                       path) -> int:
    """Write a Perfetto-loadable Chrome trace; returns the event count."""
    trace = chrome_trace(source)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
    return len(trace["traceEvents"])


def prometheus_text(registry: MetricsRegistry) -> str:
    return registry.expose()


def write_metrics(registry: MetricsRegistry, path) -> None:
    with open(path, "w") as f:
        f.write(registry.expose())


@contextlib.contextmanager
def torch_profiler_trace(logdir, enabled: bool = True):
    """`torch.profiler.profile` around the block, the CPU activity and,
    whenever `torch.cuda.is_available()`, the CUDA activity, its Chrome
    trace written on exit to `logdir/trace_<pid>_<ns>.json` (the path is
    the yielded holder's `path`). `enabled=False` is a no-op (it yields
    None). Where the profiler cannot start, it warns and runs the block
    without a profile, as the reference's `jax_profiler_trace` does; it
    never drops the CUDA activity and profiles the CPU alone."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    holder = _TraceFile(os.path.join(
        str(logdir), f"trace_{os.getpid()}_{time.perf_counter_ns()}.json"))
    try:
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as exc:                      # pragma: no cover - env
        warnings.warn(f"torch.profiler unavailable ({exc!r}); continuing "
                      "without a device profile")
        yield holder
        return
    try:
        yield holder
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(str(logdir), exist_ok=True)
        prof.export_chrome_trace(holder.path)
        holder.written = True


class _TraceFile:
    """Where `torch_profiler_trace` writes its trace, and whether it did."""

    def __init__(self, path: str):
        self.path = path
        self.written = False
