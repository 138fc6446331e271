"""Reading a `torch.profiler` window: device busy time, kernel time by name,
and the idle gaps labelled by what the host was doing.

The profiler records the device's activity alone (and the CUDA runtime
calls that come with it), which costs the host little; recording every
host operation as well slowed the host by about 15% and raised the idle
share with it. The window's length is the host's clock around it, between two
device synchronisations, so every device operation falls inside it. Busy
time is the union of the device's operations (kernels, copies, sets); an
idle gap is a stretch between them, named after the innermost host event
the trace holds at its middle ("(host: python)" where it holds none, as
when the host runs Python between calls), or "(window edges)" before the
first operation and after the last.
"""
from __future__ import annotations

import bisect
import collections

WINDOW = "portbench.window"


def _is_device(e) -> bool:
    """A device operation: not the host's, and not an annotation's mirror
    on the device's timeline (which spans whatever ran under it)."""
    if getattr(e, "is_user_annotation", False) or e.name == WINDOW:
        return False
    return getattr(e.device_type, "name", str(e.device_type)) in ("CUDA",
                                                                 "PrivateUse1")


def read(prof, window_s: float) -> dict:
    """{window_s, busy_s, kernels: {name: seconds}, gaps: {label: seconds}}
    of a window of `window_s` seconds; raises if the trace shows no device
    time."""
    events = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if _is_device(e))
    if not dev:
        raise RuntimeError("the profiler recorded no device time")
    kernels = collections.Counter()
    for s, t, name in dev:
        kernels[name] += (t - s) * 1e-6
    busy, gaps = 0.0, []
    cur_s, cur_t = dev[0][0], dev[0][1]
    for s, t, _ in dev[1:]:
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    busy_s = busy * 1e-6
    if busy_s <= 0:
        raise RuntimeError("the profiler recorded no device time")
    label = _innermost([e for e in events if not _is_device(e)
                        and e.name != WINDOW])
    by_label = collections.Counter()
    for a, b in gaps:
        by_label[label((a + b) / 2)] += (b - a) * 1e-6
    edges = window_s - (dev[-1][1] - dev[0][0]) * 1e-6
    if edges > 0:
        by_label["(window edges)"] += edges
    return dict(window_s=window_s, busy_s=busy_s,
                kernels=dict(kernels), gaps=dict(by_label))


def _innermost(host):
    """A function of a time: the name of the innermost host event running
    then. The events' nesting becomes a piecewise-constant timeline."""
    evs = sorted(((e.time_range.start, -e.time_range.end, e.name)
                  for e in host))
    cuts, names, stack = [], [], []

    def emit(t):
        cuts.append(t)
        names.append(stack[-1][1] if stack else "(host: python)")

    for s, neg_end, name in evs:
        while stack and stack[-1][0] <= s:
            end, _ = stack.pop()
            emit(end)
        stack.append((-neg_end, name))
        emit(s)
    while stack:
        end, _ = stack.pop()
        emit(end)

    def label(t):
        i = bisect.bisect_right(cuts, t) - 1
        return names[i] if i >= 0 else "(host: python)"
    return label


def top(counter: dict, n: int = 10) -> list:
    """The n largest entries as [[name, seconds], ...]."""
    return [[k, v] for k, v in sorted(counter.items(),
                                      key=lambda kv: -kv[1])[:n]]
