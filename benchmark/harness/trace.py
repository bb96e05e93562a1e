"""The traced stretch and its reduction.

A ``--trace 1`` run profiles a fixed stretch of whole calls right after the
warm-up, the same stretch in every run, with ``torch.profiler`` (CPU and
CUDA activities). One untimed call wakes the profiler first; the stretch
itself runs inside the range ``bench.window`` and ends with a
``synchronize``.

The reduction reads the profiler's raw events: the spans (CPU ranges of the
benchmark's own names), the CUDA runtime calls on the host, and the device
activities (kernels, copies, sets). A device activity belongs to a span when
the runtime call that launched it (same correlation id) started inside the
span's range: device time is attributed by where the work was launched, never
by a kernel's name. Busy time is the union of the device intervals inside
the window; idle time is labelled, instant by instant, with the innermost
span the host was in.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

from benchmark.harness.stats import gaps, union_length

WINDOW = "bench.window"
TOP = 10


@dataclass
class Event:
    kind: str  # "range" (a CPU range: span or op), "runtime", "device"
    name: str
    start: int  # ns
    end: int
    corr: int = 0  # runtime and device: the CUDA correlation id
    linked: int = 0  # device: the correlation id of the CPU op it ran under
    ident: int = 0  # range: its own correlation id


@dataclass
class Reduced:
    window_s: float
    busy_s: float
    span_device_s: dict = field(default_factory=dict)
    span_calls: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def reduce_events(events, span_names) -> Reduced:
    """The window, busy time, per-span device time and calls, and the
    breakdown, from ``events`` (a list of ``Event``)."""
    span_names = set(span_names)
    win = [e for e in events if e.kind == "range" and e.name == WINDOW]
    if len(win) != 1:
        raise ValueError(f"expected one {WINDOW} range, found {len(win)}")
    lo, hi = win[0].start, win[0].end
    spans = [e for e in events if e.kind == "range" and e.name in span_names
             and lo <= e.start and e.end <= hi]
    launch = {e.corr: e.start for e in events if e.kind == "runtime" and e.corr}
    op_start = {e.ident: e.start for e in events if e.kind == "range" and e.ident}
    device = [e for e in events if e.kind == "device" and e.name not in span_names
              and e.name != WINDOW]
    intervals = [(e.start, e.end) for e in device]
    busy = union_length(intervals, lo, hi)

    by_span = defaultdict(list)
    for s in spans:
        by_span[s.name].append((s.start, s.end))
    starts = {}
    for name, ranges in by_span.items():
        ranges.sort()
        starts[name] = [a for a, _ in ranges]
    span_dev = defaultdict(int)
    per_op = defaultdict(int)
    for d in device:
        if d.end <= lo or d.start >= hi:
            continue
        per_op[d.name] += min(d.end, hi) - max(d.start, lo)
        t = launch.get(d.corr, op_start.get(d.linked))
        if t is None:
            continue
        for name, ranges in by_span.items():
            k = bisect.bisect_right(starts[name], t) - 1
            if k >= 0 and t <= ranges[k][1]:
                span_dev[name] += d.end - d.start

    labelled = defaultdict(int)
    for label, length in _idle_by_span(gaps(intervals, lo, hi), spans):
        labelled[label] += length
    top = lambda d: [[k, v / 1e9] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Reduced(
        window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
        span_device_s={k: v / 1e9 for k, v in span_dev.items()},
        span_calls={k: len(v) for k, v in by_span.items()},
        device_ops=top(per_op), idle_gaps=top(labelled))


def _idle_by_span(idle, spans):
    """(label, ns) for every piece of the idle stretches, labelled with the
    innermost span the host was in (spans nest, on one thread), or
    "outside spans"."""
    points = sorted({p for a, b in idle for p in (a, b)}
                    | {p for s in spans for p in (s.start, s.end)})
    opening = sorted(spans, key=lambda s: (s.start, -s.end))
    stack, k, g = [], 0, 0
    idle = sorted(idle)
    for t0, t1 in zip(points, points[1:]):
        while stack and stack[-1].end <= t0:
            stack.pop()
        while k < len(opening) and opening[k].start <= t0:
            if opening[k].end > t0:
                stack.append(opening[k])
            k += 1
        while g < len(idle) and idle[g][1] <= t0:
            g += 1
        if g < len(idle) and idle[g][0] <= t0 and t1 <= idle[g][1]:
            yield (stack[-1].name if stack else "outside spans"), t1 - t0


def kineto_events(prof) -> list:
    """The profiler's raw events as ``Event``s."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            out.append(Event("device", e.name(), start, end, corr=e.correlation_id(),
                             linked=e.linked_correlation_id()))
        elif e.name().startswith(("cuda", "cu")) and e.correlation_id():
            out.append(Event("runtime", e.name(), start, end, corr=e.correlation_id()))
        else:
            out.append(Event("range", e.name(), start, end, ident=e.correlation_id()))
    return out


def profile_stretch(first_call, stretch, span_names) -> Reduced:
    """``first_call()`` untimed, then ``stretch()`` inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        first_call()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with record_function(WINDOW):
            stretch()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return reduce_events(kineto_events(prof), span_names)
