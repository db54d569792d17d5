"""Spans around the port's layers, and the reduction of a profiler trace.

A traced run wraps the functions that the port looks up at call time
(module attributes such as `qrw_tpu_torch.sim.fleet.step_lane`) for the
first cycles of its window, with `common.Wrappers`. Each span
synchronizes the card at both ends and opens a
`torch.profiler.record_function` range, so every kernel launched inside
it also ran inside it, and kernels are assigned to spans by their device
timestamps. An untraced run opens no span.

`Trace` keeps aggregates only: spans' intervals, kernels' intervals and
names, and what each span's recorder kept of its calls.
"""

from __future__ import annotations

import bisect
import collections
import time

from qrwbench.common import Hook, Wrappers


def span(name, module, attr, record=None):
    """A span around a function that the port looks up at call time; with
    `record`, what it returns of each call is kept for the readers."""
    return Hook(name, module, attr, record, None if record else 0)


def union_seconds(intervals) -> float:
    """Length of the union of (start_ns, end_ns) intervals, in seconds."""
    total = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_s is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        total += cur_e - cur_s
    return total / 1e9


def idle_gaps(intervals, lo, hi):
    """Gaps (start_ns, end_ns) inside [lo, hi] that no interval covers."""
    gaps = []
    t = lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [g for g in gaps if g[1] > g[0]]


def _innermost(spans):
    """Breakpoints (times, labels) of the innermost open span, for
    properly nested (start, end, name) spans: from times[i] on, the host
    was inside labels[i]."""
    times, labels, stack = [], [], []

    def close_to(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            times.append(end)
            labels.append(stack[-1][2] if stack else "outside_spans")

    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_to(s)
        stack.append((s, e, n))
        times.append(s)
        labels.append(n)
    close_to(float("inf"))
    return times, labels


class Trace:
    """What the per-layer readers read: spans, kernels, counts."""

    def __init__(self, events, wall_s, cycles, ticks, records, constants):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.spans = collections.defaultdict(list)   # name -> [(s, e)]
        kern = []                                     # (s, e, name)
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                if e.is_user_annotation() or name.startswith("span:"):
                    continue
                kern.append((e.start_ns(), e.end_ns(), name))
            elif name.startswith("span:"):
                self.spans[name[5:]].append((e.start_ns(), e.end_ns()))
        kern.sort()
        self.kernels = kern
        self._starts = [k[0] for k in kern]
        self.wall_s = wall_s
        self.cycles = cycles
        self.ticks = ticks
        self.records = records
        self.constants = constants
        self.busy_s = union_seconds([(s, e) for s, e, _ in kern])
        self.n_kernels = len(kern)
        self.window = None        # the untraced cycles after the profile

    def span_s(self, name) -> float:
        return sum(e - s for s, e in self.spans.get(name, ())) / 1e9

    def kernels_in(self, name):
        """(start, end, kernel name) of the kernels inside the span."""
        out = []
        for s, e in self.spans.get(name, ()):
            i = bisect.bisect_left(self._starts, s)
            while i < len(self.kernels) and self.kernels[i][0] < e:
                if self.kernels[i][1] <= e:
                    out.append(self.kernels[i])
                i += 1
        return out

    def kernel_s(self, name) -> float:
        """Device seconds of the kernels launched inside the span."""
        return sum(e - s for s, e, _ in self.kernels_in(name)) / 1e9

    def breakdown(self, lo, hi, top=10):
        """The device operations that took most time, and the idle gaps
        summed by the innermost span the host was in."""
        by_op = collections.Counter()
        for s, e, n in self.kernels:
            by_op[n[:64]] += (e - s) / 1e9
        times, labels = _innermost([(s, e, n) for n, iv in self.spans.items()
                                    for s, e in iv])
        by_gap = collections.Counter()
        for gs, ge in idle_gaps([(s, e) for s, e, _ in self.kernels], lo, hi):
            i = bisect.bisect_right(times, (gs + ge) // 2) - 1
            by_gap[labels[i] if i >= 0 else "outside_spans"] += \
                (ge - gs) / 1e9
        return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
                "idle_gaps": [[n, v] for n, v in by_gap.most_common(top)]}


def profile_cycles(run_cycle, n, spans, sync, constants):
    """Run `n` cycles under the profiler with the spans installed.
    Returns (Trace, breakdown, per-cycle results)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wrapped = Wrappers(spans, sync)
    outs = []
    try:
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("span:window"):
                t0 = time.perf_counter()
                for _ in range(n):
                    outs.append(run_cycle())
                sync()
                wall = time.perf_counter() - t0
    finally:
        wrapped.remove()
    events = prof.profiler.kineto_results.events()
    ticks = sum(o.get("ticks", 0) for o in outs)
    records = {h.name: list(wrapped.calls[h.name]) for h in spans
               if h.record is not None}
    tr = Trace(events, wall, n, ticks, records, constants)
    win = tr.spans.pop("window", [(0, 0)])[0]
    tr.wall_s = (win[1] - win[0]) / 1e9 or wall
    return tr, tr.breakdown(win[0], win[1]), outs
