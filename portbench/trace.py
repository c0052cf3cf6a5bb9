"""The benchmark's reduction of a torch.profiler chrome trace: device
activity, the device time of kernels launched inside host ranges, the
device's busy time, and the breakdown of device operations and idle gaps.

A kernel belongs to a host range when the runtime call that launched it
(matched by its correlation id) lies inside a range of that name on the
same host thread. Every device interval (kernels, copies, sets) counts once
in the busy time: their union, not their sum.
"""

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("cpu_op", "user_annotation")


class Trace:
    """Device intervals and host ranges of one chrome trace, times in
    seconds from the trace's own origin."""

    def __init__(self, events):
        self.device = []   # (start, end, name, correlation)
        self.launch = {}   # correlation -> (tid, time)
        self.ranges = []   # (start, end, name, tid)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = e.get("ts", 0.0) * 1e-6, e.get("dur", 0.0) * 1e-6
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), corr))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = (e.get("tid"), ts)
            elif cat in RANGE_CATS:
                self.ranges.append((ts, ts + dur, e.get("name", ""),
                                    e.get("tid")))
        self.device.sort()

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))


def union(intervals):
    """Merged (start, end) intervals of possibly overlapping ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(trace):
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in union((d[0], d[1]) for d in trace.device))


def device_seconds_under(trace, prefix):
    """Device seconds of the operations launched inside host ranges whose
    name starts with `prefix`."""
    by_tid = {}
    for s, e, name, tid in trace.ranges:
        if name.startswith(prefix):
            by_tid.setdefault(tid, []).append((s, e))
    merged = {tid: union(iv) for tid, iv in by_tid.items()}
    starts = {tid: [s for s, _ in iv] for tid, iv in merged.items()}
    total = 0.0
    for s, e, _, corr in trace.device:
        tid, t = trace.launch.get(corr, (None, None))
        iv = merged.get(tid)
        if iv is None:
            continue
        j = bisect.bisect_right(starts[tid], t) - 1
        if j >= 0 and t <= iv[j][1]:
            total += e - s
    return total


def _innermost(ranges):
    """(starts, segments) of the innermost range of one thread at each
    time: segments (start, end, name) that tile the covered time."""
    events = sorted(ranges, key=lambda r: (r[0], -r[1]))
    segs, stack, t = [], [], None
    for s, e, name, _ in events + [(float("inf"), float("inf"), "", None)]:
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            if t < top[1]:
                segs.append((t, top[1], top[2]))
            t = top[1]
        if stack and t is not None and t < s:
            segs.append((t, s, stack[-1][2]))
        if e != float("inf"):
            stack.append((s, e, name))
            t = s
    return [g[0] for g in segs], segs


def breakdown(trace, top=10):
    """{"device_ops": [[name, seconds]], "idle_gaps": [[host op, seconds]]}:
    the device operations that took most time, by name; and the device's
    idle time between its first and last operation, summed by the host
    operation running at each gap's middle: of the innermost operations
    running then on each host thread, the one that began last (the
    backward's run on their own thread)."""
    by_name = {}
    for s, e, name, _ in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    threads = {}
    for r in trace.ranges:
        threads.setdefault(r[3], []).append(r)
    timelines = [_innermost(rs) for rs in threads.values()]
    gaps = {}
    busy = union((d[0], d[1]) for d in trace.device)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        best = None
        for starts, segs in timelines:
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and mid < segs[j][1] and (best is None
                                                 or segs[j][0] > best[0]):
                best = segs[j]
        name = best[2] if best else "(no host op)"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in idle]}
