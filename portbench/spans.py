"""The benchmark's reading of the program's own spans in a traced window:
the host ranges `foodrec::<layer>` that foodrec_tpu_torch opens at its layer
boundaries while a profiler records (foodrec_tpu_torch/utils/trace.py).

A span is selected by prefix, as trace.device_seconds_under selects ranges;
the program keeps no span name a prefix of another. Each reading is None
where the trace holds no such span (a program without the spans) or no
device operation (a run without a card), never 0.
"""

import bisect

from portbench import trace

PREFIX = "foodrec::"


def _inside(tr, prefix):
    """The union of the host ranges whose name starts with `prefix`, on
    every thread; None where there is none or the device ran nothing."""
    iv = trace.union((s, e) for s, e, name, _ in tr.ranges
                     if name.startswith(prefix))
    return iv if iv and tr.device else None


def count(tr, prefix):
    """The number of host ranges whose name starts with `prefix`."""
    return sum(1 for r in tr.ranges if r[2].startswith(prefix))


def device_seconds_inside(tr, prefix):
    """trace.device_seconds_under, or None where the span is absent."""
    if _inside(tr, prefix) is None:
        return None
    return trace.device_seconds_under(tr, prefix)


def idle_seconds_inside(tr, prefix):
    """The device's idle time between its first and last operation that
    lies inside the ranges named by `prefix`, on any thread: the gaps
    between the union of device intervals, intersected with the union of
    the ranges."""
    inside = _inside(tr, prefix)
    if inside is None:
        return None
    busy = trace.union((d[0], d[1]) for d in tr.device)
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    total, i, j = 0.0, 0, 0
    while i < len(gaps) and j < len(inside):
        lo = max(gaps[i][0], inside[j][0])
        hi = min(gaps[i][1], inside[j][1])
        if hi > lo:
            total += hi - lo
        if gaps[i][1] < inside[j][1]:
            i += 1
        else:
            j += 1
    return total


def launches_inside(tr, prefix):
    """The device operations (kernels, copies, sets) whose launching
    runtime call, matched by correlation id, began inside the ranges named
    by `prefix`, on any thread: the backward launches from the autograd
    thread while the driving thread waits inside `foodrec::backward`."""
    inside = _inside(tr, prefix)
    if inside is None:
        return None
    starts = [s for s, _ in inside]
    n = 0
    for _, _, _, corr in tr.device:
        launch = tr.launch.get(corr)
        if launch is None:
            continue
        j = bisect.bisect_right(starts, launch[1]) - 1
        if j >= 0 and launch[1] <= inside[j][1]:
            n += 1
    return n


def ms_per(seconds, units):
    """Milliseconds a unit (a step, pass or request), or None."""
    return None if seconds is None else 1e3 * seconds / units


def launches_per_span(tr, prefix):
    """The device operations launched inside the ranges named by `prefix`,
    over the number of those ranges; None where there is none."""
    n = launches_inside(tr, prefix)
    return None if n is None else n / count(tr, prefix)
