"""merge_idle_ms.topk: the device's idle milliseconds a request while the host
is inside the program's `foodrec::topk_merge` spans, in the traced top-k
window; None where the program opens no such span."""

from portbench import spans


def read(run):
    s = spans.idle_seconds_inside(run.trace, "foodrec::topk_merge")
    return spans.ms_per(s, run.traced["requests"])
