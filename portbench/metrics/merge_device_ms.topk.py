"""merge_device_ms.topk: device milliseconds a request of the operations
launched inside the program's `foodrec::topk_merge` spans (each chunk's cat,
sort and gathers), in the traced top-k window; None where the program opens
no such span."""

from portbench import spans


def read(run):
    s = spans.device_seconds_inside(run.trace, "foodrec::topk_merge")
    return spans.ms_per(s, run.traced["requests"])
