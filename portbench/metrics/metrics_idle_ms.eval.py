"""metrics_idle_ms.eval: the device's idle milliseconds a pass while the host
is inside the program's `foodrec::metrics` spans (each block's by-user
metrics), in the traced evaluation window; None where the program opens no
such span."""

from portbench import spans


def read(run):
    s = spans.idle_seconds_inside(run.trace, "foodrec::metrics")
    return spans.ms_per(s, run.traced["passes"])
