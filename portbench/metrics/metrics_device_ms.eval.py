"""metrics_device_ms.eval: device milliseconds a pass of the operations
launched inside the program's `foodrec::metrics` spans (each block's by-user
metrics), in the traced evaluation window; None where the program opens no
such span."""

from portbench import spans


def read(run):
    s = spans.device_seconds_inside(run.trace, "foodrec::metrics")
    return spans.ms_per(s, run.traced["passes"])
