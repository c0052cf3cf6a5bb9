"""forward_idle_ms.train: the device's idle milliseconds a step while the host
is inside the program's `foodrec::forward` spans (the model's
calculate_loss), in the traced training window; None where the program opens
no such span."""

from portbench import spans


def read(run):
    s = spans.idle_seconds_inside(run.trace, "foodrec::forward")
    return spans.ms_per(s, run.traced["steps"])
