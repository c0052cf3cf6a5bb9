"""forward_device_ms.train: device milliseconds a step of the operations
launched inside the program's `foodrec::forward` spans (the model's
calculate_loss), in the traced training window; None where the program opens
no such span."""

from portbench import spans


def read(run):
    s = spans.device_seconds_inside(run.trace, "foodrec::forward")
    return spans.ms_per(s, run.traced["steps"])
