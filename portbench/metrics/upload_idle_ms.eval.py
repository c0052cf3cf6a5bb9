"""upload_idle_ms.eval: the device's idle milliseconds a pass while the host is
inside the program's `foodrec::eval_upload` spans (the pass's user,
candidate and count arrays copied to the device), in the traced evaluation
window; None where the program opens no such span."""

from portbench import spans


def read(run):
    s = spans.idle_seconds_inside(run.trace, "foodrec::eval_upload")
    return spans.ms_per(s, run.traced["passes"])
