"""ssl_device_ms.train: device milliseconds a step of the operations
launched inside the program's `foodrec::ssl` spans (SCHGN's masked-
ingredient loss: the masking draws, the encoder and the BCE), in the traced
training window; None where the program opens no such span."""

from portbench.spans import device_seconds_inside, ms_per


def read(run):
    s = device_seconds_inside(run.trace, "foodrec::ssl")
    return ms_per(s, run.traced["steps"])
