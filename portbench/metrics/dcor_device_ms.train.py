"""dcor_device_ms.train: device milliseconds a step of the operations
launched inside the program's `foodrec::dcor` spans (CLUSSL's distance-
correlation block, its forward: the views' batch rows and the three
distance correlations; the backward's launches, from autograd's thread
after the span has closed, are not counted), in the traced training
window; None where the program opens no such span."""

from portbench.spans import device_seconds_inside, ms_per


def read(run):
    s = device_seconds_inside(run.trace, "foodrec::dcor")
    return ms_per(s, run.traced["steps"])
