"""launches_per_step.train: the device operations (kernels, copies, sets)
launched inside the program's `foodrec::train_step` spans, from any thread,
over the number of those spans, in the traced training window; None where
the program opens no such span."""

from portbench import spans


def read(run):
    return spans.launches_per_span(run.trace, "foodrec::train_step")
