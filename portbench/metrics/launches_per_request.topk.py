"""launches_per_request.topk: the device operations (kernels, copies, sets)
launched inside the program's `foodrec::topk_request` spans over the number
of those spans, in the traced top-k window; None where the program opens no
such span."""

from portbench import spans


def read(run):
    return spans.launches_per_span(run.trace, "foodrec::topk_request")
