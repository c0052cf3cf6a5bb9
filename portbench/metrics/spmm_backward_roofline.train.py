"""spmm_backward_roofline.train: the SpMM backward's share of its roofline
in the traced training window. Each training forward of a graph product
through the kernel (a `Propagator` of the kernel impl whose output takes a
gradient; its module hook, opened by this file, records the graph and the
width) has one backward, the product with A^T: the same nodes and edges,
so its least time is the forward's (peaks.spmm_least_seconds: its bytes at
the HBM rate, the graph's edges counted from the dataset). Their sum, over
the device time of the operations launched inside the program's
`foodrec::spmm_backward` spans, which hold the kernel's launches and the
fix-up launches of the rows cut into slices: the slices earn no credit of
their own. None where the program opens no such span."""

from portbench import peaks
from portbench.spans import device_seconds_inside


def instrument(run):
    calls, handles = [], []
    run.spmm_backward_calls = calls

    def post(module, args, out):
        if out.requires_grad:
            calls.append((module.n_nodes, args[0].shape[1]))

    for m in run.state["model"].modules():
        if type(m).__name__ == "Propagator" and m.impl == "kernel":
            handles.append(m.register_forward_hook(post))

    def undo():
        for h in handles:
            h.remove()

    return undo


def read(run):
    s = device_seconds_inside(run.trace, "foodrec::spmm_backward")
    calls = getattr(run, "spmm_backward_calls", None)
    if not s or not calls:
        return None
    least = sum(peaks.spmm_least_seconds(n, run.graphs[n], d)
                for n, d in calls)
    return 100.0 * least / s
