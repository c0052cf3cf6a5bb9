"""spmm_roofline.train: the SpMM forward's share of its roofline in the
traced training window. Every forward product (each call of a
`Propagator` module, whatever implements it) runs inside a host range
`portbench::spmm_forward` that this file opens through module hooks; the
least time of each product (peaks.spmm_least_seconds: its bytes at the HBM
rate, the graph's edges counted from the dataset) summed, over the device
time of the kernels launched inside those ranges."""

from portbench import peaks, trace

RANGE = "portbench::spmm_forward"


def instrument(run):
    import torch

    calls, open_ranges, handles = run.spmm_calls, [], []

    def pre(module, args):
        calls.append((module.n_nodes, args[0].shape[1]))
        r = torch.autograd.profiler.record_function(RANGE)
        r.__enter__()
        open_ranges.append(r)

    def post(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    for m in run.state["model"].modules():
        if type(m).__name__ == "Propagator":
            handles.append(m.register_forward_pre_hook(pre))
            handles.append(m.register_forward_hook(post))

    def undo():
        for h in handles:
            h.remove()

    return undo


def read(run):
    device_s = trace.device_seconds_under(run.trace, RANGE)
    if not run.spmm_calls or device_s <= 0:
        return None
    least = sum(peaks.spmm_least_seconds(n, run.graphs[n], d)
                for n, d in run.spmm_calls)
    return 100.0 * least / device_s
