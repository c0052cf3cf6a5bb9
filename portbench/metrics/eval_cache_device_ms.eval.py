"""eval_cache_device_ms.eval: device milliseconds a pass of the kernels
launched inside the model's `eval_cache` (the graph propagation of an
evaluation), which this file wraps in a host range, in the traced
evaluation window."""

from portbench import trace

RANGE = "portbench::eval_cache"


def instrument(run):
    import torch

    model = run.state["model"]
    eval_cache = model.eval_cache

    def ranged():
        with torch.autograd.profiler.record_function(RANGE):
            return eval_cache()

    model.eval_cache = ranged

    def undo():
        del model.eval_cache

    return undo


def read(run):
    s = trace.device_seconds_under(run.trace, RANGE)
    return 1e3 * s / run.traced["passes"] if s > 0 else None
