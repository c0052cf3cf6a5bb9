"""backward_device_ms.train: device milliseconds a step of the kernels
launched under PyTorch's own `autograd::engine::evaluate_function:` ranges
(the loss's and the model's backward) in the traced training window."""

from portbench import trace


def read(run):
    s = trace.device_seconds_under(run.trace,
                                   "autograd::engine::evaluate_function:")
    return 1e3 * s / run.traced["steps"] if s > 0 else None
