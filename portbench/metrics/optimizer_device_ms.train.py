"""optimizer_device_ms.train: device milliseconds a step of the kernels
launched under PyTorch's own `Optimizer.step#...` ranges in the traced
training window."""

from portbench import trace


def read(run):
    s = trace.device_seconds_under(run.trace, "Optimizer.step#")
    return 1e3 * s / run.traced["steps"] if s > 0 else None
