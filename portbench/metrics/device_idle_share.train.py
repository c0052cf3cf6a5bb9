"""device_idle_share.train: the device's idle share of the traced window: 1 -
(the union of the device's kernel, copy and set intervals) / (the window's
seconds)."""

from portbench import trace


def read(run):
    if not run.trace.device:
        return None  # no device operation was traced
    return 100.0 * (1.0 - trace.busy_seconds(run.trace)
                    / run.traced["window_s"])
