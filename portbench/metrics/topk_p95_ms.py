"""topk_p95_ms: the 95th percentile of every request's time in the window,
from its call to its top-k ids on the host, in milliseconds."""

from portbench.metrics.end_to_end import percentile


def read(run):
    return 1e3 * percentile(run.window["latency_s"], 95)
