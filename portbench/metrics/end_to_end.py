"""The arithmetic of the end-to-end latency metric."""


def percentile(values, q):
    """The q-th percentile (0-100) of `values` by linear interpolation
    between the closest ranks (numpy's default method)."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
