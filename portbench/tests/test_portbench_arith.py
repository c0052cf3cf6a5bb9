"""The benchmark's arithmetic on synthetic inputs: the device's busy time
as a union, device time under host ranges, the idle gaps by host op, the
SpMM's bytes and the percentile."""

import pytest

from portbench import peaks, trace
from portbench.metrics.end_to_end import percentile


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def tr():
    # host: step [0, 100) holding backward [10, 40) and opt [50, 60) on tid
    # 1; device: k1 [20, 30), k2 [25, 45) overlapping, k3 [70, 80)
    return trace.Trace([
        _x("cpu_op", "step", 0, 100),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
           10, 30),
        _x("user_annotation", "Optimizer.step#Adam.step", 50, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 55, 1, corr=3),
        _x("kernel", "k1", 20, 10, tid=7, corr=1),
        _x("kernel", "k2", 25, 20, tid=7, corr=2),
        _x("gpu_memcpy", "k3", 70, 10, tid=7, corr=3),
    ])


def test_busy_is_the_union(tr):
    assert trace.busy_seconds(tr) == pytest.approx(35e-6)


def test_device_time_under_ranges(tr):
    assert trace.device_seconds_under(
        tr, "autograd::engine::evaluate_function:") == pytest.approx(30e-6)
    assert trace.device_seconds_under(tr, "Optimizer.step#") == \
        pytest.approx(10e-6)
    assert trace.device_seconds_under(tr, "nothing") == 0.0


def test_breakdown(tr):
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["k2", pytest.approx(20e-6)]
    # the one gap [45, 70) has its middle at 57.5, inside the optimizer
    assert b["idle_gaps"] == [["Optimizer.step#Adam.step",
                               pytest.approx(25e-6)]]


def test_spmm_bytes_and_bound():
    assert peaks.spmm_bytes(3, 4, 2) == 4 * 8 + 4 * 4 + 2 * 3 * 2 * 4
    n, nnz, d = 37539, 380674, 64
    assert peaks.spmm_least_seconds(n, nnz, d) == pytest.approx(
        peaks.spmm_bytes(n, nnz, d) / peaks.HBM_BYTES_PER_S)


def test_percentile():
    v = list(range(1, 101))
    assert percentile(v, 95) == pytest.approx(95.05)
    assert percentile([5.0], 95) == 5.0


def test_idle_gap_takes_the_op_that_began_last():
    # the main thread sits in `backward` [0, 100) while the autograd
    # thread runs MulBackward0 [40, 60); the device idles over [30, 70)
    tr = trace.Trace([
        _x("cpu_op", "backward", 0, 100, tid=1),
        _x("cpu_op", "autograd::engine::evaluate_function: MulBackward0",
           40, 20, tid=2),
        _x("kernel", "k1", 20, 10, tid=7),
        _x("kernel", "k2", 70, 10, tid=7),
    ])
    assert trace.breakdown(tr)["idle_gaps"] == [[
        "autograd::engine::evaluate_function: MulBackward0",
        pytest.approx(40e-6)]]
