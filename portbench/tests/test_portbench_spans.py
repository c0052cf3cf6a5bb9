"""The reading of the program's spans (portbench/spans.py) on hand-built
traces: device idle time inside ranges on two threads, launches matched by
correlation id across threads, and the per-layer metrics that read spans,
which read None where the program opens no span."""

import os
import types

import pytest

from portbench import harness, spans, trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def tr():
    # device busy [0, 10), [30, 40), [60, 70), [100, 110): gaps [10, 30),
    # [40, 60), [70, 100). Host: foodrec::backward [5, 50) on thread 1
    # covers the first gap and half the second; the autograd thread 2 runs
    # foodrec::backward [65, 80) too (a range of the same name elsewhere),
    # covering [70, 80) of the third; foodrec::sampler [90, 95) on thread
    # 1 covers [90, 95) of it
    return trace.Trace([
        _x("user_annotation", "foodrec::backward", 5, 45, tid=1),
        _x("user_annotation", "foodrec::backward", 65, 15, tid=2),
        _x("user_annotation", "foodrec::sampler", 90, 5, tid=1),
        _x("cuda_runtime", "cudaLaunchKernel", 1, 1, tid=1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, tid=1, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 66, 1, tid=2, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 92, 1, tid=1, corr=4),
        _x("kernel", "k1", 0, 10, tid=7, corr=1),
        _x("kernel", "k2", 30, 10, tid=7, corr=2),
        _x("gpu_memcpy", "c3", 60, 10, tid=7, corr=3),
        _x("gpu_memset", "s4", 100, 10, tid=7, corr=4),
    ])


def test_idle_inside_ranges_on_two_threads(tr):
    # [10, 30) whole, [40, 50) of [40, 60), [70, 80) of [70, 100)
    assert spans.idle_seconds_inside(tr, "foodrec::backward") == \
        pytest.approx(40e-6)
    assert spans.idle_seconds_inside(tr, "foodrec::sampler") == \
        pytest.approx(5e-6)


def test_overlapping_ranges_count_their_gap_once():
    tr = trace.Trace([
        _x("user_annotation", "foodrec::optimizer", 12, 10, tid=1),
        _x("user_annotation", "foodrec::optimizer", 15, 20, tid=2),
        _x("kernel", "k1", 0, 10, tid=7),
        _x("kernel", "k2", 30, 10, tid=7),
    ])
    # the gap [10, 30) is covered over [12, 30) by the union of the two
    assert spans.idle_seconds_inside(tr, "foodrec::optimizer") == \
        pytest.approx(18e-6)


def test_launches_by_correlation_across_threads(tr):
    # k2 from thread 1 at 20, c3 from the autograd thread at 66
    assert spans.launches_inside(tr, "foodrec::backward") == 2
    assert spans.count(tr, "foodrec::backward") == 2
    assert spans.launches_per_span(tr, "foodrec::backward") == 1.0
    assert spans.launches_inside(tr, "foodrec::sampler") == 1
    # device time of the same thread's launches, trace.py's own rule
    assert spans.device_seconds_inside(tr, "foodrec::backward") == \
        pytest.approx(20e-6)


def test_absent_span_or_device_reads_none(tr):
    for fn in (spans.idle_seconds_inside, spans.launches_inside,
               spans.device_seconds_inside, spans.launches_per_span):
        assert fn(tr, "foodrec::metrics") is None
    host_only = trace.Trace([_x("user_annotation", "foodrec::sampler", 0, 5)])
    assert spans.idle_seconds_inside(host_only, "foodrec::sampler") is None
    assert spans.launches_inside(host_only, "foodrec::sampler") is None
    assert spans.ms_per(None, 3) is None
    assert spans.ms_per(0.006, 3) == pytest.approx(2.0)


def _span_metrics():
    """(name, module) of every per-layer metric that reads spans."""
    out = []
    for m in harness.benchmark()["per_layer"]:
        mod = harness.load_module(os.path.join(harness.PKG, "metrics",
                                               m["name"] + ".py"))
        if getattr(mod, "spans", None) is spans:
            out.append((m["name"], mod))
    return out


def test_span_metrics_read_none_without_spans_and_numbers_with_them():
    metrics = _span_metrics()
    assert len(metrics) == 13
    counts = {"steps": 4, "passes": 2, "requests": 5, "window_s": 0.001}
    no_spans = trace.Trace([
        _x("cpu_op", "aten::mm", 0, 50, tid=1),
        _x("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
        _x("kernel", "k1", 10, 10, tid=7, corr=1),
        _x("kernel", "k2", 40, 10, tid=7, corr=1),
    ])
    names = ("train_step", "sampler", "forward", "backward", "optimizer",
             "metrics", "eval_upload", "topk_request", "topk_merge")
    with_spans = trace.Trace(
        [_x("user_annotation", "foodrec::" + n, 0, 60) for n in names]
        + [_x("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
           _x("kernel", "k1", 10, 10, tid=7, corr=1),
           _x("kernel", "k2", 40, 10, tid=7, corr=1)])
    for name, mod in metrics:
        run = types.SimpleNamespace(trace=no_spans, traced=counts)
        assert mod.read(run) is None, name
        run = types.SimpleNamespace(trace=with_spans, traced=counts)
        value = mod.read(run)
        assert value is not None and value > 0, name
