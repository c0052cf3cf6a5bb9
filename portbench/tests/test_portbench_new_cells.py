"""The cell schgn-foodcom-train: its planted faults turn `correct` false at
a tiny size on the CPU (a state left unchanged, half of each batch and of
each draw left out, the SSL left out), its new per-layer metrics read None
without the program's spans and numbers with them, and, on the card, its
control comes out as not correct."""

import time
import types

import pytest
import torch

from portbench import calibrate_kinds, harness, run, trace

SCHGN = "schgn-foodcom-train"


def _measure(cell):
    return run.measure(cell.name, 99, 0.3, False, device="cpu",
                       start=time.perf_counter(), cell=cell)


def test_schgn_state_left_unchanged(tiny_cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    assert not _measure(tiny_cell(SCHGN))["correct"]


def test_schgn_half_of_each_batch_left_out(tiny_cell, monkeypatch):
    from foodrec_tpu_torch.models.schgn import SCHGN as cls

    loss = cls.calculate_loss

    def half(self, user, pos, neg, generator=None, weight=None):
        h = user.shape[0] // 2
        return loss(self, user[:h], pos[:h], neg[:h], generator=generator)

    monkeypatch.setattr(cls, "calculate_loss", half)
    assert not _measure(tiny_cell(SCHGN))["correct"]


def test_schgn_ssl_left_out(tiny_cell, monkeypatch):
    from foodrec_tpu_torch.models.schgn import SCHGN as cls

    monkeypatch.setattr(cls, "_ssl_loss",
                        lambda self, table, items, generator:
                        table.new_zeros(()))
    res = _measure(tiny_cell(SCHGN))
    assert not res["correct"], res["checks"]


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(span_names):
    return trace.Trace(
        [_x("user_annotation", "foodrec::" + n, 0, 60) for n in span_names]
        + [_x("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
           _x("kernel", "k1", 10, 10, tid=7, corr=1),
           _x("kernel", "k2", 40, 10, tid=7, corr=1)])


NEW = {"score_device_ms.train": "score", "ssl_device_ms.train": "ssl",
       "spmm_backward_roofline.train": "spmm_backward"}


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_metric_reads_none_without_its_span(name):
    mod = harness.Cell(SCHGN).metric_module(name)
    counts = {"steps": 4, "window_s": 0.001}
    run_ = types.SimpleNamespace(
        trace=_trace([n for n in NEW.values() if n != NEW[name]]),
        traced=counts, graphs={10: 40}, spmm_backward_calls=[(10, 64)])
    assert mod.read(run_) is None
    run_.trace = _trace([NEW[name]])
    value = mod.read(run_)
    assert value is not None and value > 0


def test_spmm_backward_roofline_counts_the_products():
    from portbench import peaks

    mod = harness.Cell(SCHGN).metric_module("spmm_backward_roofline.train")
    calls = [(10, 64), (10, 64), (12, 32)]
    run_ = types.SimpleNamespace(trace=_trace(["spmm_backward"]),
                                 graphs={10: 40, 12: 50},
                                 spmm_backward_calls=calls)
    least = (2 * peaks.spmm_least_seconds(10, 40, 64)
             + peaks.spmm_least_seconds(12, 50, 32))
    # the launch lies inside the span: k1 and k2, 20 us of device time
    assert mod.read(run_) == pytest.approx(100.0 * least / 20e-6)


@pytest.mark.cuda
def test_control_is_not_correct(cuda_device, cache_dir, monkeypatch):
    from portbench.reference import plain

    monkeypatch.setattr(harness, "CACHE", cache_dir)
    cell = harness.Cell(SCHGN)
    cell.config["data"]["params"].update(n_users=1000, neg_num=500)
    for seed in (11, 12, 13):
        ctx = harness.Context(cell, seed, cuda_device)
        data = plain.load_dataset(f"{ctx.data_root}/Foodcom")
        for side, nums in calibrate_kinds.control(ctx, data).items():
            assert any(nums[k] > lim for k, lim in cell.limits.items()
                       if k in nums), (side, nums)
