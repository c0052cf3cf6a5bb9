"""The cell clussl-foodcom-train: its planted faults turn `correct` false at
a tiny size on the CPU (a state left unchanged, half of each batch left
out, the distance-correlation term left out), and its new per-layer
metrics read None without the program's spans and numbers with them."""

import time
import types

import pytest
import torch

from portbench import harness, run, trace

CLUSSL = "clussl-foodcom-train"


def _cell(tiny_cell):
    cell = tiny_cell(CLUSSL)
    clusters = cell.config["data"]["params"]["n_clusters"]
    cell.config["model_config"]["n_cluster"] = clusters
    return cell


def _measure(cell):
    return run.measure(cell.name, 2 ** 31 + 99, 0.3, False, device="cpu",
                       start=time.perf_counter(), cell=cell)


def test_clussl_sound_run_is_correct(tiny_cell):
    res = _measure(_cell(tiny_cell))
    assert res["correct"], res["checks"]


def test_clussl_state_left_unchanged(tiny_cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    assert not _measure(_cell(tiny_cell))["correct"]


def test_clussl_half_of_each_batch_left_out(tiny_cell, monkeypatch):
    from foodrec_tpu_torch.models.pricai_modelx import PRICAI_ModelX as cls

    loss = cls.calculate_loss

    def half(self, user, pos, neg, generator=None, weight=None):
        h = user.shape[0] // 2
        return loss(self, user[:h], pos[:h], neg[:h], generator=generator)

    monkeypatch.setattr(cls, "calculate_loss", half)
    assert not _measure(_cell(tiny_cell))["correct"]


def test_clussl_dcor_left_out(tiny_cell, monkeypatch):
    from foodrec_tpu_torch.models.pricai_modelx import PRICAI_ModelX as cls

    monkeypatch.setattr(cls, "_ssl_block",
                        lambda self, all_item, *views: (views[0].sum() * 0,))
    res = _measure(_cell(tiny_cell))
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
        + [_x("cuda_runtime", "cudaGraphLaunch", 1, 1, corr=1),
           _x("kernel", "k1", 10, 10, tid=7, corr=1),
           _x("kernel", "k2", 40, 10, tid=7, corr=1)])


NEW = {"item_views_device_ms.train": "item_views",
       "dcor_device_ms.train": "dcor"}


@pytest.mark.parametrize("name", sorted(NEW))
def test_clussl_metric_reads_none_without_its_span(name):
    mod = harness.Cell(CLUSSL).metric_module(name)
    counts = {"steps": 4, "window_s": 0.001}
    others = ["step_graph", "forward"] + [n for n in NEW.values()
                                          if n != NEW[name]]
    run_ = types.SimpleNamespace(trace=_trace(others), traced=counts)
    assert mod.read(run_) is None
    # the span inside a replay's step_graph: both graph nodes launched by
    # the one replay count, 20 us over 4 steps
    run_.trace = _trace(["step_graph", NEW[name]])
    assert mod.read(run_) == pytest.approx(20e-3 / 4)
