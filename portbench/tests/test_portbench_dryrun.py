"""A run of each cell on the CPU at a tiny size, through the port's plain
paths (no CUDA kernel), judged by the plain reference: the harness's whole
path but the look for a card."""

import time

import pytest

from portbench import harness, run

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, tiny_cell):
    cell = tiny_cell(name)
    res = run.measure(name, 2 ** 31 + 12345, 0.5, False, device="cpu",
                      start=time.perf_counter(), cell=cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == names


def test_traced_run_reads_its_trace(tiny_cell, monkeypatch):
    monkeypatch.setattr(run, "TRACE_SECONDS", 0.3)
    cell = tiny_cell("lightgcn-foodcom-train")
    res = run.measure(cell.name, 7, 0.3, True, device="cpu",
                      start=time.perf_counter(), cell=cell)
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device ran on the CPU: the device metrics find nothing to read
    assert not any(k.startswith(("device_idle", "spmm_roofline", "backward",
                                 "optimizer", "train_mfu"))
                   for k in res["metrics"])
