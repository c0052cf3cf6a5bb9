"""PyTorch port, the layer spans (foodrec_tpu_torch/utils/trace.py): free
when no profiler records, recorded where the work happens when one does,
nested as the layers nest, and without effect on any number or random
stream. On the toy synthetic dataset, CIKM_Model with the kernel impl (its
plain SpMM on the CPU)."""

import contextlib
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from foodrec_tpu_torch.utils import trace


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data import synthetic
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData

    root = tmp_path_factory.mktemp("trace_data")
    meta = synthetic.generate(str(root / "Synth"))
    cfg = Config("CIKM_Model", "Synth", {
        "data_path": str(root) + "/", "neg_sample_num": meta["neg_num"],
        "use_gpu": False, "spmm_impl": "kernel", "train_batch_size": 16,
        "eval_batch_size": 8})
    derive_data_paths(cfg, "Synth")
    data = FoodData(cfg)
    data.device_data = DeviceData.from_food_data(data)
    return cfg, data


def _trainer(toy, seed=0):
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    cfg, data = toy
    torch.set_num_threads(1)
    model = get_model("CIKM_Model")(cfg, data,
                                    torch.Generator().manual_seed(seed))
    return Trainer(cfg, model)


def _ranges(prof):
    """{span: [(start, end)]} of the foodrec:: ranges the profiler took."""
    out = {}
    for e in prof.events():
        if e.name.startswith(trace.PREFIX):
            out.setdefault(e.name[len(trace.PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer):
    return [i for i in inner if outer[0] <= i[0] and i[1] <= outer[1]]


def test_span_is_a_shared_null_context_without_a_profiler(monkeypatch):
    def forbidden(name):
        raise AssertionError(f"a RecordFunction for {name}")

    monkeypatch.setattr(trace.profiler, "record_function", forbidden)
    assert not torch.autograd._profiler_enabled()
    spans = {id(trace.span(name)) for name in trace.SPANS}
    assert spans == {id(trace._OFF)}
    with trace.span("train_step"):
        pass


def test_span_names_are_no_prefix_of_one_another():
    names = [trace.PREFIX + n for n in trace.SPANS]
    assert len(set(names)) == len(names)
    assert not [(a, b) for a in names for b in names
                if a != b and b.startswith(a)]
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            trace.span("no_such_layer")


def test_train_steps_record_each_layer_inside_its_step(toy):
    trainer = _trainer(toy)
    perm = trainer._epoch_perm()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_steps(trainer._batches(perm, 0, 2))
    r = _ranges(prof)
    assert len(r["train_step"]) == 2
    for step in r["train_step"]:
        for layer in ("sampler", "forward", "backward", "optimizer"):
            assert len(_inside(r[layer], step)) == 1, (layer, step)
    # CIKM_Model's forward: one user-item and two recipe-ingredient hops
    assert len(r["spmm_forward"]) == 6
    for fwd in r["forward"]:
        assert len(_inside(r["spmm_forward"], fwd)) == 3


def test_evaluate_records_upload_and_each_block_metrics(toy):
    trainer = _trainer(toy)
    es = toy[1].device_data.eval_test
    n_blocks = -(-es.n_users // trainer._eval_batch())
    assert n_blocks >= 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.evaluate(es, is_test=True)
    r = _ranges(prof)
    (eval_pass,) = r["eval_pass"]
    assert len(_inside(r["eval_cache"], eval_pass)) == 1
    assert len(_inside(r["eval_upload"], eval_pass)) == 1
    assert len(_inside(r["metrics"], eval_pass)) == n_blocks == len(
        r["metrics"])


def test_full_sort_topk_records_one_merge_per_chunk(toy):
    from foodrec_tpu_torch.engine.topk_evaluator import full_sort_topk

    trainer = _trainer(toy)
    model = trainer.model
    n_items = toy[1].n_items
    score_fn = functools.partial(model.score_items, model.eval_cache())
    users, user_batch, item_chunk = list(range(10)), 8, 16
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        full_sort_topk(score_fn, users, n_items, 5, user_batch=user_batch,
                       item_chunk=item_chunk, device="cpu")
    r = _ranges(prof)
    (request,) = r["topk_request"]
    chunks = -(-n_items // item_chunk) * -(-len(users) // user_batch)
    assert len(_inside(r["topk_merge"], request)) == chunks == len(
        r["topk_merge"])


def test_each_graph_backward_records_spmm_backward(toy):
    """One `spmm_backward` for each kernel product of the forward, inside
    the step's `backward`."""
    trainer = _trainer(toy)
    perm = trainer._epoch_perm()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_steps(trainer._batches(perm, 0, 1))
    r = _ranges(prof)
    (backward,) = r["backward"]
    assert len(r["spmm_backward"]) == len(r["spmm_forward"]) == 3
    assert len(_inside(r["spmm_backward"], backward)) == 3


def test_full_sort_evaluation_records_its_host_metrics(toy):
    """The full-sort path: one `topk_metrics` inside the pass, after its
    top-k request."""
    trainer = _trainer(toy)
    cfg = trainer.config
    saved = {k: cfg[k] for k in ("full_sort", "eval_by_user",
                                 "save_recommended_topk")}
    cfg["full_sort"], cfg["eval_by_user"] = True, False
    cfg["save_recommended_topk"] = False
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            trainer.evaluate(None, is_test=True)
    finally:
        for k, v in saved.items():
            cfg[k] = v
    r = _ranges(prof)
    (eval_pass,) = r["eval_pass"]
    (request,) = r["topk_request"]
    (metrics,) = _inside(r["topk_metrics"], eval_pass)
    assert request[1] <= metrics[0]


def test_spans_change_no_number_or_random_stream(toy):
    """Loss parts, parameters and the generator's state after two steps
    and an evaluation are bitwise the same with the profiler on and off."""
    runs = []
    for traced in (False, True):
        trainer = _trainer(toy, seed=3)
        perm = trainer._epoch_perm()
        prof = profile(activities=[ProfilerActivity.CPU])
        with prof if traced else contextlib.nullcontext():
            parts = trainer.train_steps(trainer._batches(perm, 0, 2))
            metrics = trainer.evaluate(toy[1].device_data.eval_test)
        if traced:
            assert len(_ranges(prof)["train_step"]) == 2
        runs.append((parts, {k: v.detach().clone() for k, v in
                             trainer.model.named_parameters()},
                     trainer.generator.get_state(), metrics))
    (p0, w0, g0, m0), (p1, w1, g1, m1) = runs
    assert torch.equal(p0, p1)
    assert sorted(w0) == sorted(w1)
    for k in w0:
        assert torch.equal(w0[k], w1[k]), k
    assert torch.equal(g0, g1)
    assert m0 == m1
    assert np.isfinite(p0.numpy()).all()
