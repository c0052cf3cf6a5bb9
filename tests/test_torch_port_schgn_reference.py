"""PyTorch port, SCHGN against the benchmark's plain reference
(portbench/reference/schgn-foodcom.py, which imports nothing of the port,
of the JAX package or of JAX): at a toy size of the benchmark's synthetic
dataset, seeded random weights from the reference's `init_spec`, the
port's `calculate_loss` with its draws taken by the `train_draws`
traffic's recorder, and the reference fed the same draws. In float64
every loss part and every leaf's gradient agree within 1e-9 of the
largest magnitude, in both interleave modes; the recorder leaves no draw
over and none short; leaving out the SSL term or dropping the interleave
misses by more than 1e3 times that. Also SCHGN's layer spans: two `score`
and one `ssl` inside the forward, the graph's `spmm_backward` inside the
backward, and none changes a number."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from portbench.reference import plain
from portbench.traffic import train_draws

TOL = 1e-9
BATCH = 24
# the benchmark's toy size (portbench/tests/conftest.py), with more
# ingredients so that the SSL has slots to mask
TOY = dict(n_users=60, n_items=200, n_ingredients=40, n_cal_levels=4,
           n_health_levels=6, n_clusters=5, img_dim=32, txt_dim=16,
           neg_num=30, train_per_user=(5, 9), valid_per_user=(1, 3),
           test_per_user=(2, 4), seed=7)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("schgn_reference"))


def _context(cache, faithful=True, seed=2 ** 31 + 77, **extra):
    """A Context of the benchmark's SCHGN cell at the toy size, on the
    CPU, with its caches under `cache`."""
    saved, harness.CACHE = harness.CACHE, cache
    try:
        cell = harness.Cell("schgn-foodcom-train")
        cell.config["data"]["params"] = dict(TOY)
        cell.config["model_config"].update(
            train_batch_size=BATCH, schgn_faithful_interleave=faithful,
            spmm_impl="kernel", **extra)
        ctx = harness.Context(cell, seed, "cpu")
    finally:
        harness.CACHE = saved
    train_draws._shapes(ctx)
    return ctx


def _batch(data, seed):
    """BATCH train pairs and a negative each that is no positive."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(len(data["train_u"]), BATCH, replace=False)
    u, pos = data["train_u"][rows], data["train_i"][rows]
    neg = rng.integers(0, data["n_items"], BATCH)
    bad = plain.positives_mask(data, u, neg)
    while bad.any():
        neg[bad] = rng.integers(0, data["n_items"], int(bad.sum()))
        bad = plain.positives_mask(data, u, neg)
    return tuple(torch.from_numpy(a) for a in (u, pos, neg))


def _program(ctx, weights, batch, seed=5):
    """The port in float64: its loss parts, its gradients by leaf and the
    draws the recorder took, in call order."""
    torch.set_num_threads(1)
    _, _, model = ctx.build_program(weights)
    model = model.to(torch.float64)
    rec = train_draws._DrawRecorder(model)
    try:
        parts = model.calculate_loss(
            *batch, generator=torch.Generator().manual_seed(seed))
    finally:
        rec.close()
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(sum(parts), list(params.values()))
    return parts, dict(zip(params, grads)), rec.masks[0]


def _reference(ctx, weights, data, batch, draws, **cfg):
    """The reference in float64 on the same weights and draws: its loss
    parts, its gradients by leaf, and the draws it left over."""
    mc = {**ctx.config["model_config"], **cfg}
    ref = ctx.cell.reference.Reference(data, mc, "cpu", dtype=torch.float64)
    w = {k: v.double().requires_grad_(True)
         for k, v in ctx.reference_weights(weights, data).items()}
    left = list(draws)
    parts = ref.loss_parts(w, *batch, left)
    grads = torch.autograd.grad(sum(parts), list(w.values()),
                                allow_unused=True)
    return parts, {k: torch.zeros_like(w[k]) if g is None else g
                   for k, g in zip(w, grads)}, left


def _rel(a, b, scale=None):
    a, b = a.detach(), b.detach()
    scale = b if scale is None else scale
    return float((a - b).abs().max() / scale.abs().max().clamp_min(1e-300))


def _grad_rel(grads, want, name):
    """_rel of leaf `name`'s gradient. A key bias shifts each query's
    logits by one constant, which the softmax ignores: its gradient is zero
    in exact arithmetic and rounding on both sides, so its error is taken
    over the query bias's gradient beside it (the convention of
    test_torch_port_schgn.py)."""
    scale = (want[name.replace("k_b", "q_b")] if name.endswith("k_b")
             else None)
    return _rel(grads[name], want[name], scale)


def _setup(cache, faithful=True):
    ctx = _context(cache, faithful)
    data = plain.load_dataset(os.path.join(ctx.data_root, "Foodcom"))
    return ctx, data, ctx.weights(), _batch(data, ctx.seed % 1000)


@pytest.mark.parametrize("faithful", [True, False],
                         ids=["faithful", "per-sample"])
def test_port_matches_the_plain_reference_in_float64(cache, faithful):
    ctx, data, weights, batch = _setup(cache, faithful)
    parts, grads, draws = _program(ctx, weights, batch)
    assert parts[2] != 0  # the SSL masked some slots
    r_parts, r_grads, left = _reference(ctx, weights, data, batch, draws)
    assert not left
    for got, want in zip(parts, r_parts):
        assert _rel(got, want) <= TOL, (got, want)
    assert set(grads) == set(r_grads)
    for name in grads:
        assert _grad_rel(grads, r_grads, name) <= TOL, name
        assert r_grads[name].abs().max() > 0, name


def test_recorder_leaves_no_draw_over_and_none_short(cache):
    ctx, data, weights, batch = _setup(cache)
    _, _, draws = _program(ctx, weights, batch)
    layers = ctx.config["model_config"]["num_hidden_layers"]
    # two score dropouts, the SSL's sequences, three dropouts a layer
    assert len(draws) == 2 + 1 + 3 * layers
    assert isinstance(draws[2], tuple) and len(draws[2]) == 3
    assert [tuple(d.shape) for d in draws[:2]] == [(BATCH, 64)] * 2
    with pytest.raises(IndexError):
        _reference(ctx, weights, data, batch, draws[:-1])
    extra = draws + [draws[-1]]
    assert len(_reference(ctx, weights, data, batch, extra)[2]) == 1


@pytest.mark.parametrize("change", ["no-ssl", "interleave-dropped"])
def test_a_wrong_reference_misses_by_far_more_than_the_tolerance(cache,
                                                                 change):
    ctx, data, weights, batch = _setup(cache)
    parts, grads, draws = _program(ctx, weights, batch)
    cfg = ({"SCHGN_ssl": False} if change == "no-ssl"
           else {"schgn_faithful_interleave": False})
    r_parts, r_grads, _ = _reference(ctx, weights, data, batch, draws, **cfg)
    loss = _rel(sum(parts), sum(r_parts))
    worst = max(_grad_rel(grads, r_grads, k) for k in grads)
    assert max(loss, worst) > 1e3 * TOL, (loss, worst)


def test_schgn_spans_and_no_number_changed(cache):
    """Two `score` spans and one `ssl` inside the step's `forward`; the
    graph's backward product inside `spmm_backward`, on the backward's
    thread; the same loss parts and gradients with the profiler on."""
    from foodrec_tpu_torch.utils import trace

    ctx, data, weights, batch = _setup(cache)
    off = _program(ctx, weights, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _program(ctx, weights, batch)
    names = [e.name[len(trace.PREFIX):] for e in prof.events()
             if e.name.startswith(trace.PREFIX)]
    assert names.count("score") == 2
    assert names.count("ssl") == 1
    assert names.count("spmm_backward") == 1
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k]), k
