"""PyTorch port, CLUSSL (PRICAI_ModelX) against the benchmark's plain
reference (portbench/reference/clussl-foodcom.py, which imports nothing of
the port, of the JAX package or of JAX): at a toy size of the benchmark's
synthetic dataset (5 k-means clusters), seeded random weights from the
reference's `init_spec`, one batch of train pairs with a negative each.

  * float32: the three loss parts within 1e-5 (relative), the bar of the
    port's float32 loss parts against the JAX package; every leaf's
    gradient within 1e-3 of its largest element, the port's bar for
    CLUSSL's gradients against JAX: the distance matrices' diagonal is
    sqrt(rounding + 1e-8), about 1e-4, whose derivative multiplies the
    rounding of r - 2 x.x + r by ~5e3 on each side, and the two sides
    round their Gram products and SpMMs differently
  * float64: every part and gradient within 1e-9, and the reference with
    its distance correlation left out misses by far more than that
  * the split of `calculate_loss` into `forward`, `_ssl_block` and
    `_bpr_block` gives the loss parts and gradients of the single
    function it replaced, bit for bit, with StepGraphs set and without
    (CLUSSL replays no graph)
  * the spans `item_views` (inside the step's forward) and `dcor` open
    once a step, and change no number
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from foodrec_tpu_torch.common.loss import bpr_loss, emb_loss
from foodrec_tpu_torch.common.ssl_losses import correlation_distance
from foodrec_tpu_torch.common.step_graph import StepGraphs
from portbench import harness
from portbench.reference import plain

CELL = "clussl-foodcom-train"
BATCH = 48
TOY = dict(n_users=60, n_items=200, n_ingredients=40, n_cal_levels=4,
           n_health_levels=6, n_clusters=5, img_dim=32, txt_dim=16,
           neg_num=30, train_per_user=(5, 9), valid_per_user=(1, 3),
           test_per_user=(2, 4), seed=7)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("clussl_reference"))


def _setup(cache, seed=2 ** 31 + 123):
    """(context, dataset, weights, batch) of the benchmark's CLUSSL cell
    at the toy size on the CPU."""
    saved, harness.CACHE = harness.CACHE, cache
    try:
        cell = harness.Cell(CELL)
        cell.config["data"]["params"] = dict(TOY)
        cell.config["model_config"].update(train_batch_size=BATCH,
                                           n_cluster=TOY["n_clusters"])
        ctx = harness.Context(cell, seed, "cpu")
    finally:
        harness.CACHE = saved
    data = plain.load_dataset(os.path.join(ctx.data_root, "Foodcom"))
    rng = np.random.default_rng(seed % 1000)
    rows = rng.choice(len(data["train_u"]), BATCH, replace=False)
    u, pos = data["train_u"][rows], data["train_i"][rows]
    neg = rng.integers(0, data["n_items"], BATCH)
    bad = plain.positives_mask(data, u, neg)
    while bad.any():
        neg[bad] = rng.integers(0, data["n_items"], int(bad.sum()))
        bad = plain.positives_mask(data, u, neg)
    batch = tuple(torch.from_numpy(a) for a in (u, pos, neg))
    return ctx, data, ctx.weights(), batch


def _grads(parts, leaves):
    return dict(zip(leaves, torch.autograd.grad(sum(parts),
                                                list(leaves.values()))))


def _program(ctx, weights, batch, dtype=torch.float32):
    """The port's loss parts and its gradients by leaf."""
    _, _, model = ctx.build_program(weights)
    model = model.to(dtype)
    parts = model.calculate_loss(*batch)
    return parts, _grads(parts, dict(model.named_parameters()))


def _reference(ctx, weights, data, batch, dtype=torch.float32, **cfg):
    mc = {**ctx.config["model_config"], **cfg}
    ref = ctx.cell.reference.Reference(data, mc, "cpu", dtype=dtype)
    w = {k: v.to(dtype).requires_grad_(True)
         for k, v in ctx.reference_weights(weights, data).items()}
    with plain.precision(False):
        parts = ref.loss_parts(w, *batch, [])
    return parts, _grads(parts, w)


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def test_port_matches_the_plain_reference_in_float32(cache):
    ctx, data, weights, batch = _setup(cache)
    parts, grads = _program(ctx, weights, batch)
    r_parts, r_grads = _reference(ctx, weights, data, batch)
    assert len(parts) == len(r_parts) == 3
    for got, want in zip(parts, r_parts):
        assert _rel(got, want) <= 1e-5, (got, want)
    assert set(grads) == set(r_grads)
    for name in grads:
        assert r_grads[name].abs().max() > 0, name
        assert _rel(grads[name], r_grads[name]) <= 1e-3, name


@pytest.mark.parametrize("seed", [2 ** 31 + 123, 2 ** 31 + 7919])
def test_port_matches_the_plain_reference_in_float64(cache, seed):
    ctx, data, weights, batch = _setup(cache, seed)
    parts, grads = _program(ctx, weights, batch, torch.float64)
    r_parts, r_grads = _reference(ctx, weights, data, batch, torch.float64)
    assert parts[1] > 0  # the views correlate
    for got, want in zip(parts, r_parts):
        assert _rel(got, want) <= 1e-9, (got, want)
    for name in grads:
        assert _rel(grads[name], r_grads[name]) <= 1e-9, name


def test_the_reference_without_dcor_misses_by_far_more(cache):
    ctx, data, weights, batch = _setup(cache)
    parts, grads = _program(ctx, weights, batch, torch.float64)
    r_parts, r_grads = _reference(ctx, weights, data, batch, torch.float64,
                                  loss_cl=0.0)
    loss = _rel(sum(parts), sum(r_parts))
    worst = max(_rel(grads[k], r_grads[k]) for k in grads)
    assert max(loss, worst) > 1e3 * 1e-9, (loss, worst)


def _single_function(model, user, pos_item, neg_item, weight=None):
    """calculate_loss as one function, as it was before its split into a
    prelude and two blocks."""
    weight = model.sample_weight(user, weight)
    all_item = torch.cat([pos_item, neg_item])
    user_all, item_all, (image_v, text_v, ingre_v) = model.forward()
    item_image = image_v[all_item]
    item_text = text_v[all_item]
    item_ingre = ingre_v[all_item]
    u_e = user_all[user]
    mf_loss = bpr_loss((u_e * item_all[pos_item]).sum(1),
                       (u_e * item_all[neg_item]).sum(1), weight=weight)
    cl = (correlation_distance(item_image, item_text)
          + correlation_distance(item_image, item_ingre)
          + correlation_distance(item_ingre, item_text))
    reg_loss = model.reg_weight * emb_loss(
        model.user_embedding[user], model.item_embedding[pos_item],
        model.item_embedding[neg_item], weight=weight)
    return mf_loss, model.loss_cl * cl, reg_loss


def _bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "tail"])
def test_split_equals_the_single_function(cache, weighted):
    ctx, _, weights, batch = _setup(cache)
    _, _, model = ctx.build_program(weights)
    weight = None
    if weighted:
        weight = (torch.arange(BATCH) < BATCH - 5).float()
    params = dict(model.named_parameters())
    want = _single_function(model, *batch, weight=weight)
    want_g = _grads(want, params)
    for graphs in (None, StepGraphs()):
        model.step_graphs = graphs
        parts = model.calculate_loss(*batch, weight=weight)
        got_g = _grads(parts, params)
        assert all(_bits(a, b) for a, b in zip(parts, want))
        assert all(_bits(got_g[k], want_g[k]) for k in params), [
            k for k in params if not _bits(got_g[k], want_g[k])]


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "blocks"])
def test_clussl_spans_and_no_number_changed(cache, graphs):
    """One `item_views` inside the step's forward, holding the three
    views' six SpMM products, and one `dcor`; the user-item hop outside
    `item_views`; the same parts and gradients with the profiler on."""
    from foodrec_tpu_torch.utils import trace

    ctx, _, weights, batch = _setup(cache)
    _, _, model = ctx.build_program(weights)
    model.step_graphs = StepGraphs() if graphs else None
    params = dict(model.named_parameters())

    def step():
        parts = model.calculate_loss(*batch)
        return parts, _grads(parts, params)

    off = step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = step()
    ranges = {}
    for e in prof.events():
        if e.name.startswith(trace.PREFIX):
            ranges.setdefault(e.name[len(trace.PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    assert len(ranges["item_views"]) == 1 and len(ranges["dcor"]) == 1
    (lo, hi), = ranges["item_views"]
    inside = [r for r in ranges["spmm_forward"] if lo <= r[0] and r[1] <= hi]
    assert len(inside) == 6 and len(ranges["spmm_forward"]) == 7
    assert all(_bits(a, b) for a, b in zip(off[0], on[0]))
    assert all(_bits(off[1][k], on[1][k]) for k in params)
