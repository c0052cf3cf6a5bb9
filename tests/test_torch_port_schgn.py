"""PyTorch port, slice 5: SCHGN against the JAX package on the toy synthetic
dataset, with the same parameters (carried over by params_from_jax), the
same batches and the same SSL sequences, and the modules it brought:
`gcn_conv_adjacency`, the calorie tables, the post-LN `bert_encoder`,
`ssl_mask_ingredients`, `truncated_normal`, and the padded blocks of the
by-user evaluator and of `full_sort_topk`.

Tolerances, as the largest |port - jax| over the largest |jax| of each array:
  * the graph and the calorie tables bitwise; the encoder (dropout 0) 1e-5
    in float32, value and gradients
  * eval_cache and score_from_cache 1e-5; Trainer.evaluate's metrics 1e-6
    (with the premise that the score differences between the two
    frameworks cannot reorder a positive/negative pair); top-k ids equal
  * calculate_loss in float32 with `deterministic=True` (no score dropout),
    the SSL sequences injected and the encoder's dropouts 0, as
    lockstep_check.py runs SCHGN: loss parts 1e-5, gradients 1e-4
  * float64, in a subprocess with JAX_ENABLE_X64: every loss part and
    gradient 1e-9 (the certificate), through the kernel impl's plain
    version, whose backward reads A^T's float64 values
The SpMM runs the CUDA kernel's plain version: the tensors lie on the CPU.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from test_torch_port_data import _port_config
from test_torch_port_models import _buffers64, _port_model
from test_torch_port_spmm_plan import levels_edges
from test_torch_port_train import (
    _assert_rel,
    _perturb,
    _rel_err,
    _torch_tree,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
GRAD_TOL = 1e-4
# deterministic: the encoder's dropouts off (calculate_loss's
# `deterministic` turns off the score dropout), as lockstep_check.py:236-243
# runs SCHGN
OVERRIDES = {"train_batch_size": 16, "hidden_dropout_prob": 0.0,
             "attention_probs_dropout_prob": 0.0}
PARAM_SCALE = 8.0  # the embedding tables, for the ranking tests
# (id, port overrides): the shipped faithful interleave through `auto` and
# through the kernel impl (A^T's own tables), and the per-sample fix
LOSS_VARIANTS = [("faithful-auto", {}),
                 ("faithful-kernel", {"spmm_impl": "kernel"}),
                 ("fixed-kernel", {"spmm_impl": "kernel",
                                   "schgn_faithful_interleave": False})]


def _jax_side(synth_root):
    """The JAX package's SCHGN on the toy data under OVERRIDES, in both
    interleave modes ({faithful: model}), and its init parameters (through
    jit: eager PRNG ops take seconds)."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.models import get_model as jget_model

    jmodels, jdata = {}, None
    for faithful in (True, False):
        jcfg, _ = make_config(synth_root, model="SCHGN", overrides={
            **OVERRIDES, "schgn_faithful_interleave": faithful,
            "use_gpu": False})
        if jdata is None:
            jdata = JFoodData(jcfg)
            jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
        jmodels[faithful] = jget_model("SCHGN")(jcfg, jdata)
    jparams = jax.device_get(jax.jit(jmodels[True].init_params)(
        jax.random.PRNGKey(0)))
    return jdata, jmodels, jparams


@pytest.fixture(scope="module")
def pair(synth_root):
    jdata, jmodels, jparams = _jax_side(synth_root)
    cfg, data, model = _port_model(synth_root, "SCHGN", OVERRIDES, jparams)
    return dict(jcfg=jmodels[True].config, jdata=jdata, jmodels=jmodels,
                jmodel=jmodels[True], jparams=jparams, cfg=cfg, data=data,
                model=model, synth_root=synth_root)


def _variant_pair(pair, extra, scale=False):
    """Both packages' SCHGN with the config `extra` (the port alone reads
    spmm_impl: "kernel", which the JAX package does not have), the JAX
    parameters loaded, the embedding tables scaled by PARAM_SCALE if
    `scale`. Returns (jax config, jax model, jax params, port model)."""
    from foodrec_tpu_torch.utils.weights import params_from_jax

    jmodel = pair["jmodels"][extra.get("schgn_faithful_interleave", True)]
    model = _port_model(pair["synth_root"], "SCHGN", {**OVERRIDES, **extra})[2]
    jparams = pair["jparams"]
    if scale:
        jparams = {k: (np.asarray(v) * np.float32(PARAM_SCALE)
                       if k.endswith("_embed") else v)
                   for k, v in jparams.items()}
    model.load_state_dict(params_from_jax(jparams, model))
    return jmodel.config, jmodel, jparams, model


# ---------------------------------------------------------------------------
# host layer: the graph and the calorie tables
# ---------------------------------------------------------------------------


def _hetero_edges(jds):
    """SCHGN's (src, dst, n) on the JAX package's toy dataset
    (schgn.py:93-107)."""
    nu, ni, ng = jds.n_users, jds.n_items, jds.num_ingredients
    ur, ri, rc = jds.uRecipe_triples, jds.rIngre_triples, jds.rCalories_triples
    src = np.concatenate([ur[:, 1] + nu, ri[:, 1] + nu + ni,
                          rc[:, 1] + nu + ni + ng])
    dst = np.concatenate([ur[:, 0], ri[:, 0] + nu, rc[:, 0] + nu])
    return src, dst, nu + ni + ng + jds.num_calories_level


@pytest.mark.parametrize("graph", ["toy", "isolated", "levels"])
def test_gcn_conv_adjacency_bitwise_equal(pair, graph):
    """The GCNConv normalization over a directed edge list, bit for bit with
    float64 values, and A^T built for the backward: on the toy hetero graph,
    on a random graph whose last nodes have no edge, and on 600 items over
    4 calorie levels (A^T's level rows are long)."""
    from foodrec_tpu.ops.graph import gcn_conv_adjacency as jgcn
    from foodrec_tpu.ops.graph import transpose_adjacency as jtranspose
    from foodrec_tpu_torch.ops.graph import (
        gcn_conv_adjacency,
        transpose_adjacency,
    )

    rng = np.random.default_rng(5)
    if graph == "toy":
        src, dst, n = _hetero_edges(pair["jdata"])
    elif graph == "isolated":
        src, dst, n = rng.integers(0, 40, 90), rng.integers(0, 40, 90), 43
    else:
        src, dst, n = levels_edges(rng)
    got, want = gcn_conv_adjacency(src, dst, n), jgcn(src, dst, n)
    assert got.vals.dtype == np.float64 and not got.symmetric
    assert got.nnz == len(src) + n  # every edge and every self loop
    for g_adj, w_adj in ((got, want),
                         (transpose_adjacency(got), jtranspose(want))):
        for a in ("rows", "cols", "vals"):
            g, w = getattr(g_adj, a), getattr(w_adj, a)
            assert g.dtype == w.dtype, a
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), a
        assert (g_adj.max_degree, g_adj.has_ell) == (w_adj.max_degree,
                                                      w_adj.has_ell)
        if w_adj.has_ell:
            np.testing.assert_array_equal(g_adj.ell_vals, w_adj.ell_vals)
        np.testing.assert_array_equal(
            g_adj.row_ptr, np.searchsorted(g_adj.rows, np.arange(n + 1)))


def test_calorie_tables_match_jax(pair, synth_root):
    """rCalories_triples and num_calories_level (dataset) and cal_level
    (DeviceData) equal the JAX package's, dtypes included; a model without
    the flags loads none of them."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu_torch.data.dataset import FoodData
    from foodrec_tpu_torch.data.device import DeviceData

    jds, ds = pair["jdata"], pair["data"]
    np.testing.assert_array_equal(ds.rCalories_triples, jds.rCalories_triples)
    assert ds.rCalories_triples.dtype == jds.rCalories_triples.dtype
    assert ds.num_calories_level == jds.num_calories_level == 4
    assert ds.cal_level == jds.cal_level
    got, want = ds.device_data.cal_level, jds.device_data.cal_level
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)

    jcfg, _ = make_config(synth_root, model="LightGCN",
                          overrides={"use_gpu": False})
    jother, other = JFoodData(jcfg), FoodData(_port_config(synth_root,
                                                           "LightGCN"))
    assert other.num_calories_level == jother.num_calories_level == 0
    assert not hasattr(other, "rCalories_triples")
    assert DeviceData.from_food_data(other).cal_level is None
    assert JDeviceData.from_food_data(jother, jcfg).cal_level is None


# ---------------------------------------------------------------------------
# blocks: encoder, sampler, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_bert_encoder_matches_jax(seed):
    """The post-LN encoder with the additive -1e8 mask, dropout 0: value and
    every gradient, with masked keys in some rows and one row of none."""
    from foodrec_tpu.common import module as jm
    from foodrec_tpu_torch.common import module as tm

    rng = np.random.default_rng(seed)
    b, L, d, inner, nhead = 5, 7, 16, 24, 2
    params = _perturb(jax.device_get(jm.bert_encoder_params(
        jax.random.PRNGKey(seed), d, inner, 2)), rng)
    x = rng.standard_normal((b, L, d)).astype(np.float32)
    masked = rng.random((b, L)) < 0.3
    masked[1] = False
    mask = (masked.astype(np.float32) * -1e8)[:, None, None, :]
    cot = rng.standard_normal((b, L, d)).astype(np.float32)

    from foodrec_tpu_torch.utils.weights import flatten_params

    y, vjp = jax.vjp(jax.jit(
        lambda p, x: jm.bert_encoder_apply(p, x, jnp.asarray(mask), nhead)),
        params, x)
    jgrads = flatten_params(jax.device_get(list(vjp(jnp.asarray(cot)))))
    targs = [_torch_tree(params), _torch_tree(x)]
    yt = tm.bert_encoder_apply(*targs, torch.from_numpy(mask), nhead)
    _assert_rel(yt.detach().numpy(), y, TOL, "bert encoder output")
    leaves = flatten_params(targs)
    tgrads = torch.autograd.grad((yt * torch.from_numpy(cot)).sum(),
                                 list(leaves.values()))
    for (k, _), g in zip(leaves.items(), tgrads):
        err = _grad_err(k, g.numpy(), jgrads)
        assert err <= TOL, f"bert encoder grad {k}: {err:.3e}"


def _grad_err(name, got, want):
    """|got - want| over the largest |want| of leaf `name`. A key bias
    shifts each query's logits by one constant, which the softmax ignores:
    its gradient is zero in exact arithmetic and rounding in both packages,
    so its error is taken over the query bias's gradient beside it."""
    ref = want[name.replace("k_b", "q_b")] if name.endswith("k_b") else None
    err = np.abs(np.asarray(got, np.float64) - want[name]).max()
    scale = np.abs(want[name] if ref is None else ref).max()
    return err / scale if scale > 0 else err


def test_bert_encoder_params_layout():
    """The JAX pytree's leaf names and shapes; truncated-normal std 0.01
    weights, zero biases, LayerNorms (1, 0)."""
    from foodrec_tpu.common import module as jm
    from foodrec_tpu_torch.common import module as tm

    want = jax.device_get(jm.bert_encoder_params(jax.random.PRNGKey(0), 64,
                                                 256, 2))
    got = tm.bert_encoder_params(torch.Generator().manual_seed(0), 64, 256, 2)
    assert len(got) == len(want) == 2
    for g_layer, w_layer in zip(got, want):
        assert sorted(g_layer) == sorted(w_layer)
        for k, w in w_layer.items():
            g = g_layer[k].numpy()
            assert g.shape == np.shape(w) and g.dtype == np.float32, k
            if k.endswith("_w") and not k.startswith("ln"):
                assert np.abs(g).max() <= 0.02 and 0.007 < g.std() < 0.01, k
            elif k.endswith("_g"):
                np.testing.assert_array_equal(g, 1.0)
            else:
                np.testing.assert_array_equal(g, 0.0)


def _ssl_draw(seed, codes, num, n_ingredients, device="cpu"):
    from foodrec_tpu_torch.data.sampling import ssl_mask_ingredients

    return ssl_mask_ingredients(
        codes, num, n_ingredients,
        torch.Generator(device=device).manual_seed(seed))


def test_ssl_mask_invariants():
    """Masks fall on real slots only at a rate near 0.2, carry the token
    n_ingredients + 1, and their negatives lie outside the recipe's real
    codes; pad and unmasked slots copy the code; pos_seq is the code; the
    same seed draws the same sequences, another seed others."""
    rng = np.random.default_rng(0)
    n_ing, b, L = 40, 600, 20
    num = rng.integers(1, L + 1, b)
    codes = np.full((b, L), n_ing)
    for r in range(b):
        codes[r, :num[r]] = rng.choice(n_ing, num[r], replace=False)
    codes, num = torch.from_numpy(codes), torch.from_numpy(num)
    masked, pos, neg = _ssl_draw(3, codes, num, n_ing)
    real = torch.arange(L)[None, :] < num[:, None]
    is_mask = masked == n_ing + 1
    assert torch.equal(pos, codes)
    assert not (is_mask & ~real).any()
    rate = float(is_mask.sum()) / float(real.sum())
    assert abs(rate - 0.2) < 0.02, rate
    assert torch.equal(masked[~is_mask], codes[~is_mask])
    assert torch.equal(neg[~is_mask], codes[~is_mask])
    for r, c in zip(*torch.nonzero(is_mask, as_tuple=True)):
        assert int(neg[r, c]) not in set(codes[r, :num[r]].tolist())
        assert 0 <= int(neg[r, c]) < n_ing
    again = _ssl_draw(3, codes, num, n_ing)
    assert all(torch.equal(a, b) for a, b in zip((masked, pos, neg), again))
    other = _ssl_draw(4, codes, num, n_ing)
    assert not torch.equal(other[0], masked)


def test_ssl_mask_full_recipe_takes_the_last_draw():
    """A recipe holding every ingredient has no negative: the last of the
    16 draws is taken, as in the JAX package."""
    n_ing = 6
    codes = torch.arange(n_ing)[None, :].repeat(50, 1)
    num = torch.full((50,), n_ing)
    masked, _, neg = _ssl_draw(0, codes, num, n_ing)
    is_mask = masked == n_ing + 1
    assert is_mask.any()
    assert ((neg[is_mask] >= 0) & (neg[is_mask] < n_ing)).all()


def test_truncated_normal_moments():
    """mean + std * N(0, 1) cut at +-2 std (not rescaled): within the cut,
    and the truncated normal's moments (std 0.8796 std), against the JAX
    package's draw's; tn_linear's shapes and stds."""
    from foodrec_tpu.common.init import truncated_normal as jtn
    from foodrec_tpu_torch.common.init import tn_linear, truncated_normal

    g = torch.Generator().manual_seed(0)
    t = truncated_normal((400_000,), g, mean=0.5, std=0.01).numpy()
    j = np.asarray(jtn(jax.random.PRNGKey(0), (400_000,), mean=0.5,
                       std=0.01))
    for x in (t, j):
        assert x.dtype == np.float32
        assert np.abs(x - 0.5).max() <= 0.02 + 1e-7
        assert abs(x.mean() - 0.5) < 1e-4
        assert abs(x.std() / 0.01 - 0.87963) < 5e-3
    assert abs(t.std() - j.std()) < 5e-5
    p = tn_linear(12, 5, g, 0.1, 0.3)
    assert p["w"].shape == (12, 5) and p["b"].shape == (5,)
    assert "b" not in tn_linear(12, 1, g, 0.1, bias=False)


# ---------------------------------------------------------------------------
# the model: parameters, serving
# ---------------------------------------------------------------------------


def test_config_and_registry(pair):
    from foodrec_tpu_torch.models import PORTED, get_model

    assert pair["cfg"].final_config_dict == pair["jcfg"].final_config_dict
    assert pair["cfg"]["schgn_faithful_interleave"] is True
    assert "SCHGN" in PORTED and get_model("SCHGN").__name__ == "SCHGN"
    assert type(pair["model"]).eval_batch_cap == 32


def test_params_from_jax_carries_every_leaf(pair):
    """Every one of the 52 leaves of the JAX init_params (schgn.py:120-150)
    lands in the port's state_dict under its name, with its values."""
    from foodrec_tpu_torch.utils.weights import flatten_params

    flat = flatten_params(pair["jparams"])
    state = pair["model"].state_dict()
    top = ["user_embed", "item_embed", "ingre_embed_first",
           "ingre_embed_mask", "health_embed", "gcn.w", "gcn.b",
           "img_trans.w", "img_trans.b", "W_att_ingre.w", "W_att_ingre.b",
           "h_att_ingre.w", "W_att_comp.w", "W_att_comp.b", "h_att_comp.w",
           "W_concat.w", "W_concat.b", "output_mlp.w", "mip_norm.w",
           "mip_norm.b"]
    layer = ["q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "dense_w", "dense_b",
             "ff1_w", "ff1_b", "ff2_w", "ff2_b", "ln1_g", "ln1_b", "ln2_g",
             "ln2_b"]
    names = top + [f"encoder.{i}.{k}" for i in range(2) for k in layer]
    assert len(names) == 52
    assert sorted(state) == sorted(flat) == sorted(names)
    for k, v in flat.items():
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_eval_cache_matches_jax(pair, impl):
    _, jmodel, jparams, model = _variant_pair(pair, {"spmm_impl": impl})
    got = model.eval_cache()
    want = jmodel.eval_cache(jparams)
    assert len(got) == len(want) == 4
    for g, w, side in zip(got, want, ("users", "items", "ingredients",
                                      "levels")):
        assert not g.requires_grad
        _assert_rel(g.numpy(), np.asarray(w), TOL, f"eval_cache {side}")


@pytest.mark.parametrize("faithful", [True, False])
def test_score_from_cache_matches_jax(pair, faithful):
    """[7, 9] candidate blocks (B not a multiple of 4, so the faithful
    interleave mixes the scores across samples), and score_items against
    one shared item list, which the JAX package scores as a broadcast
    block."""
    _, jmodel, jparams, model = _variant_pair(
        pair, {"schgn_faithful_interleave": faithful})
    rng = np.random.default_rng(2)
    users = rng.integers(0, model.n_users, 7)
    cand = rng.integers(0, model.n_items, (7, 9))
    jcache, cache = jmodel.eval_cache(jparams), model.eval_cache()
    want = np.asarray(jmodel.score_from_cache(jparams, jcache, users, cand))
    got = model.score_from_cache(cache, torch.from_numpy(users),
                                 torch.from_numpy(cand)).numpy()
    _assert_rel(got, want, TOL, "score_from_cache")
    items = rng.integers(0, model.n_items, 9)
    want_items = np.asarray(jmodel.score_from_cache(
        jparams, jcache, users, np.broadcast_to(items, (7, 9))))
    got_items = model.score_items(cache, torch.from_numpy(users),
                                  torch.from_numpy(items)).numpy()
    _assert_rel(got_items, want_items, TOL, "score_items")
    # the faithful interleave mixes samples: one user less moves the other
    # users' scores; the per-sample fix leaves them
    fewer = model.score_from_cache(cache, torch.from_numpy(users[:6]),
                                   torch.from_numpy(cand[:6])).numpy()
    moved = np.abs(fewer - got[:6]).max() / np.abs(got).max()
    assert moved > 1e-3 if faithful else moved < TOL


def test_full_sort_predict_matches_jax(pair):
    """A block of 7 users (not a multiple of 4, so the faithful interleave
    mixes the scores across users) against every item from a fresh _gcn():
    the JAX package's full_sort_predict within 1e-5, score_items over the
    same block and all items bitwise; one user alone as the JAX package
    scores it, which differs from that user's row of the block."""
    _, jmodel, jparams, model = _variant_pair(pair, {})
    users = np.arange(2, 9)
    predict = jax.jit(jmodel.full_sort_predict)
    got = model.full_sort_predict(torch.from_numpy(users))
    assert got.shape == (7, model.n_items) and not got.requires_grad
    _assert_rel(got.numpy(), np.asarray(predict(jparams, users)), TOL,
                "full_sort_predict")
    block = model.score_items(model.eval_cache(), torch.from_numpy(users),
                              torch.arange(model.n_items))
    assert torch.equal(got, block)
    one = model.full_sort_predict(torch.tensor(users[1]))
    assert one.shape == (model.n_items,)
    _assert_rel(one.numpy(), np.asarray(predict(jparams, users[1])), TOL,
                "full_sort_predict of one user")
    moved = np.abs(one.numpy() - got[1].numpy()).max()
    assert moved > 1e-3 * np.abs(got.numpy()).max()


def test_evaluate_matches_jax_with_a_partial_last_block(pair):
    """Trainer.evaluate on valid and test: the toy's 24 users make one
    block of 32 (eval_batch_cap) padded with user 0, as the JAX package
    pads it, and the metrics agree within 1e-6; scored at the users' own
    count, the faithful interleave gives other scores."""
    from foodrec_tpu.engine.trainer import Trainer as JTrainer
    from foodrec_tpu_torch.engine.trainer import Trainer

    jcfg, jmodel, jparams, model = _variant_pair(pair, {}, scale=True)
    jdd, dd = pair["jdata"].device_data, model.dd
    jcache, cache = jmodel.eval_cache(jparams), model.eval_cache()
    jtrainer, trainer = JTrainer(jcfg, jmodel), Trainer(model.config, model)
    for split, is_test in (("eval_valid", False), ("eval_test", True)):
        es = getattr(jdd, split)
        assert es.n_users % model.eval_batch_cap
        pad = model.eval_batch_cap - es.n_users
        users = np.concatenate([es.users, np.zeros(pad, es.users.dtype)])
        cand = np.concatenate([es.cand, np.zeros((pad, es.width),
                                                  es.cand.dtype)])
        scores = np.asarray(jmodel.score_from_cache(jparams, jcache, users,
                                                    cand))[:es.n_users]
        got_scores = model.score_from_cache(
            cache, torch.as_tensor(users).long(),
            torch.as_tensor(cand).long()).numpy()[:es.n_users]
        unpadded = model.score_from_cache(
            cache, torch.as_tensor(es.users).long(),
            torch.as_tensor(es.cand).long()).numpy()
        noise = np.abs(got_scores - scores).max()
        assert np.abs(unpadded - scores).max() > 100 * noise
        # premise: the two frameworks' score differences cannot reorder a
        # positive/negative pair
        for b in range(es.n_users):
            p, c = es.n_pos[b], es.n_cand[b]
            if p:
                gap = np.abs(scores[b, :p, None] - scores[b, None, p:c]).min()
                assert gap > 2 * noise, (split, b, gap, noise)
        want = jtrainer.evaluate(jparams, es, is_test=is_test)
        got = trainer.evaluate(getattr(dd, split), is_test=is_test)
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - float(want[k])) <= 1e-6, (split, k)


def test_full_sort_topk_matches_jax(pair):
    """Top-10 ids over 60 items in chunks of 16 (the last one padded with
    clamped ids) for 24 users in blocks of 5 (the last one padded), equal
    to the JAX package's sweep."""
    from foodrec_tpu.engine.topk_evaluator import full_sort_topk as jtopk
    from foodrec_tpu_torch.engine.topk_evaluator import full_sort_topk

    _, jmodel, jparams, model = _variant_pair(pair, {}, scale=True)
    n_items, users, k = model.n_items, np.arange(model.n_users), 10
    assert n_items % 16 and len(users) % 5
    jparams = jax.tree.map(jnp.asarray, jparams)  # traced item ids index it
    jcache, cache = jmodel.eval_cache(jparams), model.eval_cache()
    want = jtopk(lambda u, c: jmodel.score_from_cache(jparams, jcache, u, c),
                 users, n_items, k, user_batch=5, item_chunk=16)
    got = full_sort_topk(lambda u, i: model.score_items(cache, u, i), users,
                         n_items, k, user_batch=5, item_chunk=16, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the padded blocks with a dot-product model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lightgcn(synth_root):
    from foodrec_tpu_torch.data.dataset import FoodData
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.models import get_model

    cfg = _port_config(synth_root, "LightGCN")
    data = FoodData(cfg)
    data.device_data = DeviceData.from_food_data(data)
    model = get_model("LightGCN")(cfg, data, torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.user_embedding.mul_(PARAM_SCALE)
    return model


@pytest.mark.parametrize("split", ["eval_valid", "eval_test"])
def test_evaluator_padding_leaves_dot_product_metrics_unchanged(lightgcn,
                                                                split):
    """LightGCN scores each user on its own: the metrics are the same
    whether the last block is padded (blocks of 7 and 11) or not (one
    block of 256)."""
    import functools

    from foodrec_tpu_torch.engine.evaluator import evaluate_by_user

    es = getattr(lightgcn.dd, split)
    score = functools.partial(lightgcn.score_from_cache, lightgcn.eval_cache())
    want = evaluate_by_user(score, es, 20, batch_size=256, device="cpu")
    for bs in (7, 11):
        assert es.n_users % bs
        assert evaluate_by_user(score, es, 20, batch_size=bs,
                                device="cpu") == want


def test_topk_padding_leaves_dot_product_ids_unchanged(lightgcn):
    from foodrec_tpu_torch.engine.topk_evaluator import full_sort_topk

    cache = lightgcn.eval_cache()
    users = np.arange(lightgcn.n_users)

    def top(**kw):
        return full_sort_topk(lambda u, i: lightgcn.score_items(cache, u, i),
                              users, lightgcn.n_items, 10, device="cpu", **kw)

    want = top()
    assert torch.equal(top(user_batch=5, item_chunk=16), want)
    assert torch.equal(top(user_batch=7, item_chunk=13), want)
    # fewer items than k: the -inf pad slots come last, with the clamped id
    few = full_sort_topk(lambda u, i: lightgcn.score_items(cache, u, i),
                         users[:3], 4, 6, item_chunk=3, device="cpu")
    assert sorted(few[0, :4].tolist()) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _batch(dd, seed, b=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, dd.num_users, b), rng.integers(0, dd.n_items, b),
            rng.integers(0, dd.n_items, b))


@functools.lru_cache
def _jax_ssl_sampler(n_ingredients):
    from foodrec_tpu.data.sampling import ssl_mask_ingredients as jssl

    return jax.jit(functools.partial(jssl, n_ingredients=n_ingredients))


def _ssl_seqs(jmodel, pos, seed):
    """The JAX package's on-device SSL draw for the positives, as numpy."""
    dd = jmodel.dd
    return tuple(np.asarray(s) for s in _jax_ssl_sampler(jmodel.n_ingredients)(
        jax.random.PRNGKey(seed), jnp.asarray(dd.ingre_codes[pos]),
        jnp.asarray(dd.ingre_num[pos])))


_JAX_GRAD_FNS = {}  # one jit per JAX model and buffer binding


def _jax_parts_and_grads(jmodel, params, u, p, n, seqs, dtype=jnp.float32,
                         buffers=None):
    key = (id(jmodel), buffers is None)
    if key not in _JAX_GRAD_FNS:
        def fn(params, batch):
            batch = {**batch, "deterministic": True}
            if buffers is None:
                parts = jmodel.calculate_loss(params, batch)
            else:
                with jmodel.bind(buffers):
                    parts = jmodel.calculate_loss(params, batch)
            return sum(parts), jnp.stack(parts)

        _JAX_GRAD_FNS[key] = jax.jit(jax.value_and_grad(fn, has_aux=True))
    batch = {"u_id": jnp.asarray(u, jnp.int32),
             "pos_i_id": jnp.asarray(p, jnp.int32),
             "neg_i_id": jnp.asarray(n, jnp.int32),
             "weight": jnp.ones(len(u), dtype), "key": jax.random.PRNGKey(0),
             "ssl_masked_seq": jnp.asarray(seqs[0]),
             "ssl_pos_seq": jnp.asarray(seqs[1]),
             "ssl_neg_seq": jnp.asarray(seqs[2])}
    (_, parts), grads = _JAX_GRAD_FNS[key](params, batch)
    return np.asarray(parts), jax.device_get(grads)


def _port_parts_and_grads(model, u, p, n, seqs):
    model.zero_grad(set_to_none=True)
    parts = model.calculate_loss(
        *(torch.as_tensor(a).long() for a in (u, p, n)), deterministic=True,
        ssl_seqs=tuple(torch.tensor(s).long() for s in seqs))
    sum(parts).backward()
    return (torch.stack(parts).detach().numpy(),
            {k: v.grad for k, v in model.named_parameters()})


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("vid", [v[0] for v in LOSS_VARIANTS])
def test_calculate_loss_matches_jax(pair, vid, seed):
    """(bpr, reg, ssl) and every parameter's gradient in float32, with the
    same SSL sequences and no dropout, both packages also against the port
    in float64; the ssl part and the encoder's gradients are not zero. The
    parameters are the JAX init's plus noise 0.1: at the init itself the
    ingredient attention's logits are nearly equal over the slots, so the
    gradient of its bias is a sum that nearly cancels, and each package's
    float32 gradient lies up to 7.5e-5 from float64 there (measured); the
    float64 certificate holds the init's mathematics."""
    from foodrec_tpu_torch.utils.weights import flatten_params

    from foodrec_tpu_torch.utils.weights import params_from_jax

    extra = dict(LOSS_VARIANTS)[vid]
    _, jmodel, _, model = _variant_pair(pair, extra)
    params = _perturb(pair["jparams"], np.random.default_rng(seed))
    model.load_state_dict(params_from_jax(params, model))
    model64 = _port_model(pair["synth_root"], "SCHGN", {**OVERRIDES, **extra},
                          params, dtype=torch.float64)[2]
    u, p, n = _batch(model.dd, seed)
    seqs = _ssl_seqs(jmodel, p, seed)
    jparts, jgrads = _jax_parts_and_grads(
        jmodel, jax.tree.map(jnp.asarray, params), u, p, n, seqs)
    parts, grads = _port_parts_and_grads(model, u, p, n, seqs)
    _, grads64 = _port_parts_and_grads(model64, u, p, n, seqs)
    assert len(parts) == 3 and parts[2] > 0
    for i, (a, b) in enumerate(zip(parts, jparts)):
        _assert_rel(a, b, TOL, f"loss part {i}")
    jflat = flatten_params(jgrads)
    assert sorted(jflat) == sorted(grads)
    flat64 = {k: g.numpy() for k, g in grads64.items()}
    for k, g in grads.items():
        for got, want, what in ((g.numpy(), jflat, "jax"),
                                (g.numpy(), flat64, "port f64"),
                                (jflat[k], flat64, "jax against port f64")):
            err = _grad_err(k, got, want)
            assert err <= GRAD_TOL, f"grad {k} {what}: {err:.3e}"
    assert float(grads["encoder.1.ff2_w"].abs().max()) > 0


def test_dropout_and_ssl_draw_from_the_generator(pair):
    """Training draws the score dropout, the SSL masks and the encoder's
    dropout from the generator: the same seed gives the same loss parts,
    another seed others; `deterministic` with injected sequences draws
    nothing; serving draws nothing."""
    model = _port_model(pair["synth_root"], "SCHGN", {},
                        pair["jparams"])[2]
    u, p, n = (torch.as_tensor(a).long() for a in _batch(model.dd, 0))

    def parts(seed, **kw):
        with torch.no_grad():
            return torch.stack(model.calculate_loss(
                u, p, n, generator=torch.Generator().manual_seed(seed), **kw))

    assert torch.equal(parts(3), parts(3))
    assert not torch.equal(parts(3)[0], parts(4)[0])
    assert not torch.equal(parts(3)[2], parts(4)[2])
    seqs = tuple(torch.tensor(s).long() for s in _ssl_seqs(
        pair["jmodel"], p.numpy(), 0))
    model.hidden_dropout = model.attn_dropout = 0.0
    assert torch.equal(parts(3, deterministic=True, ssl_seqs=seqs),
                       parts(4, deterministic=True, ssl_seqs=seqs))
    x, y = model.eval_cache(), model.eval_cache()
    assert all(torch.equal(s, t) for s, t in zip(x, y))


def test_train_epoch_and_fit(pair):
    """Trainer.train_epoch on SCHGN: one Adam step a batch, three finite
    loss parts; fit runs an epoch, evaluates and restores the best."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg, data, model = _port_model(pair["synth_root"], "SCHGN",
                                   {"epochs": 1, "eval_step": 1})
    trainer = Trainer(cfg, model)
    before = model.user_embed.detach().clone()
    parts = trainer.train_epoch()
    assert parts.shape == (3,) and torch.isfinite(parts).all()
    assert not torch.equal(before, model.user_embed)
    valid, _, test = trainer.fit(data)
    assert 0 <= valid <= 1
    assert all(0 <= v <= 1 for v in test.values())


# ---------------------------------------------------------------------------
# float64 certificate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def x64_run(synth_root, tmp_path_factory):
    """This file run as a script under JAX_ENABLE_X64, started with the
    module's first test so that it runs beside the float32 tests; killed
    at teardown if nothing waited for it."""
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "True",
                "OMP_NUM_THREADS": "1",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    out_dir = tmp_path_factory.mktemp("x64_schgn")
    paths = out_dir / "stdout.txt", out_dir / "stderr.txt"
    with open(paths[0], "w") as out, open(paths[1], "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), synth_root[0]],
            cwd=REPO, env=env, stdout=out, stderr=err, text=True)
    yield proc, paths
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def x64_report(x64_run):
    proc, (out, err) = x64_run
    proc.wait(timeout=600)
    stdout, stderr = out.read_text(), err.read_text()
    assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
    return stdout


@pytest.mark.parametrize("vid", [v[0] for v in LOSS_VARIANTS])
def test_calculate_loss_float64_certificate(x64_report, vid):
    """The port in torch.float64 against the JAX package under
    JAX_ENABLE_X64: loss parts and every gradient within 1e-9 relative."""
    assert f"certificate {vid} pass_1e-9=True" in x64_report, \
        x64_report[-3000:]


def test_full_sort_predict_float64_certificate(x64_report):
    """full_sort_predict in torch.float64 for a block of 7 users in faithful
    mode against the JAX package's under JAX_ENABLE_X64: scores within
    1e-9 relative, equal top-50 ids."""
    assert "full_sort_predict pass_1e-9=True" in x64_report, \
        x64_report[-3000:]


_JAX_SIDES = {}  # the subprocess builds the JAX side once


def _certificate(root, vid):
    from foodrec_tpu_torch.utils.weights import flatten_params

    synth = (root, {"neg_num": 20})
    extra = dict(LOSS_VARIANTS)[vid]
    if root not in _JAX_SIDES:
        _JAX_SIDES[root] = _jax_side(synth)
    _, jmodels, jparams = _JAX_SIDES[root]
    jmodel = jmodels[extra.get("schgn_faithful_interleave", True)]
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
    buf64 = _buffers64(jmodel)
    model = _port_model(synth, "SCHGN", {**OVERRIDES, **extra}, jparams,
                        dtype=torch.float64)[2]
    prop = model.gcn_prop
    held = [prop.t_vals] if prop.impl == "kernel" else []
    assert all(t.dtype == torch.float64 for t in held + [model.img])
    worst_parts = worst_grads = 0.0
    for seed in (0, 1):
        u, p, n = _batch(model.dd, seed)
        seqs = _ssl_seqs(jmodel, p, seed)
        jparts, jgrads = _jax_parts_and_grads(jmodel, params64, u, p, n, seqs,
                                              dtype=jnp.float64,
                                              buffers=buf64)
        parts, grads = _port_parts_and_grads(model, u, p, n, seqs)
        assert parts.dtype == np.float64
        worst_parts = max([worst_parts] + [_rel_err(a, b)
                                           for a, b in zip(parts, jparts)])
        jflat = flatten_params(jgrads)
        for k, g in grads.items():
            assert g.dtype == torch.float64, k
            worst_grads = max(worst_grads, _grad_err(k, g.numpy(), jflat))
    ok = worst_parts <= 1e-9 and worst_grads <= 1e-9
    print(f"certificate {vid} worst_parts={worst_parts:.3e} "
          f"worst_grads={worst_grads:.3e}")
    print(f"certificate {vid} pass_1e-9={ok}", flush=True)


def _full_sort_certificate(root, k=50):
    synth = (root, {"neg_num": 20})
    _, jmodels, jparams = _JAX_SIDES[root]
    jmodel = jmodels[True]
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
    model = _port_model(synth, "SCHGN", OVERRIDES, jparams,
                        dtype=torch.float64)[2]
    users = np.arange(2, 9)
    with jmodel.bind(_buffers64(jmodel)):
        want = np.asarray(jmodel.full_sort_predict(params64, users))
    got = model.full_sort_predict(torch.from_numpy(users)).numpy()
    assert got.dtype == want.dtype == np.float64
    err = _rel_err(got, want)

    def top(scores):
        return np.argsort(-scores, axis=1, kind="stable")[:, :k]

    same = bool((top(got) == top(want)).all())
    print(f"full_sort_predict worst={err:.3e} top{k}_equal={same}")
    print(f"full_sort_predict pass_1e-9={err <= 1e-9 and same}", flush=True)


if __name__ == "__main__":
    for v in LOSS_VARIANTS:
        _certificate(sys.argv[1], v[0])
    _full_sort_certificate(sys.argv[1])
