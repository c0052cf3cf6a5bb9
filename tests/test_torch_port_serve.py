"""PyTorch port, serving slice: CIKM_Model with the JAX package's parameters
(carried over by params_from_jax) gives the same embeddings, metrics and
top-k as the JAX package on the same synthetic dataset.

The by-user metrics' cases run on the CPU against the JAX package and,
marked `cuda`, on the card, where the kernel is held to the plain path bit
for bit."""

import ctypes
import os
import re
import types

import jax
import numpy as np
import pytest
import torch

from conftest import make_config
from foodrec_tpu_torch.ops import _kernels
from torch_port_fixtures import device  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6   # float32 SpMM sums taken in other orders
# params are scaled up so that scores spread well beyond float32 noise and
# the premise below (no pos/neg score pair closer than 1e-4) holds
PARAM_SCALE = 8.0


@pytest.fixture(scope="module")
def served(synth_root):
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.models import get_model as jget_model
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.models import get_model
    from foodrec_tpu_torch.utils.weights import params_from_jax

    jcfg, meta = make_config(synth_root, model="CIKM_Model")
    jdata = JFoodData(jcfg)
    jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
    jmodel = jget_model("CIKM_Model")(jcfg, jdata)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    for k in ("user_embedding", "item_embedding", "ingre_embedding"):
        jparams[k] = np.asarray(jparams[k]) * np.float32(PARAM_SCALE)

    root = synth_root[0]
    cfg = Config("CIKM_Model", "Synth", {
        "data_path": root.rsplit("/Synth", 1)[0] + "/",
        "neg_sample_num": meta["neg_num"], "use_gpu": False})
    derive_data_paths(cfg, "Synth")
    data = FoodData(cfg)
    dd = data.device_data = DeviceData.from_food_data(data)
    model = get_model("CIKM_Model")(cfg, data)
    model.load_state_dict(params_from_jax(jparams, model))
    return dict(jcfg=jcfg, jdata=jdata, jmodel=jmodel, jparams=jparams,
                cfg=cfg, dd=dd, model=model, data=data)


def test_params_from_jax_carries_every_leaf(served):
    """Every leaf of the JAX pytree, nested ones included, lands in the
    port's state_dict under its dotted path with the same values, and the
    state_dict holds the full CIKM_Model key set and nothing else."""
    from foodrec_tpu_torch.utils.weights import flatten_params

    flat = flatten_params(served["jparams"])
    state = served["model"].state_dict()
    assert sorted(state) == sorted(flat)
    n_layers = served["cfg"]["num_hidden_layers"]
    encoder_keys = ("ff1_b", "ff1_w", "ff2_b", "ff2_w", "in_proj_b",
                    "in_proj_w", "ln1_b", "ln1_g", "ln2_b", "ln2_g",
                    "out_proj_b", "out_proj_w")
    assert sorted(state) == sorted(
        ["user_embedding", "item_embedding", "ingre_embedding",
         "image_embedding", "text_embedding",
         "image_trs.w", "image_trs.b", "text_trs.w", "text_trs.b",
         "health_mlp.l1.w", "health_mlp.l1.b", "health_mlp.l2.w",
         "health_mlp.l2.b", "mm_target_atten.ln_g", "mm_target_atten.ln_b",
         "ingre_target_atten.ln_g", "ingre_target_atten.ln_b"]
        + [f"encoder.{i}.{k}" for i in range(n_layers) for k in encoder_keys])
    for name, arr in flat.items():
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(arr),
                                      err_msg=name)


def test_params_from_jax_rejects_bad_trees(served):
    from foodrec_tpu_torch.utils.weights import params_from_jax

    params = dict(served["jparams"])
    with pytest.raises(KeyError, match="unknown"):
        params_from_jax({**params, "mystery": np.zeros(3)}, served["model"])
    with pytest.raises(KeyError, match="missing"):
        params_from_jax({k: v for k, v in params.items() if k != "health_mlp"},
                        served["model"])
    params["item_embedding"] = params["item_embedding"][:-1]
    with pytest.raises(ValueError, match="item_embedding"):
        params_from_jax(params, served["model"])


@pytest.mark.parametrize("impl", ["auto", "segment", "kernel"])
def test_eval_cache_matches_jax(served, impl):
    from foodrec_tpu_torch.models import get_model

    cfg = served["cfg"]
    cfg["spmm_impl"] = impl
    try:
        model = get_model("CIKM_Model")(cfg, served["data"])
    finally:
        cfg["spmm_impl"] = "auto"
    model.load_state_dict(served["model"].state_dict())
    user, item = model.eval_cache()
    juser, jitem = served["jmodel"].eval_cache(served["jparams"])
    np.testing.assert_allclose(user.numpy(), np.asarray(juser),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(item.numpy(), np.asarray(jitem),
                               rtol=RTOL, atol=ATOL)
    assert not user.requires_grad


def test_eval_cache_bf16_matches_jax(served, synth_root):
    """spmm_dtype bfloat16: the port's kernel impl (its plain version on the
    CPU) against the JAX package's Pallas path (interpret mode), both with x
    rounded to bf16 before each of the three hops and f32 sums, on the same
    parameters."""
    from foodrec_tpu.models import get_model as jget_model
    from foodrec_tpu_torch.models import get_model

    jcfg, _ = make_config(synth_root, model="CIKM_Model", overrides={
        "spmm_dtype": "bfloat16", "spmm_impl": "pallas"})
    jmodel = jget_model("CIKM_Model")(jcfg, served["jdata"])
    cfg = served["cfg"]
    cfg["spmm_impl"], cfg["spmm_dtype"] = "kernel", "bfloat16"
    try:
        model = get_model("CIKM_Model")(cfg, served["data"])
    finally:
        cfg["spmm_impl"], cfg["spmm_dtype"] = "auto", None
    assert model.ui_prop.bf16 and model.ri_prop.bf16
    assert jmodel.ui_prop.impl == jmodel.ri_prop.impl == "pallas"
    model.load_state_dict(served["model"].state_dict())
    user, item = model.eval_cache()
    juser, jitem = jmodel.eval_cache(served["jparams"])
    np.testing.assert_allclose(user.numpy(), np.asarray(juser),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(item.numpy(), np.asarray(jitem),
                               rtol=RTOL, atol=ATOL)
    # the rounding is there: float32 gives other embeddings at this bar
    user32, _ = served["model"].eval_cache()
    assert not np.allclose(user.numpy(), user32.numpy(), rtol=RTOL,
                           atol=ATOL)


def _metric_inputs(seed):
    rng = np.random.default_rng(seed)
    b, c, neg_num = 9, 64, 40
    n_pos = rng.integers(0, 8, size=b).astype(np.int32)
    n_cand = (n_pos + rng.integers(10, c - 8, size=b)).astype(np.int32)
    scores = rng.normal(size=(b, c)).astype(np.float32)
    # coarse grid: many exact ties between positives and negatives
    scores[:4] = np.round(scores[:4] * 2) / 2
    scores[4] = 0.25  # one user with every score tied: positives win
    return scores, n_pos, n_cand, neg_num


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_by_user_metrics_exactly_equal_to_jax(seed):
    from foodrec_tpu.engine.evaluator import by_user_metrics as jmetrics
    from foodrec_tpu_torch.engine.evaluator import by_user_metrics

    scores, n_pos, n_cand, neg_num = _metric_inputs(seed)
    want = jmetrics(scores, n_pos, n_cand, neg_num=neg_num)
    got = by_user_metrics(torch.from_numpy(scores),
                          torch.from_numpy(n_pos).long(),
                          torch.from_numpy(n_cand).long(), neg_num=neg_num)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(w := want[k])
        assert g.dtype == np.float32, k
        assert np.array_equal(g, w), (k, g, w)
    tied = 4
    if n_pos[tied]:
        assert got["recall@20"][tied] == min(20, n_pos[tied]) / n_pos[tied]
        assert got["auc"][tied] == 0


BY_USER_CASES = ("pos_neg_ties", "signed_zeros", "nan_inf", "few_candidates",
                 "no_positives", "many_positives", "odd_width")
# the main path's by-user block: users x slots (Foodcom's 8-16 test
# positives a user, ~500 negatives); 7,596 test users leave the last block
# with 172 real rows
METRIC_BLOCK = (256, 640)
METRIC_NEG = 500
METRIC_CASES = BY_USER_CASES + ("main 256x640", "last padded block")


def by_user_case(name, seed=999):
    """One case of the by-user metrics, as numpy: (scores float32 [B, C],
    n_pos int64 [B], n_cand int64 [B], neg_num)."""
    rng = np.random.default_rng([seed, METRIC_CASES.index(name)])
    if name in ("main 256x640", "last padded block"):
        b, c = METRIC_BLOCK
        n_pos = rng.integers(8, 17, b)
        n_cand = n_pos + METRIC_NEG - rng.integers(0, 4, b)
        scores = rng.standard_normal((b, c)).astype(np.float32)
        if name == "last padded block":  # pad rows score user 0's first slot
            n_pos[172:] = n_cand[172:] = 0
            scores[172:] = scores[0, 0]
        return scores, n_pos, n_cand, METRIC_NEG
    b, neg_num = 12, 40
    c = {"odd_width": 37, "many_positives": 96}.get(name, 64)
    n_pos = rng.integers(1, 9, b)
    if name == "no_positives":
        n_pos[:] = 0
    elif name == "many_positives":
        n_pos = rng.integers(21, 48, b)
    n_cand = np.minimum(n_pos + rng.integers(12, c, b), c)
    if name == "few_candidates":
        n_cand = np.minimum(n_pos + rng.integers(0, 12, b), 19)
    scores = rng.standard_normal((b, c)).astype(np.float32)
    if name == "pos_neg_ties":
        scores = np.round(scores * 2) / 2  # a coarse grid: many ties
        scores[0] = 0.25                   # every score tied: positives win
    elif name == "signed_zeros":
        scores[:, :] = np.where(rng.random((b, c)) < 0.5, scores, 0.0)
        neg_zero = np.copysign(np.float32(0), -1)
        for row in range(b):  # -0.0 positives over +0.0 negatives, and back
            pos_zero = row % 2 == 0
            scores[row, :n_pos[row]] = neg_zero if pos_zero else 0.0
            rest = scores[row, n_pos[row]:] == 0
            scores[row, n_pos[row]:][rest] = 0.0 if pos_zero else neg_zero
    elif name == "nan_inf":
        special = np.float32([np.nan, np.copysign(np.nan, -1), np.inf,
                              -np.inf])
        hit = rng.random((b, c)) < 0.3
        scores[hit] = rng.choice(special, int(hit.sum()))
    elif name == "no_positives":
        n_cand[: b // 3] = 0   # the pad rows of a last block
        scores[: b // 3] = scores[0, 0]
    return scores, n_pos.astype(np.int64), n_cand.astype(np.int64), neg_num


# what each case has to hold for the test to mean anything
_CASE_PREMISE = {
    "pos_neg_ties": lambda s, p, n: any(
        np.isin(s[r, :p[r]], s[r, p[r]:n[r]]).any() for r in range(len(s))),
    "signed_zeros": lambda s, p, n: (np.signbit(s) & (s == 0)).any()
    and (~np.signbit(s) & (s == 0)).any(),
    "nan_inf": lambda s, p, n: np.isnan(s).any() and np.isposinf(s).any()
    and np.isneginf(s).any() and np.signbit(s[np.isnan(s)]).any(),
    "few_candidates": lambda s, p, n: n.max() < 20,
    "no_positives": lambda s, p, n: (p == 0).all() and (n == 0).any(),
    "many_positives": lambda s, p, n: p.min() > 20,
    "odd_width": lambda s, p, n: s.shape[1] % 4 != 0,
    "main 256x640": lambda s, p, n: s.shape == METRIC_BLOCK
    and p.min() >= 8 and p.max() <= 16 and n.min() > METRIC_NEG,
    "last padded block": lambda s, p, n: s.shape == METRIC_BLOCK
    and (n[172:] == 0).all() and (n[:172] > 0).all(),
}


@pytest.mark.parametrize("case", METRIC_CASES)
def test_by_user_metrics_edge_cases_equal_jax(case, device):
    """On the CPU the plain path equals the JAX package bit for bit; on the
    card the kernel (one launch a call) equals the plain path bit for bit,
    twice. The cases: positives tied with negatives, -0.0 against +0.0,
    NaN of both signs and +-inf, n_cand < 20, n_pos = 0 with pad rows,
    n_pos > 20, a width that is not a multiple of 4, and the main path's
    256 x 640 block, whole and as the last block, padded."""
    from foodrec_tpu_torch.engine.evaluator import (
        by_user_metrics,
        by_user_metrics_plain,
    )

    scores, n_pos, n_cand, neg_num = by_user_case(case)
    assert _CASE_PREMISE[case](scores, n_pos, n_cand)
    host = [torch.from_numpy(a) for a in (scores, n_pos, n_cand)]
    if device == "cpu":
        from foodrec_tpu.engine.evaluator import by_user_metrics as jmetrics

        want = jmetrics(scores, n_pos.astype(np.int32),
                        n_cand.astype(np.int32), neg_num=neg_num)
        runs = [by_user_metrics(*host, neg_num=neg_num)]
    else:
        want = by_user_metrics_plain(*host, neg_num)
        before = _kernels.launches["by_user_metrics"]
        runs = [by_user_metrics(*(t.to(device) for t in host), neg_num)
                for _ in "12"]
        assert _kernels.launches["by_user_metrics"] - before == 2
    for got in runs:
        assert sorted(got) == sorted(want)
        for k in want:
            g, w = got[k].cpu().numpy(), np.asarray(want[k])
            assert g.dtype == w.dtype == np.float32, k
            assert np.array_equal(g.view(np.int32), w.view(np.int32)), (k, g,
                                                                        w)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """On the CPU, by_user_metrics and evaluate_by_user run the plain path
    and launch nothing; the kernel's launcher refuses CPU tensors."""
    from foodrec_tpu_torch.engine import evaluator

    scores, n_pos, n_cand, neg_num = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in by_user_case("pos_neg_ties"))
    with pytest.raises(ValueError, match="CUDA device"):
        _kernels.by_user_metrics(scores, n_pos, n_cand,
                                 evaluator._rank_gains(), neg_num,
                                 evaluator._MASKED_KEY)

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(_kernels, "by_user_metrics", refuse)
    monkeypatch.setattr(_kernels, "_entry", refuse)
    monkeypatch.setitem(_kernels.launches, "by_user_metrics", 0)
    want = evaluator.by_user_metrics(scores, n_pos, n_cand, neg_num)
    plain = evaluator.by_user_metrics_plain(scores, n_pos, n_cand, neg_num)
    b, c = scores.shape
    eval_set = types.SimpleNamespace(
        n_users=b, users=np.arange(b), cand=np.arange(b * c).reshape(b, c),
        n_pos=n_pos.numpy(), n_cand=n_cand.numpy())
    _, metrics, per_user, preds = evaluator.evaluate_by_user(
        lambda users, cand: scores[users], eval_set, neg_num, batch_size=5,
        device="cpu", return_per_user=True)  # 12 users: the last block padded
    assert _kernels.launches["by_user_metrics"] == 0
    assert np.array_equal(preds, scores.numpy())
    for k in want:
        assert torch.equal(want[k], plain[k]), k
        assert per_user[k].flags.c_contiguous, k
        assert np.array_equal(per_user[k], want[k].numpy()), k
    assert metrics["NDCG@20"] == float(want["ndcg@20"].numpy().mean())


_C_TYPES = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
            "int": ctypes.c_int}


@pytest.mark.parametrize("name", sorted(_kernels.KERNELS))
def test_kernel_argtypes_match_the_c_entry_point(name):
    """Each KERNELS entry's ctypes argtypes follow the parameters of the C
    entry point its source declares, one for one (a pointer passed as an
    int would be cut to 32 bits)."""
    source, symbol, argtypes = _kernels.KERNELS[name]
    with open(os.path.join(_kernels._CSRC, source)) as f:
        text = f.read()
    decl = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert decl, f"{source} declares no extern \"C\" int {symbol}(...)"
    params = [" ".join(p.split()[:-1]).replace("const ", "")
              for p in decl.group(1).split(",")]
    assert [_C_TYPES[p] for p in params] == argtypes, params


def test_trainer_evaluate_matches_jax(served):
    from foodrec_tpu.engine.trainer import Trainer as JTrainer
    from foodrec_tpu_torch.engine.trainer import Trainer

    jmodel, jparams = served["jmodel"], served["jparams"]
    jdd = served["jdata"].device_data
    for split, is_test in (("eval_valid", False), ("eval_test", True)):
        es = getattr(jdd, split)
        # premise: the f32 score differences between the two frameworks
        # (~1e-6) cannot reorder any positive/negative pair
        cache = jmodel.eval_cache(jparams)
        scores = np.asarray(jmodel.score_from_cache(jparams, cache, es.users,
                                                    es.cand))
        for b in range(es.n_users):
            p, c = es.n_pos[b], es.n_cand[b]
            if p:
                gap = np.abs(scores[b, :p, None] - scores[b, None, p:c]).min()
                assert gap > 1e-4, (split, b, gap)
        want = JTrainer(served["jcfg"], jmodel).evaluate(jparams, es,
                                                          is_test=is_test)
        got = Trainer(served["cfg"], served["model"]).evaluate(
            getattr(served["dd"], split), is_test=is_test)
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - float(want[k])) <= 1e-6, (split, k)


def test_full_sort_topk_indices_equal_jax(served):
    from foodrec_tpu.engine.topk_evaluator import full_sort_topk as jtopk
    from foodrec_tpu_torch.engine.topk_evaluator import full_sort_topk

    jmodel, jparams, model = served["jmodel"], served["jparams"], served["model"]
    n_items, users, k = model.n_items, np.arange(model.n_users), 10
    jcache = jmodel.eval_cache(jparams)
    want = jtopk(lambda u, c: jmodel.score_from_cache(jparams, jcache, u, c),
                 users, n_items, k, user_batch=8, item_chunk=16)
    cache = model.eval_cache()
    got = full_sort_topk(lambda u, i: model.score_items(cache, u, i), users,
                         n_items, k, user_batch=8, item_chunk=16, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
