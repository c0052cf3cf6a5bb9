"""PyTorch port, evaluation breadth: the full-sort path (`full_sort_topk`,
`TopKEvaluator`, engine/matrics.py and the top-k CSV), the sampled path
(`sample_rank_metrics`) and the cold / sense / health-level studies, against
the JAX package on the toy synthetic dataset with CIKM_Model's parameters
carried over by params_from_jax.

Tolerances: the metric kernels, TopKEvaluator, sample_rank_metrics and the
CSV on the same inputs exactly; through the model, the full-sort top-k ids
in every slot and its (4-place) metrics exactly, the sampled and study
metrics, per-user arrays and scores within 1e-6 (float32 sums taken in
other orders). The embedding tables are scaled up, as in
test_torch_port_serve.py, so that scores spread far beyond float32 noise.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.conftest import make_config

PARAM_SCALE = 8.0
TOL = 1e-6
STUDY_FLAGS = {"cold_study": True, "sense_study": True,
               "health_level_study": True}


@pytest.fixture(scope="module")
def pair(synth_root, tmp_path_factory):
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.engine.trainer import Trainer as JTrainer
    from foodrec_tpu.models import get_model as jget_model
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model
    from foodrec_tpu_torch.utils.weights import params_from_jax

    topk_dirs = {k: str(tmp_path_factory.mktemp(f"topk_{k}"))
                 for k in ("jax", "port")}
    jcfg, meta = make_config(synth_root, model="CIKM_Model", overrides={
        **STUDY_FLAGS, "recommend_topk": topk_dirs["jax"]})
    jdata = JFoodData(jcfg)
    jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
    jmodel = jget_model("CIKM_Model")(jcfg, jdata)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    for k in ("user_embedding", "item_embedding", "ingre_embedding"):
        jparams[k] = np.asarray(jparams[k]) * np.float32(PARAM_SCALE)

    cfg = Config("CIKM_Model", "Synth", {
        "data_path": synth_root[0].rsplit("/Synth", 1)[0] + "/",
        "neg_sample_num": meta["neg_num"], "use_gpu": False, **STUDY_FLAGS,
        "recommend_topk": topk_dirs["port"]})
    derive_data_paths(cfg, "Synth")
    data = FoodData(cfg)
    data.device_data = DeviceData.from_food_data(data)
    model = get_model("CIKM_Model")(cfg, data)
    model.load_state_dict(params_from_jax(jparams, model))
    return dict(jtrainer=JTrainer(jcfg, jmodel), jparams=jparams,
                trainer=Trainer(cfg, model), topk_dirs=topk_dirs, data=data)


def _assert_close_dicts(got, want, tol=TOL):
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - float(want[k])) <= tol, (k, got[k], want[k])


# ---------------------------------------------------------------------------
# the host-side metric kernels, on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matrics_equal_jax_exactly(seed):
    from foodrec_tpu.engine import matrics as jmatrics
    from foodrec_tpu_torch.engine import matrics

    rng = np.random.default_rng(seed)
    n, k = 40, 50
    hits = rng.random((n, k)) < 0.15
    pos_len = rng.integers(1, 30, n)
    pos_len[0] = 1        # shorter than k: the IDCG is truncated
    hits[1] = False       # a user without hits
    assert sorted(matrics.metrics_dict) == sorted(jmatrics.metrics_dict)
    for name, fn in matrics.metrics_dict.items():
        got, want = fn(hits, pos_len), jmatrics.metrics_dict[name](hits, pos_len)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _csv(directory):
    (name,) = os.listdir(directory)
    with open(os.path.join(directory, name), "rb") as f:
        return name, f.read()


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_evaluator_equals_jax_with_a_byte_equal_csv(seed, tmp_path):
    from foodrec_tpu.engine.topk_evaluator import TopKEvaluator as JTopK
    from foodrec_tpu_torch.engine.topk_evaluator import TopKEvaluator

    rng = np.random.default_rng(seed)
    n_users, n_items = 30, 200
    topk_index = np.stack([rng.permutation(n_items)[:50]
                           for _ in range(n_users)])
    pos_items = [list(rng.choice(n_items, rng.integers(1, 12), replace=False))
                 for _ in range(n_users)]
    users = list(range(n_users))
    out = {}
    for name, cls in (("jax", JTopK), ("port", TopKEvaluator)):
        directory = str(tmp_path / name)
        ev = cls({"metrics": ["Recall", "Recall2", "NDCG", "Precision", "MAP"],
                  "topk": [5, 10, 20, 50], "save_recommended_topk": True,
                  "recommend_topk": directory, "model": "CIKM_Model",
                  "dataset": "Synth"})
        result = ev.evaluate(topk_index, (users, pos_items,
                                          [len(p) for p in pos_items]),
                             is_test=True, idx=3)
        out[name] = (result, str(ev), *_csv(directory))
    (want, jstr, jname, jcsv), (got, pstr, name, csv) = out["jax"], out["port"]
    assert got == want and list(got) == list(want)
    assert "recall@20" in got and pstr == jstr
    assert csv == jcsv
    assert name.split("-idx")[0] == jname.split("-idx")[0] == "CIKM_Model-Synth"
    assert name.startswith("CIKM_Model-Synth-idx3-top50-")


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_rank_metrics_equal_jax(seed):
    from foodrec_tpu.engine.topk_evaluator import sample_rank_metrics as jsrm
    from foodrec_tpu_torch.engine.topk_evaluator import sample_rank_metrics

    rng = np.random.default_rng(seed)
    preds = rng.normal(size=(57, 21)).astype(np.float32)
    preds[:10] = np.round(preds[:10])  # ties with the positive
    got, want = sample_rank_metrics(preds, 20), jsrm(preds, 20)
    assert list(got) == list(want) and got == want


# ---------------------------------------------------------------------------
# the trainer's full-sort, sampled and study paths through the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_test", [False, True])
def test_valid_full_sort_matches_jax(pair, is_test, monkeypatch):
    """The same top-k ids in every slot, the same metrics (keys lower case,
    4 places) and score, and on the test split a byte-equal CSV."""
    from foodrec_tpu.engine import topk_evaluator as jtopk
    from foodrec_tpu_torch.engine import topk_evaluator as ptopk

    seen = {}
    for name, module in (("jax", jtopk), ("port", ptopk)):
        evaluate = module.TopKEvaluator.evaluate

        def recording(self, topk_index, *args, _name=name, _f=evaluate,
                      **kwargs):
            seen[_name] = np.asarray(topk_index)
            return _f(self, topk_index, *args, **kwargs)

        monkeypatch.setattr(module.TopKEvaluator, "evaluate", recording)
    jscore, want = pair["jtrainer"]._valid_full_sort(pair["jparams"], is_test)
    score, got = pair["trainer"]._valid_full_sort(is_test)
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    ds = pair["data"]
    n_users = ds.num_users if is_test else len(ds.valid_users)
    assert seen["port"].shape == (n_users, 50)
    assert got == want and score == jscore == got["ndcg@20"]
    if is_test:
        assert _csv(pair["topk_dirs"]["port"])[1] == \
            _csv(pair["topk_dirs"]["jax"])[1]


@pytest.mark.parametrize("is_test", [False, True])
def test_valid_sample_matches_jax(pair, is_test):
    """One row per positive, [its user's negatives, itself]: the rows equal
    the JAX package's list build, the metrics within 1e-6."""
    ds = pair["data"]
    rows = (zip(range(ds.num_users), ds.testRatings, ds.testNegatives)
            if is_test else
            zip(ds.valid_users, ds.validRatings, ds.validNegatives))
    want_u, want_c = [], []
    for u, pos_list, negs in rows:
        for p in pos_list:
            want_u.append(u)
            want_c.append(list(negs) + [p])
    users, cand = pair["trainer"]._sample_candidates(is_test)
    np.testing.assert_array_equal(users, want_u)
    np.testing.assert_array_equal(cand, want_c)

    jscore, want = pair["jtrainer"]._valid_sample(pair["jparams"], is_test)
    score, got = pair["trainer"]._valid_sample(is_test)
    _assert_close_dicts(got, want)
    assert abs(score - jscore) <= TOL


def _splits(ds):
    out = {s: (getattr(ds, f"{s}_users"), getattr(ds, f"{s}Ratings"),
               getattr(ds, f"{s}Negatives"))
           for s in ("cold", "warm", "sense", "unsense")}
    for hl in range(6):
        if len(ds.healthUsers[hl]):
            out[f"health{hl}"] = (ds.healthUsers[hl], ds.healthRatings[hl],
                                  ds.healthNegatives[hl])
    return out


def test_study_evals_match_jax(pair):
    """Every study split: metrics, per-user arrays and scores within 1e-6
    of the JAX package's `_study_eval`."""
    jds = pair["jtrainer"].model.dataset
    for name, args in _splits(pair["data"]).items():
        want = pair["jtrainer"]._study_eval(pair["jparams"],
                                            *_splits(jds)[name])
        got = pair["trainer"]._study_eval(*args)
        _assert_close_dicts(got[0], want[0])
        assert sorted(got[1]) == sorted(want[1])
        for k, v in want[1].items():
            np.testing.assert_allclose(got[1][k], v, rtol=0, atol=TOL,
                                       err_msg=f"{name} {k}")
        assert got[2].shape == want[2].shape
        np.testing.assert_allclose(got[2], want[2], rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("study", ["cold_start_study", "sense_study",
                                   "health_level_study"])
def test_studies_match_jax(pair, study):
    want = getattr(pair["jtrainer"], study)(pair["jparams"])
    got = getattr(pair["trainer"], study)()
    assert list(got) == list(want) and got
    for k, v in want.items():
        if k.endswith("predictions"):
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL)
        else:
            _assert_close_dicts(got[k], v)
            assert all(0.0 <= x <= 1.0 for x in got[k].values())


@pytest.mark.parametrize("path", ["full_sort", "sample"])
def test_valid_dispatches_on_the_yaml_flags(pair, path):
    """eval_by_user: False selects full_sort or the sampled path, as in any
    yaml that sets them; on valid and test."""
    trainer = pair["trainer"]
    cfg = trainer.config
    cfg["eval_by_user"], cfg["full_sort"] = False, path == "full_sort"
    try:
        for split, is_test in (("eval_valid", False), ("eval_test", True)):
            got = trainer.evaluate(getattr(trainer.model.dd, split), is_test)
            want = getattr(trainer, f"_valid_{path}")(is_test)[1]
            assert got == want
    finally:
        cfg["eval_by_user"], cfg["full_sort"] = True, False


def test_plot_train_loss_writes_its_file(pair, tmp_path):
    trainer = pair["trainer"]
    trainer.train_loss_dict = {0: 2.0, 1: 1.5, 2: 1.25}
    try:
        path = tmp_path / "loss.png"
        trainer.plot_train_loss(path=str(path))
        assert path.stat().st_size > 0
    finally:
        trainer.train_loss_dict = {}
