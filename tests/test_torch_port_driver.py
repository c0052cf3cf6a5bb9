"""PyTorch port, the experiment driver: config layers and the grid, the
runner's flags, quick_start's leaderboard, checkpoints and resume,
`req_training: False`, the faults the port had against the JAX package
(unread config keys, `spmm_impl: pallas`), the graph flags and the profiler
trace, and the dataset's statistics and study splits, against the JAX
package on the toy synthetic dataset.

Exact comparisons throughout, except the metrics of the JAX package's `fit`
against the port's on the same parameters: within 1e-6 (float32 sums taken
in other orders; the parameters are scaled up, as in
test_torch_port_serve.py, so that no positive and negative score are close
enough to swap).
"""

import os
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from tests.conftest import make_config

PARAM_SCALE = 8.0
STUDY_FLAGS = {"cold_study": True, "sense_study": True,
               "health_level_study": True}


def _data_path(synth_root):
    return synth_root[0].rsplit("/Synth", 1)[0] + "/"


def _port_config(synth_root, model="CIKM_Model", overrides=None, mg=False):
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import derive_data_paths

    cfg = Config(model, "Synth", {
        "data_path": _data_path(synth_root),
        "neg_sample_num": synth_root[1]["neg_num"], "use_gpu": False,
        **(overrides or {})}, mg)
    derive_data_paths(cfg, "Synth")
    return cfg


def _port_data(cfg):
    from foodrec_tpu_torch.data.dataset import FoodData
    from foodrec_tpu_torch.data.device import DeviceData

    data = FoodData(cfg)
    data.device_data = DeviceData.from_food_data(data)
    return data


def _port_model(cfg, data, seed=0):
    from foodrec_tpu_torch.models import get_model

    return get_model(cfg["model"])(cfg, data, torch.Generator().manual_seed(seed))


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# config layers and the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,mg,overrides", [
    ("CIKM_Model", False, {}),
    ("CIKM_Model", True, {}),
    ("LightGCN", False, {"flagD": [0, 1, 2, 3], "seed": [998, 999]}),
    ("LightGCN", True, {"flagD": [0, 3], "hyper_parameters": ["flagD"]}),
])
def test_config_layers_and_grid_match_jax(synth_root, model, mg, overrides):
    """The merged config (mg.yaml last, its hyper_parameters appended) and
    hyper_combinations' names and grid order equal the JAX package's."""
    from foodrec_tpu.config import Config as JConfig
    from foodrec_tpu.config import hyper_combinations as jcombinations
    from foodrec_tpu_torch.config import hyper_combinations

    jcfg = JConfig(model, "Synth", {"use_gpu": False, **overrides}, mg)
    cfg = _port_config(synth_root, model, overrides, mg)
    for key in ("data_path", "neg_sample_num", "interaction_data_path",
                "graph_data_path", "ingre_data_path"):
        cfg.final_config_dict.pop(key)
        jcfg.final_config_dict.pop(key, None)
    assert cfg.final_config_dict == jcfg.final_config_dict
    assert hyper_combinations(cfg) == jcombinations(jcfg)
    if mg and "hyper_parameters" not in overrides:
        # a runtime hyper_parameters list replaces the files' lists
        assert cfg["hyper_parameters"][-3:] == ["alpha1", "alpha2", "beta"]
        assert len(hyper_combinations(cfg)[1]) >= 3


def _scripted_trainer(log):
    """A trainer class whose fit returns made-up metrics fixed by the
    combination, so that both drivers see the same results."""

    class Scripted:
        def __init__(self, config, model, mg=False):
            self.config = config

        def fit(self, dataset, saved=False, hyper_tuple=None):
            log.append(hyper_tuple)
            rng = np.random.default_rng(zlib.crc32(repr(hyper_tuple).encode()))
            a, b, c = (float(x) for x in rng.random(3))
            return a, {"NDCG@20": a}, {"AUC": c, "NDCG@20": b}

    return lambda: Scripted


def test_quick_start_picks_the_jax_best_tuple(synth_root, tmp_path,
                                              monkeypatch):
    """Both drivers, their trainers scripted alike, walk the same grid in
    the same order and return the same best combination and metrics."""
    from foodrec_tpu.engine import quick_start as jqs
    from foodrec_tpu_torch.engine import quick_start as qs

    monkeypatch.chdir(tmp_path)
    overrides = {"data_path": _data_path(synth_root),
                 "neg_sample_num": synth_root[1]["neg_num"],
                 "use_gpu": False, "epochs": 1,
                 "seed": [998, 999], "flagD": [0, 1, 2, 3]}
    jlog, log = [], []
    monkeypatch.setattr(jqs, "get_trainer", _scripted_trainer(jlog))
    monkeypatch.setattr(qs, "get_trainer", _scripted_trainer(log))
    want = jqs.quick_start("LightGCN", "Synth", dict(overrides))
    got = qs.quick_start("LightGCN", "Synth", dict(overrides))
    assert len(log) == 8 and log == jlog
    assert got == want


def test_quick_start_writes_checkpoints_and_log(synth_root, tmp_path,
                                                monkeypatch):
    """A real two-combination grid on the CPU: one best checkpoint per
    combination under the JAX package's name, the log with its BEST block,
    and the best checkpoint reproduces the returned test metrics."""
    from foodrec_tpu_torch.engine.quick_start import quick_start
    from foodrec_tpu_torch.engine.trainer import Trainer

    monkeypatch.chdir(tmp_path)
    overrides = {"epochs": 2, "eval_step": 2, "train_batch_size": 16,
                 "seed": [999], "flagD": [1, 3],
                 "hyper_parameters": ["flagD"]}
    best = quick_start("LightGCN", "Synth", {
        "data_path": _data_path(synth_root),
        "neg_sample_num": synth_root[1]["neg_num"], "use_gpu": False,
        **overrides})
    hyper_tuple, valid, test = best
    assert hyper_tuple in ((1, 999), (3, 999))
    assert sorted(os.listdir("ckp")) == [
        f"LightGCN-Synth-['flagD', 'seed']=({f}, 999).pkl" for f in (1, 3)]
    (log_name,) = os.listdir("log")
    assert log_name.startswith("LightGCN-Synth-") and log_name.endswith(".log")
    with open(os.path.join("log", log_name), encoding="utf-8") as f:
        text = f.read()
    assert "BEST" in text and "All Over" in text and "Saving current best" in text

    cfg = _port_config(synth_root, "LightGCN", {**overrides,
                                                "flagD": hyper_tuple[0]})
    model = _port_model(cfg, _port_data(cfg), seed=1)
    model.load_state_dict(Trainer.load_checkpoint(
        f"ckp/LightGCN-Synth-['flagD', 'seed']={hyper_tuple}.pkl"))
    assert Trainer(cfg, model).evaluate(model.dd.eval_test, is_test=True) == test


@pytest.mark.parametrize("argv", [
    [],
    ["-m", "CIKM_Model", "-d", "Allrecipes", "--mg", "--data_path", "/d/",
     "--epochs", "3", "--neg_sample_num", "50", "--unknown_flag", "1"],
    ["--model", "FGCN", "--dataset", "Foodcom", "--epochs", "1"],
])
def test_runner_maps_flags_as_jax(argv, monkeypatch):
    from foodrec_tpu.engine import quick_start as jqs
    from foodrec_tpu.runner import main as jmain
    from foodrec_tpu.utils import misc as jmisc
    from foodrec_tpu_torch.engine import quick_start as qs
    from foodrec_tpu_torch.runner import main

    calls = []
    monkeypatch.setattr(jqs, "quick_start", lambda **kw: calls.append(kw))
    monkeypatch.setattr(qs, "quick_start", lambda **kw: calls.append(kw))
    monkeypatch.setattr(jmisc, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["runner"] + argv)
    jmain()
    main(argv)
    assert len(calls) == 2 and calls[0] == calls[1]


def test_runner_raises_without_cuda(synth_root, tmp_path, monkeypatch):
    """No fallback: the CLI runs on the card, and where CUDA is absent it
    raises before it reads or writes anything."""
    from foodrec_tpu_torch.runner import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-m", "LightGCN", "-d", "Synth", "--data_path",
              _data_path(synth_root)])
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cikm(synth_root):
    cfg = _port_config(synth_root, "CIKM_Model", {"train_batch_size": 32})
    return cfg, _port_data(cfg)


def test_save_best_round_trips_bitwise(cikm, tmp_path):
    from foodrec_tpu_torch.engine import checkpoint as ckpt

    cfg, data = cikm
    model = _port_model(cfg, data)
    path = str(tmp_path / "best.pkl")
    ckpt.save_best(model.state_dict(), path)
    loaded = ckpt.load_best(path)
    _assert_state_equal(loaded, model.state_dict())
    other = _port_model(cfg, data, seed=5)
    other.load_state_dict(loaded)
    _assert_state_equal(other.state_dict(), model.state_dict())


@pytest.fixture()
def deterministic():
    """torch's deterministic algorithms for one test: with several threads
    the CPU backward of a gather with repeated ids (`table[idx]`, an
    index_put_ that accumulates) adds in a varying order, so two runs of the
    same step part in the last bits."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _resume_config(synth_root, tmp_path, **extra):
    return _port_config(synth_root, "CIKM_Model", {
        "train_batch_size": 32, "attention_probs_dropout_prob": 0.5,
        "alpha1": 1.0, "alpha2": 0.1, "beta": 2,
        "ckp_root": str(tmp_path) + "/", **extra})


def test_two_plus_two_epochs_through_save_state_equal_four(synth_root,
                                                           tmp_path,
                                                           deterministic):
    """Two epochs, save_state, a new model and trainer, load_state, two more
    epochs: the parameters, optimizer moments and generator equal four
    uninterrupted epochs bitwise. Under Mirror Gradient at dropout 0.5 with
    the shipped [0.5, 50] schedule, so that the generator, the update count
    and the lr all carry across."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg = _resume_config(synth_root, tmp_path)
    data = _port_data(cfg)
    straight = Trainer(cfg, _port_model(cfg, data), mg=True)
    for _ in range(4):
        straight.train_epoch()
        straight.scheduler.step()

    first = Trainer(cfg, _port_model(cfg, data), mg=True)
    for _ in range(2):
        first.train_epoch()
        first.scheduler.step()
    path = str(tmp_path / "run.state")
    first._save_state(path, 1, 0)
    resumed = Trainer(cfg, _port_model(cfg, data, seed=3), mg=True)
    assert resumed._resume(path) == (2, 0)
    for _ in range(2):
        resumed.train_epoch()
        resumed.scheduler.step()

    _assert_state_equal(resumed.model.state_dict(), straight.model.state_dict())
    assert resumed.n_updates == straight.n_updates
    assert resumed.scheduler.get_last_lr() == straight.scheduler.get_last_lr()
    assert torch.equal(resumed.generator.get_state(),
                       straight.generator.get_state())
    for a, b in zip(resumed.optimizer.state.values(),
                    straight.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_fit_resume_trains_only_the_later_epochs(synth_root, tmp_path,
                                                 deterministic):
    """fit(save_state_every: 1) writes the JAX package's sanitized `.state`
    name; a fit with resume_from epoch 0's state trains epoch 1 only, keeps
    the resumed loss log, and ends on the parameters of the run that was not
    stopped, bitwise."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg = _resume_config(synth_root, tmp_path, epochs=2, eval_step=2,
                         save_state_every=1)
    data = _port_data(cfg)
    straight = Trainer(cfg, _port_model(cfg, data), mg=True)
    states = []
    save = straight._save_state

    def keep_each(path, epoch, cur_step):
        save(path, epoch, cur_step)
        states.append(path + f".epoch{epoch}")
        os.replace(path, states[-1])

    straight._save_state = keep_each
    straight.fit(data, hyper_tuple=(999,))
    name = "CIKM_Model-Synth-__seed__=_999,_.pkl.state"
    assert states == [str(tmp_path / name) + f".epoch{e}" for e in (0, 1)]

    cfg["resume_from"] = states[0]
    resumed = Trainer(cfg, _port_model(cfg, data, seed=3), mg=True)
    epochs = []
    train_epoch = resumed.train_epoch
    resumed.train_epoch = lambda: epochs.append(1) or train_epoch()
    resumed.fit(data, hyper_tuple=(999,))
    assert len(epochs) == 1
    assert resumed.train_loss_dict == straight.train_loss_dict
    _assert_state_equal(resumed.model.state_dict(), straight.model.state_dict())


@pytest.fixture(scope="module")
def untrained(synth_root, tmp_path_factory):
    """The JAX package's fit and the port's with req_training: False, two
    epochs, eval every epoch, saved=True, on the same (scaled) parameters."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.engine.trainer import Trainer as JTrainer
    from foodrec_tpu.models import get_model as jget_model
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.utils.weights import params_from_jax

    roots = {k: str(tmp_path_factory.mktemp(k)) + "/" for k in ("jax", "port")}
    overrides = {"req_training": False, "epochs": 2, "eval_step": 1}
    jcfg, _ = make_config(synth_root, model="CIKM_Model",
                          overrides={**overrides, "ckp_root": roots["jax"]})
    jdata = JFoodData(jcfg)
    jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
    jmodel = jget_model("CIKM_Model")(jcfg, jdata)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    for k in ("user_embedding", "item_embedding", "ingre_embedding"):
        jparams[k] = np.asarray(jparams[k]) * np.float32(PARAM_SCALE)
    jmodel.init_params = lambda key: jparams
    want = JTrainer(jcfg, jmodel).fit(jdata, saved=True, hyper_tuple=(999,))

    cfg = _port_config(synth_root, "CIKM_Model",
                       {**overrides, "ckp_root": roots["port"]})
    data = _port_data(cfg)
    model = _port_model(cfg, data)
    model.load_state_dict(params_from_jax(jparams, model))
    init = _state(model)
    trainer = Trainer(cfg, model)
    got = trainer.fit(data, saved=True, hyper_tuple=(999,))
    return dict(want=want, got=got, roots=roots, init=init, model=model,
                trainer=trainer)


def test_req_training_false_keeps_the_init_and_matches_jax(untrained):
    """No epoch trains; the evals, early stopping and the final test still
    run, on the initial parameters, with the JAX package's metrics."""
    (jscore, jvalid, jtest), (score, valid, test) = (untrained["want"],
                                                     untrained["got"])
    _assert_state_equal(untrained["model"].state_dict(), untrained["init"])
    assert untrained["trainer"].train_loss_dict == {}
    assert untrained["trainer"].n_updates == 0
    assert abs(score - float(jscore)) <= 1e-6
    for got, want in ((valid, jvalid), (test, jtest)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - float(want[k])) <= 1e-6, k


def test_checkpoint_name_equals_jax(untrained):
    names = {k: os.listdir(v) for k, v in untrained["roots"].items()}
    assert names["port"] == names["jax"] == ["CIKM_Model-Synth-['seed']=(999,).pkl"]


# ---------------------------------------------------------------------------
# the faults of the port against the JAX package, repaired
# ---------------------------------------------------------------------------


def test_unported_config_keys_raise(synth_root, cikm):
    """A mesh_shape whose size differs from the world size raises in the
    Trainer, where the JAX package's make_mesh raises for too few devices:
    here one process without a launcher and a mesh of two ranks (the mesh
    itself trains in tests/test_torch_port_mesh.py)."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg = _port_config(synth_root, "CIKM_Model", {"mesh_shape": {"data": 2}})
    model = _port_model(cikm[0], cikm[1])
    with pytest.raises(ValueError, match="mesh_shape"):
        Trainer(cfg, model)


@pytest.fixture(scope="module")
def rr_root(synth_root, tmp_path_factory):
    """A copy of the toy dataset with the recipe-recipe graphs, which the
    synthetic generator does not write: int pairs in rr_graph.txt and
    (recipe, recipe, weight) triples in rr_{co,ing,health}_graph.txt."""
    import shutil

    root = tmp_path_factory.mktemp("rr") / "Synth"
    shutil.copytree(synth_root[0], root)
    graph = root / "processed_dataset" / "graph_edge"
    rng = np.random.default_rng(7)
    n_items = synth_root[1]["n_items"]
    pairs = rng.integers(0, n_items, (40, 2))
    np.savetxt(graph / "rr_graph.txt", pairs, fmt="%d", delimiter="\t")
    for name in ("rr_co", "rr_ing", "rr_health"):
        triples = np.column_stack([rng.integers(0, n_items, (30, 2)),
                                   rng.random(30).round(4)])
        np.savetxt(graph / f"{name}_graph.txt", triples, fmt="%g")
    return str(root), synth_root[1]


@pytest.mark.parametrize("key,attrs", [
    ("load_RecipeRecipe_graph", ["rRecipe_triples"]),
    ("load_RecipeHealth_graph", ["rHealth_triples", "num_health_level"]),
    ("use_health_level", ["health_level"]),
    ("load_RecipeRecipeCo_graph", ["rr_co_triples"]),
    ("load_RecipeRecipeIng_graph", ["rr_ing_triples"]),
    ("load_RecipeRecipeHealth_graph", ["rr_health_triples"]),
])
def test_graph_config_keys_load_as_jax(rr_root, key, attrs):
    """Each of the JAX package's GraphData flags loads its file into the
    attributes the JAX package's FoodData sets, with equal values and
    dtypes; unset, they are absent (num_health_level 0)."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu_torch.data.dataset import FoodData

    jcfg, _ = make_config(rr_root, model="CIKM_Model",
                          overrides={key: True, "use_gpu": False})
    jds = JFoodData(jcfg)
    ds = FoodData(_port_config(rr_root, "CIKM_Model", {key: True}))
    for attr in attrs:
        got, want = getattr(ds, attr), getattr(jds, attr)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, attr
            np.testing.assert_array_equal(got, want, err_msg=attr)
        else:
            assert got == want, attr
    plain = FoodData(_port_config(rr_root, "CIKM_Model"))
    assert plain.num_health_level == 0
    assert not any(hasattr(plain, a) for a in attrs
                   if a != "num_health_level")


def test_profile_trace_dir_writes_the_trace(synth_root, tmp_path):
    """`profile_trace_dir`: fit runs epoch 1 (the second) under
    torch.profiler and writes its chrome trace there, with the port's
    spans; epoch 0 and the other epochs run without it."""
    import json

    from foodrec_tpu_torch.engine.trainer import Trainer

    trace_dir = str(tmp_path / "trace")
    cfg = _port_config(synth_root, "LightGCN", {
        "profile_trace_dir": trace_dir, "epochs": 3, "eval_step": 3,
        "train_batch_size": 16})
    data = _port_data(cfg)
    trainer = Trainer(cfg, _port_model(cfg, data))
    traced = []
    traced_epoch = trainer._traced_epoch
    trainer._traced_epoch = lambda d: traced.append(d) or traced_epoch(d)
    trainer.fit(data)
    assert traced == [trace_dir] and sorted(trainer.train_loss_dict) == [
        0, 1, 2]
    assert os.listdir(trace_dir) == ["epoch_1.pt.trace.json"]
    with open(os.path.join(trace_dir, "epoch_1.pt.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("calculate_loss" in e.get("name", "") or "aten::" in
               e.get("name", "") for e in events)
    # the port's spans: one train_step range a batch of the epoch
    steps = [e for e in events if e.get("name") == "foodrec::train_step"]
    assert len(steps) == trainer.n_batches


def test_spmm_impl_pallas_is_the_kernel(synth_root, cikm):
    """A config of the JAX package with `spmm_impl: pallas` builds the
    kernel impl (its plain version on the CPU), with the kernel impl's
    embeddings."""
    from foodrec_tpu_torch.ops.spmm import select_impl

    cfg, data = cikm
    models = {}
    for impl in ("pallas", "kernel"):
        cfg["spmm_impl"] = impl
        try:
            models[impl] = _port_model(cfg, data)
        finally:
            cfg["spmm_impl"] = "auto"
    assert models["pallas"].ui_prop.impl == models["pallas"].ri_prop.impl == "kernel"
    assert select_impl(models["pallas"].ui_prop.adj, "pallas", "cpu") == "kernel"
    for a, b in zip(models["pallas"].eval_cache(), models["kernel"].eval_cache()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the dataset's statistics and study splits
# ---------------------------------------------------------------------------


def test_food_data_str_and_study_splits_match_jax(synth_root):
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu_torch.data.dataset import FoodData

    jcfg, _ = make_config(synth_root, model="CIKM_Model", overrides=STUDY_FLAGS)
    jds = JFoodData(jcfg)
    ds = FoodData(_port_config(synth_root, "CIKM_Model", STUDY_FLAGS))
    assert str(ds) == str(jds)
    for attr in ("n_users", "n_items", "n_train", "n_valid", "n_test",
                 "inter_num", "user_range", "item_range"):
        assert getattr(ds, attr) == getattr(jds, attr), attr
    names = [f"{split}{kind}" for split in ("cold", "warm", "sense", "unsense")
             for kind in ("Ratings", "Negatives", "_users")]
    got = {a: getattr(ds, a) for a in names}
    want = {a: getattr(jds, a) for a in names}
    for hl in range(6):
        for attr in ("healthRatings", "healthNegatives", "healthUsers"):
            got[f"{attr}[{hl}]"] = getattr(ds, attr)[hl]
            want[f"{attr}[{hl}]"] = getattr(jds, attr)[hl]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert len(g) == len(w), name
        assert len(w) > 0 or name.startswith("health"), name
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
