"""PyTorch port: the preprocess CLI (foodrec_tpu_torch.data.preprocess_cli)
against the JAX package's, on fabricated raw trees in each format, written
as tests/test_preprocess_cli.py writes them (Food.com with ingr_map.pkl and
an image filter, Allrecipes with its own splits, generic CSVs):

  * the two CLIs write byte-identical trees, except cluster/ and
    mm_cluster/ (the port's k-means runs on the device)
  * the port's FoodData on the port's tree equals the JAX package's
    FoodData on the JAX tree, attribute for attribute, array for array
  * one batch of CIKM_Model and one of PRICAI_ModelX (CLUSSL, reading the
    clusters and centres) at equal parameters (params_from_jax) give the
    JAX package's loss parts within 1e-9 relative in float64; for CLUSSL
    both trees hold the port's clusters
  * the Food.com loader reads the ingredient and nutrition lists in every
    form ast.literal_eval accepts as the JAX package's loader does

The port's CLI runs with `--device cpu`; without it, it asks for CUDA.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from foodrec_tpu.data import preprocess_cli as jcli
from foodrec_tpu_torch.data import preprocess_cli as pcli
from tests.test_preprocess_cli import KW_NAMES, _write_foodcom, _write_generic
from tests.test_torch_port_models import _buffers64, _port_model
from tests.test_torch_port_options import _jax_model
from tests.test_torch_port_preprocess import _assert_same_files
from tests.test_torch_port_train import _rel_err

X64_TOL = 1e-9
N_NEG, N_CLUSTERS = 6, 4
COMMON = ["--n-neg", str(N_NEG), "--n-clusters", str(N_CLUSTERS),
          "--image-dim", "12", "--text-dim", "6", "--health-sample-dict"]
GRAPHS = {"load_IngreIngre_graph": True, "load_UserRecipe_graph": True,
          "use_cal_level": True, "load_RecipeCalories_graph": True,
          "load_RecipeHealth_graph": True, "health_neg_sample": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: the suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_allrecipes(raw, rng, n_items=24):
    """The Allrecipes tree of test_allrecipes_cli_presplit_and_seven_criteria:
    own splits (a test user outside train), '^' ingredients, nutrition
    dicts with '< 1' values; 2-4 ingredients a recipe, not 3 each: FoodData
    (both packages) counts the ingredients as the code matrix's largest
    entry, the pad id, which a matrix with no short row lacks."""
    rid = [40 + i for i in range(n_items)]

    def split_df(users, per_user):
        rows = []
        for u in users:
            for i in rng.choice(n_items, size=per_user, replace=False):
                rows.append({"user_id": u, "recipe_id": rid[int(i)],
                             "rating": int(rng.integers(1, 6)),
                             "dateLastModified": "2019-01-01"})
        return pd.DataFrame(rows)

    os.makedirs(raw)
    split_df(range(12), 8).to_csv(
        os.path.join(raw, "core-data-train_rating.csv"), index=False)
    split_df(range(12), 2).to_csv(
        os.path.join(raw, "core-data-valid_rating.csv"), index=False)
    pd.concat([split_df(range(12), 3), split_df([99], 3)]).to_csv(
        os.path.join(raw, "core-data-test_rating.csv"), index=False)

    def nutri():
        return str({
            "calories": {"amount": float(rng.integers(40, 900))},
            "fat": {"percentDailyValue": str(rng.integers(0, 60))},
            "sugars": {"amount": float(rng.integers(0, 30))},
            "sodium": {"amount": float(rng.integers(0, 3000))},
            "protein": {"percentDailyValue": str(rng.integers(0, 40))},
            "saturatedFat": {"percentDailyValue": "< 1"},
            "carbohydrates": {"percentDailyValue": str(
                rng.integers(0, 100))},
            "fiber": {"percentDailyValue": str(rng.integers(0, 40))},
        })

    pd.DataFrame({
        "recipe_id": rid,
        "recipe_name": [f"dish {i}" for i in rid],
        "ingredients": ["^".join(rng.choice(KW_NAMES, size=int(
                            rng.integers(2, 5)), replace=False))
                        for _ in rid],
        "nutritions": [nutri() for _ in rid],
    }).to_csv(os.path.join(raw, "core-data_recipe.csv"), index=False)


def _raw_tree(fmt, root):
    """(raw dir, extra flags) of a fabricated tree in format `fmt`."""
    raw = os.path.join(root, "raw")
    if fmt == "generic":
        _write_generic(raw, np.random.default_rng(0))
        # every third item with 2 ingredients, not 3 (see _write_allrecipes)
        path = os.path.join(raw, "ingredients.csv")
        ing = pd.read_csv(path)
        ing.loc[::3, "ingredients"] = [
            "^".join(g.split("^")[:2]) for g in ing["ingredients"][::3]]
        ing.to_csv(path, index=False)
        return raw, ["--k-core", "2"]
    if fmt == "foodcom":
        ids = _write_foodcom(raw, np.random.default_rng(1))
        img_dir = os.path.join(root, "images")
        os.makedirs(img_dir)
        for i in ids[:-3]:   # the last 3 items have no image
            open(os.path.join(img_dir, f"{i}.jpg"), "w").close()
        return raw, ["--k-core", "2", "--image-dir", img_dir]
    _write_allrecipes(raw, np.random.default_rng(2))
    return raw, []


@pytest.fixture(scope="module", params=["foodcom", "allrecipes", "generic"])
def trees(request, tmp_path_factory):
    """The JAX CLI's and the port CLI's outputs on one raw tree, each under
    <root>/Synth (the dataset name the config helpers read)."""
    fmt = request.param
    root = str(tmp_path_factory.mktemp(fmt))
    raw, extra = _raw_tree(fmt, root)
    argv = ["--format", fmt, "--raw-dir", raw, *COMMON, *extra]
    jout = jcli.main([*argv, "--out", os.path.join(root, "jax", "Synth")])
    pout = pcli.main([*argv, "--out", os.path.join(root, "port", "Synth"),
                      "--device", "cpu"])
    return dict(fmt=fmt, root=root, jout=jout, pout=pout)


def _synth_root(tree, side):
    return os.path.join(tree["root"], side, "Synth"), {"neg_num": N_NEG}


def _share_clusters(tree):
    """The port's cluster/ and mm_cluster/ into the JAX tree too."""
    if tree.get("shared"):
        return
    tree["shared"] = True
    for d in ("cluster", "mm_cluster"):
        shutil.rmtree(os.path.join(tree["jout"]["base"], d))
        shutil.copytree(os.path.join(tree["pout"]["base"], d),
                        os.path.join(tree["jout"]["base"], d))


def test_trees_are_byte_identical_but_the_clusters(trees):
    names = _assert_same_files(trees["pout"]["base"], trees["jout"]["base"],
                               skip=("cluster", "mm_cluster"))
    assert {"graph_edge/ii_graph.txt", "graph_edge/health_sample_dict.pkl",
            "graph_edge/rr_health_graph.txt", "mapping_dict.pkl",
            "data.test.negative"} <= set(names)
    assert (trees["pout"]["n_users"], trees["pout"]["n_items"]) == \
        (trees["jout"]["n_users"], trees["jout"]["n_items"])
    for modality in ("image", "text"):
        edges = np.loadtxt(os.path.join(trees["pout"]["base"], "cluster",
                                        f"{modality}_cluster_edge.txt"),
                           dtype=np.int64)
        assert edges.shape == (N_CLUSTERS * trees["pout"]["n_items"], 2)
        assert np.array_equal(np.unique(edges[:, 0]),
                              np.arange(trees["pout"]["n_items"]))


def _same(got, want, what):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif sp.issparse(want):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        for a in ("row", "col", "data"):
            np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{k}]")
    else:
        assert got == want, what


def test_food_data_on_the_port_tree_equals_jax(trees):
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from tests.conftest import make_config

    _share_clusters(trees)
    # the JAX loader reads no empty graph: Allrecipes' few ingredient names
    # keep no single-keyword edge at p = 0.025
    ii = os.path.join(trees["pout"]["base"], "graph_edge", "ii_graph.txt")
    flags = {**GRAPHS, "load_IngreIngre_graph": os.path.getsize(ii) > 0,
             "load_TextCluster_graph": True, "load_ImageCluster_graph": True,
             "n_cluster": N_CLUSTERS}
    jcfg, _ = make_config(_synth_root(trees, "jax"), model="CIKM_Model",
                          overrides={**flags, "use_gpu": False})
    jds = JFoodData(jcfg)
    root, meta = _synth_root(trees, "port")
    cfg = Config("CIKM_Model", "Synth", {
        "data_path": root.rsplit("/Synth", 1)[0] + "/",
        "neg_sample_num": N_NEG, "use_gpu": False, **flags})
    derive_data_paths(cfg, "Synth")
    ds = FoodData(cfg)
    skip = {"args_config", "config"}
    want = {k: v for k, v in vars(jds).items() if k not in skip}
    got = {k: v for k, v in vars(ds).items() if k not in skip}
    # every attribute the port keeps (it leaves out a few the JAX package
    # keeps and nothing reads, e.g. trainList and the *_user_dict copies)
    assert set(got) <= set(want) and len(got) >= 30, sorted(got)
    for k in got:
        w = want[k]
        _same(np.asarray(got[k]) if isinstance(w, np.memmap) else got[k],
              np.asarray(w) if isinstance(w, np.memmap) else w, k)
    assert ds.num_users == trees["pout"]["n_users"]


def _loss_parts64(jmodel, jparams, model, batch):
    """The JAX package's loss parts (float64, jit) and the port model's
    (float64) on one (u, pos, neg) batch."""
    u, p, n = batch
    with jax.enable_x64(True):
        params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                jparams)

        def fn(params, buffers, b):
            with jmodel.bind(buffers):
                return jnp.stack(jmodel.calculate_loss(params, b))

        jparts = np.asarray(jax.jit(fn)(params64, _buffers64(jmodel), {
            "u_id": jnp.asarray(u, jnp.int32),
            "pos_i_id": jnp.asarray(p, jnp.int32),
            "neg_i_id": jnp.asarray(n, jnp.int32),
            "weight": jnp.ones(len(u), jnp.float64),
            "key": jax.random.PRNGKey(0)}))
    with torch.no_grad():
        parts = torch.stack(model.calculate_loss(
            *(torch.as_tensor(a).long() for a in (u, p, n)),
            weight=torch.ones(len(u), dtype=torch.float64))).numpy()
    assert parts.dtype == np.float64
    return parts, jparts


@pytest.mark.parametrize("name,extra", [
    ("CIKM_Model", {"attention_probs_dropout_prob": 0.0}),
    ("PRICAI_ModelX", {"n_cluster": N_CLUSTERS,
                       "use_center_embedding": True})])
def test_loss_parts_on_the_trees_match_jax_float64(trees, name, extra):
    _share_clusters(trees)
    overrides = {"train_batch_size": 16, **extra}
    _, _, jmodel, jparams = _jax_model(_synth_root(trees, "jax"), name,
                                       overrides)
    model = _port_model(_synth_root(trees, "port"), name, overrides, jparams,
                        dtype=torch.float64)[2]
    rng = np.random.default_rng(0)
    dd = model.dd
    batch = tuple(rng.integers(0, m, 16) for m in
                  (dd.num_users, dd.n_items, dd.n_items))
    parts, jparts = _loss_parts64(jmodel, jparams, model, batch)
    assert np.isfinite(parts).all() and np.abs(parts).sum() > 0
    worst = max(_rel_err(a, b) for a, b in zip(parts, jparts))
    assert worst <= X64_TOL, (parts, jparts)


# how a list is written in PP_recipes.csv / RAW_recipes.csv: every form
# ast.literal_eval reads
LIST_FORMS = {
    "plain": (lambda v: str(v), lambda v: str(v)),
    "exponents and signs": (
        lambda v: "[" + ", ".join(f"+{x}" for x in v) + "]",
        lambda v: "[" + ", ".join(f"{x:.3e}" if k % 2 else f"-{x}"
                                  for k, x in enumerate(v)) + "]"),
    "spacing and trailing commas": (
        lambda v: "[ " + " ,".join(map(str, v)) + ", ]",
        lambda v: "[" + ",".join(f"  {x}" for x in v) + ",]"),
    "tuples and short lists": (
        lambda v: str(tuple(v)),
        lambda v: str(tuple(v[:5] if v[0] % 2 else v))),
}


@pytest.mark.parametrize("form", sorted(LIST_FORMS))
def test_foodcom_loader_reads_lists_as_jax_does(form, tmp_path):
    ingre_form, nutri_form = LIST_FORMS[form]
    raw = str(tmp_path / "raw")
    _write_foodcom(raw, np.random.default_rng(3))
    for name, col, fmt in (("PP_recipes.csv", "ingredient_ids", ingre_form),
                           ("RAW_recipes.csv", "nutrition", nutri_form)):
        path = os.path.join(raw, name)
        df = pd.read_csv(path)
        df[col] = [fmt(eval(v)) for v in df[col]]
        df.to_csv(path, index=False)
    want = jcli.load_foodcom_raw(raw)
    got = pcli.load_foodcom_raw(raw)
    assert got["item_to_ingres"] == want["item_to_ingres"]
    assert got["calories_by_item"] == want["calories_by_item"]
    assert list(got["nutrition_df"]) == list(want["nutrition_df"])
    for c, col in want["nutrition_df"].items():
        np.testing.assert_array_equal(got["nutrition_df"][c], col.to_numpy())


def test_cli_asks_for_cuda_unless_given_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcli.main(["--format", "generic", "--raw-dir", str(tmp_path),
                   "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
