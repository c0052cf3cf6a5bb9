"""PyTorch port, host layer: the same files, arrays and config as the JAX
package (foodrec_tpu_torch.data / ops.graph / config vs foodrec_tpu)."""

import os

import numpy as np
import pytest
import scipy.sparse as sp

from tests.conftest import make_config


def _port_config(synth_root, model="CIKM_Model"):
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import derive_data_paths

    root, meta = synth_root
    cfg = Config(model=model, dataset="Synth", config_dict={
        "data_path": root.rsplit("/Synth", 1)[0] + "/",
        "neg_sample_num": meta["neg_num"], "use_gpu": False})
    derive_data_paths(cfg, "Synth")
    return cfg


@pytest.fixture(scope="module")
def both(synth_root):
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu_torch.data.dataset import FoodData
    from foodrec_tpu_torch.data.device import DeviceData

    jcfg, _ = make_config(synth_root, model="CIKM_Model",
                          overrides={"use_gpu": False})
    jds = JFoodData(jcfg)
    ds = FoodData(_port_config(synth_root))
    return (jds, JDeviceData.from_food_data(jds, jcfg),
            ds, DeviceData.from_food_data(ds))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("kw", [{}, {"latent_dim": 4, "n_users": 30,
                                     "seed": 3}])
def test_synthetic_files_byte_identical(tmp_path, kw):
    from foodrec_tpu.data import synthetic as jsynth
    from foodrec_tpu_torch.data import synthetic

    m_j = jsynth.generate(str(tmp_path / "jax"), **kw)
    m_t = synthetic.generate(str(tmp_path / "port"), **kw)
    assert m_j == m_t
    fj, ft = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(fj) == sorted(ft)
    for name in fj:
        assert fj[name] == ft[name], name


def test_food_data_matches_jax(both):
    jds, _, ds, _ = both
    for attr in ("num_users", "num_items", "n_users", "n_items",
                 "num_ingredients", "valid_users", "ingredientNum"):
        assert getattr(ds, attr) == getattr(jds, attr), attr
    for attr in ("testRatings", "validRatings", "testNegatives",
                 "validNegatives"):
        got, want = getattr(ds, attr), getattr(jds, attr)
        assert len(got) == len(want), attr
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w, np.int64))
    np.testing.assert_array_equal(ds.ingredientCodeDict, jds.ingredientCodeDict)
    np.testing.assert_array_equal(ds.rIngre_triples, jds.rIngre_triples)
    for a in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(ds.train_coo_matrix, a),
                                      getattr(jds.train_coo_matrix, a))
    assert ds.train_coo_matrix.dtype == jds.train_coo_matrix.dtype
    assert sorted(ds.health_level_multi_hot) == sorted(jds.health_level_multi_hot)
    for k, v in jds.health_level_multi_hot.items():
        np.testing.assert_array_equal(ds.health_level_multi_hot[k], v)


@pytest.mark.parametrize("split", ["eval_valid", "eval_test"])
def test_eval_sets_match_jax(both, split):
    _, jdd, _, dd = both
    for a in ("n_users", "n_items", "num_users", "num_items", "n_ingredients"):
        assert getattr(dd, a) == getattr(jdd, a), a
    got, want = getattr(dd, split), getattr(jdd, split)
    for a in ("users", "cand", "n_pos", "n_cand"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
        assert getattr(got, a).dtype == getattr(want, a).dtype, a


@pytest.mark.parametrize("attr", ["train_u", "train_i", "excl_bitmap", "img",
                                  "txt", "ingre_codes", "ingre_num",
                                  "health_mh"])
def test_training_arrays_bitwise_equal(both, attr):
    """The arrays the train epoch and calculate_loss read, bit for bit and
    dtype for dtype."""
    _, jdd, _, dd = both
    got, want = getattr(dd, attr), getattr(jdd, attr)
    assert got.dtype == want.dtype and got.shape == want.shape, attr
    assert np.array_equal(np.ascontiguousarray(got).view(np.uint8),
                          np.ascontiguousarray(want).view(np.uint8)), attr
    assert dd.n_train == jdd.n_train


def test_food_data_training_attributes_match_jax(both):
    jds, _, ds, _ = both
    np.testing.assert_array_equal(ds._train_u, jds._train_u)
    np.testing.assert_array_equal(ds._train_i, jds._train_i)
    assert ds.validTestRatings == jds.validTestRatings
    for attr in ("embImage", "embText"):
        got, want = getattr(ds, attr), getattr(jds, attr)
        assert isinstance(got, np.memmap), attr  # not read into memory
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_eval_set_drops_first_repeat_of_positives():
    """A negative list repeating a positive (twice for user 0 and 1) loses
    only the first occurrence, positives lead, width pads to 128."""
    from foodrec_tpu.data.device import build_eval_set as jbuild
    from foodrec_tpu_torch.data.device import build_eval_set

    users = [0, 1, 2, 5]
    ratings = [[3, 5], [7], [1, 2, 9], []]
    negatives = [[5, 8, 5, 3, 10, 11], [7, 7, 4, 6, 2, 1],
                 [0, 4, 6, 8, 10, 12], [3, 3, 1, 0, 2, 4]]
    got = build_eval_set(users, ratings, negatives)
    want = jbuild(users, ratings, negatives)
    for a in ("users", "cand", "n_pos", "n_cand"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    assert got.cand[0, :7].tolist() == [3, 5, 8, 5, 10, 11, 0]
    assert got.width == 128


def _random_edges(seed, n, nnz, hub=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    if hub:
        rows = np.concatenate([rows, np.zeros(hub, np.int64)])
        cols = np.concatenate([cols, rng.choice(np.arange(1, n), hub,
                                                replace=False)])
    return rows, cols


@pytest.mark.parametrize("n,nnz,hub", [(17, 51, 0), (64, 192, 0),
                                       (300, 400, 200)])
def test_adjacency_bitwise_equal(n, nnz, hub):
    from foodrec_tpu.ops.graph import sym_normalized_adjacency as jsym
    from foodrec_tpu_torch.ops.graph import sym_normalized_adjacency

    rows, cols = _random_edges(n, n, nnz, hub)
    got, want = sym_normalized_adjacency(rows, cols, n), jsym(rows, cols, n)
    for a in ("rows", "cols", "vals"):
        g, w = getattr(got, a), getattr(want, a)
        assert g.dtype == w.dtype, a
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), a
    assert (got.max_degree, got.symmetric, got.has_ell) == (
        want.max_degree, want.symmetric, want.has_ell)
    if want.has_ell:
        np.testing.assert_array_equal(got.ell_cols, want.ell_cols)
        np.testing.assert_array_equal(got.ell_vals, want.ell_vals)
    csr = sp.coo_matrix((got.vals, (got.rows, got.cols)), shape=(n, n)).tocsr()
    assert got.row_ptr.dtype == np.int32
    np.testing.assert_array_equal(got.row_ptr, csr.indptr)


def _toy_graph_edges(synth_root, name):
    """The (rows, cols, n) FGCN builds its three row-normalized graphs from
    (fgcn.py:46-56), on the toy dataset."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData

    jcfg, _ = make_config(synth_root, model="FGCN",
                          overrides={"use_gpu": False})
    jds = JFoodData(jcfg)
    nu, ni, ng = jds.n_users, jds.n_items, jds.num_ingredients
    if name == "ru":
        t = jds.uRecipe_triples
        return t[:, 1] + nu, t[:, 0], nu + ni
    if name == "ir":
        t = jds.rIngre_triples
        return t[:, 1] + ni, t[:, 0], ni + ng
    t = jds.iIngre_triples
    return t[:, 1], t[:, 0], ng


@pytest.mark.parametrize("graph", ["ru", "ir", "ii", "isolated", "hub"])
def test_row_normalized_adjacency_bitwise_equal(synth_root, graph):
    """D^-1 A with the f32 reciprocal, bit for bit, on FGCN's three toy
    graphs, on a graph whose last two nodes have no edge and on a random one
    with a hub row; the CSR row pointer, and A^T built for the backward."""
    from foodrec_tpu.ops.graph import row_normalized_adjacency as jrow
    from foodrec_tpu.ops.graph import transpose_adjacency as jtranspose
    from foodrec_tpu_torch.ops.graph import (
        row_normalized_adjacency,
        transpose_adjacency,
    )

    if graph == "isolated":
        rows, cols = _random_edges(5, 40, 90)
        n = 42
    elif graph == "hub":
        rows, cols = _random_edges(6, 300, 400, hub=200)
        n = 300
    else:
        rows, cols, n = _toy_graph_edges(synth_root, graph)
    got, want = row_normalized_adjacency(rows, cols, n), jrow(rows, cols, n)
    assert not got.symmetric and not want.symmetric
    for g_adj, w_adj in ((got, want),
                         (transpose_adjacency(got), jtranspose(want))):
        for a in ("rows", "cols", "vals"):
            g, w = getattr(g_adj, a), getattr(w_adj, a)
            assert g.dtype == w.dtype, a
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), a
        assert (g_adj.max_degree, g_adj.has_ell) == (w_adj.max_degree,
                                                      w_adj.has_ell)
        csr = sp.coo_matrix((g_adj.vals, (g_adj.rows, g_adj.cols)),
                            shape=(n, n)).tocsr()
        np.testing.assert_array_equal(g_adj.row_ptr, csr.indptr)
    deg = np.diff(got.row_ptr)
    if graph == "isolated":
        assert (deg[-2:] == 0).all()
    # each nonempty row sums to 1 (float32)
    sums = np.bincount(got.rows, weights=got.vals, minlength=n)
    np.testing.assert_allclose(sums[deg > 0], 1.0, rtol=1e-6)


@pytest.mark.parametrize("model", ["FGCN", "PRICAI_ModelX"])
def test_graph_attributes_match_jax(synth_root, model):
    """The graph tables FGCN and CLUSSL read: user-recipe,
    ingredient-ingredient and recipe-ingredient int pairs, and the two
    k-means cluster edge lists, read as floats."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu_torch.data.dataset import FoodData

    jcfg, _ = make_config(synth_root, model=model,
                          overrides={"use_gpu": False})
    jds, ds = JFoodData(jcfg), FoodData(_port_config(synth_root, model))
    attrs = {"FGCN": ("uRecipe_triples", "rIngre_triples", "iIngre_triples"),
             "PRICAI_ModelX": ("rIngre_triples", "image_cluster_triples",
                               "text_cluster_triples")}[model]
    for attr in attrs:
        got, want = getattr(ds, attr), getattr(jds, attr)
        assert got.dtype == want.dtype and got.shape == want.shape, attr
        np.testing.assert_array_equal(got, want, err_msg=attr)
    absent = {"FGCN": "image_cluster_triples",
              "PRICAI_ModelX": "uRecipe_triples"}[model]
    assert not hasattr(ds, absent) and not hasattr(jds, absent)


def test_config_matches_jax_merge(synth_root):
    jcfg, _ = make_config(synth_root, model="CIKM_Model",
                          overrides={"use_gpu": False})
    cfg = _port_config(synth_root)
    assert cfg.final_config_dict == jcfg.final_config_dict
    assert cfg["device"] == "cpu"
    assert cfg["no_such_key"] is None


def test_config_raises_when_cuda_is_asked_for_and_absent(synth_root,
                                                         monkeypatch):
    import torch

    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Config(model="CIKM_Model", dataset="Synth")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
