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
