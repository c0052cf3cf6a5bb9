"""PyTorch port: the utilities no shipped model reads, against the JAX
package on seeded inputs: the kNN-graph helpers (utils/graph_utils.py) and
the MLPLayers stack (common/module.py) within 1e-6 relative in float32, on
inputs whose rows have no top-k ties; the cosine probe
(utils/diagnostics.py) within 1e-12 in float64, and its path through the
trainer, which skips it on the six shipped models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_models import _port_model
from test_torch_port_train import _rel_err

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: the suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sim(seed, n=12, d=6):
    """A cosine-similarity matrix of seeded points, and the points."""
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_build_sim_and_knn_match_jax(seed):
    from foodrec_tpu.utils import graph_utils as jg
    from foodrec_tpu_torch.utils import graph_utils as tg

    x = _sim(seed)
    want = np.asarray(jg.build_sim(jnp.asarray(x)))
    got = tg.build_sim(torch.from_numpy(x))
    assert _rel_err(got.numpy(), want) <= TOL
    sim = torch.from_numpy(want)
    srt = np.sort(want, axis=1)
    assert (np.diff(srt, axis=1)[:, -4:] > 1e-4).all()  # no top-4 ties
    for k in (1, 3):
        assert np.array_equal(
            tg.build_knn_neighbourhood(sim, k).numpy(),
            np.asarray(jg.build_knn_neighbourhood(jnp.asarray(want), k)))
    a = np.abs(want)
    assert _rel_err(tg.compute_normalized_laplacian(torch.from_numpy(a))
                    .numpy(), np.asarray(jg.compute_normalized_laplacian(
                        jnp.asarray(a)))) <= TOL


@pytest.mark.parametrize("norm", ["none", "sym", "rw"])
def test_laplacians_match_jax(norm):
    """get_sparse_laplacian (with a node of no out-edge), get_dense_laplacian
    and build_knn_normalized_graph, dense and sparse."""
    from foodrec_tpu.utils import graph_utils as jg
    from foodrec_tpu_torch.utils import graph_utils as tg

    rng = np.random.default_rng(2)
    edge_index = np.array([[0, 0, 1, 2, 2, 4], [1, 2, 0, 1, 4, 0]])
    w = rng.random(6).astype(np.float32) + 0.5
    ei, ew = tg.get_sparse_laplacian(torch.from_numpy(edge_index),
                                     torch.from_numpy(w), 5, norm)
    jei, jew = jg.get_sparse_laplacian(jnp.asarray(edge_index),
                                       jnp.asarray(w), 5, norm)
    assert np.array_equal(ei.numpy(), np.asarray(jei))
    assert _rel_err(ew.numpy(), np.asarray(jew)) <= TOL
    adj = np.abs(_sim(3, n=10))
    adj = np.abs(np.asarray(jg.build_sim(jnp.asarray(_sim(3, n=10)))))
    adj[4] = 0.0  # an empty row: its degree's inverse is 0
    assert _rel_err(tg.get_dense_laplacian(torch.from_numpy(adj), norm)
                    .numpy(), np.asarray(jg.get_dense_laplacian(
                        jnp.asarray(adj), norm))) <= TOL
    adj[4] = np.abs(_sim(4, n=10)[:, 0])
    for sparse in (True, False):
        got = tg.build_knn_normalized_graph(torch.from_numpy(adj), 3,
                                            sparse, norm)
        want = jg.build_knn_normalized_graph(jnp.asarray(adj), 3, sparse,
                                             norm)
        if sparse:
            assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
            assert _rel_err(got[1].numpy(), np.asarray(want[1])) <= TOL
        else:
            assert _rel_err(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("init_method", [None, "norm"])
@pytest.mark.parametrize("activation,last", [("relu", True),
                                             ("tanh", False),
                                             ("leakyrelu", True),
                                             ("sigmoid", False)])
def test_mlp_layers_match_jax(init_method, activation, last):
    """The JAX package's parameters through both stacks; the port's own
    init has the same layout and the distribution's bounds."""
    from foodrec_tpu.common import module as jm
    from foodrec_tpu_torch.common import module as tm
    from foodrec_tpu_torch.utils.weights import flatten_params

    layers = [8, 6, 4]
    jparams = jax.device_get(jm.mlp_layers_params(
        jax.random.PRNGKey(0), layers, init_method=init_method))
    x = np.random.default_rng(5).normal(size=(5, 8)).astype(np.float32)
    want = np.asarray(jm.mlp_layers_apply(jparams, jnp.asarray(x),
                                          activation=activation,
                                          last_activation=last))
    tparams = [{k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
               for p in jparams]
    got = tm.mlp_layers_apply(tparams, torch.from_numpy(x),
                              activation=activation, last_activation=last)
    assert _rel_err(got.numpy(), want) <= TOL
    own = tm.mlp_layers_params(torch.Generator().manual_seed(0), layers,
                               init_method=init_method)
    flat, jflat = flatten_params(own), flatten_params(jparams)
    assert sorted(flat) == sorted(jflat)  # 0.w, 0.b, 1.w, 1.b
    for k, v in flat.items():
        assert tuple(v.shape) == np.shape(jflat[k]), k
    if init_method is None:
        assert float(own[0]["w"].abs().max()) <= 1 / np.sqrt(8)
    else:
        assert not own[0]["b"].any()


def test_mlp_layers_dropout_draws_from_its_generator():
    from foodrec_tpu_torch.common.module import (
        mlp_layers_apply,
        mlp_layers_params,
    )

    params = mlp_layers_params(torch.Generator().manual_seed(1), [8, 8])
    x = torch.ones(64, 8)

    def run(seed):
        return mlp_layers_apply(params, x, drop_rate=0.5,
                                generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    assert torch.equal(mlp_layers_apply(params, x), mlp_layers_apply(
        params, x, drop_rate=0.0))


def test_cos_similarity_float64_matches_jax():
    """The probe's four cosines within 1e-12 of the JAX package's in
    float64. The two fractions are counts over N * D entries: JAX takes the
    mean of a bool array in float32 even under x64 (36 / 80 comes out
    0.45000001788), so they are held to the same count and to float32's
    resolution."""
    from foodrec_tpu.utils.diagnostics import embedding_cos_similarity as jcos
    from foodrec_tpu_torch.utils.diagnostics import embedding_cos_similarity

    rng = np.random.default_rng(1)
    mats = [rng.normal(size=(10, 8)) for _ in range(6)]
    mats[3][2] = 0.0  # a zero gradient row: its cosine is 0 (eps clamp)
    with jax.enable_x64(True):
        want = [float(v) for v in jcos(*(jnp.asarray(m) for m in mats))]
    got = embedding_cos_similarity(*(torch.from_numpy(m) for m in mats))
    assert all(g.dtype == torch.float64 for g in got)
    for g, w in zip(got[:4], want[:4]):
        assert abs(float(g) - w) <= 1e-12 * max(1.0, abs(w)), (g, w)
    n = mats[0].size
    for g, w in zip(got[4:], want[4:]):
        assert round(float(g) * n) == round(w * n) and 0 < w < 1
        assert abs(float(g) - w) <= 2.0 ** -23 * w, (g, w)


def test_diagnostic_embeddings_on_the_shipped_models(synth_root):
    """None on the six shipped models (their id, text and image tables
    are missing or of other widths), a tuple where all three share one
    width, as the JAX package's base model decides."""
    from foodrec_tpu.models.base import GeneralRecommender as JBase

    overrides = {"PRICAI_ModelX": {"n_cluster": 5}}
    for name in ("CIKM_Model", "LightGCN", "BM3", "FGCN", "PRICAI_ModelX",
                 "SCHGN"):
        model = _port_model(synth_root, name, overrides.get(name, {}))[2]
        tree = dict(model.named_parameters())
        assert model.diagnostic_embeddings(tree) is None, name
        assert JBase.diagnostic_embeddings(
            None, {k: v.detach().numpy() for k, v in tree.items()}) is None
    same = {k: torch.ones(4, 3) for k in ("item_embedding", "text_embedding",
                                          "image_embedding")}
    got = model.diagnostic_embeddings(same)
    assert len(got) == 3 and got[0] is same["item_embedding"]


def test_cosine_probe_through_the_trainer(synth_root, caplog):
    """`calcu_cos_similarity`: the epoch sums the six numbers of every step
    and fit logs them; zeros on a shipped model, as the JAX package's
    (trainer.py:332-334), and the probe's values where the model has
    same-width tables (here LightGCN's free item table standing for all
    three: cosine 1, no row above itself)."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    model = _port_model(synth_root, "LightGCN", {
        "train_batch_size": 16, "calcu_cos_similarity": True, "epochs": 1,
        "eval_step": 1})[2]
    trainer = Trainer(model.config, model)
    trainer.train_epoch()
    assert torch.equal(trainer._epoch_cos_sim, torch.zeros(6))

    def same_width(tree):
        t = tree.get("item_embedding")
        return None if t is None else (t, t, t)

    model.diagnostic_embeddings = same_width
    with caplog.at_level("INFO"):
        trainer.fit(model.dataset)
    sim = trainer._epoch_cos_sim.numpy()
    n = trainer.n_batches
    np.testing.assert_allclose(sim[[0, 2]], n, rtol=1e-6)
    assert sim[4] == sim[5] == 0.0
    assert "cos-sim (summed over batches) [id-text: " in caplog.text
