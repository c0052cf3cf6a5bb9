"""PyTorch port, slice 4: LightGCN, BM3, FGCN and PRICAI_ModelX (CLUSSL)
against the JAX package on the toy synthetic dataset, with the same
parameters (carried over by params_from_jax) and the same batches, and the
self-supervised losses of `common/ssl_losses.py`.

Each model runs in the variants its options select: LightGCN flagD 0, 1, 3
(image, text, free item table), FGCN's three aggregators, CLUSSL with and
without the pretrained cluster centers. Tolerances, as the largest
|port - jax| over the largest |jax| of each array:
  * eval_cache 1e-5; by-user metrics 1e-6 (with a premise check that the
    score differences between the two frameworks cannot reorder a
    positive/negative pair)
  * calculate_loss in float32, dropout 0: loss parts 1e-5, gradients 1e-4,
    for both packages against the port in float64 as well; CLUSSL's
    gradients 1e-3: its dCor term takes sqrt(max(d^2, 0) + 1e-8) of the
    squared distances of each row to itself and to a repeated item, which
    are 0 in exact arithmetic, so float32 rounding there is amplified up to
    5,000-fold, and each package's float32 gradients lie 1e-4 to 2.5e-4
    from the float64 ones on these batches (measured). The float64
    certificate holds the mathematics.
  * float64, in a subprocess with JAX_ENABLE_X64: every loss part and
    gradient of every variant 1e-9 (the certificate); one lockstep epoch
    each for LightGCN and for FGCN (whose backward runs on A^T's own
    tables), loss parts, the trained model's outputs and its parameters
    1e-5, as tests/test_torch_port_train.py holds CIKM_Model
The SpMM runs the CUDA kernel's plain version: the tensors lie on the CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_config
from tests.test_torch_port_train import (
    _assert_rel,
    _jax_epoch_batches,
    _jax_loss_and_grads,
    _port_loss_and_grads,
    _rel_err,
    _torch_tree,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
GRAD_TOL = 1e-4
DCOR_GRAD_TOL = 1e-3  # CLUSSL's float32 gradients (module docstring)
BATCH_SIZE = 16
PARAM_SCALE = 8.0   # spreads the serving scores well beyond float32 noise

# (id, model, overrides); dropout 0 so both packages compute one function
VARIANTS = [
    ("lightgcn-image", "LightGCN", {"flagD": [0]}),
    ("lightgcn-text", "LightGCN", {"flagD": [1]}),
    ("lightgcn-id", "LightGCN", {"flagD": [3]}),
    ("bm3", "BM3", {"dropout": 0.0}),
    ("fgcn-gcn", "FGCN", {"aggregator_type": "gcn", "mess_dropout": 0.0}),
    ("fgcn-graphsage", "FGCN", {"aggregator_type": "graphsage",
                                "mess_dropout": 0.0}),
    ("fgcn-bi", "FGCN", {"aggregator_type": "bi", "mess_dropout": 0.0}),
    ("clussl", "PRICAI_ModelX", {"n_cluster": 5,
                                 "use_center_embedding": False}),
    ("clussl-centers", "PRICAI_ModelX", {"n_cluster": 5,
                                         "use_center_embedding": True}),
]
LOCKSTEP = ("lightgcn-text", "fgcn-bi")


def _overrides(extra):
    return {"train_batch_size": BATCH_SIZE, **extra}


def _port_model(synth_root, name, overrides, jparams=None,
                dtype=torch.float32, seed=0):
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.models import get_model
    from foodrec_tpu_torch.utils.weights import params_from_jax

    root, meta = synth_root
    cfg = Config(name, "Synth", {
        "data_path": root.rsplit("/Synth", 1)[0] + "/",
        "neg_sample_num": meta["neg_num"], "use_gpu": False, **overrides})
    derive_data_paths(cfg, "Synth")
    data = FoodData(cfg)
    data.device_data = DeviceData.from_food_data(data)
    model = get_model(name)(
        cfg, data, generator=torch.Generator().manual_seed(seed)).to(dtype)
    if jparams is not None:
        # after .to(dtype): under x64 some JAX leaves are float64 draws
        model.load_state_dict(params_from_jax(jparams, model))
    return cfg, data, model


def _jax_model(synth_root, name, overrides):
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.models import get_model as jget_model

    jcfg, _ = make_config(synth_root, model=name,
                          overrides={**overrides, "use_gpu": False})
    jdata = JFoodData(jcfg)
    jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
    jmodel = jget_model(name)(jcfg, jdata)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    return jcfg, jdata, jmodel, jparams


@pytest.fixture(scope="module", params=VARIANTS, ids=[v[0] for v in VARIANTS])
def pair(request, synth_root):
    vid, name, extra = request.param
    overrides = _overrides(extra)
    jcfg, jdata, jmodel, jparams = _jax_model(synth_root, name, overrides)
    cfg, data, model = _port_model(synth_root, name, overrides, jparams)
    return dict(vid=vid, name=name, overrides=overrides, jcfg=jcfg,
                jdata=jdata, jmodel=jmodel, jparams=jparams, cfg=cfg,
                data=data, model=model, synth_root=synth_root)


def test_config_matches_jax(pair):
    assert pair["cfg"].final_config_dict == pair["jcfg"].final_config_dict


def test_params_from_jax_carries_every_leaf(pair):
    """The JAX pytree's leaf set is the port's state_dict key set, and each
    leaf lands with its values."""
    from foodrec_tpu_torch.utils.weights import flatten_params

    flat = flatten_params(pair["jparams"])
    state = pair["model"].state_dict()
    assert sorted(state) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_eval_cache_matches_jax(pair):
    got = pair["model"].eval_cache()
    want = pair["jmodel"].eval_cache(pair["jparams"])
    assert len(got) == 2
    for g, w, side in zip(got, want, ("users", "items")):
        assert not g.requires_grad
        _assert_rel(g.numpy(), np.asarray(w), TOL, f"eval_cache {side}")


def _scaled(jparams):
    """The embedding tables times PARAM_SCALE: the scores spread out."""
    return {k: (np.asarray(v) * np.float32(PARAM_SCALE)
                if k.endswith("embedding") else v)
            for k, v in jparams.items()}


def test_evaluate_matches_jax(pair):
    """Trainer.evaluate on valid and test, by-user metrics within 1e-6 on
    the same (scaled) parameters, where every positive/negative score pair
    is further apart than twice the largest score difference between the
    two frameworks (so none can swap)."""
    from foodrec_tpu.engine.trainer import Trainer as JTrainer
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.utils.weights import params_from_jax

    jmodel, model = pair["jmodel"], pair["model"]
    jparams = _scaled(pair["jparams"])
    model = _port_model(pair["synth_root"], pair["name"],
                        pair["overrides"])[2]
    model.load_state_dict(params_from_jax(jparams, model))
    jdd, dd = pair["jdata"].device_data, model.dd
    jcache, cache = jmodel.eval_cache(jparams), model.eval_cache()
    for split, is_test in (("eval_valid", False), ("eval_test", True)):
        es = getattr(jdd, split)
        scores = np.asarray(jmodel.score_from_cache(jparams, jcache, es.users,
                                                    es.cand))
        # premise: the score differences between the two frameworks cannot
        # reorder any positive/negative pair
        noise = np.abs(model.score_from_cache(
            cache, torch.as_tensor(es.users).long(),
            torch.as_tensor(es.cand).long()).numpy() - scores).max()
        for b in range(es.n_users):
            p, c = es.n_pos[b], es.n_cand[b]
            if p:
                gap = np.abs(scores[b, :p, None] - scores[b, None, p:c]).min()
                assert gap > 2 * noise, (split, b, gap, noise)
        want = JTrainer(pair["jcfg"], jmodel).evaluate(jparams, es,
                                                        is_test=is_test)
        got = Trainer(model.config, model).evaluate(getattr(dd, split),
                                                    is_test=is_test)
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - float(want[k])) <= 1e-6, (split, k)


def _batch(dd, seed, b=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, dd.num_users, b), rng.integers(0, dd.n_items, b),
            rng.integers(0, dd.n_items, b))


@pytest.mark.parametrize("seed", [0, 1])
def test_calculate_loss_matches_jax(pair, seed):
    """The loss parts and every parameter's gradient in float32, both
    packages also against the port in float64."""
    from foodrec_tpu_torch.utils.weights import flatten_params

    grad_tol = DCOR_GRAD_TOL if pair["name"] == "PRICAI_ModelX" else GRAD_TOL
    model = pair["model"]
    model64 = _port_model(pair["synth_root"], pair["name"],
                          pair["overrides"], pair["jparams"],
                          dtype=torch.float64)[2]
    u, p, n = _batch(model.dd, seed)
    jparts, jgrads = _jax_loss_and_grads(pair["jmodel"], pair["jparams"],
                                         u, p, n)
    parts, grads = _port_loss_and_grads(model, u, p, n)
    _, grads64 = _port_loss_and_grads(model64, u, p, n)
    assert len(parts) == len(jparts)
    for i, (a, b) in enumerate(zip(parts, jparts)):
        _assert_rel(a, b, TOL, f"loss part {i}")
    jflat = flatten_params(jgrads)
    assert sorted(jflat) == sorted(grads)
    for k, g in grads.items():
        _assert_rel(g.numpy(), jflat[k], grad_tol, f"grad {k}")
        _assert_rel(g.numpy(), grads64[k].numpy(), grad_tol, f"f64 grad {k}")
        _assert_rel(jflat[k], grads64[k].numpy(), grad_tol,
                    f"jax f64 grad {k}")


@pytest.fixture(scope="module", autouse=True)
def x64_run(synth_root, tmp_path_factory):
    """This file run as a script under JAX_ENABLE_X64 (a subprocess, because
    x64 must be set before JAX configures itself), started when the
    module's first test starts so that it runs beside the float32 tests;
    killed at teardown if nothing waited for it. Yields (process, stdout
    path, stderr path)."""
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "True",
                "OMP_NUM_THREADS": "1",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    out_dir = tmp_path_factory.mktemp("x64")
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
    """The float64 run's stdout: the certificate of every variant and the
    lockstep epochs."""
    proc, (out, err) = x64_run
    proc.wait(timeout=900)
    stdout, stderr = out.read_text(), err.read_text()
    assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
    return stdout


@pytest.mark.parametrize("vid", [v[0] for v in VARIANTS])
def test_calculate_loss_float64_certificate(x64_report, vid):
    """The port in torch.float64 against the JAX package under
    JAX_ENABLE_X64: loss parts and every gradient within 1e-9 relative."""
    assert f"certificate {vid} pass_1e-9=True" in x64_report, \
        x64_report[-3000:]


@pytest.mark.parametrize("vid", LOCKSTEP)
def test_lockstep_epoch_matches_jax(x64_report, vid):
    """One epoch of the JAX package's jit epoch replayed through the port's
    `train_steps` on the same batches, in float64: the loss parts, every
    parameter leaf in L2 norm and the trained model's outputs (eval_cache,
    the loss parts of a probe batch) within 1e-5 relative."""
    assert f"lockstep {vid} pass=True" in x64_report, x64_report[-3000:]


def _variant(vid):
    return next(v for v in VARIANTS if v[0] == vid)


def _certificate(root, vid):
    from foodrec_tpu_torch.utils.weights import flatten_params

    _, name, extra = _variant(vid)
    synth = (root, {"neg_num": 20})
    overrides = _overrides(extra)
    _, _, jmodel, jparams = _jax_model(synth, name, overrides)
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
    buf64 = _buffers64(jmodel)
    model = _port_model(synth, name, overrides, jparams,
                        dtype=torch.float64)[2]
    worst_parts = worst_grads = 0.0
    for seed in (0, 1):
        u, p, n = _batch(model.dd, seed)
        jparts, jgrads = _jax_loss_and_grads(jmodel, params64, u, p, n,
                                             dtype=jnp.float64, buffers=buf64)
        parts, grads = _port_loss_and_grads(model, u, p, n)
        assert parts.dtype == np.float64
        worst_parts = max([worst_parts] + [_rel_err(a, b)
                                           for a, b in zip(parts, jparts)])
        jflat = flatten_params(jgrads)
        for k, g in grads.items():
            assert g.dtype == torch.float64, k
            worst_grads = max(worst_grads, _rel_err(g.numpy(), jflat[k]))
    ok = worst_parts <= 1e-9 and worst_grads <= 1e-9
    print(f"certificate {vid} worst_parts={worst_parts:.3e} "
          f"worst_grads={worst_grads:.3e}")
    print(f"certificate {vid} pass_1e-9={ok}", flush=True)


def _buffers64(jmodel):
    return jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float64)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x, jmodel.buffers)


def _lockstep(root, vid):
    """One JAX epoch and its replay through the port, then a second epoch's
    loss parts; prints the worst relative errors and whether they are
    within 1e-5."""
    from foodrec_tpu.engine.trainer import Trainer as JTrainer
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.utils.weights import flatten_params

    _, name, extra = _variant(vid)
    synth = (root, {"neg_num": 20})
    overrides = _overrides(extra)
    jcfg, _, jmodel, jparams = _jax_model(synth, name, overrides)
    jtrainer = JTrainer(jcfg, jmodel)
    cfg, _, model = _port_model(synth, name, overrides, jparams,
                                dtype=torch.float64)
    trainer = Trainer(cfg, model)
    assert trainer.n_batches == jtrainer.n_batches > 2

    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
    opt_state = jtrainer.optimizer.init(params)
    buf64 = _buffers64(jmodel)
    probe = _batch(model.dd, 5)
    key = jax.random.PRNGKey(11)
    worst = {"parts": 0.0, "outputs": 0.0, "params_l2": 0.0}
    for epoch in range(2):
        key, k_epoch = jax.random.split(key)
        batches = _jax_epoch_batches(jtrainer, k_epoch)
        params, opt_state, jparts = jtrainer._epoch_fn(params, opt_state,
                                                       k_epoch)
        parts = trainer.train_steps(
            tuple(torch.as_tensor(a, dtype=torch.int64) for a in b)
            for b in batches)
        trainer.scheduler.step()
        worst["parts"] = max([worst["parts"]] + [
            _rel_err(a, b) for a, b in zip(parts.numpy(), np.asarray(jparts))])
        if epoch > 0:
            continue
        with jmodel.bind(buf64):
            jcache = jmodel.eval_cache(params)
        outs = [_rel_err(a.numpy(), b)
                for a, b in zip(model.eval_cache(), jcache)]
        probe_j, _ = _jax_loss_and_grads(jmodel, params, *probe,
                                         dtype=jnp.float64, buffers=buf64)
        probe_t, _ = _port_loss_and_grads(model, *probe)
        outs += [_rel_err(a, b) for a, b in zip(probe_t, probe_j)]
        state = model.state_dict()
        worst["outputs"] = max(outs)
        worst["params_l2"] = max(
            np.linalg.norm(state[k].numpy() - v) / np.linalg.norm(v)
            for k, v in flatten_params(jax.device_get(params)).items())
    ok = all(v <= 1e-5 for v in worst.values())
    print(f"lockstep {vid} " + " ".join(f"worst_{k}={v:.3e}"
                                        for k, v in worst.items()))
    print(f"lockstep {vid} pass={ok}", flush=True)


# ---------------------------------------------------------------------------
# dropout, options, registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,extra", [("BM3", {"dropout": 0.3}),
                                        ("FGCN", {"mess_dropout": 0.1})])
def test_dropout_draws_from_the_generator(synth_root, name, extra):
    """The same generator seed gives the same loss, another seed another
    one; serving (eval_cache) draws nothing."""
    _, _, model = _port_model(synth_root, name, _overrides(extra))
    u, p, n = (torch.as_tensor(a) for a in _batch(model.dd, 0))

    def loss(seed):
        with torch.no_grad():
            parts = model.calculate_loss(
                u, p, n, generator=torch.Generator().manual_seed(seed))
        return torch.stack(parts)

    assert torch.equal(loss(3), loss(3))
    assert not torch.equal(loss(3), loss(4))
    a, b = model.eval_cache(), model.eval_cache()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name,extra", [("LightGCN", {"flagD": [1]}),
                                        ("BM3", {"dropout": 0.0})])
def test_frozen_modality_tables_match_jax(synth_root, name, extra):
    """`freeze_modality_tables: True`: the feature tables are buffers, so
    the JAX pytree (which leaves them out) maps onto the state_dict; the
    serving embeddings, the loss parts and every gradient in float32 match
    the JAX package's frozen model (the float64 certificate is in
    test_torch_port_options.py)."""
    from foodrec_tpu_torch.utils.weights import flatten_params

    overrides = _overrides({"freeze_modality_tables": True, **extra})
    _, _, jmodel, jparams = _jax_model(synth_root, name, overrides)
    model = _port_model(synth_root, name, overrides, jparams)[2]
    assert "image_embedding" in dict(model.named_buffers())
    assert sorted(model.state_dict()) == sorted(flatten_params(jparams))
    for g, w in zip(model.eval_cache(), jmodel.eval_cache(jparams)):
        _assert_rel(g.numpy(), np.asarray(w), TOL, "eval_cache")
    u, p, n = _batch(model.dd, 0)
    jparts, jgrads = _jax_loss_and_grads(jmodel, jparams, u, p, n)
    parts, grads = _port_loss_and_grads(model, u, p, n)
    for i, (a, b) in enumerate(zip(parts, jparts)):
        _assert_rel(a, b, TOL, f"loss part {i}")
    jflat = flatten_params(jgrads)
    assert sorted(jflat) == sorted(grads)
    for k, g in grads.items():
        _assert_rel(g.numpy(), jflat[k], GRAD_TOL, f"grad {k}")


def test_registry_resolves_the_ported_models():
    from foodrec_tpu_torch.models import PORTED, get_model

    for name in PORTED:
        assert get_model(name).__name__ == name
    with pytest.raises(ValueError, match="PRICAI_ModelX"):
        get_model("NoSuchModel")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,weighted", [("emb_loss", False),
                                           ("l2_loss", False),
                                           ("l2_loss", True)])
def test_other_losses_match_jax(name, weighted, seed):
    """The unweighted emb_loss (BM3's reg over whole tables: norms over the
    last tensor's row count) and l2_loss, values and VJPs at 1e-5."""
    from foodrec_tpu.common import loss as jl
    from foodrec_tpu_torch.common import loss as tl

    rng = np.random.default_rng(seed)
    embs = (rng.standard_normal((13, 8)).astype(np.float32),
            rng.standard_normal((9, 5, 8)).astype(np.float32))
    w = (rng.random(9) < 0.8).astype(np.float32)
    if weighted:
        embs = (embs[0][:9],) + embs[1:]
    jkw = {"weight": jnp.asarray(w)} if weighted else {}
    tkw = {"weight": torch.from_numpy(w)} if weighted else {}
    y, vjp = jax.vjp(lambda *e: getattr(jl, name)(*e, **jkw), *embs)
    jgrads = vjp(jnp.ones((), jnp.float32))
    targs = [_torch_tree(e) for e in embs]
    yt = getattr(tl, name)(*targs, **tkw)
    _assert_rel(yt.detach().numpy(), y, TOL, f"{name} value")
    for i, (g, jg) in enumerate(zip(torch.autograd.grad(yt, targs), jgrads)):
        _assert_rel(g.numpy(), np.asarray(jg), TOL, f"{name} grad {i}")


# ---------------------------------------------------------------------------
# self-supervised losses
# ---------------------------------------------------------------------------


def _ssl_inputs(name, rng):
    """Rows of norm ~3e-3 (squared distances ~1e-5, well above dCor's 1e-8).
    dCor's VJP amplifies the float32 rounding of the zero distance of each
    row to itself (and to a repeated row) in proportion to the rows' norm
    (module docstring): at unit norm each package's float32 VJP lies
    0.5e-3 to 3e-3 from float64, at this norm under 5e-6, so a wrong formula
    shows and rounding does not."""
    b, d = 12, 8
    views = [(1e-3 * rng.standard_normal((b, d))).astype(np.float32)
             for _ in range(3)]
    views[1][3] = views[1][7]  # a repeated row: a zero distance off the
    # diagonal
    if name == "cl_loss":
        return (np.concatenate(views[:2]),), np.ones((), np.float32)
    if name == "correlation_distance":
        return tuple(views[:2]), np.ones((), np.float32)
    return tuple(views), np.ones((), np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["correlation_distance", "cl_loss",
                                  "poly_view_cl", "min_mutual_information",
                                  "orthogonal_loss"])
def test_ssl_losses_match_jax(name, seed):
    """Value and VJP of every function in float32 at 1e-5."""
    from foodrec_tpu.common import ssl_losses as js
    from foodrec_tpu_torch.common import ssl_losses as ts

    args, cot = _ssl_inputs(name, np.random.default_rng(seed))
    jfn, tfn = getattr(js, name), getattr(ts, name)
    y, vjp = jax.vjp(jfn, *args)
    jgrads = vjp(jnp.asarray(cot))
    targs = [_torch_tree(a) for a in args]
    yt = tfn(*targs)
    _assert_rel(yt.detach().numpy(), y, TOL, f"{name} value")
    tgrads = torch.autograd.grad(yt, targs)
    for i, (g, jg) in enumerate(zip(tgrads, jgrads)):
        _assert_rel(g.numpy(), np.asarray(jg), TOL, f"{name} grad {i}")


if __name__ == "__main__":
    for v in VARIANTS:
        _certificate(sys.argv[1], v[0])
    for vid in LOCKSTEP:
        _lockstep(sys.argv[1], vid)
