"""PyTorch port, training slice: CIKM_Model's blocks, losses, calculate_loss,
negative sampler and train epoch against the JAX package on the toy
synthetic dataset, with the same parameters (carried over by
params_from_jax) and the same batches.

Tolerances, as the largest |port - jax| over the largest |jax| of each
array (float32 sums taken in other orders):
  * blocks and losses, values and gradients: 1e-5
  * calculate_loss: the loss parts 1e-5; the parameter gradients 1e-4, for
    both packages against the port in float64 as well. The health head
    normalizes item_health over its two query rows (dim 1), and a feature
    column whose two entries are both near zero has a tiny norm: the
    gradient there is float32 rounding of the forward values amplified by
    1/norm, so each package's float32 gradients already lie above 1e-5 from
    the float64 ones on these batches, and a 1e-5 bar between the two would
    test rounding luck. The float64 certificate holds the mathematics.
  * float64, in a subprocess with JAX_ENABLE_X64: calculate_loss parts and
    gradients 1e-9 (the certificate); two lockstep epochs, loss parts and
    the trained model's outputs 1e-5, parameters 1e-4 in L2 norm (see
    test_lockstep_epochs_match_jax for why)
The SpMM inside runs the CUDA kernel's plain version, because the tensors
lie on the CPU.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
GRAD_TOL = 1e-4   # float32 calculate_loss gradients (module docstring)
BATCH_SIZE = 16   # several steps and an exact tail on the toy set


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:
        return 0.0
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    return err / scale if scale > 0 else err


def _assert_rel(got, want, tol, name):
    err = _rel_err(got, want)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def _torch_tree(tree, dtype=torch.float32):
    """A nested dict/list of numpy leaves as tensors that need a gradient."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_torch_tree(v, dtype) for v in tree]
    return torch.tensor(np.asarray(tree), dtype=dtype, requires_grad=True)


def _perturb(tree, rng, scale=0.1):
    """Every leaf plus noise, so that LayerNorm gains and zero biases are
    not trivially 1 and 0."""
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), tree)


def _compare_vjp(jfn, jargs, tfn, targs, cot, name):
    """Output and gradients of every argument of jfn/tfn against each other
    for the cotangent `cot`."""
    from foodrec_tpu_torch.utils.weights import flatten_params

    y, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(cot))
    yt = tfn(*targs)
    _assert_rel(yt.detach().numpy(), y, TOL, f"{name} output")
    leaves = flatten_params(list(targs))
    tgrads = torch.autograd.grad((yt * torch.from_numpy(cot)).sum(),
                                 list(leaves.values()), allow_unused=True)
    jflat = flatten_params(jax.device_get(list(jgrads)))
    for (k, _), g in zip(leaves.items(), tgrads):
        g = np.zeros(np.shape(jflat[k])) if g is None else g.numpy()
        _assert_rel(g, jflat[k], TOL, f"{name} grad {k}")


# ---------------------------------------------------------------------------
# blocks and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transformer_encoder_matches_jax(seed):
    """Post-LN encoder with a key-padding mask, one query row fully padded
    (its attention is NaN -> 0) and one with no padding."""
    from foodrec_tpu.common import module as jm
    from foodrec_tpu_torch.common import module as tm

    rng = np.random.default_rng(seed)
    b, L, d, nhead = 5, 7, 16, 2
    params = _perturb(jax.device_get(jm.transformer_encoder_params(
        jax.random.PRNGKey(seed), d, 4 * d, 2)), rng)
    x = rng.standard_normal((b, L, d)).astype(np.float32)
    pad = rng.random((b, L)) < 0.4
    pad[0], pad[1] = True, False
    cot = rng.standard_normal((b, L, d)).astype(np.float32)

    _compare_vjp(
        lambda p, x: jm.transformer_encoder_apply(
            p, x, nhead, pad_mask=jnp.asarray(pad), act="gelu"),
        (params, x),
        lambda p, x: tm.transformer_encoder_apply(
            p, x, nhead, pad_mask=torch.from_numpy(pad), act="gelu"),
        (_torch_tree(params), _torch_tree(x)), cot, "encoder")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("masked", [True, False])
def test_target_attention_matches_jax(seed, masked):
    """Both uses in CIKM_Model: multimodal queries over padded ingredient
    keys (the -2^32+1 mask), and ingredients over the two multimodal rows."""
    from foodrec_tpu.common import module as jm
    from foodrec_tpu_torch.common import module as tm

    rng = np.random.default_rng(seed)
    b, lq, lk, d, nhead = 6, 2, 9, 16, 2
    if not masked:
        lq, lk = lk, lq
    params = _perturb(jax.device_get(jm.target_attention_params(d // nhead)),
                      rng)
    q = rng.standard_normal((b, lq, d)).astype(np.float32)
    kv = rng.standard_normal((b, lk, d)).astype(np.float32)
    pad_id = 50
    ids = np.where(rng.random((b, lk)) < 0.4, pad_id,
                   rng.integers(0, pad_id, (b, lk)))
    ids[0, 0] = 1  # keep one key in every row
    cot = rng.standard_normal((b, lq, d)).astype(np.float32)
    kw = dict(padding_idx=pad_id) if masked else {}

    _compare_vjp(
        lambda p, q, kv: jm.target_attention_apply(
            p, q, kv, nhead, seq_ids=jnp.asarray(ids) if masked else None,
            **kw)[0],
        (params, q, kv),
        lambda p, q, kv: tm.target_attention_apply(
            p, q, kv, nhead, seq_ids=torch.from_numpy(ids) if masked else None,
            **kw),
        (_torch_tree(params), _torch_tree(q), _torch_tree(kv)), cot,
        "target_attention")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mlp_2layer_matches_jax(seed):
    from foodrec_tpu.common import module as jm
    from foodrec_tpu_torch.common import module as tm

    rng = np.random.default_rng(seed)
    params = _perturb(jax.device_get(
        jm.mlp_2layer_params(jax.random.PRNGKey(seed), 16, 16, 6)), rng)
    x = rng.standard_normal((11, 16)).astype(np.float32)
    cot = rng.standard_normal((11, 6)).astype(np.float32)
    _compare_vjp(jm.mlp_2layer_apply, (params, x), tm.mlp_2layer_apply,
                 (_torch_tree(params), _torch_tree(x)), cot, "mlp_2layer")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_losses_match_jax(seed):
    """bpr_loss and the weighted emb_loss (the epoch always passes a
    weight), values and gradients; a zero weight drops its row."""
    from foodrec_tpu.common import loss as jl
    from foodrec_tpu_torch.common import loss as tl

    rng = np.random.default_rng(seed)
    b = 13
    pos, neg = (rng.standard_normal(b).astype(np.float32) * 3
                for _ in range(2))
    w = (rng.random(b) < 0.8).astype(np.float32)
    embs = [rng.standard_normal((b, 8)).astype(np.float32),
            rng.standard_normal((b, 5, 8)).astype(np.float32)]
    one = np.ones((), np.float32)

    _compare_vjp(lambda p, n: jl.bpr_loss(p, n, weight=jnp.asarray(w)),
                 (pos, neg),
                 lambda p, n: tl.bpr_loss(p, n, weight=torch.from_numpy(w)),
                 (_torch_tree(pos), _torch_tree(neg)), one, "bpr_loss")
    _compare_vjp(lambda a, c: jl.emb_loss(a, c, weight=jnp.asarray(w)),
                 tuple(embs),
                 lambda a, c: tl.emb_loss(a, c, weight=torch.from_numpy(w)),
                 tuple(_torch_tree(e) for e in embs), one, "emb_loss")


def test_dropout_draws_from_its_generator():
    from foodrec_tpu_torch.common.module import dropout

    x = torch.ones(4000)
    a = dropout(x, 0.5, torch.Generator().manual_seed(3))
    b = dropout(x, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert abs(float((a == 0).float().mean()) - 0.5) < 0.05
    assert dropout(x, 0.0, None) is x


# ---------------------------------------------------------------------------
# negative sampling
# ---------------------------------------------------------------------------


def _bitmap(excluded, num_items):
    """uint32 packed bitmap with bit i of row u set for i in excluded[u]."""
    words = -(-num_items // 32)
    bm = np.zeros((len(excluded), words), np.uint32)
    for u, items in enumerate(excluded):
        for i in items:
            bm[u, i >> 5] |= np.uint32(1) << np.uint32(i & 31)
    return bm


def test_sampler_invariants():
    """No excluded item where a free one exists, every draw in
    [0, num_items), and the fall-back to the last draw for a user who
    excludes every item. The bitmap's int32 view reads the same bits as the
    JAX package's uint32 words, bit 31 included."""
    from foodrec_tpu.data.sampling import is_excluded as jis_excluded
    from foodrec_tpu_torch.data.sampling import is_excluded, sample_negatives

    num_items = 70
    excluded = [set(range(0, num_items, 2)) | {31, 63}, set(range(num_items)),
                set(), {5, 31, 32}]
    bm = _bitmap(excluded, num_items)
    bm_t = torch.from_numpy(bm.view(np.int32))
    users = torch.arange(len(excluded)).repeat_interleave(500)
    items = torch.arange(num_items).repeat(len(excluded))
    uu = torch.arange(len(excluded)).repeat_interleave(num_items)
    got = is_excluded(bm_t, uu, items).numpy()
    want = np.asarray(jis_excluded(jnp.asarray(bm), jnp.asarray(uu.numpy()),
                                   jnp.asarray(items.numpy())))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == sum(len(e) for e in excluded)

    n_tries = 32
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    neg = sample_negatives(users, bm_t, num_items, gen, n_tries=n_tries)
    assert neg.dtype == torch.int64 and neg.shape == users.shape
    assert bool(((neg >= 0) & (neg < num_items)).all())
    for u, items in enumerate(excluded):
        picked = set(neg[users == u].tolist())
        if u == 1:
            # every draw collides: the last of the n_tries draws is taken
            draws = torch.randint(0, num_items, (n_tries, users.numel()),
                                  generator=torch.Generator().set_state(state))
            assert torch.equal(neg[users == u], draws[-1][users == u])
        else:
            assert not picked & items, (u, picked & items)


# ---------------------------------------------------------------------------
# the model and the epoch against the JAX package
# ---------------------------------------------------------------------------


def _overrides(extra=None):
    return {"attention_probs_dropout_prob": 0.0,
            "train_batch_size": BATCH_SIZE, **(extra or {})}


def _port_model(synth_root, overrides, jparams=None, dtype=torch.float32):
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.models import get_model
    from foodrec_tpu_torch.utils.weights import params_from_jax

    root, meta = synth_root
    cfg = Config("CIKM_Model", "Synth", {
        "data_path": root.rsplit("/Synth", 1)[0] + "/",
        "neg_sample_num": meta["neg_num"], "use_gpu": False, **overrides})
    derive_data_paths(cfg, "Synth")
    data = FoodData(cfg)
    data.device_data = DeviceData.from_food_data(data)
    model = get_model("CIKM_Model")(
        cfg, data, generator=torch.Generator().manual_seed(0)).to(dtype)
    if jparams is not None:
        # after .to(dtype): under x64 some JAX leaves are float64 draws
        model.load_state_dict(params_from_jax(jparams, model))
    return cfg, data, model


@pytest.fixture(scope="module")
def pair(synth_root):
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.models import get_model as jget_model

    jcfg, _ = make_config(synth_root, model="CIKM_Model",
                          overrides=_overrides())
    jdata = JFoodData(jcfg)
    jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
    jmodel = jget_model("CIKM_Model")(jcfg, jdata)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    cfg, data, model = _port_model(synth_root, _overrides(), jparams)
    return dict(jcfg=jcfg, jdata=jdata, jmodel=jmodel, jparams=jparams,
                cfg=cfg, data=data, model=model, synth_root=synth_root)


def _batch(dd, seed, b=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, dd.num_users, b), rng.integers(0, dd.n_items, b),
            rng.integers(0, dd.n_items, b))


def _jax_loss_and_grads(jmodel, jparams, u, p, n, dtype=jnp.float32,
                        buffers=None):
    batch = {"u_id": jnp.asarray(u, jnp.int32),
             "pos_i_id": jnp.asarray(p, jnp.int32),
             "neg_i_id": jnp.asarray(n, jnp.int32),
             "weight": jnp.ones(len(u), dtype), "key": jax.random.PRNGKey(0)}

    def fn(params):
        if buffers is None:
            parts = jmodel.calculate_loss(params, batch)
        else:
            with jmodel.bind(buffers):
                parts = jmodel.calculate_loss(params, batch)
        return sum(parts), jnp.stack(parts)

    (_, parts), grads = jax.value_and_grad(fn, has_aux=True)(jparams)
    return np.asarray(parts), jax.device_get(grads)


def _port_loss_and_grads(model, u, p, n):
    model.zero_grad(set_to_none=True)
    parts = model.calculate_loss(*(torch.as_tensor(a) for a in (u, p, n)))
    sum(parts).backward()
    return (torch.stack(parts).detach().numpy(),
            {k: v.grad for k, v in model.named_parameters()})


@pytest.fixture(scope="module")
def port_f64(pair):
    """The port in float64 with the same parameters: the reference the
    float32 gradients of both packages are held to."""
    return _port_model(pair["synth_root"], _overrides(), pair["jparams"],
                       dtype=torch.float64)[2]


@pytest.mark.parametrize("seed", [0, 1])
def test_calculate_loss_matches_jax(pair, port_f64, seed):
    """The four loss parts (mf, health, kd, reg) and the gradient of every
    parameter, float32, dropout 0; both packages' float32 gradients also
    against the port's float64 ones."""
    from foodrec_tpu_torch.utils.weights import flatten_params

    u, p, n = _batch(pair["model"].dd, seed)
    jparts, jgrads = _jax_loss_and_grads(pair["jmodel"], pair["jparams"],
                                         u, p, n)
    parts, grads = _port_loss_and_grads(pair["model"], u, p, n)
    _, grads64 = _port_loss_and_grads(port_f64, u, p, n)
    for i, (a, b) in enumerate(zip(parts, jparts)):
        _assert_rel(a, b, TOL, f"loss part {i}")
    jflat = flatten_params(jgrads)
    assert sorted(jflat) == sorted(grads)
    for k, g in grads.items():
        _assert_rel(g.numpy(), jflat[k], GRAD_TOL, f"grad {k}")
        _assert_rel(g.numpy(), grads64[k].numpy(), GRAD_TOL, f"f64 grad {k}")
        _assert_rel(jflat[k], grads64[k].numpy(), GRAD_TOL,
                    f"jax f64 grad {k}")
    # the ingredient pad row trains (encoder and KD paths)
    assert float(grads["ingre_embedding"][-1].abs().max()) > 0


@pytest.fixture(scope="module")
def x64_report(synth_root):
    """The stdout of this file run as a script under JAX_ENABLE_X64 (a
    subprocess, because x64 must be set before JAX configures itself): the
    float64 certificate and the float64 lockstep epochs."""
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "True",
                "OMP_NUM_THREADS": "1",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), synth_root[0]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


def test_calculate_loss_float64_certificate(x64_report):
    """The port in torch.float64 against the JAX package under
    JAX_ENABLE_X64: loss parts and every gradient within 1e-9 relative."""
    assert "certificate pass_1e-9=True" in x64_report, x64_report[-2000:]


def test_lockstep_epochs_match_jax(x64_report):
    """Two epochs of the JAX package's jit epoch, replayed through the
    port's `train_steps` on the same batches, in float64, LambdaLR stepped
    between them. Within 1e-5 relative: the loss parts of both epochs, and
    after the first (six steps, the last at its exact size) every parameter
    leaf in L2 norm and the trained model's outputs (eval_cache embeddings,
    the loss parts of a probe batch).

    The parameters are compared after one epoch, not two, because two
    correct implementations part exponentially under Adam: an element whose
    gradient is near Adam's eps of 1e-8 moves by lr * g / (|g| + eps), so a
    difference dg in its gradient moves it by up to lr * dg / eps (2e5 dg),
    and the key part of in_proj_b has a gradient that is zero in exact
    arithmetic (the softmax ignores a shift shared by all keys), so its
    rounding noise is such a gradient. The gap grows each step, in float64
    too; in float32 those biases take steps of +-lr with a random sign, so
    even two float32 runs of the JAX package, its jit epoch and a
    step-by-step replay, do not keep 1e-5."""
    assert "lockstep pass=True" in x64_report, x64_report[-2000:]


def _certificate_main(root):
    """Run in the float64 subprocess: print the worst relative error of the
    loss parts and of the gradients, and whether both are <= 1e-9."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.models import get_model as jget_model
    from foodrec_tpu_torch.utils.weights import flatten_params

    assert jax.config.jax_enable_x64
    jcfg, _ = make_config((root, {"neg_num": 20}), model="CIKM_Model",
                          overrides=_overrides())
    jdata = JFoodData(jcfg)
    jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
    jmodel = jget_model("CIKM_Model")(jcfg, jdata)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
    buf64 = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float64)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x, jmodel.buffers)
    _, _, model = _port_model((root, {"neg_num": 20}), _overrides(),
                              jparams, dtype=torch.float64)
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
    print(f"certificate worst_parts={worst_parts:.3e} "
          f"worst_grads={worst_grads:.3e}")
    print(f"certificate pass_1e-9={ok}")


def _jax_epoch_batches(jtrainer, key):
    """The (u, pos, neg) batches that `jtrainer._epoch_fn(.., key)` draws:
    its permutation, its exact-size tail and its negatives
    (foodrec_tpu/engine/trainer.py:264-275, 343-350, 435-437)."""
    from foodrec_tpu.data.sampling import sample_negatives

    dd = jtrainer.model.dd
    bs, n_train = jtrainer.train_batch_size, jtrainer.n_train
    n_tries = jtrainer.config["neg_sample_tries"] or 32
    k_perm, k_steps = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k_perm, n_train))
    batches = []
    for b in range(jtrainer.n_batches):
        idx = perm[b * bs:(b + 1) * bs]
        u = dd.train_u[idx]
        k_neg, _ = jax.random.split(jax.random.fold_in(k_steps, b))
        neg = sample_negatives(k_neg, jnp.asarray(u), jnp.asarray(dd.excl_bitmap),
                               dd.num_items, n_tries=n_tries)
        batches.append((u, dd.train_i[idx], np.asarray(neg)))
    return batches


def _lockstep_main(root):
    """Run in the float64 subprocess: two JAX epochs and their replay
    through the port; print the worst relative errors and whether they are
    within the bars of test_lockstep_epochs_match_jax."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.engine.trainer import Trainer as JTrainer
    from foodrec_tpu.models import get_model as jget_model
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.utils.weights import flatten_params

    jcfg, _ = make_config((root, {"neg_num": 20}), model="CIKM_Model",
                          overrides=_overrides())
    jdata = JFoodData(jcfg)
    jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
    jmodel = jget_model("CIKM_Model")(jcfg, jdata)
    jtrainer = JTrainer(jcfg, jmodel)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    cfg, _, model = _port_model((root, {"neg_num": 20}), _overrides(),
                                jparams, dtype=torch.float64)
    trainer = Trainer(cfg, model)
    assert trainer.n_batches == jtrainer.n_batches > 2
    assert 0 < trainer.n_train % BATCH_SIZE  # an exact tail
    assert trainer.num_items == jtrainer.model.dd.num_items

    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
    opt_state = jtrainer.optimizer.init(params)
    buf64 = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float64)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x, jmodel.buffers)
    probe = _batch(model.dd, 5)
    key = jax.random.PRNGKey(11)
    worst = {"parts": 0.0, "outputs": 0.0, "params_l2": 0.0}
    for epoch in range(2):
        key, k_epoch = jax.random.split(key)
        batches = _jax_epoch_batches(jtrainer, k_epoch)
        assert len(batches[-1][0]) == trainer.n_train % BATCH_SIZE
        params, opt_state, jparts = jtrainer._epoch_fn(params, opt_state,
                                                       k_epoch)
        lr = trainer.scheduler.get_last_lr()[0]
        assert abs(lr / (cfg["learning_rate"] * 0.5 ** (epoch / 50)) - 1) \
            < 1e-12, lr
        parts = trainer.train_steps(
            tuple(torch.as_tensor(a, dtype=torch.int64) for a in b)
            for b in batches)
        trainer.scheduler.step()
        assert parts.dtype == torch.float64
        worst["parts"] = max([worst["parts"]] + [
            _rel_err(a, b) for a, b in zip(parts.numpy(), np.asarray(jparts))])
        if epoch > 0:
            continue
        # after the first epoch: the trained model's outputs and parameters
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
    ok = (worst["parts"] <= 1e-5 and worst["outputs"] <= 1e-5
          and worst["params_l2"] <= 1e-5)
    print("lockstep " + " ".join(f"worst_{k}={v:.3e}"
                                 for k, v in worst.items()))
    print(f"lockstep pass={ok}")


# ---------------------------------------------------------------------------
# the port's own epoch and fit
# ---------------------------------------------------------------------------


def _finite_unit(metrics):
    vals = np.array(list(metrics.values()), dtype=np.float64)
    return bool(np.isfinite(vals).all() and (vals >= 0).all()
                and (vals <= 1).all())


def test_fit_runs_and_restores_best(pair):
    """Two epochs with eval every epoch: the loss of each is logged, the
    metrics are finite, and the model ends on the best-on-valid state."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    _, data, model = _port_model(pair["synth_root"], _overrides(
        {"epochs": 2, "eval_step": 1, "attention_probs_dropout_prob": 0.5}))
    trainer = Trainer(model.config, model)
    snaps, scores = [], []
    valid = trainer._valid

    def recording_valid(eval_set, is_test=False):
        out = valid(eval_set, is_test)
        if not is_test:
            snaps.append({k: v.clone() for k, v in model.state_dict().items()})
            scores.append(out[0])
        return out

    trainer._valid = recording_valid
    best_score, best_valid, test = trainer.fit(data)
    assert sorted(trainer.train_loss_dict) == [0, 1]
    assert all(np.isfinite(v) for v in trainer.train_loss_dict.values())
    assert _finite_unit(best_valid) and _finite_unit(test)
    assert len(snaps) == 2 and best_score == max(scores)
    best = scores.index(max(scores))
    state = model.state_dict()
    assert all(torch.equal(state[k], snaps[best][k]) for k in state)


def test_fit_stops_early_and_restores_the_best_epoch(pair):
    """stopping_step 0: the first epoch whose valid score does not improve
    ends fit, and the parameters of the best epoch come back."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    _, data, model = _port_model(pair["synth_root"], _overrides(
        {"epochs": 5, "eval_step": 1, "stopping_step": 0}))
    trainer = Trainer(model.config, model)
    scores = iter([0.5, 0.4, 0.3, 0.2, 0.1])
    snaps = []
    valid = trainer._valid

    def scripted_valid(eval_set, is_test=False):
        if is_test:
            return valid(eval_set, is_test)
        snaps.append({k: v.clone() for k, v in model.state_dict().items()})
        s = next(scores)
        return s, {"recall@20": s}

    trainer._valid = scripted_valid
    best_score, best_valid, test = trainer.fit(data)
    assert len(snaps) == 2 and sorted(trainer.train_loss_dict) == [0, 1]
    assert best_score == 0.5 and best_valid == {"recall@20": 0.5}
    assert _finite_unit(test)
    state = model.state_dict()
    assert all(torch.equal(state[k], snaps[0][k]) for k in state)
    assert not all(torch.equal(state[k], snaps[1][k]) for k in state)


def test_nan_loss_aborts_the_epoch_and_fit(pair):
    """A NaN loss ends the epoch at the next `epoch_scan_chunk` boundary
    (never a host sync per step), and fit stops without logging the
    epoch."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    _, data, model = _port_model(pair["synth_root"], _overrides(
        {"epochs": 3, "eval_step": 1, "epoch_scan_chunk": 2}))
    with torch.no_grad():
        model.user_embedding.fill_(float("nan"))
    trainer = Trainer(model.config, model)
    assert trainer.n_batches > 2
    steps = []
    train_steps = trainer.train_steps

    def counting(batches):
        batches = list(batches)
        steps.append(len(batches))
        return train_steps(batches)

    trainer.train_steps = counting
    parts = trainer.train_epoch()
    assert steps == [2] and not torch.isfinite(parts).all()
    steps.clear()
    trainer.fit(data)
    assert steps == [2] and trainer.train_loss_dict == {}


def test_train_epoch_counts_every_pair(pair):
    """The port's own epoch: ceil(n_train / bs) steps over one permutation
    of the train pairs, the last at its exact size, with negatives outside
    each user's positives; the loss falls on the toy set."""
    from foodrec_tpu_torch.data.sampling import is_excluded
    from foodrec_tpu_torch.engine.trainer import Trainer

    _, _, model = _port_model(pair["synth_root"], _overrides())
    trainer = Trainer(model.config, model)
    seen = []
    train_steps = trainer.train_steps

    def recording(batches):
        batches = list(batches)
        seen.extend(batches)
        return train_steps(batches)

    trainer.train_steps = recording
    first = trainer.train_epoch()
    assert len(seen) == trainer.n_batches
    sizes = [len(u) for u, _, _ in seen]
    assert sizes[:-1] == [BATCH_SIZE] * (len(seen) - 1)
    assert sum(sizes) == trainer.n_train
    pairs = sorted(zip(torch.cat([u for u, _, _ in seen]).tolist(),
                       torch.cat([p for _, p, _ in seen]).tolist()))
    dd = model.dd
    assert pairs == sorted(zip(dd.train_u.tolist(), dd.train_i.tolist()))
    for u, _, neg in seen:
        assert not bool(is_excluded(trainer._excl, u, neg).any())
    for _ in range(4):
        trainer.scheduler.step()
        last = trainer.train_epoch()
    assert torch.isfinite(last).all() and float(last.sum()) < float(first.sum())


@pytest.mark.parametrize("extra", [
    {"health_neg_sample": True, "use_health_level": True},
    {"exact_final_batch": False},
    {"learner": "sgd"},
], ids=["health_neg_sample", "padded_final_batch", "sgd"])
def test_training_options_run(pair, extra):
    """The options the port once refused run a CIKM_Model epoch: every
    batch carries its health-stratified negatives (outside the user's
    positives), or has the full size with the wrapped rows weighted 0, or
    the step is plain SGD; the loss parts are finite (their values against
    the JAX package are in test_torch_port_options.py)."""
    from foodrec_tpu_torch.data.sampling import is_excluded
    from foodrec_tpu_torch.engine.trainer import Trainer

    _, _, model = _port_model(pair["synth_root"], _overrides(extra))
    trainer = Trainer(model.config, model)
    seen = []
    train_steps = trainer.train_steps

    def recording(batches):
        batches = list(batches)
        seen.extend(batches)
        return train_steps(batches)

    trainer.train_steps = recording
    before = model.user_embedding.detach().clone()
    parts = trainer.train_epoch()
    assert torch.isfinite(parts).all() and len(seen) == trainer.n_batches
    assert not torch.equal(before, model.user_embedding)
    if "health_neg_sample" in extra:
        for u, _, _, more in seen:
            hn = more["health_neg"]
            assert hn.dtype == torch.int64 and hn.shape == u.shape
            assert not bool(is_excluded(trainer._excl, u, hn).any())
    elif "exact_final_batch" in extra:
        assert all(len(b[0]) == BATCH_SIZE for b in seen)
        w = torch.cat([b[3]["weight"] for b in seen])
        assert int(w.sum()) == trainer.n_train < len(w)
    else:
        assert type(trainer.optimizer) is torch.optim.SGD
        assert all(len(b) == 3 for b in seen)


if __name__ == "__main__":
    _certificate_main(sys.argv[1])
    _lockstep_main(sys.argv[1])
