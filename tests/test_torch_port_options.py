"""PyTorch port: the training and data options against the JAX
package on the toy synthetic dataset.

  * host data: the recipe-recipe and recipe-health graphs, the scalar
    health level and the health sampler's buckets, equal arrays
  * the health-stratified negatives: given the JAX package's draws the pick
    is exactly equal; with the port's own generator the invariants hold
  * sample weights: each of the six models' weighted calculate_loss, on a
    batch whose last rows repeat earlier ones with weight 0 (the padded
    tail), loss parts and gradients within 1e-9 relative in float64
  * the padded final batch: one float64 lockstep epoch of LightGCN with
    `exact_final_batch: False`, the JAX package's permutation and negatives
    replayed through the port, parameters within 1e-9 relative
  * the learners sgd, adagrad and rmsprop, with and without weight decay:
    6 float64 updates within 1e-12 relative of the JAX package's optax
    chain, and a resume through `save_state` bitwise
  * CIKM_Model's scalar health level (`use_health_level_multi_hot: False`):
    the loss parts and gradients within 1e-9 in float64, at the width of
    the recipe-health graph's levels and at width 0

Float64 runs in this process under `jax.enable_x64`, the JAX side through
`jax.jit`; the SpMM runs the CUDA kernel's plain version, because the
tensors lie on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_config
from tests.test_torch_port_models import _buffers64, _port_model
from tests.test_torch_port_schgn import _grad_err
from tests.test_torch_port_train import _rel_err

X64_TOL = 1e-9
LEARNER_TOL = 1e-12
BATCH_SIZE = 16
HEALTH = {"use_health_level": True, "load_RecipeHealth_graph": True,
          "health_neg_sample": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: the suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(synth_root, name, overrides):
    """The JAX package's model, built under x64 as JAX_ENABLE_X64 builds it
    (its graph values stay float64), with its init parameters (through
    jit: eager PRNG ops are slow)."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.models import get_model as jget_model

    jcfg, _ = make_config(synth_root, model=name,
                          overrides={**overrides, "use_gpu": False})
    with jax.enable_x64(True):
        jdata = JFoodData(jcfg)
        jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
        jmodel = jget_model(name)(jcfg, jdata)
        jparams = jax.device_get(jax.jit(jmodel.init_params)(
            jax.random.PRNGKey(0)))
    return jcfg, jdata, jmodel, jparams


def _padded_batch(dd, seed, b=24, n_pad=7):
    """(u, pos, neg, weight): b - n_pad random rows, then the first n_pad
    rows again with weight 0, as the epoch's wrapped tail."""
    rng = np.random.default_rng(seed)
    n = b - n_pad
    u, p, q = (rng.integers(0, dd.num_users, n), rng.integers(0, dd.n_items, n),
               rng.integers(0, dd.n_items, n))
    w = np.concatenate([np.ones(n), np.zeros(n_pad)])
    return (np.concatenate([u, u[:n_pad]]), np.concatenate([p, p[:n_pad]]),
            np.concatenate([q, q[:n_pad]]), w)


def _certify(jmodel, jparams, model, batches, batch_extra=None,
             port_kw=None):
    """Worst relative error of the loss parts and of every gradient, the
    JAX package in float64 (jit, buffers bound as float64) against the
    port model (float64) on each (u, pos, neg, weight) batch. A key
    bias's gradient, zero in exact arithmetic, is held to its query bias's
    scale (`_grad_err`)."""
    from foodrec_tpu_torch.utils.weights import flatten_params

    worst_parts = worst_grads = 0.0
    flags = {}  # Python flags of the JAX batch (SCHGN's deterministic)
    with jax.enable_x64(True):
        params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                jparams)
        buf64 = _buffers64(jmodel)

        def fn(params, buffers, batch):
            with jmodel.bind(buffers):
                parts = jmodel.calculate_loss(params, {**batch, **flags})
            return sum(parts), jnp.stack(parts)

        grad_fn = jax.jit(jax.value_and_grad(fn, has_aux=True))
        for i, (u, p, n, w) in enumerate(batches):
            extra = batch_extra(i, p) if batch_extra else {}
            flags.update((k, extra.pop(k)) for k in list(extra)
                         if isinstance(extra[k], bool))
            batch = {"u_id": jnp.asarray(u, jnp.int32),
                     "pos_i_id": jnp.asarray(p, jnp.int32),
                     "neg_i_id": jnp.asarray(n, jnp.int32),
                     "weight": jnp.asarray(w, jnp.float64),
                     "key": jax.random.PRNGKey(0),
                     **{k: jnp.asarray(v) for k, v in extra.items()}}
            (_, jparts), jgrads = grad_fn(params64, buf64, batch)
            jflat = flatten_params(jax.device_get(jgrads))
            model.zero_grad(set_to_none=True)
            kw = port_kw(i, extra) if port_kw else {}
            parts = model.calculate_loss(
                *(torch.as_tensor(a).long() for a in (u, p, n)),
                weight=torch.as_tensor(w), **kw)
            sum(parts).backward()
            tparts = torch.stack(parts).detach().numpy()
            assert tparts.dtype == np.float64
            worst_parts = max([worst_parts] + [
                _rel_err(a, b) for a, b in zip(tparts, np.asarray(jparts))])
            grads = {k: v.grad for k, v in model.named_parameters()}
            assert sorted(grads) == sorted(jflat)
            for k, g in grads.items():
                g = torch.zeros_like(model.state_dict()[k]) if g is None else g
                assert tuple(g.shape) == np.shape(jflat[k]), k
                if not g.numel():  # the health head at width 0
                    continue
                worst_grads = max(worst_grads, _grad_err(k, g.numpy(), jflat))
    return worst_parts, worst_grads


# ---------------------------------------------------------------------------
# host data
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def health_data(synth_root):
    """Both packages' FoodData and DeviceData with the scalar health level,
    the recipe-health graph and the health sampler's buckets."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData

    jcfg, meta = make_config(synth_root, model="CIKM_Model",
                             overrides={**HEALTH, "use_gpu": False})
    jds = JFoodData(jcfg)
    jdd = JDeviceData.from_food_data(jds, jcfg)
    root = synth_root[0]
    cfg = Config("CIKM_Model", "Synth", {
        "data_path": root.rsplit("/Synth", 1)[0] + "/",
        "neg_sample_num": meta["neg_num"], "use_gpu": False, **HEALTH})
    derive_data_paths(cfg, "Synth")
    ds = FoodData(cfg)
    return jds, jdd, ds, DeviceData.from_food_data(ds)


def test_health_arrays_match_jax(health_data):
    jds, jdd, ds, dd = health_data
    assert ds.num_health_level == jds.num_health_level == 6
    assert ds.train_item_list == jds.train_item_list
    np.testing.assert_array_equal(ds.rHealth_triples, jds.rHealth_triples)
    assert ds.health_level == jds.health_level
    assert ds.neg_sample_set == jds.neg_sample_set
    for b in range(6):
        assert list(getattr(ds, f"health_{b}")) == \
            list(getattr(jds, f"health_{b}"))
    for attr in ("health_level", "health_bucket_items", "health_in_sample",
                 "train_items_arr"):
        got, want = getattr(dd, attr), getattr(jdd, attr)
        assert got.dtype == want.dtype, attr
        np.testing.assert_array_equal(got, want, err_msg=attr)


def test_health_neg_sample_requires_the_health_level(synth_root):
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData

    root = synth_root[0]
    cfg = Config("CIKM_Model", "Synth", {
        "data_path": root.rsplit("/Synth", 1)[0] + "/", "use_gpu": False,
        "health_neg_sample": True})
    derive_data_paths(cfg, "Synth")
    with pytest.raises(ValueError, match="use_health_level"):
        DeviceData.from_food_data(FoodData(cfg))


# ---------------------------------------------------------------------------
# health-stratified negatives
# ---------------------------------------------------------------------------


def _health_case(dd, seed, b=300):
    """Users, positives and a bitmap that excludes most items for some
    users (the uniform fall-back's and the last draw's cases), and bucket
    arrays with one level emptied."""
    from tests.test_torch_port_train import _bitmap

    rng = np.random.default_rng(seed)
    users = rng.integers(0, dd.num_users, b)
    pos = rng.integers(0, dd.n_items, b)
    excluded = []
    for u in range(dd.num_users):
        frac = (0.0, 0.5, 0.97, 1.0)[u % 4]
        excluded.append(set(np.flatnonzero(rng.random(dd.num_items) < frac)))
    bitmap = _bitmap(excluded, dd.num_items)
    buckets = dd.health_bucket_items.copy()
    buckets[3] = -1  # an empty bucket takes the uniform path
    return users, pos, bitmap, buckets, excluded


@pytest.mark.parametrize("seed", [0, 1])
def test_health_pick_equals_jax_on_its_draws(health_data, seed):
    """The JAX package's sampler and the port's pick step on the JAX
    package's own 32 draws: the same item for every sample."""
    from foodrec_tpu.data.sampling import (
        sample_health_stratified_negatives as jsample)
    from foodrec_tpu_torch.data.sampling import pick_health_negatives

    _, _, _, dd = health_data
    users, pos, bitmap, buckets, _ = _health_case(dd, seed)
    key = jax.random.PRNGKey(seed)
    n_tries = 32
    want = np.asarray(jsample(
        key, jnp.asarray(users, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(bitmap), jnp.asarray(dd.health_level),
        jnp.asarray(buckets), jnp.asarray(dd.health_in_sample),
        jnp.asarray(dd.train_items_arr), n_tries=n_tries))
    draws = np.asarray(jax.random.randint(
        key, (n_tries, len(users)), 0, jnp.iinfo(jnp.int32).max,
        dtype=jnp.int32))
    got = pick_health_negatives(
        torch.from_numpy(draws).long(), torch.from_numpy(users),
        torch.from_numpy(pos), torch.from_numpy(bitmap.view(np.int32)),
        torch.from_numpy(dd.health_level), torch.from_numpy(buckets),
        torch.from_numpy(dd.health_in_sample),
        torch.from_numpy(dd.train_items_arr))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_health_sampler_invariants(health_data):
    """With the port's generator, against the rule recomputed in numpy from
    the draws: a user in the sample set whose bucket is not empty takes
    slot `draw % len` of its positive's health bucket, the others item
    `draw % len` of the train list; the first candidate outside the user's
    positives is taken, the last where all 32 collide."""
    from foodrec_tpu_torch.data.sampling import (
        health_negative_draws,
        sample_health_stratified_negatives,
    )

    _, _, _, dd = health_data
    users, pos, bitmap, buckets, excluded = _health_case(dd, 2, b=2000)
    args = [torch.from_numpy(a) for a in (
        users, pos, bitmap.view(np.int32), dd.health_level, buckets,
        dd.health_in_sample, dd.train_items_arr)]
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    got = sample_health_stratified_negatives(*args, gen).numpy()
    draws = health_negative_draws(args[0], gen.set_state(state)).numpy()
    assert draws.shape == (32, len(users))
    assert draws.min() >= 0 and draws.max() < 2 ** 31 - 1

    level = dd.health_level[pos]
    lists = [b[b >= 0] for b in buckets]
    from_bucket = dd.health_in_sample[users] & np.array(
        [len(lists[lv]) > 0 for lv in level])
    assert 0 < from_bucket.sum() < len(users)
    train = dd.train_items_arr
    n_last = n_first = 0
    for k in range(len(users)):
        pool = lists[level[k]] if from_bucket[k] else train
        cands = pool[draws[:, k] % len(pool)]
        free = [c for c in cands if c not in excluded[users[k]]]
        assert got[k] == (free[0] if free else cands[-1]), k
        n_last += not free
        n_first += bool(free) and free[0] == cands[0]
    # the fall-back to the last draw and the first draw's hits both occur
    assert n_last and n_first


# ---------------------------------------------------------------------------
# sample weights in the six models' losses
# ---------------------------------------------------------------------------

WEIGHTED = [
    ("CIKM_Model", {"attention_probs_dropout_prob": 0.0}),
    ("LightGCN", {}),
    ("BM3", {"dropout": 0.0}),
    ("FGCN", {"mess_dropout": 0.0}),
    ("PRICAI_ModelX", {"n_cluster": 5}),
    ("SCHGN", {"hidden_dropout_prob": 0.0,
               "attention_probs_dropout_prob": 0.0}),
]


def _schgn_seqs(jmodel):
    """SCHGN's deterministic mode with the JAX package's SSL draws
    injected into both packages."""
    from foodrec_tpu.data.sampling import ssl_mask_ingredients

    sampler = jax.jit(functools.partial(
        ssl_mask_ingredients, n_ingredients=jmodel.n_ingredients))
    dd = jmodel.dd

    def batch_extra(i, pos):
        seqs = sampler(jax.random.PRNGKey(i), jnp.asarray(dd.ingre_codes[pos]),
                       jnp.asarray(dd.ingre_num[pos]))
        return {"deterministic": True,
                **dict(zip(("ssl_masked_seq", "ssl_pos_seq", "ssl_neg_seq"),
                           (np.asarray(s) for s in seqs)))}

    def port_kw(i, extra):
        return {"deterministic": True, "ssl_seqs": tuple(
            torch.from_numpy(extra[k]).long() for k in
            ("ssl_masked_seq", "ssl_pos_seq", "ssl_neg_seq"))}

    return batch_extra, port_kw


@pytest.mark.parametrize("name,extra", WEIGHTED, ids=[w[0] for w in WEIGHTED])
def test_weighted_loss_float64_matches_jax(synth_root, name, extra):
    """calculate_loss with the padded tail's weight: loss parts and every
    gradient within 1e-9 relative of the JAX package's in float64. The
    wrapped rows count nowhere but in CLUSSL's dCor, which runs over the
    whole batch in both packages."""
    overrides = {"train_batch_size": BATCH_SIZE, **extra}
    _, _, jmodel, jparams = _jax_model(synth_root, name, overrides)
    model = _port_model(synth_root, name, overrides, jparams,
                        dtype=torch.float64)[2]
    batches = [_padded_batch(model.dd, s) for s in (0, 1)]
    hooks = _schgn_seqs(jmodel) if name == "SCHGN" else (None, None)
    worst_parts, worst_grads = _certify(jmodel, jparams, model, batches,
                                        *hooks)
    assert worst_parts <= X64_TOL and worst_grads <= X64_TOL, \
        (worst_parts, worst_grads)


# ---------------------------------------------------------------------------
# the padded final batch
# ---------------------------------------------------------------------------


def _jax_padded_batches(jtrainer, key):
    """The (u, pos, neg, weight) batches that `jtrainer._epoch_fn(.., key)`
    draws with the padded tail: its permutation resized cyclically to
    n_batches * bs, weight (position < n_train) and its negatives
    (foodrec_tpu/engine/trainer.py:264-275, 343-350)."""
    from foodrec_tpu.data.sampling import sample_negatives

    dd = jtrainer.model.dd
    bs, n_train = jtrainer.train_batch_size, jtrainer.n_train
    k_perm, k_steps = jax.random.split(key)
    perm = np.asarray(jnp.resize(jax.random.permutation(k_perm, n_train),
                                 jtrainer.n_batches * bs))
    batches = []
    for b in range(jtrainer.n_batches):
        idx = perm[b * bs:(b + 1) * bs]
        u = dd.train_u[idx]
        k_neg, _ = jax.random.split(jax.random.fold_in(k_steps, b))
        neg = sample_negatives(k_neg, jnp.asarray(u),
                               jnp.asarray(dd.excl_bitmap), dd.num_items,
                               n_tries=jtrainer.config["neg_sample_tries"]
                               or 32)
        weight = (b * bs + np.arange(bs)) < n_train
        batches.append((u, dd.train_i[idx], np.asarray(neg), weight))
    return batches


def test_padded_final_batch_lockstep_float64(synth_root):
    """One LightGCN epoch of the JAX package's jit epoch with
    `exact_final_batch: False`, replayed through the port's train_steps on
    its permutation, negatives and weights: every batch at the full size,
    the loss parts and every parameter within 1e-9 relative (float64).

    The lr is 2^-10: inside the JAX epoch the schedule reads optax's int32
    count, so its lr is a float32 even under x64 (1e-3 would be 4.7e-8
    off the port's float64 lr), and 2^-10 is exact in both."""
    from foodrec_tpu.engine.trainer import Trainer as JTrainer
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.utils.weights import flatten_params

    overrides = {"train_batch_size": BATCH_SIZE, "exact_final_batch": False,
                 "learning_rate": 2.0 ** -10}
    jcfg, _, jmodel, jparams = _jax_model(synth_root, "LightGCN", overrides)
    cfg, _, model = _port_model(synth_root, "LightGCN", overrides, jparams,
                                dtype=torch.float64)
    trainer = Trainer(cfg, model)
    assert trainer.pad_tail and trainer.n_train % BATCH_SIZE
    with jax.enable_x64(True):
        jtrainer = JTrainer(jcfg, jmodel)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
        opt_state = jtrainer.optimizer.init(params)
        key = jax.random.PRNGKey(11)
        batches = _jax_padded_batches(jtrainer, key)
        params, _, jparts = jtrainer._epoch_fn(params, opt_state, key)
        params = jax.device_get(params)
        jparts = np.asarray(jparts)
    assert all(len(b[0]) == BATCH_SIZE for b in batches)
    assert int(sum(b[3].sum() for b in batches)) == trainer.n_train
    parts = trainer.train_steps(
        (*(torch.as_tensor(a, dtype=torch.int64) for a in b[:3]),
         {"weight": torch.as_tensor(b[3], dtype=torch.float32)})
        for b in batches)
    assert _rel_err(parts.numpy(), jparts) <= X64_TOL
    state = model.state_dict()
    for k, v in flatten_params(params).items():
        assert _rel_err(state[k].numpy(), v) <= X64_TOL, k


def test_padded_epoch_draws_full_weighted_batches(synth_root):
    """The port's own padded epoch: every batch at the full size, the
    permutation cycled over its start, weight 1 exactly on the first
    n_train positions."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    model = _port_model(synth_root, "LightGCN", {
        "train_batch_size": BATCH_SIZE, "exact_final_batch": False})[2]
    trainer = Trainer(model.config, model)
    seen = []
    steps = trainer.train_steps
    trainer.train_steps = lambda batches: _record(seen, batches, steps)
    parts = trainer.train_epoch()
    assert torch.isfinite(parts).all() and len(seen) == trainer.n_batches
    assert all(len(b[0]) == BATCH_SIZE for b in seen)
    w = torch.cat([b[3]["weight"] for b in seen])
    assert w.dtype == torch.float32
    assert torch.equal(w, (torch.arange(len(w)) < trainer.n_train).float())
    pairs = sorted(zip(torch.cat([b[0] for b in seen]).tolist()[
        :trainer.n_train], torch.cat([b[1] for b in seen]).tolist()[
        :trainer.n_train]))
    dd = model.dd
    assert pairs == sorted(zip(dd.train_u.tolist(), dd.train_i.tolist()))


def _record(seen, batches, steps):
    batches = list(batches)
    seen.extend(batches)
    return steps(batches)


# ---------------------------------------------------------------------------
# learners
# ---------------------------------------------------------------------------

LEARNERS = [(name, wd) for name in ("sgd", "adagrad", "rmsprop")
            for wd in (0.0, 0.01)]


def _learner_params(rng):
    return {"a": rng.standard_normal((5, 4)), "b": rng.standard_normal(3)}


@pytest.mark.parametrize("learner,wd", LEARNERS)
def test_learner_float64_matches_optax(learner, wd):
    """6 updates at the lr of the update count, one of them on an exact
    zero gradient (rss / rms of zero), against the JAX package's optax
    chain (trainer.py:48-68) in float64: within 1e-12 relative."""
    from foodrec_tpu.engine.trainer import build_optimizer as jbuild
    from foodrec_tpu_torch.engine.trainer import build_optimizer

    rng = np.random.default_rng(3)
    p0 = _learner_params(rng)
    grads = [{k: rng.standard_normal(v.shape) for k, v in p0.items()}
             for _ in range(6)]
    grads[2]["b"][:] = 0.0

    def lr_schedule(count):
        return 0.01 * 0.5 ** ((count // 2) / 50)

    def jax_lr_schedule(count):
        # optax's int32 count would make the lr a float32 (see
        # test_padded_final_batch_lockstep_float64); the rule is under test
        return 0.01 * 0.5 ** (jnp.asarray(count // 2, jnp.float64) / 50)

    with jax.enable_x64(True):
        opt = jbuild(learner, jax_lr_schedule, wd)
        params = {k: jnp.asarray(v) for k, v in p0.items()}
        state = opt.init(params)
        import optax

        for g in grads:
            upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, params)
            params = optax.apply_updates(params, upd)
        want = jax.device_get(params)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = build_optimizer(learner, list(tp.values()), 0.01, wd)
    for count, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        for group in topt.param_groups:
            group["lr"] = lr_schedule(count)
        topt.step()
    for k, p in tp.items():
        assert _rel_err(p.detach().numpy(), want[k]) <= LEARNER_TOL, k


@pytest.mark.parametrize("learner", ["sgd", "adagrad", "rmsprop"])
def test_learner_resume_through_save_state_is_bitwise(tmp_path, learner):
    """3 updates, the optimizer's state through save_state / load_state
    into a fresh optimizer, 3 more: bitwise the 6 updates of one run."""
    from foodrec_tpu_torch.engine import checkpoint as ckpt
    from foodrec_tpu_torch.engine.trainer import build_optimizer

    rng = np.random.default_rng(4)
    p0 = _learner_params(rng)
    grads = [{k: rng.standard_normal(v.shape) for k, v in p0.items()}
             for _ in range(6)]

    def run(tp, opt, gs):
        for g in gs:
            for k, p in tp.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()

    def fresh():
        tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
        return tp, build_optimizer(learner, list(tp.values()), 0.01, 0.01)

    whole, opt = fresh()
    run(whole, opt, grads)
    first, opt = fresh()
    run(first, opt, grads[:3])
    path = str(tmp_path / "state")
    ckpt.save_state(path, first, opt.state_dict(), {}, torch.Generator()
                    .get_state(), 0, 0.0, 0, {})
    state = ckpt.load_state(path)
    resumed, opt2 = fresh()
    with torch.no_grad():
        for k, p in resumed.items():
            p.copy_(state["model"][k])
    opt2.load_state_dict(state["optimizer"])
    # SGD without momentum keeps no state
    assert bool(opt2.state_dict()["state"]) == (learner != "sgd")
    run(resumed, opt2, grads[3:])
    for k in whole:
        assert torch.equal(whole[k], resumed[k]), k


def test_unknown_learner_warns_and_takes_adam(caplog):
    from foodrec_tpu_torch.engine.trainer import build_optimizer

    with caplog.at_level("WARNING"):
        opt = build_optimizer("nadam", [torch.zeros(2, requires_grad=True)],
                              0.01, 0.0)
    assert type(opt) is torch.optim.Adam and opt.defaults["eps"] == 1e-8
    assert "unrecognized optimizer" in caplog.text


# ---------------------------------------------------------------------------
# CIKM_Model's scalar health level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph", [True, False], ids=["rh-levels", "width0"])
def test_scalar_health_level_float64_matches_jax(synth_root, graph):
    """`use_health_level_multi_hot: False`: the health head's width is the
    dataset's num_health_level (6 with the recipe-health graph, 0 without)
    and its target all zeros, as in the JAX package; loss parts and
    gradients within 1e-9 relative in float64."""
    overrides = {"train_batch_size": BATCH_SIZE,
                 "attention_probs_dropout_prob": 0.0,
                 "use_health_level_multi_hot": False,
                 "load_RecipeHealth_graph": graph}
    _, _, jmodel, jparams = _jax_model(synth_root, "CIKM_Model", overrides)
    model = _port_model(synth_root, "CIKM_Model", overrides, jparams,
                        dtype=torch.float64)[2]
    width = 6 if graph else 0
    assert model.health_mlp["l2"]["w"].shape == (64, width)
    assert not model.health_mh.any()
    batches = [_padded_batch(model.dd, s, n_pad=0) for s in (0, 1)]
    worst_parts, worst_grads = _certify(jmodel, jparams, model, batches)
    assert worst_parts <= X64_TOL and worst_grads <= X64_TOL, \
        (worst_parts, worst_grads)


# ---------------------------------------------------------------------------
# frozen modality tables
# ---------------------------------------------------------------------------

FROZEN = [("CIKM_Model", {"attention_probs_dropout_prob": 0.0}),
          ("LightGCN", {"flagD": [1]}),
          ("BM3", {"dropout": 0.0})]


@pytest.mark.parametrize("name,extra", FROZEN, ids=[f[0] for f in FROZEN])
def test_frozen_tables_float64_matches_jax(synth_root, name, extra):
    """`freeze_modality_tables: True`: the raw image and text tables are
    buffers, outside the state_dict and the optimizer, as they are outside
    the JAX pytree; loss parts and gradients within 1e-9 relative in
    float64."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    overrides = {"train_batch_size": BATCH_SIZE,
                 "freeze_modality_tables": True, **extra}
    _, _, jmodel, jparams = _jax_model(synth_root, name, overrides)
    model = _port_model(synth_root, name, overrides, jparams,
                        dtype=torch.float64)[2]
    names = {n for n, _ in model.named_parameters()}
    assert not names & {"image_embedding", "text_embedding"}
    # LightGCN's projected feature table is named image_embedding
    assert "image_embedding" in dict(model.named_buffers())
    assert "image_embedding" not in model.state_dict()
    trainer = Trainer(model.config, model)
    n_opt = sum(p.numel() for g in trainer.optimizer.param_groups
                for p in g["params"])
    assert n_opt == sum(np.size(v) for v in jax.tree.leaves(jparams))
    batches = [_padded_batch(model.dd, s, n_pad=0) for s in (0, 1)]
    worst_parts, worst_grads = _certify(jmodel, jparams, model, batches)
    assert worst_parts <= X64_TOL and worst_grads <= X64_TOL, \
        (worst_parts, worst_grads)


# ---------------------------------------------------------------------------
# row_sparse_table_update
# ---------------------------------------------------------------------------


def test_row_sparse_key_lockstep_float64_matches_jax_row_sparse(
        synth_root, monkeypatch):
    """`row_sparse_table_update: True` on CIKM_Model: one epoch of the JAX
    package's jit epoch, which takes its row-sparse Adam path for both
    modality tables, replayed through the port, which runs the dense
    update: the loss parts and every parameter within 1e-9 relative
    (float64), the encoder's key bias as said below. The lr is 2^-10, as
    in test_padded_final_batch_lockstep_float64."""
    import foodrec_tpu.engine.trainer as jtrainer_mod
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.utils.weights import flatten_params

    traced = []
    row_sparse_update = jtrainer_mod.apply_update_row_sparse

    def spy(*args, **kwargs):
        traced.append(sorted(args[-1]))   # the step's row-sparse tables
        return row_sparse_update(*args, **kwargs)

    monkeypatch.setattr(jtrainer_mod, "apply_update_row_sparse", spy)
    overrides = {"train_batch_size": BATCH_SIZE, "exact_final_batch": False,
                 "learning_rate": 2.0 ** -10,
                 "attention_probs_dropout_prob": 0.0,
                 "row_sparse_table_update": True}
    jcfg, _, jmodel, jparams = _jax_model(synth_root, "CIKM_Model", overrides)
    cfg, _, model = _port_model(synth_root, "CIKM_Model", overrides, jparams,
                                dtype=torch.float64)
    trainer = Trainer(cfg, model)
    with jax.enable_x64(True):
        jtrainer = jtrainer_mod.Trainer(jcfg, jmodel)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)
        opt_state = jtrainer.optimizer.init(params)
        key = jax.random.PRNGKey(11)
        batches = _jax_padded_batches(jtrainer, key)
        params, _, jparts = jtrainer._epoch_fn(params, opt_state, key)
        params = jax.device_get(params)
        jparts = np.asarray(jparts)
    assert traced and all(t == ["image_embedding", "text_embedding"]
                          for t in traced), traced
    parts = trainer.train_steps(
        (*(torch.as_tensor(a, dtype=torch.int64) for a in b[:3]),
         {"weight": torch.as_tensor(b[3], dtype=torch.float32)})
        for b in batches)
    assert _rel_err(parts.numpy(), jparts) <= X64_TOL
    state = model.state_dict()
    for k, v in flatten_params(params).items():
        got = state[k].numpy()
        if k.endswith("in_proj_b"):
            # the key part's gradient is zero in exact arithmetic (the
            # softmax ignores a shift shared by all keys), so both packages
            # move it from 0 by Adam-scaled rounding noise only: it stays
            # within a millionth of one Adam step (lr) of 0, and the query
            # and value parts are held to the bar
            d = len(v) // 3
            assert max(np.abs(got[d:2 * d]).max(), np.abs(
                v[d:2 * d]).max()) <= 1e-6 * cfg["learning_rate"], k
            got, v = (np.concatenate([a[:d], a[2 * d:]]) for a in (got, v))
        assert _rel_err(got, v) <= X64_TOL, k


@pytest.mark.parametrize("value", [True, False, None, "auto"],
                         ids=["true", "false", "null", "auto"])
def test_row_sparse_key_is_accepted_and_trains_as_dense(synth_root, caplog,
                                                        value):
    """Every value of `row_sparse_table_update` builds the trainer and
    takes the dense update: three steps from the same weights on the same
    batches give the parameters and Adam state of a run with `False`, bit
    for bit; `True` says in the log that the dense update runs."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    def three_steps(v):
        model = _port_model(synth_root, "CIKM_Model", {
            "train_batch_size": BATCH_SIZE, "seed": 999,
            "row_sparse_table_update": v})[2]
        trainer = Trainer(model.config, model)
        assert type(trainer.optimizer) is torch.optim.Adam
        trainer.train_steps(
            tuple(torch.as_tensor(a, dtype=torch.int64) for a in
                  _padded_batch(model.dd, s, b=BATCH_SIZE, n_pad=0)[:3])
            for s in (0, 1, 2))
        return trainer

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with caplog.at_level("INFO"):
            got = three_steps(value)
        assert ("dense Adam update runs" in caplog.text) == (value is True)
        want = three_steps(False)
    finally:
        torch.use_deterministic_algorithms(was)
    sg, sw = got.model.state_dict(), want.model.state_dict()
    assert all(torch.equal(sg[k], sw[k]) for k in sw)
    og, ow = (t.optimizer.state_dict()["state"] for t in (got, want))
    assert sorted(og) == sorted(ow)
    for i in ow:
        for key, v in ow[i].items():
            assert torch.equal(v, og[i][key]), (i, key)
