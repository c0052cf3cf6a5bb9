"""PyTorch port, scale-out: `mesh_shape` through torch.distributed, held
against the JAX package's mesh on its 8-device virtual CPU mesh and against
the port's own single-process runs.

The ranks are processes on the CPU over gloo (`parallel/spawn.py`: a
FileStore rendezvous in a temporary directory, so no port can collide under
xdist, torch on one thread, a deadline on each group); their functions are
in tests/torch_mesh_workers.py. One group of each size runs the jobs of
this file, and each test reads its job's result.

  * make_mesh: every rank's coordinates and axis groups equal the device
    layout of JAX's make_mesh; a mesh the group does not fit raises
  * shard_batch: each rank's rows equal the addressable shard of JAX's
    shard_batch, for a batch that divides `data` and for the tail that does
    not (replicated)
  * param_shardings: the leaves JAX's rule picks, for all six models, at
    the toy size with 512-d features and at Foodcom's row counts
  * mesh epochs in float64 against the single-process epochs, within 1e-9
    relative (loss parts and every leaf): {data: 2} for LightGCN (Adam),
    CIKM_Model, SCHGN and BM3 (SGD, as tests/test_mesh.py) and CIKM_Model
    under Mirror Gradient, {data: 4} for LightGCN, {model: 2} for LightGCN
    (also with gradient clipping) and CLUSSL with their 512-d tables
    row-sharded
  * one {data: 2, model: 2} CIKM_Model SGD step against the same step of
    the JAX package's mesh, from the same parameters, float64, 1e-9
  * distributed_full_sort_topk at {model: 2} and {model: 3} (61 items, not
    divisible) on an integer-valued cache (exact scores, many ties): the
    ids of JAX's distributed_full_sort_topk and of the port's
    full_sort_topk; the trainer's full-sort eval over `model` equals the
    single-process one
  * runner.main at {data: 2} (the mesh from a dataset yaml): one log and
    one checkpoint, from rank 0, which loads into a single-process Trainer;
    resume_from under the mesh equals the uninterrupted run, at {data: 2}
    and at {model: 2} with gradient clipping, and save_state files cross
    between a mesh and one process
  * the dry run, dryrun_multichip(4) and (8), prints its OK line
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_config
from tests.test_torch_port_models import _buffers64
from tests.test_torch_port_schgn import _grad_err
from tests.test_torch_port_train import _rel_err

X64_TOL = 1e-9
SPAWN_TIMEOUT = 120
LR = 2.0 ** -6
BASE = {"train_batch_size": 16, "seed": 999}
MG = {"alpha1": 1.0, "alpha2": 0.1, "beta": 3}
CLIP = 0.05  # a max_norm that the toy runs' steps clip to (SGD: under
# Adam, clipped gradients near its eps turn rounding into steps of ~lr)
MODELS = ("CIKM_Model", "LightGCN", "BM3", "FGCN", "PRICAI_ModelX", "SCHGN")
# the toy synthetic's row counts -> Foodcom's (FOODCOM_SCALE in chip_smoke.py)
TOY_ROWS = {"n_users": 24, "n_items": 60, "n_ingredients": 12,
            "n_clusters": 6}
FOODCOM_ROWS = {24: 7596, 60: 29943, 13: 4964, 12: 4963, 6: 2000}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_mesh(shape):
    """JAX's make_mesh (foodrec_tpu/parallel/mesh.py:27-38) on the first of
    the 8 virtual devices: create_device_mesh of all devices takes exactly
    8, so a smaller mesh is built as make_mesh builds it, from fewer."""
    from jax.experimental import mesh_utils
    from jax.sharding import Mesh

    sizes = tuple(shape.values())
    devices = jax.devices()[:int(np.prod(sizes))]
    return Mesh(mesh_utils.create_device_mesh(sizes, devices=devices),
                tuple(shape))


def _spawn(n, jobs):
    from foodrec_tpu_torch.parallel.spawn import run_ranks
    from tests import torch_mesh_workers

    return run_ranks(torch_mesh_workers.run_jobs, n, args=(jobs,),
                     timeout=SPAWN_TIMEOUT, threads=1)[0]


@pytest.fixture(scope="module")
def x512(tmp_path_factory):
    """A toy dataset with 512-d image and text features (the modality
    tables qualify for `model` sharding) and 6 clusters."""
    from foodrec_tpu_torch.data import synthetic

    root = tmp_path_factory.mktemp("mesh512") / "Synth"
    synthetic.generate(str(root), n_clusters=TOY_ROWS["n_clusters"],
                       img_dim=512, txt_dim=512)
    return str(root)


CLUSSL512 = {"n_cluster": TOY_ROWS["n_clusters"], "use_center_embedding": True}
# (case id, model, dataset ("toy" or "x512"), mesh_shape, overrides, mg)
EPOCHS = [
    ("LightGCN-adam-data2", "LightGCN", "toy", {"data": 2},
     {"learner": "adam"}, False),
    ("CIKM-sgd-data2", "CIKM_Model", "toy", {"data": 2}, {"learner": "sgd"},
     False),
    ("SCHGN-sgd-data2", "SCHGN", "toy", {"data": 2}, {"learner": "sgd"},
     False),
    ("BM3-sgd-data2", "BM3", "toy", {"data": 2}, {"learner": "sgd"}, False),
    ("CIKM-mg-data2", "CIKM_Model", "toy", {"data": 2},
     {"learner": "sgd", **MG}, True),
    ("LightGCN-adam-model2", "LightGCN", "x512", {"model": 2},
     {"learner": "adam"}, False),
    ("LightGCN-sgd-clip-model2", "LightGCN", "x512", {"model": 2},
     {"learner": "sgd", "clip_grad_norm": {"max_norm": CLIP}}, False),
    ("CLUSSL-sgd-model2", "PRICAI_ModelX", "x512", {"model": 2},
     {"learner": "sgd", **CLUSSL512}, False),
    ("LightGCN-adam-data4", "LightGCN", "toy", {"data": 4},
     {"learner": "adam"}, False),
]


def _epoch_job(case, roots):
    """Two epochs; one under Mirror Gradient, whose replayed step on
    -alpha2 * g2 grows a rounding difference about threefold a step
    (1e-16 to 2e-13 over the toy set's six steps, measured), so that two
    correct runs part past 1e-9 in the second epoch."""
    cid, model, ds, shape, overrides, mg = case
    return (cid, "epoch", dict(root=roots[ds], model=model, mesh_shape=shape,
                               overrides={**BASE, **overrides},
                               epochs=1 if mg else 2, mg=mg))


def _topk_cache():
    rng = np.random.default_rng(3)
    ue = rng.integers(-3, 4, (37, 4)).astype(np.float32)
    ie = rng.integers(-3, 4, (61, 4)).astype(np.float32)
    return ue, ie


def _jax_batch(root):
    rng = np.random.default_rng(11)
    return tuple(rng.integers(0, n, 16) for n in (24, 60, 60))


@pytest.fixture(scope="module")
def jax_start(x512):
    """The JAX package's CIKM_Model on the 512-d toy set under x64: its
    init parameters (float64, flattened by the port's names) and one SGD
    step of them on its {data: 2, model: 2} mesh."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.models import get_model as jget_model
    from foodrec_tpu.parallel.mesh import shard_batch
    from foodrec_tpu_torch.utils.weights import flatten_params

    jcfg, _ = make_config((x512, {"neg_num": 20}), model="CIKM_Model",
                          overrides={"attention_probs_dropout_prob": 0.0,
                                     "use_gpu": False})
    u, p, n = _jax_batch(x512)
    with jax.enable_x64(True):
        jdata = JFoodData(jcfg)
        jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
        jmodel = jget_model("CIKM_Model")(jcfg, jdata)
        params = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64),
            jax.device_get(jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))))
        mesh = _jax_mesh({"data": 2, "model": 2})
        shardings = jmodel.param_shardings(mesh, params)
        assert shardings["image_embedding"].spec[0] == "model"
        buffers = _buffers64(jmodel)
        batch = {"u_id": jnp.asarray(u, jnp.int32),
                 "pos_i_id": jnp.asarray(p, jnp.int32),
                 "neg_i_id": jnp.asarray(n, jnp.int32),
                 "weight": jnp.ones(16, jnp.float64),
                 "key": jax.random.PRNGKey(0)}

        def step(params, buffers, batch):
            batch = shard_batch(mesh, batch)

            def loss_fn(q):
                with jmodel.bind(buffers):
                    parts = jmodel.calculate_loss(q, batch)
                return sum(parts), jnp.stack(parts)

            (_, parts), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return jax.tree.map(lambda a, b: a - LR * b, params, g), parts

        new, parts = jax.jit(step)(jax.device_put(params, shardings), buffers,
                                   batch)
        start = flatten_params(jax.device_get(params))
        new = flatten_params(jax.device_get(new))
    return ({k: torch.from_numpy(np.array(v)) for k, v in start.items()},
            new, np.asarray(parts), (u, p, n))


@pytest.fixture(scope="module")
def world4(synth_root, x512, jax_start):
    roots = {"toy": synth_root[0], "x512": x512}
    state, _, _, batch = jax_start
    jobs = [
        ("layout-data2-model2", "layout",
         dict(mesh_shape={"data": 2, "model": 2})),
        ("layout-model2-data2", "layout",
         dict(mesh_shape={"model": 2, "data": 2})),
        ("mismatch", "mesh_size_mismatch", dict(mesh_shape={"data": 2})),
        ("shard", "shard", dict(mesh_shape={"data": 2, "model": 2},
                                batches=_shard_batches())),
        _epoch_job(EPOCHS[-1], roots),
        ("jax_step", "jax_step", dict(
            root=x512, mesh_shape={"data": 2, "model": 2}, state=state,
            batch=batch, lr=LR)),
    ]
    return _spawn(4, jobs)


@pytest.fixture(scope="module")
def world2(synth_root, x512, tmp_path_factory):
    roots = {"toy": synth_root[0], "x512": x512}
    ue, ie = _topk_cache()
    config_dir = str(tmp_path_factory.mktemp("mesh_configs") / "configs")
    from foodrec_tpu_torch import config as config_mod

    shutil.copytree(config_mod._CONFIG_DIR, config_dir)
    os.makedirs(os.path.join(config_dir, "dataset"), exist_ok=True)
    with open(os.path.join(config_dir, "dataset", "Synth.yaml"), "w") as f:
        f.write("mesh_shape: {data: 2}\nuse_gpu: False\n")
    work = {k: str(tmp_path_factory.mktemp(f"mesh_{k}"))
            for k in ("runner", "resume-data2", "resume-model2")}
    jobs = [_epoch_job(c, roots) for c in EPOCHS[:-1]] + [
        ("topk-model2", "topk", dict(mesh_shape={"model": 2}, user_emb=ue,
                                     item_emb=ie, k=20, user_batch=16)),
        ("full_sort", "full_sort_valid", dict(
            root=synth_root[0], model="LightGCN", mesh_shape={"model": 2})),
        ("resume-data2", "resume", dict(root=synth_root[0], model="LightGCN",
                                        mesh_shape={"data": 2},
                                        workdir=work["resume-data2"])),
        ("resume-model2", "resume", dict(
            root=x512, model="LightGCN", mesh_shape={"model": 2},
            workdir=work["resume-model2"], overrides={"learner": "adam"})),
        ("runner", "runner", dict(root=synth_root[0], model="CIKM_Model",
                                  mesh_shape={"data": 2},
                                  workdir=work["runner"],
                                  config_dir=config_dir)),
    ]
    out = _spawn(2, jobs)
    out["runner_dir"] = work["runner"]
    return out


@pytest.fixture(scope="module")
def world3():
    ue, ie = _topk_cache()
    return _spawn(3, [("topk-model3", "topk", dict(
        mesh_shape={"model": 3}, user_emb=ue, item_emb=ie, k=20,
        user_batch=16))])


# ---------------------------------------------------------------------------
# make_mesh, shard_batch, param_shardings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["layout-data2-model2",
                                  "layout-model2-data2"])
def test_make_mesh_layout_equals_jax(world4, case):
    shape = ({"data": 2, "model": 2} if case == "layout-data2-model2"
             else {"model": 2, "data": 2})
    devices = _jax_mesh(shape).devices
    names = tuple(shape)
    where = {int(d.id): idx for idx, d in np.ndenumerate(devices)}
    for rank, (coords, groups) in enumerate(world4[case]):
        assert tuple(coords[a] for a in names) == where[rank]
        for i, axis in enumerate(names):
            line = np.moveaxis(devices, i, -1)[
                tuple(c for j, c in enumerate(where[rank]) if j != i)]
            assert groups[axis] == [int(d.id) for d in line], (rank, axis)


def test_make_mesh_size_mismatch_raises(world4):
    assert world4["mismatch"] is not None
    assert "mesh_shape" in world4["mismatch"]


def _shard_batches():
    rng = np.random.default_rng(5)
    return [{"u": rng.integers(0, 100, rows).astype(np.int32),
             "w": rng.random(rows).astype(np.float32)}
            for rows in (8, 7)]


@pytest.mark.parametrize("which", [0, 1], ids=["divisible", "tail"])
def test_shard_batch_equals_jax(world4, which):
    from foodrec_tpu.parallel.mesh import shard_batch

    mesh = _jax_mesh({"data": 2, "model": 2})
    batch = {k: jnp.asarray(v) for k, v in _shard_batches()[which].items()}
    out = jax.jit(lambda b: shard_batch(mesh, b))(batch)
    where = {int(d.id): idx for idx, d in np.ndenumerate(mesh.devices)}
    by_coords = {where[rank]: rows[which]
                 for rank, rows in enumerate(world4["shard"])}
    for key, arr in out.items():
        for s in arr.addressable_shards:
            got = by_coords[where[int(s.device.id)]][key]
            np.testing.assert_array_equal(got, np.asarray(s.data))
    n_rows = len(batch["u"])
    assert all(len(r[which]["u"]) == (n_rows // 2 if n_rows % 2 == 0
                                       else n_rows)
               for r in world4["shard"])


class _SizeOnly:
    def __init__(self, model):
        self.shape = {"data": 1, "model": model}

    def size(self, axis):
        return self.shape.get(axis, 1)


def _picked(model_name, x512, n_model, rows=None):
    """(JAX's leaves, the port's leaves) row-sharded over a `model` axis of
    n_model, the shapes' first dims mapped through `rows`."""
    from foodrec_tpu.data.dataset import FoodData as JFoodData
    from foodrec_tpu.data.device import DeviceData as JDeviceData
    from foodrec_tpu.models import get_model as jget_model
    from foodrec_tpu_torch.models.base import row_sharded
    from foodrec_tpu_torch.utils.weights import flatten_params
    from tests.test_torch_port_models import _port_model

    overrides = CLUSSL512 if model_name == "PRICAI_ModelX" else {}
    jcfg, _ = make_config((x512, {"neg_num": 20}), model=model_name,
                          overrides={**overrides, "use_gpu": False})
    jdata = JFoodData(jcfg)
    jdata.device_data = JDeviceData.from_food_data(jdata, jcfg)
    jmodel = jget_model(model_name)(jcfg, jdata)
    rows = rows or {}

    def mapped(shape):
        return tuple([rows.get(shape[0], shape[0]), *shape[1:]]
                     if shape else shape)

    shapes = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(mapped(a.shape), a.dtype),
        jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)))
    mesh = _jax_mesh({"data": 1, "model": n_model})
    picked_jax = sorted(
        k for k, s in flatten_params(jmodel.param_shardings(mesh, shapes))
        .items() if len(s.spec) and s.spec[0] == "model")
    _, _, port = _port_model((x512, {"neg_num": 20}), model_name, overrides)
    picked_port = sorted(
        n for n, p in port.named_parameters()
        if row_sharded(n, mapped(tuple(p.shape)), n_model))
    rule_port = sorted(n for n, spec in port.param_shardings(
        _SizeOnly(n_model)).items() if spec) if not rows else None
    return picked_jax, picked_port, rule_port


PICKS_FOODCOM = {
    2: {"PRICAI_ModelX": ["image_prototype_embedding",
                          "text_prototype_embedding"]},
    3: {"CIKM_Model": ["image_embedding", "text_embedding"],
        "BM3": ["image_embedding", "text_embedding"],
        "LightGCN": ["image_embedding"]},
}


@pytest.mark.parametrize("scale,n_model", [("toy", 2), ("foodcom", 2),
                                           ("foodcom", 3)])
@pytest.mark.parametrize("model_name", MODELS)
def test_param_shardings_pick_the_jax_leaves(x512, model_name, scale,
                                             n_model):
    rows = FOODCOM_ROWS if scale == "foodcom" else None
    picked_jax, picked_port, rule_port = _picked(model_name, x512, n_model,
                                                 rows)
    assert picked_port == picked_jax
    if rule_port is not None:  # the model's own param_shardings
        assert rule_port == picked_jax
    if scale == "foodcom":
        assert picked_jax == PICKS_FOODCOM[n_model].get(model_name, [])


# ---------------------------------------------------------------------------
# training under the mesh
# ---------------------------------------------------------------------------


def _assert_states_close(got, want, tol):
    """Every leaf within tol of its largest |value| (a key bias, which
    moves by rounding only, of its query bias's: `_grad_err`)."""
    assert sorted(got) == sorted(want)
    want = {k: v.numpy() for k, v in want.items()}
    worst = max(_grad_err(k, got[k].numpy(), want) for k in want)
    assert worst <= tol, worst


@pytest.mark.parametrize("case", EPOCHS, ids=[c[0] for c in EPOCHS])
def test_mesh_epochs_equal_single_process(world2, world4, case):
    (parts, state, moved), (parts_ref, state_ref, _) = (
        world4 if case is EPOCHS[-1] else world2)[case[0]]
    for a, b in zip(parts, parts_ref):
        assert a.dtype == np.float64
        assert _rel_err(a, b) <= X64_TOL
    _assert_states_close(state, state_ref, X64_TOL)
    assert moved > 1e-6  # the epochs trained


def test_mesh_step_equals_jax_mesh_step(world4, jax_start):
    start, jax_new, jax_parts, _ = jax_start
    parts, state, sharded = world4["jax_step"]
    assert sharded == ["image_embedding", "text_embedding"]
    for a, b in zip(parts, jax_parts):
        assert _rel_err(a, b) <= X64_TOL
    assert sorted(state) == sorted(jax_new)
    for k, v in state.items():
        assert _rel_err(v.numpy(), jax_new[k]) <= X64_TOL, k
    assert any(not np.array_equal(state[k].numpy(), start[k].numpy())
               for k in state)


# ---------------------------------------------------------------------------
# the full-sort top-k over `model`
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_model", [2, 3])
def test_distributed_topk_equals_jax_and_single(world2, world3, n_model):
    from foodrec_tpu.engine.topk_evaluator import (
        distributed_full_sort_topk as jax_distributed,
    )
    ue, ie = _topk_cache()
    per_rank, single = (world2 if n_model == 2 else world3)[
        f"topk-model{n_model}"]

    def score_local(cache_local, users_blk, cand_b):
        u, i = cache_local
        return jnp.einsum("bd,bcd->bc", u[users_blk], i[cand_b])

    want = jax_distributed(_jax_mesh({"model": n_model}), score_local,
                           (jnp.asarray(ue), jnp.asarray(ie)),
                           list(range(len(ue))), len(ie), 20, user_batch=16)
    assert len(per_rank) == n_model
    for ids in per_rank:
        np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(single, want)


def test_full_sort_eval_over_model_axis_equals_single(world2):
    (score, result), (score_ref, result_ref) = world2["full_sort"]
    assert result == result_ref
    assert score == score_ref


# ---------------------------------------------------------------------------
# the driver under the mesh
# ---------------------------------------------------------------------------


def test_runner_under_mesh_writes_once_and_loads_in_one_process(
        world2, synth_root):
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model
    from tests.torch_mesh_workers import _config, _data

    hyper, valid, test = world2["runner"]
    work = world2["runner_dir"]
    assert len(os.listdir(os.path.join(work, "log"))) == 1
    (ckpt_name,) = os.listdir(os.path.join(work, "ckp"))
    cfg = _config(synth_root[0], "CIKM_Model", {})
    data = _data(cfg)
    model = get_model("CIKM_Model")(cfg, data,
                                    torch.Generator().manual_seed(1))
    model.load_state_dict(Trainer.load_checkpoint(
        os.path.join(work, "ckp", ckpt_name)))
    assert Trainer(cfg, model).evaluate(data.device_data.eval_test,
                                        is_test=True) == test


@pytest.mark.parametrize("case", ["resume-data2", "resume-model2"])
def test_resume_under_mesh_equals_uninterrupted(world2, case):
    """resume_from under the mesh equals the run that was not stopped, its
    parameters and optimizer moments after epoch 2 bit for bit; a
    save_state file written under the mesh (at model 2 the row-sharded
    table and its Adam moments whole) resumes in one process, and one
    process's under the mesh, within 1e-9."""
    states = world2[case]
    full, moments = states["full"]
    resumed, resumed_moments = states["resumed"]
    for k in full:
        assert torch.equal(full[k], resumed[k]), k
    for i, leaf in moments.items():
        for key, v in leaf.items():
            assert torch.equal(v, resumed_moments[i][key]), (i, key)
    for crossed in ("mesh_to_one", "one_to_mesh"):
        _assert_states_close(states[crossed][0], full, X64_TOL)


@pytest.mark.parametrize("n_ranks", [4, 8])
def test_dryrun_multichip_prints_ok(n_ranks, capsys):
    from foodrec_tpu_torch.multichip import dryrun_multichip

    out = dryrun_multichip(n_ranks, device="cpu", timeout=SPAWN_TIMEOUT,
                           threads=1)
    line = capsys.readouterr().out
    assert f"dryrun_multichip({n_ranks}): OK" in line
    assert out["mesh"] == ({"data": n_ranks // 2, "model": 2})
