"""Rank functions of tests/test_torch_port_mesh.py, run in the processes
that `foodrec_tpu_torch.parallel.spawn.run_ranks` starts (gloo on the CPU).
This module imports no JAX, so that the ranks start quickly.

`run_jobs(rank, jobs)` runs each (name, kwargs) of `jobs` on every rank in
order and returns {name: result}; a job's result is rank 0's (the other
ranks return None) unless it says otherwise.
"""

import os

import numpy as np
import torch
import torch.distributed as dist


def _config(root, model, overrides):
    from foodrec_tpu_torch import config as config_mod
    from foodrec_tpu_torch.data.dataset import derive_data_paths

    cfg = config_mod.Config(model, "Synth", {
        "data_path": root.rsplit("/Synth", 1)[0] + "/", "neg_sample_num": 20,
        "use_gpu": False, **overrides})
    derive_data_paths(cfg, "Synth")
    return cfg


def _data(cfg):
    from foodrec_tpu_torch.data.dataset import FoodData
    from foodrec_tpu_torch.data.device import DeviceData

    data = FoodData(cfg)
    data.device_data = DeviceData.from_food_data(data)
    return data


def _trainer(root, model, overrides, dtype=torch.float64, state=None,
             mg=False):
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    cfg = _config(root, model, overrides)
    data = _data(cfg)
    m = get_model(model)(cfg, data, torch.Generator().manual_seed(0)).to(dtype)
    if state is not None:
        m.load_state_dict(state)
    return Trainer(cfg, m, mg), data


def _host(state):
    return {k: v.detach().cpu().clone() for k, v in state.items()}


# -- jobs -----------------------------------------------------------------------
def layout(rank, mesh_shape):
    """Every rank's (coordinates, the ranks of each axis group)."""
    from foodrec_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_shape, "cpu")
    out = (mesh.coords, {a: dist.get_process_group_ranks(g)
                         for a, g in mesh.groups.items()})
    box = [None] * mesh.world_size
    dist.all_gather_object(box, out)
    return box if rank == 0 else None


def mesh_size_mismatch(rank, mesh_shape):
    """The error text of make_mesh on a mesh the group does not fit."""
    from foodrec_tpu_torch.parallel.mesh import make_mesh

    try:
        make_mesh(mesh_shape, "cpu")
    except ValueError as e:
        return str(e)
    return None


def shard(rank, mesh_shape, batches):
    """Every rank's shard_batch of each batch (dicts of arrays)."""
    from foodrec_tpu_torch.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(mesh_shape, "cpu")
    mine = [{k: np.asarray(v) for k, v in shard_batch(
        mesh, {k: torch.as_tensor(v) for k, v in b.items()}).items()}
        for b in batches]
    box = [None] * mesh.world_size
    dist.all_gather_object(box, mine)
    return box if rank == 0 else None


def epoch(rank, root, model, mesh_shape, overrides, epochs=1, mg=False):
    """(loss parts of each epoch, whole state, the largest move of a leaf
    relative to its size) of float64 epochs under the mesh, and on rank 0
    the same epochs in this process without it."""

    def run(shape):
        trainer, _ = _trainer(root, model, {**overrides,
                                            "mesh_shape": shape}, mg=mg)
        start = _host(trainer.model.full_state_dict())
        parts = [trainer.train_epoch().numpy() for _ in range(epochs)]
        state = _host(trainer.model.full_state_dict())
        moved = max(float((state[k] - v).abs().max() / v.abs().max())
                    for k, v in start.items() if v.abs().max() > 0)
        return parts, state, moved

    mesh_out = run(mesh_shape)
    return (mesh_out, run(None)) if rank == 0 else None


def jax_step(rank, root, mesh_shape, state, batch, lr):
    """One float64 SGD step of CIKM_Model under the mesh from `state` (the
    JAX package's parameters) on `batch` (u, pos, neg): (loss parts, whole
    state)."""
    trainer, _ = _trainer(root, "CIKM_Model", {
        "mesh_shape": mesh_shape, "learner": "sgd", "learning_rate": lr,
        "weight_decay": 0.0, "attention_probs_dropout_prob": 0.0},
        state=state)
    sharded = sorted(trainer.model.row_shards)
    parts = trainer.train_steps([tuple(torch.as_tensor(a).long()
                                       for a in batch)])
    full = _host(trainer.model.full_state_dict())
    return (parts.numpy(), full, sharded) if rank == 0 else None


def topk(rank, mesh_shape, user_emb, item_emb, k, user_batch):
    """The ids of distributed_full_sort_topk (every rank's) and, on rank 0,
    full_sort_topk's, over a cache of dot-product scores."""
    from foodrec_tpu_torch.engine.topk_evaluator import (
        distributed_full_sort_topk,
        full_sort_topk,
    )
    from foodrec_tpu_torch.parallel.mesh import make_mesh

    ue, ie = torch.as_tensor(user_emb), torch.as_tensor(item_emb)

    def score(users, items):
        return ue[users] @ ie[items].T

    users = list(range(len(ue)))
    mesh = make_mesh(mesh_shape, "cpu")
    ids = distributed_full_sort_topk(mesh, score, users, len(ie), k,
                                     user_batch=user_batch, item_chunk=16,
                                     device="cpu").numpy()
    box = [None] * mesh.world_size
    dist.all_gather_object(box, ids)
    single = full_sort_topk(score, users, len(ie), k, user_batch=user_batch,
                            device="cpu").numpy()
    return (box, single) if rank == 0 else None


def full_sort_valid(rank, root, model, mesh_shape):
    """Trainer._valid_full_sort on the test split under the mesh and, on
    rank 0, without it: (score, metrics) each."""
    overrides = {"full_sort": True, "eval_by_user": False}
    out = []
    for shape in (mesh_shape, None):
        if shape is None and rank:
            break
        trainer, _ = _trainer(root, model, {**overrides, "mesh_shape": shape},
                              dtype=torch.float32)
        out.append(trainer._valid_full_sort(is_test=True))
    return out if rank == 0 else None


def runner(rank, root, model, mesh_shape, workdir, config_dir):
    """runner.main on one epoch, mesh_shape and use_gpu: False read from a
    dataset yaml in `config_dir` (a copy of the package's configs), run in
    `workdir`: quick_start's best (hyper_tuple, valid, test) on every
    rank."""
    from foodrec_tpu_torch import config as config_mod
    from foodrec_tpu_torch import runner as runner_mod

    os.makedirs(os.path.join(config_dir, "dataset"), exist_ok=True)
    config_mod._CONFIG_DIR = config_dir
    os.chdir(workdir)
    return runner_mod.main([
        "-m", model, "-d", "Synth",
        "--data_path", root.rsplit("/Synth", 1)[0] + "/", "--epochs", "1",
        "--neg_sample_num", "20"])


def resume(rank, root, model, mesh_shape, workdir, overrides=None):
    """The model and optimizer states that fit's save_state wrote after its
    2nd epoch: {"full": one run under the mesh, "resumed": a 1-epoch run
    under the mesh resumed under the mesh from its file, "mesh_to_one":
    that file resumed in one process, "one_to_mesh": a 1-epoch run in one
    process resumed under the mesh}. (fit's own result is the best-on-valid
    parameters, and a resumed fit starts with the best valid score the file
    held, before its epoch's eval, as in the JAX package.)"""
    os.chdir(workdir)
    base = {**(overrides or {}), "eval_step": 1, "save_state_every": 1,
            "stopping_step": 10}

    def fit(shape, ckp_root, epochs=2, resume_from=None):
        if shape is not None or rank == 0:
            trainer, data = _trainer(root, model, {
                **base, "mesh_shape": shape, "ckp_root": ckp_root,
                "epochs": epochs, "resume_from": resume_from})
            trainer.fit(data)
        dist.barrier()  # rank 0 has written its save_state file
        (name,) = os.listdir(ckp_root)
        return os.path.join(ckp_root, name)

    def state(path):
        saved = torch.load(path, weights_only=True)
        return saved["model"], saved["optimizer"]["state"]

    paths = {"full": fit(mesh_shape, "full/")}
    cut = fit(mesh_shape, "cut/", epochs=1)
    paths["resumed"] = fit(mesh_shape, "again/", resume_from=cut)
    paths["mesh_to_one"] = fit(None, "one/", resume_from=cut)
    one_cut = fit(None, "one_cut/", epochs=1)
    paths["one_to_mesh"] = fit(mesh_shape, "back/", resume_from=one_cut)
    return {k: state(p) for k, p in paths.items()} if rank == 0 else None


def run_jobs(rank, jobs):
    return {name: globals()[fn](rank, **kwargs) for name, fn, kwargs in jobs}
