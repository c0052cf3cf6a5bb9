# coding: utf-8
"""The multichip dry run (counterpart of `__graft_entry__.py:126-210`,
`dryrun_multichip`): one full CIKM_Model training step on n ranks of a 2-D
mesh, the batch split over `data` and the 512-d modality tables row-sharded
over `model`, held against the same step in one process.

    python -m foodrec_tpu_torch.multichip 4          # on the card
    python -m foodrec_tpu_torch.multichip 4 --cpu    # on the CPU, over gloo

The mesh is the JAX package's: {data: n / 2, model: 2} for an even n >= 4,
else {data: n}. The ranks run on the card (each on cuda:rank % cards), and
the run raises before any rank starts where there is none, unless
`device="cpu"` (`--cpu`); they talk over NCCL when each has a card of its
own and over gloo otherwise (NCCL refuses two ranks on one card, and the
CPU has no NCCL). The step: the first 2n train pairs, negatives from a
generator seeded 2, Adam at lr 1e-3, the encoder's dropout drawn alike on
both sides. The bars are the JAX package's: the loss within 1e-5
relative, the parameters within 1e-2 in global relative L2 and 5e-3 in max
|delta| (Adam's first step is about sign(g) * lr, so a gradient near 0 may
flip in the last bit).
"""

import argparse
import os
import tempfile

import numpy as np
import torch

N_USERS, N_ITEMS, NEG_NUM = 32, 64, 10


def mesh_for(n_ranks):
    """The JAX package's pick: model 2 when n is even and >= 4."""
    if n_ranks % 2 == 0 and n_ranks >= 4:
        return {"data": n_ranks // 2, "model": 2}
    return {"data": n_ranks}


def _step(root, mesh_shape, device, b):
    """(loss, whole state_dict on the host) of one step on b rows."""
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.data.sampling import sample_negatives
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    cfg = Config("CIKM_Model", "Synth", {
        "data_path": root + "/", "neg_sample_num": NEG_NUM,
        "use_gpu": device == "cuda", "learner": "adam",
        "learning_rate": 1e-3, "weight_decay": 0.0, "mesh_shape": mesh_shape,
        # the kernel on the card even where `auto` would take ELL on the
        # toy graphs, so that every rank launches it
        "spmm_impl": "kernel" if device == "cuda" else "auto"})
    derive_data_paths(cfg, "Synth")
    data = FoodData(cfg)
    data.device_data = dd = DeviceData.from_food_data(data)
    model = get_model("CIKM_Model")(cfg, data, torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model)
    dev = model.device
    u = torch.as_tensor(dd.train_u[:b]).to(dev, torch.int64)
    pos = torch.as_tensor(dd.train_i[:b]).to(dev, torch.int64)
    excl = torch.from_numpy(dd.excl_bitmap.view(np.int32)).to(dev)
    neg = sample_negatives(u, excl, dd.num_items,
                           torch.Generator(device=dev).manual_seed(2))
    loss = float(trainer.train_steps([(u, pos, neg)]).sum())
    return loss, trainer._host_snapshot()


def _rank(rank, root, mesh_shape, device):
    """This rank's kernel launches in the mesh step; on rank 0 also both
    steps' losses and whole states."""
    from foodrec_tpu_torch.ops import _kernels

    for k in _kernels.launches:
        _kernels.launches[k] = 0
    b = 2 * int(np.prod(list(mesh_shape.values())))
    loss, state = _step(root, mesh_shape, device, b)
    out = dict(launches=dict(_kernels.launches))
    if rank != 0:
        return out
    # the replicated step, in this process alone
    loss_rep, state_rep = _step(root, None, device, b)
    if state_rep.keys() != state.keys():
        raise AssertionError("the mesh step's leaves differ")
    return dict(out, loss=loss, loss_rep=loss_rep, state=state,
                state_rep=state_rep)


def dryrun_multichip(n_ranks, device="cuda", timeout=300, threads=None):
    """Run the dry run on n_ranks ranks; prints the JAX package's OK line
    and returns its numbers (with each rank's kernel launches), or
    raises: on "cuda" where CUDA is not available, before any rank
    starts."""
    from foodrec_tpu_torch.data import synthetic
    from foodrec_tpu_torch.parallel.spawn import run_ranks
    from foodrec_tpu_torch.utils.device import resolve_device

    device = resolve_device(device).type
    mesh_shape = mesh_for(n_ranks)
    backend = ("nccl" if device == "cuda"
               and torch.cuda.device_count() >= n_ranks else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        synthetic.generate(os.path.join(tmp, "Synth"), n_users=N_USERS,
                           n_items=N_ITEMS, neg_num=NEG_NUM, img_dim=512,
                           txt_dim=8)
        if device == "cuda":
            from foodrec_tpu_torch.ops import _kernels

            _kernels.build()  # once, before any rank starts
        ranks = run_ranks(_rank, n_ranks, args=(tmp, mesh_shape, device),
                          backend=backend, timeout=timeout, threads=threads)
    loss, loss_rep = ranks[0]["loss"], ranks[0]["loss_rep"]
    state, state_rep = ranks[0]["state"], ranks[0]["state_rep"]
    if not np.isfinite(loss):
        raise AssertionError(f"loss {loss}")
    np.testing.assert_allclose(loss, loss_rep, rtol=1e-5)
    diffs = torch.cat([(state[k].double() - state_rep[k].double()).ravel()
                       for k in state_rep])
    ref = torch.cat([state_rep[k].double().ravel() for k in state_rep])
    rel = float(diffs.norm() / ref.norm())
    max_abs = float(diffs.abs().max())
    if not (rel < 1e-2 and max_abs < 5e-3):
        raise AssertionError(f"parameters part: relative L2 {rel:.3e}, "
                             f"max |delta| {max_abs:.3e}")
    print(f"dryrun_multichip({n_ranks}): OK, loss={loss:.4f} (replicated "
          f"{loss_rep:.4f}, max param delta {max_abs:.2e}), mesh={mesh_shape}",
          flush=True)
    return dict(loss=loss, loss_rep=loss_rep, max_abs=max_abs, rel_l2=rel,
                mesh=mesh_shape, backend=backend,
                launches=[r["launches"] for r in ranks])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    dryrun_multichip(a.n_ranks, device="cpu" if a.cpu else "cuda")
