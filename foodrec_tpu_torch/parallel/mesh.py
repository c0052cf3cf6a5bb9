# coding: utf-8
"""The device mesh over torch.distributed (counterpart of
`foodrec_tpu/parallel/mesh.py`): one process per card, `config['mesh_shape']`
(e.g. {data: 8}, {data: 4, model: 2}) naming its axes.

  * `data`: each train step's batch is split over the axis; every rank
    draws the global batch's randomness from the same seeded generator and
    takes its own rows, the losses reduce over the global batch
    (`batch_sum`, `gather_batch_rows`), and the gradients are summed over
    the axis, so a sharded step computes what one process computes
  * `model`: the large modality tables are row-sharded over the axis
    (models/base.py `param_shardings`), and the full-sort eval takes a
    top-k per item shard (engine/topk_evaluator.py)

JAX's mesh is one controller whose compiler inserts the collectives; here
each rank is a process, and the collectives are the program's own
(`parallel/collectives.py`). The graph propagation is replicated compute on
every rank, as the graph is replicated in the JAX package.

The process group is the one `torchrun` or a spawner initialized; without
one, `make_mesh` initializes it from `torchrun`'s environment, or, for a
mesh of one rank, in this process alone. Its backend follows the device:
`nccl` on `cuda`, `gloo` on the CPU.
"""

import contextlib
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from foodrec_tpu_torch.parallel import collectives as coll

AXES = ("data", "model")


class Mesh:
    """A named mesh of the process group's ranks, laid out row-major over
    `mesh_shape`'s axes as `mesh_utils.create_device_mesh` lays out the
    devices: with {data: d, model: m}, rank r is at data r // m, model
    r % m. `shape` reads as JAX's `mesh.shape`; `groups[axis]` is this
    rank's process subgroup along the axis (the ranks whose other
    coordinates equal its own)."""

    def __init__(self, mesh_shape, device):
        self.names = tuple(mesh_shape)
        self.sizes = tuple(int(v) for v in mesh_shape.values())
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.backend = dist.get_backend()
        grid = np.arange(self.world_size).reshape(self.sizes)
        self.coords = {n: int(c) for n, c in zip(
            self.names, np.unravel_index(self.rank, self.sizes))}
        self.groups = {}
        for i, name in enumerate(self.names):
            # every rank creates every group, in the same order
            for line in np.moveaxis(grid, i, -1).reshape(-1, self.sizes[i]):
                group = dist.new_group(line.tolist())
                if self.rank in line:
                    self.groups[name] = group

    @property
    def shape(self):
        return dict(zip(self.names, self.sizes))

    def size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)

    def group(self, axis):
        return self.groups.get(axis)


def process_rank():
    """This process's rank: the process group's, else the launcher's
    RANK, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def _init_process_group(mesh_shape, n, device):
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    elif n == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        raise ValueError(
            f"mesh_shape {mesh_shape} needs {n} processes, one a card, and "
            f"this is one process without a launcher: start it with "
            f"torchrun --nproc_per_node={n}")


def _load_kernels(mesh):
    """The CUDA kernels, built once by the host's local rank 0 (nothing is
    built when a parent built them before the ranks started) and loaded
    by every rank; a rank whose load fails raises."""
    from foodrec_tpu_torch.ops import _kernels

    if int(os.environ.get("LOCAL_RANK", mesh.rank)) == 0:
        _kernels.build()
    dist.barrier()
    _kernels.load_all()


def make_mesh(mesh_shape, device="cuda"):
    """The Mesh for `mesh_shape` (a dict axis -> size, axes `data` and
    `model`), on this rank's `device`; None when mesh_shape is empty.
    Raises when the mesh's size differs from the process group's."""
    if not mesh_shape:
        return None
    unknown = sorted(set(mesh_shape) - set(AXES))
    if unknown:
        raise ValueError(f"mesh_shape {mesh_shape}: unknown axes {unknown} "
                         f"(the axes are {AXES})")
    n = int(np.prod([int(v) for v in mesh_shape.values()]))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        _init_process_group(mesh_shape, n, device)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh_shape {mesh_shape} has {n} ranks, the "
                         f"process group {world}")
    mesh = Mesh(mesh_shape, device)
    if device.type == "cuda":
        _load_kernels(mesh)
    logging.getLogger().info(f"mesh {mesh.shape}: {world} ranks over "
                             f"{mesh.backend}")
    return mesh


def replicated(mesh):
    """The fully replicated placement (mesh.py:46-47), as
    `param_shardings` writes it: no axis; a row-sharded table's is
    ("model",)."""
    return ()


def shard_batch(mesh, batch):
    """This rank's rows of every batch tensor whose rows divide `data`;
    scalars and the rest stay whole (replicated), so a tail batch that does
    not divide runs replicated and exact (mesh.py:50-64)."""
    if mesh is None:
        return batch
    d, i = mesh.size("data"), mesh.index("data")

    def rows(v):
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] % d == 0:
            b = v.shape[0] // d
            return v[i * b:(i + 1) * b]
        return v

    return {k: rows(v) for k, v in batch.items()}


# -- the batch under a data shard ---------------------------------------------
# (group, index, size, local rows) of the `data` shard while calculate_loss
# runs on this rank's rows of a global batch; None otherwise
_ROWS = None


@contextlib.contextmanager
def batch_rows(mesh, n_rows):
    """Inside, the model's losses and draws follow a global batch of
    `n_rows` of which this rank holds its `data` shard; a batch that does
    not divide `data`, or a mesh without the axis, leaves them alone."""
    global _ROWS
    d = mesh.size("data") if mesh is not None else 1
    if d == 1 or n_rows % d:
        yield
        return
    prev = _ROWS
    _ROWS = (mesh.group("data"), mesh.index("data"), d, n_rows // d)
    try:
        yield
    finally:
        _ROWS = prev


def batch_sum(x):
    """The sum of `x` over the global batch: the local sum, summed over
    `data` under a shard (differentiable)."""
    s = x.sum()
    return s if _ROWS is None else coll.sum_over_ranks(s, _ROWS[0])


def _blocks(n, local):
    k = n // local
    if k * local != n:
        raise ValueError(f"{n} rows are not whole blocks of the {local} "
                         "local batch rows")
    return k


def gather_batch_rows(x):
    """x's rows of the global batch, in its order: x's leading dim holds k
    blocks of this rank's rows (a [2B] cat of positives and negatives is
    two), and so does the result's, each block of the global batch
    (differentiable)."""
    if _ROWS is None:
        return x
    group, _, d, local = _ROWS
    k = _blocks(x.shape[0], local)
    g = coll.gather_rows(x, group)                     # [d * k * local]
    g = g.reshape((d, k, local) + x.shape[1:]).transpose(0, 1)
    return g.reshape((k * d * local,) + x.shape[1:])


def take_batch_rows(x):
    """This rank's rows of `x`, whose leading dim holds k blocks of the
    global batch (the inverse of `gather_batch_rows`)."""
    if _ROWS is None:
        return x
    _, i, d, local = _ROWS
    k = _blocks(x.shape[0], d * local)
    return x.reshape((k, d, local) + x.shape[1:])[:, i].reshape(
        (k * local,) + x.shape[1:])


def batch_draw(draw, shape, dim=0):
    """draw(shape), a random tensor whose dim `dim` holds the batch's rows:
    under a shard, the global batch's draw (the same on every rank, from
    the same generator state) and this rank's rows of it."""
    if _ROWS is None:
        return draw(tuple(shape))
    _, i, d, local = _ROWS
    k = _blocks(shape[dim], local)
    full = list(shape)
    full[dim] = k * d * local
    out = draw(tuple(full))
    idx = (torch.arange(k)[:, None] * (d * local) + i * local
           + torch.arange(local)[None, :]).reshape(-1)
    return out.index_select(dim, idx.to(out.device))
