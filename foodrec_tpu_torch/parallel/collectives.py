# coding: utf-8
"""The collectives of the mesh, in one place: plain ones for the trainer's
gradient reduction, the top-k merge and the checkpoints' gathers, and the
autograd Functions that the losses and the row-sharded tables go through.

Two conventions of differentiation, one per axis:

  * `data`: every rank holds its own rows of the batch, and a loss part is
    the global batch's value on every rank; each rank backpropagates 1/size
    of it (the trainer divides the summed parts by the `data` size) and the
    gradients are summed over `data`. So `sum_over_ranks` sums in the
    forward and in the backward, and `gather_rows` gathers in the forward
    and sums the gradients of each rank's slice in the backward.
  * `model`: the ranks of a `model` group hold the same rows of the batch and
    compute the same thing downstream of a row-sharded table; only the
    table's rows are split. So `model_sum` (the masked lookups of the local
    rows, summed) passes the gradient through unchanged, and `model_gather`
    (the local rows' projections, gathered) hands each rank the gradient of
    its own rows; the projection's weights, applied to the local rows only,
    go through `model_grad_sum`, whose backward sums their gradient over
    the group.

The collectives used (all_reduce, all_gather, broadcast) run on CUDA
tensors over nccl and over gloo alike: asked of a gloo group on the H100,
all three took CUDA tensors and gave the right results (the `cuda` case of
tests/test_torch_port_mesh.py's dry run steps a {data: 2, model: 2} mesh
of ranks sharing one card over gloo), so no tensor goes through host
memory here.
"""

import torch
import torch.distributed as dist


def all_reduce(t, group):
    """Sum `t` over `group` in place; returns it."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t, group):
    """Every rank's `t` concatenated along dim 0, in the group's rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return torch.cat(out)


def broadcast(t, group, src_index=0):
    """`t` of the group's `src_index`-th rank, in place on every rank."""
    if dist.get_world_size(group) > 1:
        dist.broadcast(t, group=group,
                       src=dist.get_global_rank(group, src_index))
    return t


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.group)
        i = dist.get_rank(ctx.group)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelGradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None


def sum_over_ranks(x, group):
    """The sum of `x` over `group` (a `data` group), differentiable."""
    return _SumOverRanks.apply(x, group)


def gather_rows(x, group):
    """Every `data` rank's `x` along dim 0, differentiable."""
    return _GatherRows.apply(x, group)


def model_sum(x, group):
    """The sum of `x` over a `model` group, the gradient passed through."""
    return _ModelSum.apply(x, group)


def model_grad_sum(x, group):
    """x itself, its gradient summed over a `model` group: a replicated
    weight applied to each rank's rows of a row-sharded table."""
    return _ModelGradSum.apply(x, group)


def model_gather(x, group):
    """Every `model` rank's `x` along dim 0, each rank's gradient its own
    rows'."""
    return _ModelGather.apply(x, group)


def sharded_lookup(table, ids, offset, group):
    """`full_table[ids]` from a table row-sharded over a `model` group, this
    rank holding rows [offset, offset + len(table)): the local rows where an
    id falls in them, zero elsewhere, summed over the group. Only the local
    rows get a gradient."""
    local = ids - offset
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    mask = inside.reshape(inside.shape + (1,) * (rows.dim() - ids.dim()))
    return model_sum(torch.where(mask, rows, torch.zeros_like(rows)), group)
