"""PyTorch port, the CUDA SpMM's work plan and its bf16 mode.

`plan_csr` cuts a CSR matrix into the kernel's items on the host. Its
invariants are held here on small graphs, and the plan is executed in plain
torch in the kernel's own order (`planned_spmm`: each item's rows summed
edge by edge, each cut row's slices into a scratch, then the fix-up adding
them in item order on two half-warps) against `spmm_csr_plain` and the JAX
package's `segment` and Pallas (interpret mode) impls, rtol 1e-5 / atol
1e-6 (float32 sums taken in other orders). The CUDA kernel itself runs
only on the card, where the `cuda` cases of tests/test_torch_port_spmm.py
hold it against the plain version.

bf16 mode follows the JAX package per impl: the kernel impl (its plain
version on the CPU) against JAX `pallas` with compute_dtype bfloat16 at rtol
1e-5 / atol 1e-6 -- both round x (g in the backward) to bf16 and sum in f32,
so only the order of the f32 sums differs; `segment` and `ell` compute in
bf16 in both packages, where the two frameworks round products and partial
sums at other places, so they meet at the bf16 bar of tests/test_spmm.py:149
(3e-2)."""

import numpy as np
import pytest
import torch

from test_torch_port_spmm import _adjs, _row_normalized_adjs

RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 3e-2


def _long_row_csr(rng, item_edges):
    """A row of 50x the item length between short and empty rows."""
    deg = rng.poisson(3, 200)
    deg[rng.random(200) < 0.3] = 0
    deg[77] = 50 * item_edges
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return row_ptr, rng.integers(0, 200, row_ptr[-1]).astype(np.int32)


def _row_ptr(kind, rng, item_edges):
    if kind == "nnz=0":
        return np.zeros(31, np.int32)
    if kind == "long row":
        return _long_row_csr(rng, item_edges)[0]
    adj, _ = _adjs(kind, rng)
    return adj.row_ptr


@pytest.mark.parametrize("geometry", [(64, 32, 16), (8, 3, 2)])
@pytest.mark.parametrize("kind", ["hub+empty", "ring", "random", "nnz=0",
                                  "long row"])
def test_plan_invariants(rng, kind, geometry):
    """Every edge lies in exactly one item and the items keep CSR order;
    every row, empty ones included, belongs to exactly one item of whole
    rows (at most item_edges edges and item_rows rows, and no more room for
    the next row) or is cut into slices of at most item_edges edges that
    cover it;
    the partial slots and the fix-up table list the slices in item order;
    block_edges / block_rows are the most one block covers."""
    from foodrec_tpu_torch.ops.spmm import plan_csr

    item_edges, item_rows, per_block = geometry
    row_ptr = _row_ptr(kind, rng, item_edges).astype(np.int64)
    n, nnz = len(row_ptr) - 1, int(row_ptr[-1])
    deg = np.diff(row_ptr)
    plan = plan_csr(row_ptr, item_edges=item_edges, item_rows=item_rows,
                    items_per_block=per_block)
    assert plan.table.dtype == np.int32
    assert (plan.n_rows, plan.nnz) == (n, nnz)
    ir, ie, slot = (plan.item_row.astype(np.int64),
                    plan.item_edge.astype(np.int64), plan.item_slot)
    assert len(ir) == len(ie) == plan.n_items + 1 == len(slot) + 1
    # edges: contiguous ranges in order from 0 to nnz, so each edge is in
    # exactly one item and a row's edges keep their order
    assert ie[0] == 0 and ie[-1] == nnz and (np.diff(ie) >= 0).all()
    assert ir[0] == 0 and ir[-1] == n and (np.diff(ir) >= 0).all()
    cut = deg > item_edges
    covered = np.zeros(n, np.int64)
    for i in range(plan.n_items):
        if slot[i] < 0:  # whole rows item_row[i]:item_row[i+1]
            rows = np.arange(ir[i], ir[i + 1])
            assert 1 <= len(rows) <= item_rows
            assert not cut[rows].any()
            nxt = ir[i + 1]  # greedy: the next row would not have fitted
            assert (nxt == n or cut[nxt] or len(rows) == item_rows
                    or row_ptr[nxt + 1] - row_ptr[ir[i]] > item_edges)
            assert ie[i] == row_ptr[ir[i]] and ie[i + 1] == row_ptr[ir[i + 1]]
            assert ie[i + 1] - ie[i] <= item_edges
            covered[rows] += 1
        else:            # one slice of the cut row item_row[i]
            r = ir[i]
            assert cut[r] and 0 < ie[i + 1] - ie[i] <= item_edges
            assert row_ptr[r] <= ie[i] < ie[i + 1] <= row_ptr[r + 1]
    is_slice = slot >= 0
    np.testing.assert_array_equal(slot[is_slice],
                                  np.arange(is_slice.sum()))
    np.testing.assert_array_equal(plan.fix_row, np.flatnonzero(cut))
    fix_ptr = plan.fix_ptr
    assert plan.n_partials == fix_ptr[-1] == is_slice.sum()
    for k, r in enumerate(plan.fix_row):
        mine = np.flatnonzero(is_slice & (ir[:-1] == r))
        np.testing.assert_array_equal(slot[mine],
                                      np.arange(fix_ptr[k], fix_ptr[k + 1]))
        assert ie[mine[0]] == row_ptr[r] and ie[mine[-1] + 1] == row_ptr[r + 1]
        covered[r] += 1
    np.testing.assert_array_equal(covered, np.ones(n))
    firsts = np.arange(0, plan.n_items, per_block)
    lasts = np.minimum(firsts + per_block, plan.n_items)
    assert plan.block_edges == max(ie[lasts] - ie[firsts])
    assert plan.block_rows == max(ir[lasts] - ir[firsts])


def planned_spmm(row_ptr, cols, vals, plan, x):
    """The kernel's work in plain torch and in the kernel's order: an item
    of whole rows sums each of its rows edge by edge (empty rows zero), a
    slice of a cut row sums its edges into its partial slot, and the fix-up
    adds a cut row's partials on two half-warps, the even positions on one
    and the odd on the other, each in item order, then the even sum plus the
    odd one."""
    row_ptr, cols = row_ptr.long(), cols.long()
    n, d = row_ptr.numel() - 1, x.shape[1]
    y = torch.full((n, d), float("nan"), dtype=x.dtype)
    partials = torch.empty((plan.n_partials, d), dtype=x.dtype)

    def in_order(terms):
        acc = torch.zeros(d, dtype=x.dtype)
        for term in terms:
            acc = acc + term
        return acc

    ir, ie, slot = plan.item_row, plan.item_edge, plan.item_slot
    for i in range(plan.n_items):
        start, end = int(ie[i]), int(ie[i + 1])
        rows = ([(start, end)] if slot[i] >= 0 else
                [(int(row_ptr[r]), int(row_ptr[r + 1]))
                 for r in range(int(ir[i]), int(ir[i + 1]))])
        sums = [in_order(vals[e] * x[cols[e]] for e in range(e0, e1))
                for e0, e1 in rows]
        if slot[i] >= 0:
            partials[slot[i]] = sums[0]
        else:
            y[int(ir[i]):int(ir[i + 1])] = torch.stack(sums)
    for k, r in enumerate(plan.fix_row):
        mine = partials[int(plan.fix_ptr[k]):int(plan.fix_ptr[k + 1])]
        y[int(r)] = in_order(mine[0::2]) + in_order(mine[1::2])
    return y


def _matrices(kind, rng):
    """(port adjacency, JAX adjacency) of A: the symmetric hub+empty graph,
    the row-normalized graph or its transpose, an edgeless graph, or a row
    of 50x the item length."""
    from foodrec_tpu.ops.graph import NormalizedAdjacency as JAdj
    from foodrec_tpu.ops.graph import transpose_adjacency as jtranspose
    from foodrec_tpu_torch.ops.graph import NormalizedAdjacency
    from foodrec_tpu_torch.ops.graph import transpose_adjacency

    if kind == "symmetric":
        return _adjs("hub+empty", rng)
    if kind in ("row-normalized A", "row-normalized A^T"):
        adj, jadj = _row_normalized_adjs(rng)
        if kind.endswith("A^T"):
            adj, jadj = transpose_adjacency(adj), jtranspose(jadj)
        return adj, jadj
    if kind == "nnz=0":
        row_ptr, cols = np.zeros(41, np.int32), np.zeros(0, np.int32)
    else:
        row_ptr, cols = _long_row_csr(rng, 8)
    deg = np.diff(row_ptr)
    n = len(deg)
    fields = dict(n_nodes=n, rows=np.repeat(np.arange(n, dtype=np.int32), deg),
                  cols=cols, vals=rng.standard_normal(len(cols)).astype(
                      np.float32), ell_cols=None, ell_vals=None,
                  max_degree=int(deg.max()), symmetric=False)
    return (NormalizedAdjacency(row_ptr=row_ptr, **fields),
            JAdj(**fields))


@pytest.mark.parametrize("item_edges", [8, 64])
@pytest.mark.parametrize("kind", ["symmetric", "row-normalized A",
                                  "row-normalized A^T", "nnz=0", "long row"])
def test_planned_spmm_matches_plain_and_jax(rng, kind, item_edges):
    from foodrec_tpu.ops.spmm import Propagator as JPropagator
    from foodrec_tpu_torch.ops.spmm import plan_csr, spmm_csr_plain

    adj, jadj = _matrices(kind, rng)
    x = rng.standard_normal((adj.n_nodes, 16)).astype(np.float32)
    plan = plan_csr(adj.row_ptr, item_edges=item_edges, item_rows=5,
                    items_per_block=2)
    csr = tuple(torch.from_numpy(a) for a in (adj.row_ptr, adj.cols,
                                              adj.vals))
    got = planned_spmm(*csr, plan, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, spmm_csr_plain(*csr, torch.from_numpy(x)).numpy(),
        rtol=RTOL, atol=ATOL)
    impls = ("segment", "pallas") if adj.nnz else ("segment",)
    for impl in impls:
        ref = np.asarray(JPropagator(jadj, impl=impl)(x))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"jax {impl}")


@pytest.mark.parametrize("graph", ["symmetric", "row-normalized"])
def test_bf16_kernel_impl_matches_jax_pallas(rng, graph):
    """Forward and jax.vjp: the port's kernel impl in bf16 mode (its plain
    version on the CPU: x, then g, rounded to bf16, f32 sums) against the
    JAX package's Pallas path with compute_dtype bfloat16."""
    import jax
    import jax.numpy as jnp

    from foodrec_tpu.ops.spmm import Propagator as JPropagator
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, jadj = (_adjs("hub+empty", rng) if graph == "symmetric"
                 else _row_normalized_adjs(rng))
    x = rng.standard_normal((adj.n_nodes, 16)).astype(np.float32)
    g = rng.standard_normal((adj.n_nodes, 16)).astype(np.float32)
    y_ref, vjp = jax.vjp(JPropagator(jadj, impl="pallas",
                                     compute_dtype="bfloat16"),
                         jnp.asarray(x))
    gx_ref = vjp(jnp.asarray(g))[0]
    prop = Propagator(adj, impl="kernel", compute_dtype="bfloat16",
                      device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    y = prop(xt)
    gx, = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_ref), rtol=RTOL,
                               atol=ATOL)
    # bf16 mode is not f32: the rounding shows at this bar
    y32 = Propagator(adj, impl="kernel", device="cpu")(torch.from_numpy(x))
    assert not np.allclose(y.detach().numpy(), y32.numpy(), rtol=RTOL,
                           atol=ATOL)


@pytest.mark.parametrize("impl", ["segment", "ell"])
@pytest.mark.parametrize("kind", ["random", "ring"])
def test_bf16_plain_impls_match_jax(rng, impl, kind):
    from foodrec_tpu.ops.spmm import Propagator as JPropagator
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, jadj = _adjs(kind, rng)
    x = rng.standard_normal((adj.n_nodes, 32)).astype(np.float32)
    ref = np.asarray(JPropagator(jadj, impl=impl, compute_dtype="bfloat16")(x))
    prop = Propagator(adj, impl=impl, compute_dtype="bfloat16", device="cpu")
    assert prop.impl == impl
    got = prop(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=BF16_TOL, atol=BF16_TOL)


def test_plan_buffers_follow_the_propagator(rng):
    """The kernel impl keeps its plan tables as non-persistent int32
    buffers, and A^T's own plan only for a graph that is not symmetric."""
    from foodrec_tpu_torch.ops.spmm import Propagator

    sym, _ = _adjs("hub+empty", rng)
    nonsym, _ = _row_normalized_adjs(rng)
    for adj in (sym, nonsym):
        prop = Propagator(adj, impl="kernel", device="cpu")
        assert prop.plan_table.dtype == torch.int32
        assert "plan_table" not in prop.state_dict()
        assert hasattr(prop, "t_plan_table") == (not adj.symmetric)
        for transpose in (False, True):
            row_ptr, cols, vals, plan = prop.csr(transpose=transpose)
            assert plan.table is (prop.t_plan_table
                                  if transpose and not adj.symmetric
                                  else prop.plan_table)
            assert (plan.n_rows, plan.nnz) == (row_ptr.numel() - 1,
                                               cols.numel())


def levels_edges(rng, n_items=600, n_levels=4, n_users=50):
    """SCHGN's pattern at the size of a plan test (src, dst, n): items ->
    users and calorie levels -> items, every item at one of 4 levels, so
    A^T's level rows hold ~150 edges each."""
    items = rng.integers(0, n_items, 400)
    src = np.concatenate([items + n_users,
                          rng.integers(0, n_levels, n_items)
                          + n_users + n_items])
    dst = np.concatenate([rng.integers(0, n_users, 400),
                          np.arange(n_items) + n_users])
    return src, dst, n_users + n_items + n_levels


def test_plan_cuts_the_calorie_rows_of_schgn_a_t(rng):
    """SCHGN's graph (gcn_conv_adjacency): A's rows, the targets, are short,
    and A^T's calorie-level rows exceed ITEM_EDGES, so the backward's plan
    cuts exactly those rows and the fix-up adds them. The plans executed in
    plain torch, with the values rounded to float32 as on the card, equal
    `segment`: forward on A, and the gradient (A^T g) on A^T; the kernel
    impl's autograd (its plain version on the CPU) equals it too."""
    from foodrec_tpu_torch.ops.graph import gcn_conv_adjacency
    from foodrec_tpu_torch.ops.spmm import ITEM_EDGES, Propagator

    src, dst, n = levels_edges(rng)
    adj = gcn_conv_adjacency(src, dst, n)
    prop = Propagator(adj, impl="kernel", device="cpu")
    segment = Propagator(adj, impl="segment", device="cpu")
    t_deg = np.diff(prop.t_row_ptr.numpy())
    assert prop.plan.n_fix == 0 and adj.max_degree <= ITEM_EDGES
    np.testing.assert_array_equal(prop.t_plan.fix_row, np.arange(n - 4, n))
    assert (t_deg[n - 4:] > ITEM_EDGES).all()

    x = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    xx = x.clone().requires_grad_(True)
    y_ref = segment(xx)
    gx_ref, = torch.autograd.grad(y_ref, xx, g)
    for transpose, inp, want in ((False, x, y_ref.detach()), (True, g, gx_ref)):
        row_ptr, cols, vals, plan = prop.csr(transpose=transpose)
        got = planned_spmm(row_ptr, cols, vals.float(), plan, inp)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"A^T={transpose}")
    xx = x.clone().requires_grad_(True)
    gx, = torch.autograd.grad(prop(xx), xx, g)
    np.testing.assert_allclose(gx.numpy(), gx_ref.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["ell", "segment", "kernel"])
def test_propagator_keeps_the_values_dtype(rng, impl):
    """On the CPU the value buffers keep the adjacency's dtype: a float32
    graph's bitwise as before; a float64 graph (gcn_conv_adjacency) stays
    float64, so a module cast to float64 multiplies by the unrounded values,
    and a float32 product rounds them once."""
    import scipy.sparse as sp

    from foodrec_tpu_torch.ops.graph import gcn_conv_adjacency
    from foodrec_tpu_torch.ops.spmm import Propagator

    sym, _ = _adjs("random", rng)
    prop = Propagator(sym, impl=impl, device="cpu")
    names = ("ell_vals",) if impl == "ell" else ("vals",)
    for name in names:
        got = getattr(prop, name).numpy()
        want = sym.ell_vals if impl == "ell" else sym.vals
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))

    adj = gcn_conv_adjacency(*levels_edges(rng))
    prop = Propagator(adj, impl=impl, device="cpu")
    vals = (prop.ell_vals,) if impl == "ell" else (prop.vals,) + (
        (prop.t_vals,) if impl == "kernel" else ())
    assert all(v.dtype == torch.float64 for v in vals)
    a = sp.csr_matrix((adj.vals, (adj.rows, adj.cols)),
                      shape=(adj.n_nodes, adj.n_nodes))
    x = rng.standard_normal((adj.n_nodes, 8))
    y64 = prop.to(torch.float64)(torch.from_numpy(x))
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(y64.numpy(), a @ x, rtol=1e-12, atol=1e-14)
    y32 = prop(torch.from_numpy(x.astype(np.float32)))
    a32 = a.astype(np.float32)
    assert y32.dtype == torch.float32
    np.testing.assert_allclose(y32.numpy(), a32 @ x.astype(np.float32),
                               rtol=RTOL, atol=ATOL)
