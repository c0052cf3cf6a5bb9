"""PyTorch port, SpMM: the port's plain versions (`ell`, `segment`, and the
CSR kernel's CPU path) against the JAX package's `segment` and Pallas
(interpret mode) impls on the same graphs and inputs, rtol 1e-5 / atol 1e-6
(float32 sums taken in other orders).

The `kernel` impl against the plain versions runs on the CPU and, marked
`cuda`, on the card, where it launches the CUDA kernel: its gradient
against `segment` autograd, and on irregular graphs (a hub row, empty rows,
an odd n, no edges at all, widths 16, 64 and 96, a row-normalized and a
symmetric graph with a hub, a power-law user-item graph and a CLUSSL
item-cluster graph at Foodcom's size) its forward and A^T backward, in
float32 and in bf16 mode, against the plain CSR version in float64 within
the kernel's bar 1e-5 * max|y| + 1e-6 (bench.py:106), the same bits on two
runs."""

import numpy as np
import pytest
import torch

from foodrec_tpu_torch.ops.graph import (
    NormalizedAdjacency,
    bipartite_offset_edges,
    row_normalized_adjacency,
    sym_normalized_adjacency,
    transpose_adjacency,
)
from torch_port_fixtures import device  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _graph(kind, rng):
    """(rows, cols, n): random edges, a hub row above ELL_DEGREE_CAP plus
    empty rows, or a bounded-degree ring."""
    if kind == "random":
        n = 61
        return rng.integers(0, n, 150), rng.integers(0, n, 150), n
    if kind == "hub+empty":
        n = 300
        rows = np.concatenate([np.zeros(200, np.int64),
                               rng.integers(1, 150, 100)])
        cols = np.concatenate([rng.choice(np.arange(1, 250), 200,
                                          replace=False),
                               rng.integers(1, 150, 100)])
        return rows, cols, n  # nodes 250..299 have no edges
    n = 40
    return np.arange(n), (np.arange(n) + 1) % n, n


def _adjs(kind, rng):
    from foodrec_tpu.ops.graph import sym_normalized_adjacency as jsym

    rows, cols, n = _graph(kind, rng)
    return sym_normalized_adjacency(rows, cols, n), jsym(rows, cols, n)


def _port_adj(graph, rng):
    """The port's adjacency of `_adjs("random")` (symmetric) or of
    `_row_normalized_adjs` (row-normalized), the same draws, built without
    the JAX package."""
    if graph == "symmetric":
        return sym_normalized_adjacency(*_graph("random", rng))
    return row_normalized_adjacency(*_graph("hub+empty", rng))


@pytest.mark.parametrize("kind", ["random", "hub+empty"])
@pytest.mark.parametrize("d", [16, 64])
def test_port_impls_match_jax_segment_and_pallas(rng, kind, d):
    from foodrec_tpu.ops.graph import ELL_DEGREE_CAP
    from foodrec_tpu.ops.spmm import Propagator as JPropagator
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, jadj = _adjs(kind, rng)
    if kind == "hub+empty":
        deg = np.diff(adj.row_ptr)
        assert deg.max() > ELL_DEGREE_CAP and (deg == 0).any()
    x = rng.standard_normal((adj.n_nodes, d)).astype(np.float32)
    refs = {impl: np.asarray(JPropagator(jadj, impl=impl)(x))
            for impl in ("segment", "pallas")}
    xt = torch.from_numpy(x)
    for impl in ("ell", "segment", "kernel"):
        prop = Propagator(adj, impl=impl, device="cpu")
        got = prop(xt).numpy()
        for name, ref in refs.items():
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"port {impl} vs jax {name}")


def test_propagate_mean_matches_jax(rng):
    from foodrec_tpu.ops.spmm import Propagator as JPropagator
    from foodrec_tpu.ops.spmm import propagate_mean as jmean
    from foodrec_tpu_torch.ops.spmm import Propagator, propagate_mean

    adj, jadj = _adjs("random", rng)
    x = rng.standard_normal((adj.n_nodes, 32)).astype(np.float32)
    want = np.asarray(jmean(JPropagator(jadj, impl="segment"), x, 3))
    for impl in ("segment", "kernel"):
        got = propagate_mean(Propagator(adj, impl=impl, device="cpu"),
                             torch.from_numpy(x), 3).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_auto_rule(rng):
    from foodrec_tpu_torch.ops.spmm import Propagator, select_impl

    ring, _ = _adjs("ring", rng)
    hub, _ = _adjs("hub+empty", rng)
    loose, _ = _adjs("random", rng)
    assert Propagator(ring, device="cpu").impl == "ell"
    assert Propagator(hub, device="cpu").impl == "segment"
    assert Propagator(loose, device="cpu").impl == "segment"
    # on the card, graphs that fail the ELL padding test take the kernel
    assert select_impl(hub, "auto", "cuda") == "kernel"
    assert select_impl(loose, "auto", "cuda") == "kernel"
    assert select_impl(ring, "auto", "cuda") == "ell"
    assert select_impl(hub, "ell", "cpu") == "segment"  # no ELL table
    # the JAX package's name for its SpMM kernel is the kernel here
    assert select_impl(ring, "pallas", "cpu") == "kernel"
    with pytest.raises(ValueError):
        select_impl(ring, "mystery", "cpu")


def test_unported_options_raise(rng):
    """spmm_dtype bfloat16 is ported (every impl builds and computes in it;
    its parity with the JAX package is in test_torch_port_spmm_plan.py);
    dtypes the JAX package does not have raise instead of running in f32."""
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, _ = _adjs("random", rng)
    x = torch.from_numpy(rng.standard_normal((adj.n_nodes, 8)).astype(
        np.float32))
    for impl in ("ell", "segment", "kernel"):
        prop = Propagator(adj, impl=impl, compute_dtype="bfloat16",
                          device="cpu")
        assert prop.bf16
        y = prop(x)
        assert y.dtype == torch.float32 and torch.isfinite(y).all()
    assert not Propagator(adj, compute_dtype="float32", device="cpu").bf16
    for dtype in ("float16", "bf16", "float64"):
        with pytest.raises(ValueError, match="spmm_dtype"):
            Propagator(adj, compute_dtype=dtype, device="cpu")


def _row_normalized_adjs(rng):
    """A graph that is not symmetric: the JAX package's row-normalized
    adjacency, and the same arrays as the port's NormalizedAdjacency."""
    from foodrec_tpu.ops.graph import row_normalized_adjacency as jrow

    rows, cols, n = _graph("hub+empty", rng)
    jadj = jrow(rows, cols, n)
    assert not jadj.symmetric
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(jadj.rows, minlength=n))]).astype(np.int32)
    adj = NormalizedAdjacency(
        n_nodes=n, rows=jadj.rows, cols=jadj.cols, vals=jadj.vals,
        row_ptr=row_ptr, ell_cols=jadj.ell_cols, ell_vals=jadj.ell_vals,
        max_degree=jadj.max_degree, symmetric=False)
    return adj, jadj


def _cotangent(kind, y):
    """A loss of y whose gradient reaches the SpMM as the layouts the model
    gives it: an expanded ones tensor (`sum`), rows of zeros from a slice
    (`slice`), or a dense tensor (`weighted`)."""
    if kind == "sum":
        return y.sum()
    if kind == "slice":
        return y[: y.shape[0] // 3].sum()
    w = torch.linspace(-1.0, 1.0, y.numel(), dtype=y.dtype,
                       device=y.device).reshape(y.shape)
    return (y * w).sum()


@pytest.mark.parametrize("graph", ["symmetric", "row-normalized"])
@pytest.mark.parametrize("kind", ["sum", "slice", "weighted"])
def test_port_gradients_match_jax_custom_vjp(rng, graph, kind):
    """d/dx of the port's `kernel` (SpmmCSR, its plain version on the CPU),
    `segment` and `ell` against jax.vjp through the JAX package's custom VJP
    (segment, and Pallas in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from foodrec_tpu.ops.spmm import Propagator as JPropagator
    from foodrec_tpu_torch.ops.spmm import Propagator

    adj, jadj = (_adjs("hub+empty", rng) if graph == "symmetric"
                 else _row_normalized_adjs(rng))
    d = 16
    x = rng.standard_normal((adj.n_nodes, d)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    # the cotangent of the loss with respect to y, fed to jax.vjp
    y0 = torch.zeros((adj.n_nodes, d), requires_grad=True)
    g, = torch.autograd.grad(_cotangent(kind, y0), y0)
    refs = {}
    for impl in ("segment", "pallas"):
        _, vjp = jax.vjp(JPropagator(jadj, impl=impl), jnp.asarray(x))
        refs[impl] = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    for impl in ("kernel", "segment", "ell"):
        y = Propagator(adj, impl=impl, device="cpu")(xt)
        got, = torch.autograd.grad(_cotangent(kind, y), xt)
        for name, ref in refs.items():
            np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"port {impl} vs jax {name}")


@pytest.mark.parametrize("graph", ["symmetric", "row-normalized"])
def test_kernel_impl_gradient_equals_segment(rng, graph, device):
    """SpmmCSR's backward runs the kernel on A^T (its plain version for a
    CPU tensor): its gradient is segment autograd's, through
    propagate_mean's three hops, and the adjacency gets none. A
    non-symmetric graph holds A^T's own CSR tables; a symmetric one reuses
    A's."""
    from foodrec_tpu_torch.ops.spmm import Propagator, propagate_mean

    adj = _port_adj(graph, rng)
    x = rng.standard_normal((adj.n_nodes, 8)).astype(np.float32)
    grads = {}
    for impl in ("kernel", "segment"):
        prop = Propagator(adj, impl=impl, device=device)
        xt = torch.from_numpy(x).to(device).requires_grad_(True)
        y = propagate_mean(prop, xt, 3)
        grads[impl], = torch.autograd.grad(_cotangent("weighted", y), xt)
        assert not any(b.requires_grad for b in prop.buffers())
    np.testing.assert_allclose(grads["kernel"].cpu().numpy(),
                               grads["segment"].cpu().numpy(), rtol=RTOL,
                               atol=ATOL)
    kernel = Propagator(adj, impl="kernel", device=device)
    assert hasattr(kernel, "t_row_ptr") == (graph != "symmetric")


def _random_adjacency(rng, n, avg_degree=8, empty_frac=0.2, hub_degree=0):
    """A graph that is not symmetric: Poisson degrees, a share of the rows
    empty, a hub row at n // 2, uniform columns, N(0, 1) values."""
    deg = rng.poisson(avg_degree, n)
    deg[rng.random(n) < empty_frac] = 0
    if hub_degree:
        deg[n // 2] = hub_degree
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return NormalizedAdjacency(
        n_nodes=n, rows=np.repeat(np.arange(n, dtype=np.int32), deg),
        cols=rng.integers(0, n, row_ptr[-1]).astype(np.int32),
        vals=rng.standard_normal(row_ptr[-1]).astype(np.float32),
        row_ptr=row_ptr, ell_cols=None, ell_vals=None,
        max_degree=int(deg.max()), symmetric=False)


def _with_hub(rng, n, n_edges, hub):
    """Uniform random edges plus node 0 joined to `hub` others."""
    rows = np.concatenate([rng.integers(0, n, n_edges), np.zeros(hub, int)])
    cols = np.concatenate([rng.integers(0, n, n_edges),
                           rng.choice(np.arange(1, n), hub, replace=False)])
    return rows, cols, n


def _power_law(rng, n_users, n_items, n_edges):
    """A user-item graph, symmetric-normalized: uniform users, Zipf-0.8 item
    popularity (the JAX package's microbench graph,
    tools/spmm_microbench.py:23-34)."""
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    u = rng.integers(0, n_users, n_edges)
    i = rng.choice(n_items, size=n_edges, p=pop / pop.sum()) + n_users
    return sym_normalized_adjacency(u, i, n_users + n_items)


def _item_clusters(rng, n_items, n_clusters, per_item):
    """A CLUSSL item-cluster graph (pricai_modelx.py:63-78): `per_item`
    uniform clusters an item, symmetric-normalized."""
    triples = np.stack([np.repeat(np.arange(n_items), per_item),
                        rng.integers(0, n_clusters, n_items * per_item)], 1)
    rows, cols = bipartite_offset_edges(triples, offset_tail=n_items)
    return sym_normalized_adjacency(rows, cols, n_items + n_clusters)


# name -> (width, adjacency from an rng)
IRREGULAR = {
    "hub+empty d64": (64, lambda rng: _random_adjacency(rng, 10_001,
                                                        hub_degree=6000)),
    "hub+empty d16": (16, lambda rng: _random_adjacency(rng, 10_001,
                                                        hub_degree=6000)),
    "odd n d96": (96, lambda rng: _random_adjacency(rng, 4_097,
                                                    hub_degree=700)),
    "nnz=0 d64": (64, lambda rng: _random_adjacency(rng, 1_000,
                                                    avg_degree=0)),
    "empty stretch d64": (64, lambda rng: _random_adjacency(
        rng, 3_001, avg_degree=3, empty_frac=0.9)),
    "row-normalized hub d64": (64, lambda rng: row_normalized_adjacency(
        *_with_hub(rng, 8_191, 30_000, 3_000))),
    "symmetric hub d64": (64, lambda rng: sym_normalized_adjacency(
        *_with_hub(rng, 12_289, 60_000, 5_000))),
    # Foodcom's users and items, ~192k interactions (bench.py:27-32)
    "power-law foodcom d64": (64, lambda rng: _power_law(rng, 7596, 29943,
                                                         192_000)),
    # Foodcom's items and 2,000 clusters, 6 an item as upstream k-means
    "clussl clusters d64": (64, lambda rng: _item_clusters(rng, 29943, 2000,
                                                           6)),
    # the same at the benchmark's 2 an item (portbench/data/synthetic.py)
    "clussl clusters degree 2 d64": (64, lambda rng: _item_clusters(
        rng, 29943, 2000, 2)),
}


def _plain64(adj, x):
    """A @ x by the plain CSR version in float64 on the CPU."""
    from foodrec_tpu_torch.ops.spmm import spmm_csr_plain

    return spmm_csr_plain(torch.from_numpy(adj.row_ptr),
                          torch.from_numpy(adj.cols),
                          torch.from_numpy(adj.vals).double(),
                          x.detach().cpu().double())


@pytest.mark.parametrize("graph", IRREGULAR)
def test_kernel_impl_equals_plain_on_irregular_graphs(graph, device):
    """The kernel impl's forward (A @ x) and its gradient (A^T @ g, A^T's
    own tables where A is not symmetric), in float32 and in bf16 mode
    (x, and g, rounded to bf16 as the plain version's input), within the
    kernel's bar of the plain CSR version in float64; two runs give the
    same bits."""
    from foodrec_tpu_torch.ops.spmm import Propagator

    rng = np.random.default_rng(list(IRREGULAR).index(graph))
    d, build = IRREGULAR[graph]
    adj = build(rng)
    adj_t = transpose_adjacency(adj)
    x, g = (torch.from_numpy(rng.standard_normal((adj.n_nodes, d)).astype(
        np.float32)).to(device) for _ in "xg")
    for mode in ("float32", "bfloat16"):
        prop = Propagator(adj, impl="kernel", compute_dtype=mode,
                          device=device)
        assert prop.impl == "kernel"

        def run():
            xx = x.clone().requires_grad_(True)
            y = prop(xx)
            return y.detach(), torch.autograd.grad(y, xx, g)[0]

        (y, gx), again = run(), run()
        assert all(torch.equal(a, b) for a, b in zip((y, gx), again)), mode
        rounded = (lambda t: t.bfloat16().float()) if prop.bf16 else (
            lambda t: t)
        for name, got, want in (("forward", y, _plain64(adj, rounded(x))),
                                ("gradient", gx,
                                 _plain64(adj_t, rounded(g)))):
            err = float((got.cpu().double() - want).abs().max())
            bar = 1e-5 * float(want.abs().max()) + 1e-6
            assert err <= bar, (mode, name, err, bar)


def test_kernel_wrapper_raises_without_cuda(rng, monkeypatch, tmp_path):
    """The kernel module imports without nvcc or CUDA; asking it for the card
    raises instead of falling back to the CPU."""
    from foodrec_tpu_torch.ops import _kernels
    from foodrec_tpu_torch.ops.spmm import Propagator, plan_csr

    adj, _ = _adjs("random", rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Propagator(adj, impl="kernel", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        _kernels._entry("spmm_csr")
    plan = plan_csr(adj.row_ptr)
    with pytest.raises(ValueError, match="CUDA device"):
        _kernels.spmm_csr(torch.from_numpy(adj.row_ptr),
                          torch.from_numpy(adj.cols),
                          torch.from_numpy(adj.vals),
                          plan.with_table(torch.from_numpy(plan.table)),
                          torch.zeros(adj.n_nodes, 8))
    # no toolkit: the build raises with a message instead of a silent fallback
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
