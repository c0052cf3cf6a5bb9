"""PyTorch port, `gather_rows` (foodrec_tpu_torch/ops/gather.py): a row
gather whose backward on the card is the hand-written kernel of
csrc/gather_rows_bwd.cu and on the CPU the plain version.

On the CPU: the plain backward equals autograd's gradient of table[idx] in
float64 within 1e-12 (one id 20,000 times, all ids distinct, no ids, a
[512, 20] SCHGN batch with 82% pad slots, a [1024, 20] CIKM batch);
`gather_rows` matches table[idx] forward and backward; out-of-range ids and
a non-contiguous table raise; two runs give the same bits; a shared
`RowIds` gives the gradients of separate gathers; the sorted order is the
stable one; a numpy emulation of the kernel's two passes (tiles of 32
sorted positions, the parts of longer runs combined by 16 half-warps and a
tree) writes every row once and equals the plain version; and one training
step of CIKM_Model and of SCHGN takes 2 and 7 gather backwards.

Marked `cuda`, on the card (`python3 -m pytest -m cuda
tests/test_torch_port_gather.py -q`):
the kernel against the plain version at the main path's shapes within
1e-6 * max|g| * sqrt(run), bit for bit against the emulation, the same bits
on two runs, no host sync under `set_sync_debug_mode("error")`, and the
launches a training step of each model counts."""

import os

import numpy as np
import pytest
import torch

from foodrec_tpu_torch.ops import _kernels, gather
from foodrec_tpu_torch.ops.gather import (
    RowIds,
    gather_rows,
    gather_rows_backward_plain,
)
from torch_port_fixtures import cuda_device  # noqa: F401

D = 64
N_INGRE = 4963             # Foodcom's ingredients; the pad id is N_INGRE
N_ROWS = N_INGRE + 2       # SCHGN's [ingredients; pad; mask token]
N_ITEMS = 29943
# the emulation's constants: gather_rows_bwd.cu's kTile, kSlices, kChunk
TILE, SLICES, CHUNK = _kernels.GATHER_TILE, 16, 1024


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ingredient_codes(rng, b, pad_id=N_INGRE, slots=20):
    """[b, slots] codes as the synthetic data holds them: 1-6 real
    ingredients a recipe, the other slots the pad id (~82% of them)."""
    codes = np.full((b, slots), pad_id, np.int64)
    for i, k in enumerate(rng.integers(1, 7, b)):
        codes[i, :k] = rng.choice(pad_id, size=k, replace=False)
    return codes


def case_ids(name, rng):
    """(ids, n_rows) of a named case."""
    if name == "one id 20000 times":
        return np.full(20000, 7, np.int64), 50
    if name == "all distinct":
        return rng.permutation(3000)[:2500].astype(np.int64), 3000
    if name == "no ids":
        return np.zeros((0, 20), np.int64), 40
    if name == "schgn [512, 20], 82% pad":
        return ingredient_codes(rng, 512), N_ROWS
    if name == "cikm [1024, 20]":
        return ingredient_codes(rng, 1024), N_INGRE + 1
    if name == "items [512]":
        return rng.integers(0, N_ITEMS, 512), N_ITEMS
    raise KeyError(name)


CPU_CASES = ["one id 20000 times", "all distinct", "no ids",
             "schgn [512, 20], 82% pad", "cikm [1024, 20]"]


@pytest.mark.parametrize("name", CPU_CASES)
def test_plain_backward_is_autograds_gradient(name):
    rng = np.random.default_rng(CPU_CASES.index(name))
    ids, n_rows = case_ids(name, rng)
    ids = torch.from_numpy(ids)
    table = torch.randn(n_rows, D, dtype=torch.float64, requires_grad=True)
    g = torch.randn(*ids.shape, D, dtype=torch.float64)
    want, = torch.autograd.grad(table[ids], table, g)
    got = gather_rows_backward_plain(g, ids, n_rows)
    assert got.shape == want.shape and got.dtype == torch.float64
    scale = float(want.abs().max()) if want.numel() else 1.0
    assert float((got - want).abs().max()) <= 1e-12 * max(scale, 1.0)


@pytest.mark.parametrize("name", CPU_CASES)
def test_gather_rows_matches_index_forward_and_backward(name):
    rng = np.random.default_rng(10 + CPU_CASES.index(name))
    ids, n_rows = case_ids(name, rng)
    ids = torch.from_numpy(ids)
    table = torch.randn(n_rows, D, dtype=torch.float64, requires_grad=True)
    g = torch.randn(*ids.shape, D, dtype=torch.float64)
    rows = gather_rows(table, ids)
    assert torch.equal(rows, table[ids])
    got, = torch.autograd.grad(rows, table, g)
    want, = torch.autograd.grad(table[ids], table, g)
    scale = float(want.abs().max()) if want.numel() else 1.0
    assert float((got - want).abs().max()) <= 1e-12 * max(scale, 1.0)
    with torch.no_grad():  # no gradient to take: the gather alone
        assert torch.equal(gather_rows(table, ids), table[ids].detach())


@pytest.mark.parametrize("bad", [10, 11, -1])
def test_out_of_range_ids_raise(bad):
    table = torch.randn(10, D, requires_grad=True)
    ids = torch.tensor([[0, 3], [bad, 9]])
    with pytest.raises((IndexError, RuntimeError)):
        gather_rows(table, ids)
    with pytest.raises((IndexError, RuntimeError)), torch.no_grad():
        gather_rows(table, ids)


def test_non_contiguous_or_non_2d_table_raises():
    base = torch.randn(D, 10, requires_grad=True)
    ids = torch.tensor([1, 2, 2])
    with pytest.raises(ValueError):
        gather_rows(base.T, ids)
    with pytest.raises(ValueError):
        gather_rows(torch.randn(10, 4, D), ids)


def test_two_runs_give_the_same_bits():
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(ingredient_codes(rng, 512))
    g = torch.randn(512, 20, D)
    grads = []
    for _ in range(2):
        table = torch.randn(N_ROWS, D, generator=torch.Generator()
                            .manual_seed(0)).requires_grad_(True)
        grads.append(torch.autograd.grad(gather_rows(table, ids), table,
                                         g)[0])
    assert torch.equal(grads[0].view(torch.int32), grads[1].view(torch.int32))


def test_shared_row_ids_give_the_gradients_of_separate_gathers():
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(ingredient_codes(rng, 64))
    t1 = torch.randn(N_ROWS, D, dtype=torch.float64, requires_grad=True)
    t2 = torch.randn(N_ROWS, D, dtype=torch.float64, requires_grad=True)
    g1, g2 = torch.randn(2, 64, 20, D, dtype=torch.float64)

    def grads(a, b):
        loss = (gather_rows(t1, a) * g1).sum() + (gather_rows(t2, b) * g2).sum()
        return torch.autograd.grad(loss, (t1, t2))

    shared = RowIds(ids)
    for got, want in zip(grads(shared, shared), grads(ids, ids.clone())):
        assert torch.equal(got, want)


def test_plan_is_the_stable_sorted_order_made_once():
    rng = np.random.default_rng(5)
    ids = ingredient_codes(rng, 100)
    rid = RowIds(torch.from_numpy(ids))
    sid, order = rid.plan()
    assert rid.plan()[0] is sid and rid.plan()[1] is order
    assert sid.dtype == torch.int32 and order.dtype == torch.int64
    want = np.argsort(ids.reshape(-1), kind="stable")
    assert np.array_equal(order.numpy(), want)
    assert np.array_equal(sid.numpy(), ids.reshape(-1)[want])


# ------------------------------------------------ the kernel's two passes


def emulate_kernel(g, sid, order, n_rows):
    """gather_rows_bwd.cu's two passes in numpy, float32 adds in the
    kernel's order: (out, writes of each row, row_ptr, writes of each
    row_ptr entry)."""
    n, d = g.shape
    out = np.full((n_rows, d), np.nan, np.float32)
    writes = np.zeros(n_rows, np.int64)
    n_tiles = -(-n // TILE)
    parts = np.full((2 * n_tiles, d), np.nan, np.float32)
    row_ptr = np.full(n_rows + 1, -1, np.int64)
    ptr_writes = np.zeros(n_rows + 1, np.int64)
    zero = np.zeros(d, np.float32)
    for t in range(n_tiles):
        t0 = t * TILE
        ln = min(TILE, n - t0)
        ids, pos = sid[t0:t0 + ln], order[t0:t0 + ln]
        has_prev, has_next = t0 > 0, t0 + ln < n
        prev = sid[t0 - 1] if has_prev else 0
        nxt = sid[t0 + ln] if has_next else 0
        for k in range(ln):
            v = ids[k]
            first = ids[k - 1] != v if k else (not has_prev or prev != v)
            if first:
                u = ids[k - 1] if k else (prev if has_prev else -1)
                r = np.arange(max(u + 1, 0), min(v, n_rows) + 1)
                row_ptr[r] = t0 + k
                ptr_writes[r] += 1
        if not has_next:
            r = np.arange(max(ids[-1] + 1, 0), n_rows + 1)
            row_ptr[r] = n
            ptr_writes[r] += 1
        acc, a = zero, 0
        for k in range(ln):
            acc = acc + g[pos[k]]
            v = ids[k]
            if k + 1 < ln and ids[k + 1] == v:
                continue
            from_prev = a == 0 and has_prev and prev == v
            to_next = k + 1 == ln and has_next and nxt == v
            if not from_prev and not to_next:
                if 0 <= v < n_rows:
                    out[v] = acc
                    writes[v] += 1
            else:
                if a == 0:
                    parts[2 * t] = acc
                if k + 1 == ln:
                    parts[2 * t + 1] = acc
            acc, a = zero, k + 1
    for r in range(n_rows):
        s, e = row_ptr[r], row_ptr[r + 1]
        if e <= s:
            out[r] = zero
            writes[r] += 1
            continue
        first, last = s // TILE, (e - 1) // TILE
        if first == last:
            continue
        n_parts, total = last - first + 1, zero
        for c0 in range(0, n_parts, CHUNK):
            sums = []
            for h in range(SLICES):
                acc = zero
                for j in range(c0 + h, min(n_parts, c0 + CHUNK), SLICES):
                    acc = acc + parts[2 * first + 1 if j == 0
                                      else 2 * (first + j)]
                sums.append(acc)
            w = SLICES // 2
            while w:
                for h in range(w):
                    sums[h] = sums[h] + sums[h + w]
                w //= 2
            total = total + sums[0]
        out[r] = total
        writes[r] += 1
    return out, writes, row_ptr, ptr_writes


def _bar(g2, ids, n_rows):
    """1e-6 * max|g| * sqrt(run) a row, run its id's count."""
    count = np.bincount(ids[(ids >= 0) & (ids < n_rows)], minlength=n_rows)
    return 1e-6 * float(np.abs(g2).max()) * np.sqrt(np.maximum(count, 1))


EMULATED = {
    "tile-aligned runs": (np.repeat(np.arange(0, 40, 2), 32), 45),
    "runs across 2 and 3 tiles": (np.repeat([1, 3, 4, 9], [40, 70, 5, 33]),
                                  12),
    "one id 40,000 times (two chunks)": (np.full(40000, 2), 3),
    "short tail tile, empty rows at both ends": (
        np.repeat([5, 6, 8], [31, 2, 13]), 20),
    "ids past the table": (np.array([0, 1, 1, 7, 7, 9, 9, 9]), 6),
}


@pytest.mark.parametrize("name", sorted(EMULATED) + [
    "schgn [512, 20], 82% pad", "one id 20000 times", "all distinct"])
def test_emulated_kernel_writes_every_row_once_and_equals_plain(name):
    rng = np.random.default_rng(len(name))
    if name in EMULATED:
        ids, n_rows = EMULATED[name]
    else:
        ids, n_rows = case_ids(name, rng)
    flat = np.asarray(ids, np.int64).reshape(-1)
    rng.shuffle(flat)
    g = rng.standard_normal((flat.size, 8)).astype(np.float32)
    order = np.argsort(flat, kind="stable")
    out, writes, row_ptr, ptr_writes = emulate_kernel(
        g, flat[order].astype(np.int32), order, n_rows)
    assert (writes == 1).all() and (ptr_writes == 1).all()
    assert np.array_equal(row_ptr, np.searchsorted(np.sort(flat),
                                                   np.arange(n_rows + 1)))
    keep = (flat >= 0) & (flat < n_rows)
    want = gather_rows_backward_plain(
        torch.from_numpy(g[keep]).double(), torch.from_numpy(flat[keep]),
        n_rows).numpy()
    assert (np.abs(out - want) <= _bar(g, flat, n_rows)[:, None]).all()


# -------------------------------------------------- routing in the models

TOY = dict(n_users=60, n_items=200, n_ingredients=40, n_cal_levels=4,
           n_health_levels=6, n_clusters=5, img_dim=32, txt_dim=16,
           neg_num=30, train_per_user=(5, 9), valid_per_user=(1, 3),
           test_per_user=(2, 4), seed=7)
# gather backwards a training step: CIKM's encoder and reg gathers (one
# sorted order); SCHGN's two scores, three SSL and two reg gathers
STEP_GATHERS = {"cikm-foodcom-train": 2, "schgn-foodcom-train": 7}


def _toy_step(cell_name, device, cache):
    """One Trainer step of the benchmark cell's model at the toy size on
    `device`."""
    from portbench import harness
    from portbench.reference import plain
    from portbench.traffic import train_draws
    from foodrec_tpu_torch.engine.trainer import Trainer

    saved, harness.CACHE = harness.CACHE, cache
    try:
        cell = harness.Cell(cell_name)
        cell.config["data"]["params"] = dict(TOY)
        cell.config["model_config"].update(train_batch_size=24)
        ctx = harness.Context(cell, 2 ** 31 + 5, device)
    finally:
        harness.CACHE = saved
    train_draws._shapes(ctx)
    cfg, _, model = ctx.build_program(ctx.weights())
    data = plain.load_dataset(os.path.join(ctx.data_root, "Foodcom"))
    rng = np.random.default_rng(0)
    rows = rng.choice(len(data["train_u"]), 24, replace=False)
    batch = tuple(torch.from_numpy(a).to(device) for a in (
        data["train_u"][rows], data["train_i"][rows],
        rng.integers(0, data["n_items"], 24)))
    trainer = Trainer(cfg, model)
    return lambda: trainer.train_steps([batch])


@pytest.mark.parametrize("cell", sorted(STEP_GATHERS))
def test_training_step_takes_the_gather_backwards(cell, tmp_path,
                                                  monkeypatch):
    step = _toy_step(cell, "cpu", str(tmp_path))
    calls = []
    plain = gather.gather_rows_backward_plain

    def counted(g, ids, n_rows):
        calls.append(tuple(ids.shape))
        return plain(g, ids, n_rows)

    monkeypatch.setattr(gather, "gather_rows_backward_plain", counted)
    step()
    assert len(calls) == STEP_GATHERS[cell], calls
    assert all(shape[-1] == 20 for shape in calls)


# ------------------------------------------------------------ on the card


CARD_CASES = ["schgn [512, 20], 82% pad", "cikm [1024, 20]", "items [512]",
              "one id 20000 times"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_kernel_matches_plain_and_repeats_on_the_card(name, cuda_device):
    rng = np.random.default_rng(20 + CARD_CASES.index(name))
    ids, n_rows = case_ids(name, rng)
    ids_t = torch.from_numpy(ids).to(cuda_device)
    g = torch.randn(*ids.shape, D, device=cuda_device)
    table = torch.randn(n_rows, D, device=cuda_device, requires_grad=True)
    _kernels.load_all()
    before = _kernels.launches["gather_rows_bwd"]
    assert torch.equal(gather_rows(table, ids_t), table[ids_t])
    # the sort, the gather and the backward, each run with its own plan
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [torch.autograd.grad(gather_rows(table, RowIds(ids_t)), table,
                                    g)[0] for _ in "12"]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _kernels.launches["gather_rows_bwd"] - before == 2
    assert torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))
    want = gather_rows_backward_plain(g.double(), ids_t, n_rows)
    bar = torch.from_numpy(_bar(g.cpu().numpy(), ids.reshape(-1), n_rows))
    err = (runs[0].double() - want).abs().cpu()
    assert (err <= bar[:, None]).all(), float(err.max())
    if ids.size <= 20480:  # the emulation's Python loops stay short
        flat = ids.reshape(-1)
        order = np.argsort(flat, kind="stable")
        emu = emulate_kernel(g.reshape(-1, D).cpu().numpy(),
                             flat[order].astype(np.int32), order, n_rows)[0]
        assert np.array_equal(runs[0].cpu().numpy().view(np.int32),
                              emu.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(STEP_GATHERS))
def test_training_step_launches_on_the_card(cell, cuda_device, tmp_path):
    step = _toy_step(cell, cuda_device, str(tmp_path))
    step()  # first step: builds the kernel
    before = _kernels.launches["gather_rows_bwd"]
    step()
    torch.cuda.synchronize()
    assert _kernels.launches["gather_rows_bwd"] - before == STEP_GATHERS[cell]


@pytest.mark.cuda
def test_kernel_refuses_another_tile_size(cuda_device):
    """The scratch is sized in Python by GATHER_TILE; a launch that names
    another tile size than the kernel's is refused, and writes nothing."""
    n, n_rows = 100, 10
    g = torch.randn(n, D, device=cuda_device)
    sid, order = torch.sort(torch.randint(0, n_rows, (n,), device=cuda_device,
                                          dtype=torch.int32), stable=True)
    out = torch.full((n_rows, D), 7.0, device=cuda_device)
    scratch = torch.empty(2 * n * D + n_rows + 1, dtype=torch.int32,
                          device=cuda_device)
    fn = _kernels._entry("gather_rows_bwd")
    err = fn(g.data_ptr(), sid.data_ptr(), order.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), n, n_rows, D, 4, _kernels.GATHER_TILE // 2,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err != 0
    assert (out == 7.0).all()
