"""PyTorch port, the loss block replayed as CUDA graphs
(foodrec_tpu_torch/common/step_graph.py): CIKM_Model's and SCHGN's
`calculate_loss` split into an eager prelude (the propagation and every
random draw) and a block, which a single-process Trainer on the card
captures once per input signature and replays.

On the CPU: the encoders' pre-drawn masks (`transformer_encoder_masks`,
`bert_encoder_masks`) give their generator path's outputs and gradients bit
for bit and leave the generator where it leaves it; the two models'
prelude-and-block loss parts and gradients equal their generator path's
bit for bit, with and without the padded tail's weight; a Trainer on the
CPU gives its model no graphs.

Marked `cuda`, on the card (`python3 -m pytest -m cuda
tests/test_torch_port_step_graph.py -q`): one epoch of three steps (two
full batches and the tail) through `train_epoch`, plain, with the padded
tail's weight and with Mirror Gradient, gives the loss parts, the last
gradients and the parameters of the same epoch with the block run eagerly,
bit for bit, with one capture a signature; replays make no host sync under
`set_sync_debug_mode("error")`; a recorder that replaces the three draw
functions, as the benchmark's does, sees the same draws on the graphs'
steps as on the generator path's; a `load_state_dict` keeps the graphs,
and a rebound parameter drops them; a backward after a later forward of
its graph raises.
"""

import pytest
import torch

from foodrec_tpu_torch.common import module, step_graph
from foodrec_tpu_torch.common.step_graph import StepGraphs
from test_torch_port_gather import TOY
from torch_port_fixtures import cuda_device, device  # noqa: F401

CELLS = ("cikm-foodcom-train", "schgn-foodcom-train")
# three steps an epoch: two batches of BATCH and the tail
DATA = dict(TOY, n_users=200)
BATCH = 512


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _build(cell_name, device, cache, **model_config):
    """The benchmark cell's (config, model, batch) at the toy size on
    `device`, the model's weights from a fixed seed; the batch is the first
    BATCH train pairs with one negative each."""
    from portbench import harness
    from portbench.traffic import train_draws

    saved, harness.CACHE = harness.CACHE, cache
    try:
        cell = harness.Cell(cell_name)
        cell.config["data"]["params"] = dict(DATA)
        cell.config["model_config"].update(train_batch_size=BATCH,
                                           **model_config)
        ctx = harness.Context(cell, 2 ** 31 + 11, device)
    finally:
        harness.CACHE = saved
    train_draws._shapes(ctx)
    cfg, _, model = ctx.build_program(ctx.weights())
    dd = model.dd
    gen = torch.Generator().manual_seed(3)
    b = min(BATCH, dd.n_train)
    batch = tuple(torch.as_tensor(a[:b]).to(device) for a in (
        dd.train_u, dd.train_i)) + (torch.randint(
            0, dd.n_items, (b,), generator=gen).to(device),)
    return cfg, model, batch


# ----------------------------------------------------------- the encoders


ENCODERS = {"transformer 0.5": ("transformer", 0.5, 0.5),
            "bert 0.2 / 0.3": ("bert", 0.2, 0.3),
            "bert 0 / 0.3": ("bert", 0.0, 0.3)}


def _encoder(kind, hidden, attn, x, gen, masks):
    g = torch.Generator().manual_seed(1)
    nhead, (b, L, d) = 2, x.shape
    if kind == "transformer":
        params = module.transformer_encoder_params(g, d, 4 * d, 2)
        pad = torch.arange(L)[None, :] >= torch.randint(1, L, (b, 1),
                                                        generator=g)
        apply = dict(pad_mask=pad, drop_rate=hidden)
        draw = (lambda: module.transformer_encoder_masks(
            params, x.shape, nhead, hidden, gen, x.device, x.dtype))
    else:
        params = module.bert_encoder_params(g, d, 4 * d, 2)
        mask = (torch.rand(b, L, generator=g) < 0.3) * -1e8
        apply = dict(attn_mask=mask[:, None, None, :], hidden_dropout=hidden,
                     attn_dropout=attn)
        draw = (lambda: module.bert_encoder_masks(
            params, x.shape, nhead, hidden, attn, gen, x.device, x.dtype))
    leaves = [v.requires_grad_() for p in params for v in p.values()]
    fn = (module.transformer_encoder_apply if kind == "transformer"
          else module.bert_encoder_apply)
    if masks:
        y = fn(params, x, nhead=nhead, masks=draw(), **apply)
    else:
        y = fn(params, x, nhead=nhead, generator=gen, **apply)
    grads = torch.autograd.grad((y * y).sum(), [x] + leaves)
    return y.detach(), grads


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_masks_equal_the_generator_path(name):
    kind, hidden, attn = ENCODERS[name]
    x = torch.randn(6, 5, 8, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    outs = []
    for masks in (False, True):
        gen = torch.Generator().manual_seed(4)
        outs.append((*_encoder(kind, hidden, attn, x, gen, masks),
                     gen.get_state()))
    (y0, g0, s0), (y1, g1, s1) = outs
    assert _bits(y0, y1)
    assert all(_bits(a, b) for a, b in zip(g0, g1))
    assert torch.equal(s0, s1)


# ------------------------------------------------------- the models' split


def _step(model, batch, gen, weight=None):
    """calculate_loss and the gradient of its sum: (parts, {name: grad})."""
    model.zero_grad(set_to_none=True)
    parts = model.calculate_loss(*batch, generator=gen, weight=weight)
    sum(parts).backward()
    return ([p.detach().clone() for p in parts],
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None})


@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "tail"])
@pytest.mark.parametrize("cell", CELLS)
def test_split_loss_equals_the_generator_path(cell, weighted, device,
                                              tmp_path, monkeypatch):
    _, model, batch = _build(cell, device, str(tmp_path))
    weight = None
    if weighted:
        weight = (torch.arange(batch[0].shape[0], device=device)
                  < batch[0].shape[0] - 7).float()
    # the block runs as it is, off the graphs
    monkeypatch.setattr(StepGraphs, "_capture", False)
    runs = []
    for graphs in (None, StepGraphs()):
        model.step_graphs = graphs
        gen = torch.Generator(device=device).manual_seed(5)
        runs.append((*_step(model, batch, gen, weight), gen.get_state()))
    (p0, g0, s0), (p1, g1, s1) = runs
    assert all(_bits(a, b) for a, b in zip(p0, p1))
    assert g0.keys() == g1.keys()
    assert all(_bits(g0[k], g1[k]) for k in g0), [
        k for k in g0 if not _bits(g0[k], g1[k])]
    assert torch.equal(s0, s1)


def test_trainer_on_the_cpu_gives_no_graphs(tmp_path):
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg, model, _ = _build("cikm-foodcom-train", "cpu", str(tmp_path))
    model.step_graphs = StepGraphs()
    Trainer(cfg, model)
    assert model.step_graphs is None


# ---------------------------------------------------------------- the card


def _epoch(cell, device, cache, graphs=True, mg=False, **model_config):
    """One train_epoch of three steps: (summed loss parts, the last
    gradients, the parameters, captures during it)."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg, model, _ = _build(cell, device, cache, **model_config)
    trainer = Trainer(cfg, model, mg=mg)
    assert trainer.n_batches == 3 and trainer.n_train % BATCH
    if not graphs:
        model.step_graphs._capture = False
    before = step_graph.captures
    parts = trainer.train_epoch()
    torch.cuda.synchronize()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return parts, grads, params, step_graph.captures - before, trainer


# each variant's model config and its signatures: the full batch's and the
# tail's, or with the padded tail one (every batch full, with a weight)
VARIANTS = {"plain": ({}, 2),
            "padded tail": ({"exact_final_batch": False}, 1),
            "mirror gradient": ({"mg": True, "alpha1": 1.0, "alpha2": 0.2,
                                 "beta": 2}, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("cell", CELLS)
def test_graph_epoch_equals_the_eager_block(cell, variant, cuda_device,
                                            tmp_path):
    kw, signatures = VARIANTS[variant]
    kw = dict(kw)
    mg = kw.pop("mg", False)
    runs = [_epoch(cell, cuda_device, str(tmp_path), graphs=g, mg=mg, **kw)
            for g in (True, False)]
    (pa, ga, wa, ca, trainer), (pb, gb, wb, cb, _) = runs
    assert (ca, cb) == (signatures, 0)
    assert _bits(pa, pb)
    assert ga.keys() == gb.keys()
    for k in ga:
        assert _bits(ga[k], gb[k]), k
        assert _bits(wa[k], wb[k]), k
    # a second epoch replays what the first captured
    before = step_graph.captures
    trainer.train_epoch()
    assert step_graph.captures == before


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_replays_make_no_host_sync(cell, cuda_device, tmp_path):
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg, model, batch = _build(cell, cuda_device, str(tmp_path))
    trainer = Trainer(cfg, model)
    trainer.train_steps([batch])  # captures
    torch.cuda.synchronize()
    before = step_graph.captures
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_steps([batch, batch])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert step_graph.captures == before


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_recorded_draws_equal_the_generator_paths(cell, cuda_device,
                                                  tmp_path):
    """The benchmark's recorder, which replaces `common.module.dropout`,
    `models.schgn.dropout` and `models.schgn.ssl_mask_ingredients`, sees
    the same draws in the same order on the graphs' steps as on the
    generator path's."""
    from portbench.traffic.train_draws import _DrawRecorder
    from foodrec_tpu_torch.engine.trainer import Trainer

    records = []
    for graphs in (True, False):
        cfg, model, batch = _build(cell, cuda_device, str(tmp_path))
        trainer = Trainer(cfg, model)
        if not graphs:
            model.step_graphs = None
        rec = _DrawRecorder(model)
        try:
            trainer.train_steps([batch, batch, batch])
        finally:
            rec.close()
        records.append((rec.masks, rec.parts))
    (ma, pa), (mb, pb) = records
    assert len(ma) == len(mb) == 3
    flat = [[t for d in step for t in (d if isinstance(d, tuple) else (d,))]
            for step in ma + mb]
    for a, b in zip(flat[:3], flat[3:]):
        assert len(a) == len(b) > 0
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert pa == pb


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_loaded_state_keeps_the_graphs_and_rebinding_drops_them(
        cell, cuda_device, tmp_path):
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg, model, batch = _build(cell, cuda_device, str(tmp_path))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model)
    trainer.train_steps([batch, batch])
    before = step_graph.captures
    model.load_state_dict(start)
    trainer.generator.manual_seed(9)
    parts = trainer.train_steps([batch])
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    assert step_graph.captures == before

    _, eager, _ = _build(cell, cuda_device, str(tmp_path))
    eager_trainer = Trainer(cfg, eager)
    eager.step_graphs._capture = False
    eager_trainer.generator.manual_seed(9)
    want = eager_trainer.train_steps([batch])
    assert _bits(parts, want)
    for n, p in eager.named_parameters():
        if p.grad is not None:
            assert _bits(grads[n], p.grad), n

    name = next(n for n, _ in model.named_parameters() if "." not in n)
    setattr(model, name, torch.nn.Parameter(getattr(model, name).detach()
                                            .clone()))
    trainer.train_steps([batch])
    assert step_graph.captures == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_backward_after_a_later_forward_raises(cell, cuda_device, tmp_path):
    """A graph holds one forward's activations: the backward of a forward
    that another forward of the same signature followed would take the
    later one's, and raises instead."""
    from foodrec_tpu_torch.engine.trainer import Trainer

    cfg, model, batch = _build(cell, cuda_device, str(tmp_path))
    trainer = Trainer(cfg, model)
    trainer.train_steps([batch])  # captures
    first, second = (model.calculate_loss(*batch, generator=trainer.generator)
                     for _ in range(2))
    with pytest.raises(RuntimeError, match="after another forward"):
        sum(first).backward()
    sum(second).backward()
