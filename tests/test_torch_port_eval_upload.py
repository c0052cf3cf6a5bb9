"""PyTorch port, the by-user evaluation's resident eval sets
(engine/evaluator.py `_device_arrays`): an EvalSet's padded device arrays
are copied once per device and block size and read by every later pass,
which then gives the first pass's metrics, per-user arrays and scores bit
for bit; the arrays go with their set; a set that cannot be held (no weak
reference) is copied on every pass and gives the same numbers.

`evaluator.copies` counts the copies. The cases marked `cuda` run on the
card: there a second pass copies nothing of 1 MB or more to the device.
This module imports no JAX, so it runs on the card as it is."""

import gc
import json
import types
import weakref

import numpy as np
import pytest
import torch

from foodrec_tpu_torch.data.device import build_eval_set
from foodrec_tpu_torch.engine import evaluator
from torch_port_fixtures import (  # noqa: F401
    cuda_device,
    device,
    port_synth_root,
)

N_USERS, N_ITEMS, NEG_NUM = 23, 90, 30


def _eval_set(seed=0):
    """An EvalSet of N_USERS users, 1-6 positives and NEG_NUM negatives
    each (some negatives repeat a positive, which the set drops)."""
    rng = np.random.default_rng(seed)
    ratings = [rng.choice(N_ITEMS, rng.integers(1, 7), replace=False)
               for _ in range(N_USERS)]
    negatives = [rng.choice(N_ITEMS, NEG_NUM, replace=False)
                 for _ in range(N_USERS)]
    return build_eval_set(np.arange(N_USERS), ratings, negatives,
                          pad_multiple=8)


def _namespace(es):
    """The same arrays in an object that cannot be weakly referenced."""
    return types.SimpleNamespace(n_users=es.n_users, users=es.users,
                                 cand=es.cand, n_pos=es.n_pos,
                                 n_cand=es.n_cand)


def _scorer(device, seed=0):
    """float32 dot products of random user and item factors: each user is
    scored on its own, so a block's padding moves no real user's score."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(N_USERS, 8, generator=g).to(device)
    i = torch.randn(N_ITEMS, 8, generator=g).to(device)
    return lambda users, cand: (u[users][:, None, :] * i[cand]).sum(-1)


def _pass(es, device, batch_size=8):
    return evaluator.evaluate_by_user(_scorer(device), es, NEG_NUM,
                                      batch_size=batch_size, device=device,
                                      return_per_user=True)


def _assert_same_pass(got, want):
    """Two by-user passes equal bit for bit: score, metrics, per-user
    arrays and scores."""
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        assert np.array_equal(got[2][k].view(np.int32),
                              want[2][k].view(np.int32)), k
    assert np.array_equal(got[3].view(np.int32), want[3].view(np.int32))


def test_second_pass_reads_the_held_arrays(device):
    """One copy for two passes over one set, and the second pass gives the
    first's numbers bit for bit; a SimpleNamespace holding the same arrays
    is copied on each of its passes and gives them too."""
    es = _eval_set()
    before = evaluator.copies
    first = _pass(es, device)
    second = _pass(es, device)
    assert evaluator.copies - before == 1
    _assert_same_pass(second, first)

    ns = _namespace(es)
    with pytest.raises(TypeError):
        weakref.ref(ns)
    for _ in "12":
        _assert_same_pass(_pass(ns, device), first)
    assert evaluator.copies - before == 3
    assert ns not in evaluator._resident.keys()


@pytest.mark.parametrize("batch_size", [1, 5, 8, 23, 64])
def test_each_block_size_and_device_keeps_its_own_padding(device,
                                                          batch_size):
    """A block size (23 users: 1 and 23 divide them, 5, 8 and 64 do not)
    and a second device each copy the set once more, each padded with zero
    rows to its own block size; the metrics are the one-block pass's."""
    es = _eval_set(seed=1)
    other = "meta" if device == "cpu" else "cpu"
    want = _pass(es, device, batch_size=256)
    before = evaluator.copies
    got = _pass(es, device, batch_size=batch_size)
    _assert_same_pass(_pass(es, device, batch_size=batch_size), got)
    assert got[:2] == want[:2]
    assert np.array_equal(got[3], want[3])
    evaluator._device_arrays(es, batch_size, other)
    assert evaluator.copies - before == 2

    rows = -(-N_USERS // batch_size) * batch_size
    held = evaluator._resident[es]
    assert len(held) == 3  # blocks of 256 and of batch_size, other device
    for dev in (device, other):
        arrays = evaluator._device_arrays(es, batch_size, dev)
        for a, host in zip(arrays, (es.users, es.cand, es.n_pos, es.n_cand)):
            assert a.dtype == torch.int64
            assert a.device.type == torch.device(dev).type
            assert a.shape == (rows,) + host.shape[1:]
            if dev != "meta":
                assert np.array_equal(a[:N_USERS].cpu().numpy(), host)
                assert not a[N_USERS:].any()
    assert evaluator.copies - before == 2


def test_dropped_eval_set_leaves_nothing_held(device):
    """An EvalSet's entry, and its device arrays, go with it."""
    es = _eval_set(seed=2)
    _pass(es, device)
    assert es in evaluator._resident
    (arrays,) = evaluator._resident[es].values()
    refs = [weakref.ref(a) for a in arrays]
    n_held = len(evaluator._resident)
    del es, arrays
    gc.collect()
    assert len(evaluator._resident) == n_held - 1
    assert all(r() is None for r in refs)


@pytest.fixture(scope="module")
def toy(port_synth_root):
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData

    root, meta = port_synth_root
    cfg = Config("CIKM_Model", "Synth", {
        "data_path": root.rsplit("/Synth", 1)[0] + "/",
        "neg_sample_num": meta["neg_num"], "eval_batch_size": 8,
        "use_gpu": False})
    derive_data_paths(cfg, "Synth")
    data = FoodData(cfg)
    data.device_data = DeviceData.from_food_data(data)
    return cfg, data


def _trainer(cfg, data, device):
    from foodrec_tpu_torch.engine.trainer import Trainer
    from foodrec_tpu_torch.models import get_model

    cfg["device"] = device  # the config is the module's, built for the CPU
    torch.set_num_threads(1)
    model = get_model("CIKM_Model")(cfg, data, torch.Generator().manual_seed(0))
    return Trainer(cfg, model)


def test_trainer_copies_each_split_once(toy, device):
    """A Trainer's evaluations of the valid and the test split, two each,
    copy each split once; the second pass gives the first's metrics."""
    cfg, data = toy
    trainer = _trainer(cfg, data, device)
    dd = data.device_data
    before = evaluator.copies
    for es, is_test in ((dd.eval_valid, False), (dd.eval_test, True)):
        first = trainer.evaluate(es, is_test=is_test)
        assert trainer.evaluate(es, is_test=is_test) == first
    assert evaluator.copies - before == 2


def test_study_eval_leaves_nothing_held(toy):
    """`_study_eval` builds a fresh set each call: it is copied, and its
    entry goes when the call returns."""
    cfg, data = toy
    trainer = _trainer(cfg, data, "cpu")
    ds = trainer.model.dataset
    gc.collect()
    n_held, before = len(evaluator._resident), evaluator.copies
    for _ in "12":
        trainer._study_eval(ds.valid_users, ds.validRatings,
                            ds.validNegatives)
    gc.collect()
    assert evaluator.copies - before == 2
    assert len(evaluator._resident) == n_held


def _host_to_device_copies(prof, tmp_path):
    """The bytes of each host-to-device copy in the profiler's trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["args"]["bytes"] for e in events
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]


def test_second_pass_copies_nothing_to_the_card(cuda_device, tmp_path):
    """On the card, two `Trainer.evaluate(dd.eval_test, is_test=True)`
    passes copy the set once: the first pass's trace holds its candidate
    list's copy (1 MB or more), the second's no host-to-device copy of
    1 MB or more, and its metrics are the first's bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data import synthetic
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData

    meta = synthetic.generate(str(tmp_path / "Synth"), n_users=600,
                              n_items=1000, neg_num=500)
    cfg = Config("CIKM_Model", "Synth", {
        "data_path": str(tmp_path) + "/", "neg_sample_num": meta["neg_num"]})
    derive_data_paths(cfg, "Synth")
    data = FoodData(cfg)
    dd = data.device_data = DeviceData.from_food_data(data)
    assert dd.eval_test.n_users * dd.eval_test.width * 8 >= 2**20
    trainer = _trainer(cfg, data, cuda_device)

    before = evaluator.copies
    copied, results = [], []
    for _ in "12":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            results.append(trainer.evaluate(dd.eval_test, is_test=True))
            torch.cuda.synchronize()
        copied.append(_host_to_device_copies(prof, tmp_path))
    assert evaluator.copies - before == 1
    assert max(copied[0]) >= 2**20
    assert all(b < 2**20 for b in copied[1]), copied[1]
    assert results[1] == results[0]
