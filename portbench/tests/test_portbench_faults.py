"""Each fault a cell can have, planted under the timed path at a tiny size
on the CPU, turns `correct` false: a step that leaves the state unchanged,
half of each batch left out (the mean taken over the rest), and an answer
altered where it is produced. (No cell spans chips, so no exchange
between chips can be left out.)"""

import time

import pytest
import torch

from portbench import run

TRAIN = ["cikm-foodcom-train", "lightgcn-foodcom-train"]


def _measure(cell):
    return run.measure(cell.name, 99, 0.3, False, device="cpu",
                       start=time.perf_counter(), cell=cell)


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged(name, tiny_cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    assert not _measure(tiny_cell(name))["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_each_batch_left_out(name, tiny_cell, monkeypatch):
    from foodrec_tpu_torch.models import get_model

    cls = get_model(tiny_cell(name).config["model"])
    loss = cls.calculate_loss

    def half(self, user, pos, neg, generator=None, weight=None):
        h = user.shape[0] // 2
        return loss(self, user[:h], pos[:h], neg[:h], generator=generator)

    monkeypatch.setattr(cls, "calculate_loss", half)
    assert not _measure(tiny_cell(name))["correct"]


def test_eval_score_altered(tiny_cell, monkeypatch):
    from foodrec_tpu_torch.models.base import GeneralRecommender

    score = GeneralRecommender.score_from_cache

    def altered(self, cache, users, cand):
        out = score(self, cache, users, cand)
        out[0, 0] += 1.0
        return out

    monkeypatch.setattr(GeneralRecommender, "score_from_cache", altered)
    assert not _measure(tiny_cell("cikm-foodcom-eval"))["correct"]


def test_topk_id_altered(tiny_cell, monkeypatch):
    from foodrec_tpu_torch.engine import topk_evaluator

    full_sort_topk = topk_evaluator.full_sort_topk

    def altered(*args, **kwargs):
        ids = full_sort_topk(*args, **kwargs)
        ids[:, 0] = ids[:, -1]
        return ids

    monkeypatch.setattr(topk_evaluator, "full_sort_topk", altered)
    assert not _measure(tiny_cell("lightgcn-foodcom-topk"))["correct"]
