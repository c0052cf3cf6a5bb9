# coding: utf-8
"""Host ranges at the layer boundaries of the port's hot paths, recorded by
the `torch.profiler` that is recording, if any.

`span(name)` opens the range `foodrec::<name>` through
`torch.autograd.profiler.record_function`, so it lands in the profiler's
chrome trace beside the device's kernels, timed by the same profiler: a
device idle gap can be laid against the layer the host was in. When no profiler
records, `span` returns one shared null context after a single flag check:
0.4 µs a span on the host of an H100 machine, where an unconditional
`record_function` costs 8 µs, so the spans cost nothing that shows in an
untraced step.

The spans, and where they sit:

  * `train_step`: one batch from its draw to its last update, Mirror
    Gradient's two included (engine/trainer.py `_batches`)
  * `sampler`: the batch's slice and gathers and its negatives
    (`_batches`)
  * `forward`, `backward`, `optimizer`: `calculate_loss`; the backward and
    the mesh's gradient reduction; the scale, clip, lr and
    `optimizer.step()` (`_backward`, `_update`)
  * `spmm_forward`: one graph product (ops/spmm.py `Propagator.forward`)
  * `spmm_backward`: the kernel's product with A^T in the backward of one
    graph product, its fix-up launches included (ops/spmm.py
    `SpmmCSR.backward`)
  * `gather_backward`: the table's gradient in the backward of one row
    gather (ops/gather.py `_GatherRows.backward`: the kernel's two
    launches on the card)
  * `score`, `ssl`: SCHGN's scorer and its masked-ingredient loss
    (models/schgn.py `SCHGN._score`, `SCHGN._ssl_loss`)
  * `eval_pass`, `eval_cache`: one evaluation; its graph propagation
    (`Trainer._valid`, `_score_fn`, `_valid_full_sort`)
  * `eval_upload`, `metrics`: a by-user pass's arrays copied to the device;
    a block's metrics (engine/evaluator.py `evaluate_by_user`)
  * `topk_request`, `topk_merge`: one full-sort top-k call; one chunk's
    merge (engine/topk_evaluator.py)
  * `topk_metrics`: the host's metrics of a full-sort evaluation's top-k
    lists (`TopKEvaluator.evaluate` in `Trainer._valid_full_sort`)
  * `step_graph`: one replay of a captured loss block's CUDA graph, its
    forward or its backward (common/step_graph.py `_Replay`)
  * `item_views`, `dcor`: CLUSSL's three item-side views, their
    propagation and sum; its distance-correlation block; each around the
    forward's call (models/pricai_modelx.py `forward`, `calculate_loss`)

No span name is a prefix of another: readers select ranges by prefix.
Spans touch no tensor and no random stream.
"""

import contextlib

import torch
from torch.autograd import profiler

PREFIX = "foodrec::"
SPANS = ("train_step", "sampler", "forward", "backward", "optimizer",
         "spmm_forward", "eval_pass", "eval_cache", "eval_upload", "metrics",
         "topk_request", "topk_merge", "spmm_backward", "score", "ssl",
         "topk_metrics", "gather_backward", "step_graph", "item_views",
         "dcor")

_OFF = contextlib.nullcontext()


def span(name):
    """The range `foodrec::<name>` while a profiler records; otherwise a
    shared null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if name not in SPANS:
        raise ValueError(f"{name!r} is not one of the port's spans {SPANS}")
    return profiler.record_function(PREFIX + name)
