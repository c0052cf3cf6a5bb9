"""graph_replays_per_step.train: the replays of captured CUDA graphs a
step, the program's `foodrec::step_graph` spans (each the forward or the
backward of a model's loss block, foodrec_tpu_torch/common/step_graph.py)
over its `foodrec::train_step` spans, in the traced training window; None
where the program opens no such span."""

from portbench.spans import count


def read(run):
    replays = count(run.trace, "foodrec::step_graph")
    steps = count(run.trace, "foodrec::train_step")
    return replays / steps if replays and steps else None
