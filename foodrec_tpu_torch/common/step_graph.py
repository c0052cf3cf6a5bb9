# coding: utf-8
"""A model's batch-sized loss block, replayed as CUDA graphs.

A training step of CIKM_Model or SCHGN launches about a thousand small
kernels, and the host's dispatch of them, not the device, sets the step's
pace. The two models split `calculate_loss` into an eager prelude and a
block. The prelude is the graph propagation through their `Propagator`s
and every random draw of the step, in call order. The block is the rest of
the loss: a function of tensors alone (the batch's ids, the weight, the
propagated tables, the draws) and of the model's parameters and buffers.
`StepGraphs.run` captures the block's forward and its backward as two CUDA
graphs, once per input signature (the shapes, dtypes and gradient flags of
the block's inputs, None where one is absent), and replays them through one
autograd node:

  * its forward copies the step's inputs into the graphs' static inputs
    and replays the forward graph; the node's outputs are the loss parts
  * its backward copies the parts' gradients in and replays the backward
    graph; its gradients of the propagated tables flow on into the eager
    SpMM backward, and those of the parameters reach `.grad`
  * parameters and buffers are read where they lie, never copied: a change
    of any one's address (a rebound Parameter, a move) drops the model's
    graphs, and the next step captures again; loading values into the same
    tensors (`load_state_dict`) keeps them

A capture first runs the block once, forward and backward, on a side
stream, so that kernels are built and libraries loaded outside the capture;
that run draws nothing and updates nothing (its gradients go to
`autograd.grad`, not to `.grad`). The step that meets a signature first
captures and then replays, as every later step does. While it captures,
the model's parameters are stood in for by new leaves on the same memory:
the prelude's graph, alive meanwhile, holds the parameters' own gradient
accumulators, which belong to the default stream, and a capture whose
gradient flowed into them would make that stream wait on the capturing
one, which CUDA refuses.

A model may run several blocks: the graphs are keyed by the block's
function and the signature, so two blocks of equal signatures keep their
own graphs.

Each replay, forward and backward, lies inside the span
`foodrec::step_graph`; where `run` is given a span's name, the replay
opens that span too, inside `step_graph`, as the block's eager call does
around the call. The spans opened inside the block
(`score`, `ssl`, `gather_backward`) open only while it is captured, and
the kernel launch counts of `ops/_kernels.py` count its launches only
then. `captures` counts the captures.

On tensors off the card, `run` calls the block as it is.
"""

import contextlib
import itertools

import torch
from torch.autograd.function import once_differentiable

from foodrec_tpu_torch.utils.trace import span as trace_span

# captures since the caller last reset it
captures = 0
_NO_SPAN = contextlib.nullcontext()


def _span(name):
    """The span `foodrec::<name>`, or a null context where `name` is
    None."""
    return _NO_SPAN if name is None else trace_span(name)


def _storage(t):
    return t.untyped_storage().data_ptr()


@contextlib.contextmanager
def _stand_ins(model):
    """Inside, each trainable parameter of `model` is replaced by a new
    leaf Parameter on the same memory (one for a parameter that several
    modules share); yields them in `model.parameters()` order."""
    swapped, alias = [], {}
    for m in model.modules():
        for name, p in m._parameters.items():
            if p is None or not p.requires_grad:
                continue
            if id(p) not in alias:
                alias[id(p)] = torch.nn.Parameter(p.detach())
            swapped.append((m, name, p))
            m._parameters[name] = alias[id(p)]
    try:
        yield [p for p in model.parameters() if p.requires_grad]
    finally:
        for m, name, p in swapped:
            m._parameters[name] = p


class _Graph:
    """The two graphs of one signature and their static tensors: inputs,
    outputs, the outputs' gradients, and the gradients of the inputs and
    parameters (None where the block gives none); `span` names the span
    each replay opens, or is None."""

    def __init__(self, model, block, args, span=None):
        global captures
        self.span = span
        self.inputs = [None if a is None
                       else a.detach().clone().requires_grad_(a.requires_grad)
                       for a in args]
        with torch.enable_grad(), _stand_ins(model) as params:
            wrt = [s for s in self.inputs if s is not None and s.requires_grad]
            wrt += params
            torch.cuda.synchronize()
            with torch.cuda.stream(torch.cuda.Stream()):
                outs = block(*self.inputs)
                diff = [o for o in outs if o.requires_grad]
                if diff and wrt:
                    torch.autograd.grad(diff, wrt, [torch.ones_like(o)
                                                    for o in diff],
                                        allow_unused=True)
                del outs, diff
            torch.cuda.synchronize()

            pool = torch.cuda.graph_pool_handle()
            self.fwd, self.bwd = torch.cuda.CUDAGraph(), None
            with torch.cuda.graph(self.fwd, pool=pool):
                outs = block(*self.inputs)
            self.outputs = tuple(o.detach() for o in outs)
            self.diff = [i for i, o in enumerate(outs) if o.requires_grad]
            self.grad_outputs = [torch.empty_like(outs[i]) for i in self.diff]
            grads = [None] * len(wrt)
            if self.diff and wrt:
                self.bwd = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.bwd, pool=pool):
                    grads = torch.autograd.grad(
                        [outs[i] for i in self.diff], wrt, self.grad_outputs,
                        allow_unused=True)
        del outs
        # the gradient of each of the node's inputs, in order: the block's
        # arguments, then the parameters
        it = iter(grads)
        self.grads = [next(it) if s is not None and s.requires_grad else None
                      for s in self.inputs] + [next(it) for _ in params]
        # a gradient that shares memory with another static tensor is handed
        # on as a copy: autograd may keep the one it is given as `.grad`,
        # which the optimizer's scaling and clipping change in place
        seen = {_storage(t) for t in itertools.chain(
            self.outputs, self.grad_outputs,
            (s for s in self.inputs if s is not None))}
        self.copied = []
        for g in self.grads:
            self.copied.append(g is not None and _storage(g) in seen)
            if g is not None:
                seen.add(_storage(g))
        # forward replays so far: a backward belongs to the latest
        self.replays = 0
        captures += 1

    def grads_out(self):
        return tuple(None if g is None else g.clone() if c else g.detach()
                     for g, c in zip(self.grads, self.copied))


class _Replay(torch.autograd.Function):
    """One step of a captured block: forward(graph, *args, *params)."""

    @staticmethod
    def forward(ctx, graph, *args):
        graph.replays += 1
        ctx.graph, ctx.replay = graph, graph.replays
        for s, a in zip(graph.inputs, args):
            if s is not None:
                s.copy_(a)
        with trace_span("step_graph"), _span(graph.span):
            graph.fwd.replay()
        return tuple(o.detach() for o in graph.outputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        graph = ctx.graph
        if ctx.replay != graph.replays:
            raise RuntimeError(
                "a replayed loss block's backward after another forward of "
                "its graph: the graph holds the latest forward's "
                "activations only")
        if graph.bwd is None:
            return (None,) * (1 + len(graph.grads))
        for s, i in zip(graph.grad_outputs, graph.diff):
            s.copy_(grads[i])
        with trace_span("step_graph"), _span(graph.span):
            graph.bwd.replay()
        return (None, *graph.grads_out())


class StepGraphs:
    """A model's captured loss blocks, one `_Graph` a signature. A Trainer
    that runs in one process on the card gives its model one
    (`model.step_graphs`)."""

    # off, `run` calls the block as it is on the card too (a test's seam)
    _capture = True

    def __init__(self):
        self._graphs = {}
        self._where = None

    def run(self, model, block, args, span=None):
        """block(*args) -> a tuple of tensors, the loss parts: `args` are
        the step's tensors (or None), and the block reads nothing else but
        the model's parameters and buffers. With `span`, the block's call,
        and on the card each of its replays, forward and backward, lies
        inside `foodrec::<span>`.

        On the card a signature's graph holds one forward's activations
        and outputs: each forward is followed by its own backward before
        the next forward of that signature (a backward after a later
        forward raises), and the returned parts are views of the graph's
        static outputs, which the next replay overwrites; a caller that
        keeps them across steps keeps a copy."""
        if not (self._capture and args[0].is_cuda):
            with _span(span):
                return block(*args)
        params = [p for p in model.parameters() if p.requires_grad]
        where = tuple(t.data_ptr()
                      for t in itertools.chain(params, model.buffers()))
        if where != self._where:
            self._graphs.clear()
            self._where = where
        # a bound method is made anew at each access: key by its function
        key = (getattr(block, "__func__", block),) + tuple(
            None if a is None else (a.shape, a.dtype, a.requires_grad)
            for a in args)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _Graph(model, block, args, span)
        return _Replay.apply(graph, *args, *params)

