# coding: utf-8
"""Model contract (counterpart of `foodrec_tpu/models/base.py`; reference
FoodRec/common/abstract_recommender.py:8-91).

A model is an `nn.Module` that holds its parameters and, as registered
buffers, its graph tables and item side tables. It reads its arrays from the
dataset's `device_data` (a `DeviceData`, attached by the caller as in the
JAX package). Training calls

    calculate_loss(user, pos_item, neg_item, generator, weight=None)
                                          -> tuple of scalar losses, summed
                                             for the gradient; `weight` [B]
                                             is the padded final batch's
                                             0/1 sample weight (None: ones)

and evaluation splits into

    eval_cache()                          -> (user_emb, item_emb), the graph
                                             propagation, once per evaluation
    score_from_cache(cache, users, cand)  -> [B, C] candidate scores
    score_items(cache, users, items)      -> [B, C] scores against one shared
                                             item list (full-catalog top-k)

Under a mesh with a `model` axis, `shard_tables` keeps only this rank's
rows of the tables `param_shardings` picks, and the model reads them
through `table_rows` (a gather by ids) and `table_map` (a whole-table
projection), which give every rank the single-process values.
"""

import numpy as np
import torch
from torch import nn

from foodrec_tpu_torch.ops.spmm import Propagator
from foodrec_tpu_torch.parallel.collectives import (
    all_gather,
    model_gather,
    model_grad_sum,
    sharded_lookup,
)
from foodrec_tpu_torch.parallel.mesh import replicated


def row_sharded(name, shape, n_model):
    """The JAX package's rule (foodrec_tpu/models/base.py:176-198): a
    parameter is row-sharded over a `model` axis of n_model > 1 when it is
    2-D with at least 512 columns, its rows divide n_model and its name
    holds `embedding` (the modality feature tables)."""
    return (n_model > 1 and len(shape) == 2 and shape[1] >= 512
            and shape[0] % n_model == 0 and "embedding" in name)


def as_parameters(tree, device):
    """A dict (or list) of tensors as nested ParameterDicts (ModuleList), so
    that a leaf at tree["ir_aggs"][0]["W1"]["w"] is the parameter
    `ir_aggs.0.W1.w`, the JAX pytree's path."""
    if isinstance(tree, list):
        return nn.ModuleList(as_parameters(t, device) for t in tree)
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v.to(device)) for k, v in tree.items()})
    return nn.ModuleDict(
        {k: as_parameters(v, device) for k, v in tree.items()})


class GeneralRecommender(nn.Module):
    # {name: (first row, full rows)} of the row-sharded tables
    row_shards = {}
    # the StepGraphs (common/step_graph.py) a single-process Trainer on the
    # card gives the model; CIKM_Model and SCHGN run their loss block
    # through it, and every model runs eagerly without one
    step_graphs = None

    def __init__(self, config, dataset):
        super().__init__()
        self.config = config
        self.device = torch.device(config["device"])
        self.dataset = dataset  # the full-sort, sampled and study evals read it
        self.dd = dataset.device_data
        self.n_users = dataset.n_users
        self.n_items = dataset.n_items
        self.embedding_size = config["embedding_size"]
        # modality features as host float32 tables
        # (abstract_recommender.py:84-91); a model that trains them makes
        # them parameters
        self.v_feat = self.t_feat = None
        if config["is_multimodal_model"] and not config["end2end"]:
            self.v_feat = np.asarray(self.dd.img, dtype=np.float32)
            self.t_feat = np.asarray(self.dd.txt, dtype=np.float32)

    def diagnostic_embeddings(self, tree):
        """The same-width (id, text, image) tables of the cosine probe
        (foodrec_tpu/models/base.py:157-173; reference trainer.py:584-629)
        from `tree`, a {parameter name: tensor} dict of the parameters or of
        their gradients; None unless the three exist with one width, as on
        the six shipped models, where the probe is then skipped."""
        keys = ("item_embedding", "text_embedding", "image_embedding")
        if not all(tree.get(k) is not None for k in keys):
            return None
        mats = [tree[k] for k in keys]
        if len({m.shape[-1] for m in mats}) != 1:
            return None
        return tuple(mats)

    def sample_weight(self, user, weight):
        """The per-sample loss weight [B]: `weight` in the parameters'
        dtype, or ones (every row counts)."""
        dtype = next(self.parameters()).dtype
        if weight is None:
            return torch.ones(user.shape[0], dtype=dtype, device=user.device)
        return weight.to(dtype)

    # -- sharding -------------------------------------------------------------
    def param_shardings(self, mesh):
        """{parameter name: placement}: ("model",) for a table row-sharded
        over `model` (`row_sharded`), () for a replicated one."""
        m = mesh.size("model") if mesh is not None else 1
        return {n: ("model",) if row_sharded(n, tuple(p.shape), m)
                else replicated(mesh) for n, p in self.named_parameters()}

    def shard_tables(self, mesh):
        """Keep only this rank's rows [i * n / m, (i + 1) * n / m) of each
        table `param_shardings` row-shards, i the rank's `model` index."""
        self._mesh = mesh
        self.row_shards = {}
        m, i = mesh.size("model"), mesh.index("model")
        for name, spec in self.param_shardings(mesh).items():
            if not spec:
                continue
            full = self.get_parameter(name)
            n = full.shape[0] // m
            path, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(path), leaf, nn.Parameter(
                full.detach()[i * n:(i + 1) * n].clone()))
            self.row_shards[name] = (i * n, full.shape[0])

    def table_rows(self, name, ids):
        """The table `name`'s rows at `ids` (any shape)."""
        table = getattr(self, name)
        if name not in self.row_shards:
            return table[ids]
        return sharded_lookup(table, ids, self.row_shards[name][0],
                              self._mesh.group("model"))

    def table_map(self, name, fn, weights):
        """fn(weights, table `name`), fn mapping the table's rows one to one
        with the dict of parameters `weights` (a projection, `linear_apply`):
        a row-sharded table's local rows mapped, then gathered over `model`,
        the weights' gradient summed over `model`."""
        table = getattr(self, name)
        if name not in self.row_shards:
            return fn(weights, table)
        group = self._mesh.group("model")
        weights = {k: model_grad_sum(w, group) for k, w in weights.items()}
        return model_gather(fn(weights, table), group)

    def full_state_dict(self):
        """The state_dict with every row-sharded table gathered whole (a
        collective over `model`): what one process holds."""
        state = self.state_dict()
        for name in self.row_shards:
            state[name] = all_gather(state[name].detach(),
                                     self._mesh.group("model"))
        return state

    def load_full_state_dict(self, state):
        """Load a whole state_dict (`full_state_dict`'s, or one process's),
        keeping this rank's rows of the row-sharded tables."""
        state = dict(state)
        for name, (first, _) in self.row_shards.items():
            rows = self.get_parameter(name).shape[0]
            state[name] = state[name][first:first + rows]
        self.load_state_dict(state)

    def propagator(self, adj):
        """A Propagator over `adj` with the config's spmm_impl and
        spmm_dtype, on the model's device."""
        return Propagator(adj, impl=self.config["spmm_impl"] or "auto",
                          compute_dtype=self.config["spmm_dtype"],
                          device=self.device)

    def forward(self):
        raise NotImplementedError

    def calculate_loss(self, user, pos_item, neg_item, generator=None,
                       weight=None):
        raise NotImplementedError

    @torch.no_grad()
    def eval_cache(self):
        # detached: a model may return a parameter itself (FGCN's items)
        return tuple(t.detach() for t in self.forward()[:2])

    def score_from_cache(self, cache, users, cand):
        user_emb, item_emb = cache[:2]
        return torch.einsum("bd,bcd->bc", user_emb[users], item_emb[cand])

    def score_items(self, cache, users, items):
        user_emb, item_emb = cache[:2]
        return user_emb[users] @ item_emb[items].T

    def score_candidates(self, users, cand):
        return self.score_from_cache(self.eval_cache(), users, cand)
