# coding: utf-8
"""BM3: bootstrapped multimodal SSL baseline (counterpart of
`foodrec_tpu/models/bm3.py`; reference FoodRec/models/bm3.py, Zhou et al.
WWW'23).

A LightGCN encoder over users+items with a residual item-id table
(bm3.py:87-98), and BYOL-style losses between online embeddings passed
through one shared linear `predictor` and stop-gradient targets perturbed
by dropout (bm3.py:100-150). The image and text tables are trainable, as the
reference trains them (`from_pretrained(freeze=False)`, bm3.py:53-58), unless
`freeze_modality_tables: True` keeps them as buffers, out of the optimizer
(the JAX package's opt-in, bm3.py:71-99).
Serving scores are dot products of the predictor's outputs.

The dropout masks draw from the `generator` that calculate_loss is given, in
the order user, item, text, image target (the JAX package splits one key so).
The reg term is the reference's unweighted emb_loss over the whole
propagated tables (bm3.py:150), so it divides by n_items.
"""

import torch
from torch import nn

from foodrec_tpu_torch.common.init import (
    linear_apply,
    torch_linear,
    xavier_normal,
    xavier_uniform,
)
from foodrec_tpu_torch.common.loss import cosine, emb_loss
from foodrec_tpu_torch.common.module import dropout
from foodrec_tpu_torch.models import register
from foodrec_tpu_torch.models.base import GeneralRecommender, as_parameters
from foodrec_tpu_torch.ops.graph import (
    sym_normalized_adjacency,
    ui_bipartite_edges,
)
from foodrec_tpu_torch.ops.spmm import propagate_mean
from foodrec_tpu_torch.parallel.mesh import batch_sum


def _wmean(x, w):
    return batch_sum(x * w) / batch_sum(w).clamp_min(1.0)


@register("BM3")
class BM3(GeneralRecommender):
    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        self.n_layers = config["n_layers"]
        self.reg_weight = config["reg_weight"]
        self.cl_weight = config["cl_weight"]
        self.dropout = config["dropout"]
        frozen = bool(config["freeze_modality_tables"])

        rows, cols = ui_bipartite_edges(dataset.train_coo_matrix, self.n_users)
        self.prop = self.propagator(
            sym_normalized_adjacency(rows, cols, self.n_users + self.n_items))

        # leaf order of the JAX package's init_params (bm3.py:78-96)
        g = generator or torch.Generator().manual_seed(0)
        d = self.embedding_size
        self.user_embedding = nn.Parameter(
            xavier_uniform((self.n_users, d), g).to(self.device))
        self.item_id_embedding = nn.Parameter(
            xavier_uniform((self.n_items, d), g).to(self.device))
        self.predictor = as_parameters(
            torch_linear(d, d, g, init=xavier_normal), self.device)
        self.modalities = []
        for name, feat in (("image", self.v_feat), ("text", self.t_feat)):
            if feat is None:
                continue
            self.modalities.append(name)
            table = torch.from_numpy(feat.copy()).to(self.device)
            if frozen:
                self.register_buffer(f"{name}_embedding", table,
                                     persistent=False)
            else:
                setattr(self, f"{name}_embedding", nn.Parameter(table))
            setattr(self, f"{name}_trs", as_parameters(torch_linear(
                feat.shape[1], d, g, init=xavier_normal), self.device))

    def _gnn_encode(self):
        ego = torch.cat([self.user_embedding, self.item_id_embedding], dim=0)
        all_emb = propagate_mean(self.prop, ego, self.n_layers)
        return (all_emb[: self.n_users],
                all_emb[self.n_users:] + self.item_id_embedding)

    def forward(self):
        u, i = self._gnn_encode()
        return linear_apply(self.predictor, u), linear_apply(self.predictor, i)

    def calculate_loss(self, user, pos_item, neg_item, generator=None,
                       weight=None):
        """(loss_ui + loss_iu, reg, cl_weight * the modality losses) for one
        batch of int64 ids [B], weighted by `weight` (or ones); `generator`
        draws the dropout masks."""
        weight = self.sample_weight(user, weight)
        u_online_ori, i_online_ori = self._gnn_encode()

        # stop-gradient dropout targets (bm3.py:108-122)
        u_target = dropout(u_online_ori.detach(), self.dropout,
                           generator)[user]
        i_target = dropout(i_online_ori.detach(), self.dropout,
                           generator)[pos_item]
        u_online = linear_apply(self.predictor, u_online_ori)[user]
        i_online = linear_apply(self.predictor, i_online_ori)[pos_item]

        # text before image, the JAX package's order of draws
        cl = 0.0
        for name in reversed(self.modalities):
            feat_online = self.table_map(f"{name}_embedding", linear_apply,
                                         getattr(self, f"{name}_trs"))
            target = dropout(feat_online.detach(), self.dropout,
                             generator)[pos_item]
            online = linear_apply(self.predictor, feat_online)[pos_item]
            cl = (cl + _wmean(1 - cosine(online, i_target), weight)
                  + _wmean(1 - cosine(online, target), weight))

        loss_ui = _wmean(1 - cosine(u_online, i_target), weight)
        loss_iu = _wmean(1 - cosine(i_online, u_target), weight)
        reg = self.reg_weight * emb_loss(u_online_ori, i_online_ori)
        return loss_ui + loss_iu, reg, self.cl_weight * cl
