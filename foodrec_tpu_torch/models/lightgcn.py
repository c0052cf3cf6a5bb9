# coding: utf-8
"""LightGCN baseline (counterpart of `foodrec_tpu/models/lightgcn.py`;
reference FoodRec/models/lightgcn.py).

One propagator over the joint users+items node space, `n_layers` SpMM hops
and a layer-mean readout; serving scores are dot products. `flagD` selects
the item ego table: 0 a linear projection of the image features, 1 of the
text features (shipped), 2 and 3 the free item table. Faithful quirks kept
from the JAX package:
  * the projection `image_trs` keeps torch's default Linear init (it is
    created after the reference's xavier pass, lightgcn.py:72-74), and the
    trainable feature table is named `image_embedding` even when it holds
    the text features
  * the free item table feeds only the reg term, which reads the raw
    tables, not the propagated ones (lightgcn.py:167-175)
With `freeze_modality_tables: True` the feature table is a buffer, out of
the optimizer (the JAX package's opt-in, lightgcn.py:46-87).
"""

import torch
from torch import nn

from foodrec_tpu_torch.common.init import (
    default_linear,
    linear_apply,
    xavier_uniform,
)
from foodrec_tpu_torch.common.loss import bpr_loss, emb_loss
from foodrec_tpu_torch.models import register
from foodrec_tpu_torch.models.base import GeneralRecommender, as_parameters
from foodrec_tpu_torch.ops.graph import (
    sym_normalized_adjacency,
    ui_bipartite_edges,
)
from foodrec_tpu_torch.ops.spmm import propagate_mean


@register("LightGCN")
class LightGCN(GeneralRecommender):
    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        self.n_layers = config["n_layers"]
        self.reg_weight = config["reg_weight"]
        flag = config["flagD"]
        self.flagD = int(flag[0] if isinstance(flag, (list, tuple))
                         else (flag or 3))
        frozen = bool(config["freeze_modality_tables"])

        rows, cols = ui_bipartite_edges(dataset.train_coo_matrix, self.n_users)
        self.prop = self.propagator(
            sym_normalized_adjacency(rows, cols, self.n_users + self.n_items))

        # leaf order of the JAX package's init_params (lightgcn.py:62-83)
        feat = {0: self.v_feat, 1: self.t_feat}.get(self.flagD)
        g = generator or torch.Generator().manual_seed(0)
        d = self.embedding_size
        self.user_embedding = nn.Parameter(
            xavier_uniform((self.n_users, d), g).to(self.device))
        self.item_embedding = nn.Parameter(
            xavier_uniform((self.n_items, d), g).to(self.device))
        self.has_feat = feat is not None
        if self.has_feat:
            self.image_trs = as_parameters(
                default_linear(feat.shape[1], d, g), self.device)
            table = torch.from_numpy(feat.copy()).to(self.device)
            if frozen:
                self.register_buffer("image_embedding", table,
                                     persistent=False)
            else:
                self.image_embedding = nn.Parameter(table)

    def _ego(self):
        if self.has_feat:
            item_ego = self.table_map("image_embedding", linear_apply,
                                      self.image_trs)
        else:
            item_ego = self.item_embedding
        return torch.cat([self.user_embedding, item_ego], dim=0)

    def forward(self):
        all_emb = propagate_mean(self.prop, self._ego(), self.n_layers)
        return all_emb[: self.n_users], all_emb[self.n_users:]

    def calculate_loss(self, user, pos_item, neg_item, generator=None,
                       weight=None):
        """(mf, reg) for one batch of int64 ids [B], weighted by `weight`
        (or ones); nothing is random."""
        weight = self.sample_weight(user, weight)
        user_all, item_all = self.forward()
        u_e = user_all[user]
        mf_loss = bpr_loss((u_e * item_all[pos_item]).sum(1),
                           (u_e * item_all[neg_item]).sum(1), weight=weight)
        reg_loss = self.reg_weight * emb_loss(
            self.user_embedding[user],
            self.item_embedding[pos_item],
            self.item_embedding[neg_item],
            weight=weight,
        )
        return mf_loss, reg_loss
