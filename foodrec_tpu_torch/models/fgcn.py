# coding: utf-8
"""FGCN: hierarchical GNN baseline (counterpart of
`foodrec_tpu/models/fgcn.py`; reference FoodRec/models/fgcn.py).

Three stacked graphs (fgcn.py:149-183), each row-normalized D^-1 A over the
symmetrized edge set (fgcn.py:84-106), so none is symmetric and the SpMM
backward runs on A^T's own tables:

  * ingredient-ingredient (`ii_prop`): `n_layers` hops of a GCN with one
    shared linear `w1_conv`, layer-mean readout
  * item-ingredient (`ir_prop`, items then ingredients) and user-item
    (`ru_prop`, users then items): Aggregator stacks (gcn / graphsage / bi,
    fgcn.py:219-263) with leaky_relu at slope 0.01 and message dropout,
    each layer's output L2-normalized (1e-12 clamp), layer-mean readout

Faithful quirks kept from the JAX package: the item side returned is the raw
`item_id_embedding` (fgcn.py:185-194), so the item propagation reaches only
the users; the ingredient pad row takes no part (and no gradient). The
message dropout draws from `calculate_loss`'s generator, ir stack then ru
stack, one mask per hop; serving runs without it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from foodrec_tpu_torch.common.init import (
    linear_apply,
    linear_params,
    xavier_normal,
)
from foodrec_tpu_torch.common.loss import bpr_loss, emb_loss, normalize
from foodrec_tpu_torch.common.module import dropout
from foodrec_tpu_torch.models import register
from foodrec_tpu_torch.models.base import GeneralRecommender, as_parameters
from foodrec_tpu_torch.ops.graph import row_normalized_adjacency

AGGREGATORS = ("gcn", "graphsage", "bi")


@register("FGCN")
class FGCN(GeneralRecommender):
    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        self.n_ingredients = dataset.num_ingredients
        self.reg_weight = config["reg_weight"]
        self.aggregator_type = config["aggregator_type"]
        self.mess_dropout = config["mess_dropout"]
        self.layers = config["layers"]
        self.n_layers = config["n_layers"]
        if self.aggregator_type not in AGGREGATORS:
            raise NotImplementedError(self.aggregator_type)
        nu, ni, ng = self.n_users, self.n_items, self.n_ingredients

        # (recipe + n_users, user) / (ingredient + n_items, recipe) / (t, h)
        # edge sets (fgcn.py:108-147)
        ur, ri, ii = (dataset.uRecipe_triples, dataset.rIngre_triples,
                      dataset.iIngre_triples)
        self.ru_prop = self.propagator(
            row_normalized_adjacency(ur[:, 1] + nu, ur[:, 0], nu + ni))
        self.ir_prop = self.propagator(
            row_normalized_adjacency(ri[:, 1] + ni, ri[:, 0], ni + ng))
        self.ii_prop = self.propagator(
            row_normalized_adjacency(ii[:, 1], ii[:, 0], ng))

        # leaf order of the JAX package's init_params (fgcn.py:58-90)
        g = generator or torch.Generator().manual_seed(0)
        d = self.embedding_size
        self.user_embedding = nn.Parameter(
            xavier_normal((nu, d), g).to(self.device))
        self.item_id_embedding = nn.Parameter(
            xavier_normal((ni, d), g).to(self.device))
        self.ingre_embedding = nn.Parameter(
            xavier_normal((ng + 1, d), g).to(self.device))
        self.w1_conv = as_parameters(linear_params(d, d, g), self.device)
        self.ir_aggs = as_parameters(self._agg_params(g), self.device)
        self.ru_aggs = as_parameters(self._agg_params(g), self.device)

    def _agg_params(self, g):
        out = []
        for d_in, d_out in zip(self.layers[:-1], self.layers[1:]):
            if self.aggregator_type == "gcn":
                out.append({"W": linear_params(d_in, d_out, g)})
            elif self.aggregator_type == "graphsage":
                out.append({"W": linear_params(2 * d_in, d_out, g)})
            else:
                out.append({"W1": linear_params(d_in, d_out, g),
                            "W2": linear_params(d_in, d_out, g)})
        return out

    def _aggregate(self, p, prop, x, generator, training):
        """One Aggregator hop (fgcn.py:246-263)."""
        side = prop(x)
        if self.aggregator_type == "gcn":
            out = F.leaky_relu(linear_apply(p["W"], x + side))
        elif self.aggregator_type == "graphsage":
            out = F.leaky_relu(linear_apply(p["W"], torch.cat([x, side], 1)))
        else:  # bi-interaction
            out = (F.leaky_relu(linear_apply(p["W1"], x + side))
                   + F.leaky_relu(linear_apply(p["W2"], x * side)))
        return dropout(out, self.mess_dropout, generator) if training else out

    def _stack(self, prop, aggs, ego, generator, training):
        outs, x = [ego], ego
        for p in aggs:
            x = self._aggregate(p, prop, x, generator, training)
            outs.append(normalize(x, dim=1))
        return sum(outs) / len(outs)

    def gnn_encode(self, generator=None, training=False):
        # ingredient-ingredient GCN: shared linear, then propagate
        # (fgcn.py:149-158); the pad row (last) is left out
        x = acc = self.ingre_embedding[:-1]
        for _ in range(self.n_layers):
            x = self.ii_prop(linear_apply(self.w1_conv, x))
            acc = acc + x
        ingre_ii = acc / (self.n_layers + 1)

        ir_all = self._stack(
            self.ir_prop, self.ir_aggs,
            torch.cat([self.item_id_embedding, ingre_ii]), generator, training)
        ru_all = self._stack(
            self.ru_prop, self.ru_aggs,
            torch.cat([self.user_embedding, ir_all[: self.n_items]]),
            generator, training)
        # items returned raw (fgcn.py:194)
        return (ru_all[: self.n_users], self.item_id_embedding,
                ir_all[self.n_items:])

    def forward(self):
        return self.gnn_encode()[:2]

    def calculate_loss(self, user, pos_item, neg_item, generator=None,
                       weight=None):
        """(mf, reg) for one batch of int64 ids [B]; `generator` draws the
        message dropout."""
        weight = self.sample_weight(user, weight)
        user_all, item_all, _ = self.gnn_encode(generator, training=True)
        u_e = user_all[user]
        pos_e = item_all[pos_item]
        neg_e = item_all[neg_item]
        # mean-form logsigmoid BPR (fgcn.py:196-203)
        mf = bpr_loss((u_e * pos_e).sum(1), (u_e * neg_e).sum(1),
                      weight=weight)
        reg = self.reg_weight * emb_loss(u_e, pos_e, neg_e, weight=weight)
        return mf, reg
