# coding: utf-8
"""CIKM_Model / HealthRec (CIKM 2024), serving half (counterpart of
`foodrec_tpu/models/cikm_model.py`; reference FoodRec/models/cikm_model.py).

Serving is the two-stage LightGCN of `forward` (cikm_model.py:195-204):
recipe-ingredient propagation (n_layers hops) over an [items; ingredients]
node space feeds the item side of user-item propagation (ui_layers hops);
both readouts are layer means, and scores are dot products.

The module holds the parameters serving reads: `user_embedding`,
`item_embedding` and `ingre_embedding` (with its [n_ingredients+1] pad row,
which `forward` leaves out of propagation). The encoder, the two target
attentions, the health MLP, the modality projections and the modality tables
arrive with `calculate_loss` in the training slice, so serving never puts the
image table on the card.
"""

import torch
from torch import nn

from foodrec_tpu_torch.common.init import xavier_uniform
from foodrec_tpu_torch.models import register
from foodrec_tpu_torch.models.base import GeneralRecommender
from foodrec_tpu_torch.ops.graph import (
    bipartite_offset_edges,
    sym_normalized_adjacency,
    ui_bipartite_edges,
)
from foodrec_tpu_torch.ops.spmm import Propagator, propagate_mean


@register("CIKM_Model")
class CIKM_Model(GeneralRecommender):
    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        self.n_ingredients = dataset.num_ingredients
        self.n_layers = config["n_layers"]
        self.ui_layers = config["ui_layers"]
        impl = config["spmm_impl"] or "auto"

        # user-item graph (cikm_model.py:139-180)
        rows, cols = ui_bipartite_edges(dataset.train_coo_matrix, self.n_users)
        self.ui_prop = Propagator(
            sym_normalized_adjacency(rows, cols, self.n_users + self.n_items),
            impl=impl, compute_dtype=config["spmm_dtype"], device=self.device)

        # recipe-ingredient graph over items+ingredients (cikm_model.py:91-134)
        ri_rows, ri_cols = bipartite_offset_edges(
            dataset.rIngre_triples, offset_head=0, offset_tail=self.n_items)
        self.ri_prop = Propagator(
            sym_normalized_adjacency(ri_rows, ri_cols,
                                     self.n_items + self.n_ingredients),
            impl=impl, compute_dtype=config["spmm_dtype"], device=self.device)

        d = self.embedding_size
        self.user_embedding = nn.Parameter(
            torch.empty(self.n_users, d, device=self.device))
        self.item_embedding = nn.Parameter(
            torch.empty(self.n_items, d, device=self.device))
        self.ingre_embedding = nn.Parameter(
            torch.empty(self.n_ingredients + 1, d, device=self.device))
        self.init_params(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_params(self, generator):
        """xavier_uniform with torch fans for each table, in the JAX
        package's leaf order (user, item, ingredient)."""
        for p in (self.user_embedding, self.item_embedding,
                  self.ingre_embedding):
            p.copy_(xavier_uniform(tuple(p.shape), generator))

    def forward(self):
        ingre = self.ingre_embedding
        ir_ego = torch.cat([self.item_embedding, ingre[:-1]], dim=0)
        ir_all = propagate_mean(self.ri_prop, ir_ego, self.n_layers)
        item_ir = ir_all[: self.n_items]
        ingre_ir = ir_all[self.n_items:]

        ui_ego = torch.cat([self.user_embedding, item_ir], dim=0)
        ui_all = propagate_mean(self.ui_prop, ui_ego, self.ui_layers)
        return ui_all[: self.n_users], ui_all[self.n_users:], ingre_ir
