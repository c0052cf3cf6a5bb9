# coding: utf-8
"""PRICAI_ModelX / CLUSSL (PRICAI 2024) (counterpart of
`foodrec_tpu/models/pricai_modelx.py`; reference
FoodRec/models/pricai_modelx.py).

Three parallel item-side bipartite graphs, each over items then its extra
nodes: item-ingredient (`ingre_prop`), item-image cluster (`image_prop`) and
item-text cluster (`text_prop`), the k-means prototypes being learnable
nodes. Each is propagated `n_ri_layers` hops with a layer-mean readout; the
three item views are summed and feed `n_ui_layers` hops of user-item
LightGCN (`ui_prop`) (pricai_modelx.py:179-230). Serving scores are dot
products. The self-supervised term is the distance correlation between the
three item views over the batch's positive and negative rows
(pricai_modelx.py:263, 409-437).

`use_center_embedding` starts the prototypes from the pretrained k-means
centers `mm_cluster/{image,text}_center.npy`, projected by `image_trs` /
`text_trs` (pricai_modelx.py:75-86); otherwise they are free tables. The
ingredient pad row takes no part (and no gradient).
"""

import numpy as np
import torch
from torch import nn

from foodrec_tpu_torch.common.init import (
    linear_apply,
    torch_linear,
    xavier_normal,
    xavier_uniform,
)
from foodrec_tpu_torch.common.loss import bpr_loss, emb_loss
from foodrec_tpu_torch.common.ssl_losses import correlation_distance
from foodrec_tpu_torch.models import register
from foodrec_tpu_torch.models.base import GeneralRecommender, as_parameters
from foodrec_tpu_torch.ops.graph import (
    bipartite_offset_edges,
    sym_normalized_adjacency,
    ui_bipartite_edges,
)
from foodrec_tpu_torch.ops.spmm import propagate_mean
from foodrec_tpu_torch.parallel.mesh import gather_batch_rows


@register("PRICAI_ModelX")
class PRICAI_ModelX(GeneralRecommender):
    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        self.n_ingredients = dataset.num_ingredients
        self.n_ri_layers = config["n_ri_layers"]
        self.n_ui_layers = config["n_ui_layers"]
        self.reg_weight = config["reg_weight"]
        self.loss_cl = config["loss_cl"]
        nc = config["n_cluster"]
        self.n_cluster = int(nc[0] if isinstance(nc, (list, tuple)) else nc)

        rows, cols = ui_bipartite_edges(dataset.train_coo_matrix, self.n_users)
        self.ui_prop = self.propagator(
            sym_normalized_adjacency(rows, cols, self.n_users + self.n_items))

        def item_side(triples, n_extra):
            r, c = bipartite_offset_edges(np.asarray(triples, dtype=np.int64),
                                          offset_tail=self.n_items)
            return self.propagator(
                sym_normalized_adjacency(r, c, self.n_items + n_extra))

        self.ingre_prop = item_side(dataset.rIngre_triples, self.n_ingredients)
        self.image_prop = item_side(dataset.image_cluster_triples,
                                    self.n_cluster)
        self.text_prop = item_side(dataset.text_cluster_triples,
                                   self.n_cluster)

        # leaf order of the JAX package's init_params
        # (pricai_modelx.py:88-111)
        g = generator or torch.Generator().manual_seed(0)
        d = self.embedding_size
        self.user_embedding = nn.Parameter(
            xavier_uniform((self.n_users, d), g).to(self.device))
        self.item_embedding = nn.Parameter(
            xavier_uniform((self.n_items, d), g).to(self.device))
        self.ingre_embedding = nn.Parameter(
            xavier_uniform((self.n_ingredients + 1, d), g).to(self.device))
        self.use_center = bool(config["use_center_embedding"])
        for name in ("image", "text"):
            if self.use_center:
                center = np.load(f"{config['interaction_data_path']}"
                                 f"mm_cluster/{name}_center.npy")
                proto = torch.from_numpy(center.astype(np.float32))
                setattr(self, f"{name}_trs", as_parameters(torch_linear(
                    proto.shape[1], d, g, init=xavier_normal), self.device))
            else:
                proto = xavier_uniform((self.n_cluster, d), g)
            setattr(self, f"{name}_prototype_embedding",
                    nn.Parameter(proto.to(self.device)))

    def _prototypes(self, name):
        if self.use_center:
            return self.table_map(f"{name}_prototype_embedding",
                                  linear_apply, getattr(self, f"{name}_trs"))
        return getattr(self, f"{name}_prototype_embedding")

    def forward(self):
        def view(prop, extra):
            ego = torch.cat([self.item_embedding, extra], dim=0)
            return propagate_mean(prop, ego, self.n_ri_layers)[: self.n_items]

        item_ingre = view(self.ingre_prop, self.ingre_embedding[:-1])
        item_image = view(self.image_prop, self._prototypes("image"))
        item_text = view(self.text_prop, self._prototypes("text"))

        item_emb = item_ingre + item_image + item_text
        ui_ego = torch.cat([self.user_embedding, item_emb], dim=0)
        ui_all = propagate_mean(self.ui_prop, ui_ego, self.n_ui_layers)
        return (ui_all[: self.n_users], ui_all[self.n_users:],
                (item_image, item_text, item_ingre))

    def calculate_loss(self, user, pos_item, neg_item, generator=None,
                       weight=None):
        """(mf, loss_cl * dCor, reg) for one batch of int64 ids [B];
        nothing is random."""
        weight = self.sample_weight(user, weight)
        all_item = torch.cat([pos_item, neg_item])
        user_all, item_all, (image_v, text_v, ingre_v) = self.forward()
        # dCor reads the global batch's rows (all of them under a mesh)
        item_image = gather_batch_rows(image_v[all_item])
        item_text = gather_batch_rows(text_v[all_item])
        item_ingre = gather_batch_rows(ingre_v[all_item])

        u_e = user_all[user]
        mf_loss = bpr_loss((u_e * item_all[pos_item]).sum(1),
                           (u_e * item_all[neg_item]).sum(1), weight=weight)
        cl = (correlation_distance(item_image, item_text)
              + correlation_distance(item_image, item_ingre)
              + correlation_distance(item_ingre, item_text))
        reg_loss = self.reg_weight * emb_loss(
            self.user_embedding[user],
            self.item_embedding[pos_item],
            self.item_embedding[neg_item],
            weight=weight,
        )
        return mf_loss, self.loss_cl * cl, reg_loss
