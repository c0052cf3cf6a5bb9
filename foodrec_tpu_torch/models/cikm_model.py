# coding: utf-8
"""CIKM_Model / HealthRec (CIKM 2024), the flagship model (counterpart of
`foodrec_tpu/models/cikm_model.py`; reference FoodRec/models/cikm_model.py).

  * two-stage LightGCN (`forward`, cikm_model.py:195-204): recipe-ingredient
    propagation (n_layers hops) over an [items; ingredients] node space feeds
    the item side of user-item propagation (ui_layers hops); both readouts
    are layer means, and serving scores are dot products
  * `calculate_loss` (cikm_model.py:206-292): a post-LN transformer encoder
    over the padded 20-token ingredient sequences; two target attentions
    (multimodal queries over encoded ingredients -> item_health, encoded
    ingredients over the multimodal features -> item_mm); the health BCE in
    logit space, BPR, the KD hinge 1 - cos(item_know, item_emb) and the reg
    term, as the tuple (mf, health, kd, reg)

The parameters are named like the JAX package's pytree (`encoder.0.in_proj_w`,
`health_mlp.l1.w`, ...), with linear weights stored [in, out], so
`utils/weights.py` carries them over one to one. The image and text tables
are trainable parameters, as the reference trains them, unless
`freeze_modality_tables: True` keeps them as buffers, out of the optimizer
(the JAX package's opt-in, cikm_model.py:132-135). With
`use_health_level_multi_hot: False` the health head's width is the
dataset's `num_health_level` (0 unless `load_RecipeHealth_graph` is set)
and its target is all zeros, as in the JAX package (cikm_model.py:83-86,
120-122).

Faithful quirks kept from the JAX package:
  * forward()'s propagated ingredient output is not used by the loss, which
    reads the raw ingre_embedding table
  * the ingredient pad row (id = n_ingredients) trains through the encoder
    and KD paths but is detached on the reg path (cikm_model.py:179-193)
  * F.normalize on 3-D tensors runs along dim 1, the positions
    (cikm_model.py:245-253)
  * item_know sums the normalized rows over all 20 positions (pads included)
    and divides by the true ingredient count
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
from foodrec_tpu_torch.common.loss import bpr_loss, cosine, emb_loss, normalize
from foodrec_tpu_torch.common.module import (
    mlp_2layer_apply,
    mlp_2layer_params,
    target_attention_apply,
    target_attention_params,
    transformer_encoder_apply,
    transformer_encoder_params,
)
from foodrec_tpu_torch.models import register
from foodrec_tpu_torch.models.base import GeneralRecommender, as_parameters
from foodrec_tpu_torch.ops.graph import (
    bipartite_offset_edges,
    sym_normalized_adjacency,
    ui_bipartite_edges,
)
from foodrec_tpu_torch.ops.spmm import propagate_mean
from foodrec_tpu_torch.parallel.mesh import batch_sum


def _softplus(x):
    """log(1 + e^x) as jax.nn.softplus computes it; F.softplus returns x
    itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


@register("CIKM_Model")
class CIKM_Model(GeneralRecommender):
    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        dd = self.dd
        self.n_ingredients = dataset.num_ingredients
        self.n_layers = config["n_layers"]
        self.ui_layers = config["ui_layers"]
        self.reg_weight = config["reg_weight"]
        self.loss_kd = config["loss_kd"]
        self.loss_health = config["loss_health"]
        self.kd_threshold = config["kd_threshold"]
        self.nhead = config["num_attention_heads"]
        self.attn_dropout = config["attention_probs_dropout_prob"]
        self.hidden_act = config["hidden_act"]
        self.freeze_mm = bool(config["freeze_modality_tables"])

        # user-item graph (cikm_model.py:139-180)
        rows, cols = ui_bipartite_edges(dataset.train_coo_matrix, self.n_users)
        self.ui_prop = self.propagator(
            sym_normalized_adjacency(rows, cols, self.n_users + self.n_items))

        # recipe-ingredient graph over items+ingredients (cikm_model.py:91-134)
        ri_rows, ri_cols = bipartite_offset_edges(
            dataset.rIngre_triples, offset_head=0, offset_tail=self.n_items)
        self.ri_prop = self.propagator(
            sym_normalized_adjacency(ri_rows, ri_cols,
                                     self.n_items + self.n_ingredients))

        # item side tables, gathered per batch (cikm_model.py:115-124)
        if config["use_health_level_multi_hot"]:
            n_health = len(dataset.health_level_multi_hot[0])
        else:
            n_health = dataset.num_health_level
        health_mh = dd.health_mh
        if health_mh is None:
            health_mh = np.zeros((self.n_items, n_health), np.float32)
        for name, arr, dtype in (("ingre_codes", dd.ingre_codes, torch.int64),
                                 ("ingre_num", dd.ingre_num, torch.int32),
                                 ("health_mh", health_mh, torch.float32)):
            self.register_buffer(name, torch.as_tensor(arr).to(
                device=self.device, dtype=dtype), persistent=False)

        # leaf order of the JAX package's init_params (cikm_model.py:137-159)
        g = generator or torch.Generator().manual_seed(0)
        d = self.embedding_size
        img = torch.from_numpy(dd.img.copy())
        txt = torch.from_numpy(dd.txt.copy())
        self.user_embedding = nn.Parameter(
            xavier_uniform((self.n_users, d), g).to(self.device))
        self.item_embedding = nn.Parameter(
            xavier_uniform((self.n_items, d), g).to(self.device))
        # pad row (last) trains via encoder/KD, detached on the reg path
        self.ingre_embedding = nn.Parameter(
            xavier_uniform((self.n_ingredients + 1, d), g).to(self.device))
        self.encoder = as_parameters(transformer_encoder_params(
            g, d, 4 * d, config["num_hidden_layers"]), self.device)
        self.mm_target_atten = as_parameters(
            target_attention_params(d // self.nhead), self.device)
        self.ingre_target_atten = as_parameters(
            target_attention_params(d // self.nhead), self.device)
        self.health_mlp = as_parameters(
            mlp_2layer_params(g, d, d, n_health), self.device)
        self.image_trs = as_parameters(
            torch_linear(img.shape[1], d, g, init=xavier_normal), self.device)
        self.text_trs = as_parameters(
            torch_linear(txt.shape[1], d, g, init=xavier_normal), self.device)
        if self.freeze_mm:
            # constant tables, not in the state_dict (nor in the JAX pytree)
            self.register_buffer("image_embedding", img.to(self.device),
                                 persistent=False)
            self.register_buffer("text_embedding", txt.to(self.device),
                                 persistent=False)
        else:
            self.image_embedding = nn.Parameter(img.to(self.device))
            self.text_embedding = nn.Parameter(txt.to(self.device))

    def forward(self):
        ingre = self.ingre_embedding
        ir_ego = torch.cat([self.item_embedding, ingre[:-1]], dim=0)
        ir_all = propagate_mean(self.ri_prop, ir_ego, self.n_layers)
        item_ir = ir_all[: self.n_items]
        ingre_ir = ir_all[self.n_items:]

        ui_ego = torch.cat([self.user_embedding, item_ir], dim=0)
        ui_all = propagate_mean(self.ui_prop, ui_ego, self.ui_layers)
        return ui_all[: self.n_users], ui_all[self.n_users:], ingre_ir

    def calculate_loss(self, user, pos_item, neg_item, generator=None,
                       weight=None):
        """(mf, health, kd, reg) for one batch of int64 ids [B]; `generator`
        draws the encoder's dropout. The losses take the JAX epoch's weighted
        formulas, with `weight` (the padded final batch's) or ones."""
        weight = self.sample_weight(user, weight)
        w2 = torch.cat([weight, weight])
        items2 = torch.cat([pos_item, neg_item])              # [2B]
        ingredients = self.ingre_codes[items2]                # [2B, 20]
        ingre_num = self.ingre_num[items2]                    # [2B]
        health_level = self.health_mh[items2]                 # [2B, H]

        user_all, item_all, _ = self.forward()
        ingre_table = self.ingre_embedding

        # ingredient transformer (cikm_model.py:228-238)
        encoded = transformer_encoder_apply(
            self.encoder, ingre_table[ingredients], self.nhead,
            pad_mask=ingredients == self.n_ingredients, act=self.hidden_act,
            drop_rate=self.attn_dropout, generator=generator)

        # multimodal queries (cikm_model.py:240-246)
        mm_query = torch.stack(
            [linear_apply(self.image_trs,
                          self.table_rows("image_embedding", items2)),
             linear_apply(self.text_trs,
                          self.table_rows("text_embedding", items2))],
            dim=1)                                            # [2B, 2, D]
        item_health = target_attention_apply(
            self.mm_target_atten, mm_query, encoded, self.nhead,
            seq_ids=ingredients, padding_idx=self.n_ingredients)
        item_mm = target_attention_apply(
            self.ingre_target_atten, encoded, mm_query, self.nhead)

        # pads included in the sum, the true count in the divisor
        item_know = normalize(item_mm, dim=1).sum(1) / ingre_num[:, None]

        # health BCE in logit space: log(sigmoid(z)) = -softplus(-z), with
        # torch BCELoss's clamp of the log at -100 (cikm_model.py:254-264)
        health_logit = mlp_2layer_apply(
            self.health_mlp, normalize(item_health, dim=1).mean(1))
        log_p = (-_softplus(-health_logit)).clamp_min(-100.0)
        log_1mp = (-_softplus(health_logit)).clamp_min(-100.0)
        bce = -(health_level * log_p + (1 - health_level) * log_1mp)
        health_loss = batch_sum(bce * w2[:, None])

        # BPR (cikm_model.py:266-271)
        u_e = user_all[user]
        pos_e = item_all[pos_item]
        neg_e = item_all[neg_item]
        mf_loss = bpr_loss((u_e * pos_e).sum(1), (u_e * neg_e).sum(1),
                           weight=weight)

        # KD hinge (cikm_model.py:273-279)
        cos = cosine(item_know, torch.cat([pos_e, neg_e], dim=0))
        kd = 1 - batch_sum(cos * w2) / batch_sum(w2).clamp_min(1.0)
        kd_loss = (kd - self.kd_threshold).clamp_min(0.0)

        # reg (cikm_model.py:281-290): the pad row gets no gradient here
        reg_table = torch.cat([ingre_table[:-1], ingre_table[-1:].detach()])
        reg_loss = self.reg_weight * emb_loss(
            self.user_embedding[user],
            self.item_embedding[pos_item],
            self.item_embedding[neg_item],
            reg_table[self.ingre_codes[pos_item]],
            reg_table[self.ingre_codes[neg_item]],
            weight=weight,
        )
        return (mf_loss, self.loss_health * health_loss,
                self.loss_kd * kd_loss, reg_loss)
