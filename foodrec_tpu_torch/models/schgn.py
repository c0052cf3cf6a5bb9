# coding: utf-8
"""SCHGN: heterogeneous-graph multimodal recommender, the reference's default
model (counterpart of `foodrec_tpu/models/schgn.py`; reference
FoodRec/models/schgn.py, runner.py default -m SCHGN).

  * one GCNConv + tanh over users, items, ingredients and calorie levels
    with the directed edges items -> users, ingredients -> items and calorie
    levels -> items plus self loops (schgn.py:29-41, 139-151): one hop of
    `gcn_prop` over `gcn_conv_adjacency`, which is not symmetric, so the
    SpMM backward runs on A^T's own tables (the calorie-level rows of A^T
    are the long ones)
  * truncated-normal embedding tables, a zero ingredient pad row and a
    learnable mask token (schgn.py:80-89, 120-125)
  * two additive attentions: over the 20 ingredient slots, conditioned on
    the user and the image (schgn.py:159-184), and over the four components
    [item, ingredients, image, calorie level] (schgn.py:186-206)
  * score = an MLP over [u, item, u * item] with dropout 0.5 before the
    ReLU in training (schgn.py:265-268)
  * masked-ingredient SSL: the post-LN encoder over the masked sequence and
    a BCE on sigmoid(pos - neg) at the masked slots (schgn.py:208-232)
  * sum-form BPR and per-tensor L2 regs (schgn.py:305-316)

`schgn_faithful_interleave: True` (the shipped default) keeps the
reference's `.view(b, -1)` of the component scores, which mixes the scores
of a flattened block of samples (schgn.py:198-200), so a sample's score
depends on the block it is scored in; False takes the per-sample fix.

Scoring takes users and items that broadcast against each other (users
[B, 1] against items [B, C] or [C]): the per-item tables are gathered once
per item, and the ingredient attention's [.., 3D] input is applied as three
[D, D] products instead of a concatenation, so a [64, 8192] top-k block
holds [64, 8192, 20, 64] and not [.., 192].
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from foodrec_tpu_torch.common.init import (
    default_linear,
    tn_linear,
    truncated_normal,
)
from foodrec_tpu_torch.common.loss import l2_loss
from foodrec_tpu_torch.common.module import (
    apply_dropout_mask,
    bert_encoder_apply,
    bert_encoder_masks,
    bert_encoder_params,
    dropout,
)
from foodrec_tpu_torch.data.sampling import ssl_mask_ingredients
from foodrec_tpu_torch.models import register
from foodrec_tpu_torch.models.base import GeneralRecommender, as_parameters
from foodrec_tpu_torch.ops.gather import RowIds, gather_rows
from foodrec_tpu_torch.ops.graph import gcn_conv_adjacency
from foodrec_tpu_torch.parallel.mesh import (
    batch_sum,
    gather_batch_rows,
    take_batch_rows,
)
from foodrec_tpu_torch.utils.trace import span


@register("SCHGN")
class SCHGN(GeneralRecommender):
    # the candidate-wise attention is memory-heavy: eval user blocks of 32
    eval_batch_cap = 32

    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        dd = self.dd
        self.n_ingredients = dataset.num_ingredients
        self.n_health = dataset.num_calories_level  # calorie levels
        self.regs = config["regs"]
        self.reg_image = config["reg_image"]
        self.reg_w = config["reg_w"]
        self.reg_g = config["reg_g"]
        self.reg_health = config["reg_health"]
        self.ssl = config["ssl"]
        self.use_ssl = bool(config["SCHGN_ssl"])
        self.nhead = config["num_attention_heads"]
        self.hidden_dropout = config["hidden_dropout_prob"]
        self.attn_dropout = config["attention_probs_dropout_prob"]
        self.hidden_act = config["hidden_act"]
        self.masked_p = 0.2  # dataloader.py:17
        self.faithful_interleave = bool(config["schgn_faithful_interleave"])

        # node order users | items | ingredients | calorie levels
        nu, ni, ng = self.n_users, self.n_items, self.n_ingredients
        ur, ri, rc = (np.asarray(t, dtype=np.int64) for t in (
            dataset.uRecipe_triples, dataset.rIngre_triples,
            dataset.rCalories_triples))
        src = np.concatenate([ur[:, 1] + nu,              # item -> user
                              ri[:, 1] + nu + ni,         # ingredient -> item
                              rc[:, 1] + nu + ni + ng])   # level -> item
        dst = np.concatenate([ur[:, 0], ri[:, 0] + nu, rc[:, 0] + nu])
        self.gcn_prop = self.propagator(
            gcn_conv_adjacency(src, dst, nu + ni + ng + self.n_health))

        cal = dd.cal_level if dd.cal_level is not None else np.zeros(ni)
        for name, arr, dtype in (("ingre_codes", dd.ingre_codes, torch.int64),
                                 ("ingre_num", dd.ingre_num, torch.int64),
                                 ("cal_level", cal, torch.int64),
                                 ("img", dd.img, torch.float32)):
            self.register_buffer(name, torch.tensor(
                arr, dtype=dtype, device=self.device), persistent=False)

        # the JAX package's init_params leaves (schgn.py:120-150)
        g = generator or torch.Generator().manual_seed(0)
        d = self.embedding_size
        img_size = dd.img.shape[1]

        def table(n):
            return nn.Parameter(
                truncated_normal((n, d), g, std=0.01).to(self.device))

        def params(tree):
            return as_parameters(tree, self.device)

        self.user_embed = table(nu)
        self.item_embed = table(ni)
        self.ingre_embed_first = table(ng)
        self.ingre_embed_mask = table(1)
        self.health_embed = table(self.n_health)
        self.gcn = params(tn_linear(d, d, g, math.sqrt(2.0 / (d + d))))
        self.img_trans = params(tn_linear(img_size, d, g,
                                          math.sqrt(2.0 / (img_size + d))))
        self.W_att_ingre = params(tn_linear(3 * d, d, g,
                                            math.sqrt(2.0 / (4 * d)),
                                            math.sqrt(2.0 / (2 * d))))
        self.h_att_ingre = params({"w": torch.ones(d, 1)})
        self.W_att_comp = params(tn_linear(2 * d, d, g,
                                           math.sqrt(2.0 / (3 * d)),
                                           math.sqrt(2.0 / (2 * d))))
        self.h_att_comp = params({"w": torch.ones(d, 1)})
        self.W_concat = params(tn_linear(3 * d, d, g,
                                         math.sqrt(2.0 / (4 * d)),
                                         math.sqrt(2.0 / (2 * d))))
        self.output_mlp = params(tn_linear(d, 1, g, math.sqrt(2.0 / (2 * d)),
                                           bias=False))
        self.mip_norm = params(default_linear(d, d, g))
        self.encoder = params(bert_encoder_params(
            g, d, config["inner_size"], config["num_hidden_layers"]))

    # ------------------------------------------------------------------ core
    def _gcn(self):
        """One GCNConv + tanh over the whole graph (schgn.py:29-41,
        247-254): the user, item, [ingredient; 0; mask] and calorie-level
        tables."""
        x = torch.cat([self.user_embed, self.item_embed,
                       self.ingre_embed_first, self.health_embed])
        y = torch.tanh(self.gcn_prop(x) @ self.gcn["w"] + self.gcn["b"])
        u, i, g, h = y.split([self.n_users, self.n_items, self.n_ingredients,
                              self.n_health])
        g_full = torch.cat([g, x.new_zeros(1, x.shape[1]),
                            self.ingre_embed_mask])
        return u, i, g_full, h

    def _ingre_table(self):
        """[ingredients; 0 (the pad); mask token]."""
        first = self.ingre_embed_first
        return torch.cat([first, first.new_zeros(1, first.shape[1]),
                          self.ingre_embed_mask])

    def _attention_ingredient_level(self, ingre_emb, u_emb, img_emb,
                                    ingre_num):
        """(schgn.py:159-184): additive attention over the ingredient slots
        conditioned on user and image, slots >= ingre_num masked by
        subtracting 1e12. ingre_emb [*I, L, D] and img_emb [*I, D] follow
        the items, u_emb [*U, D] the users."""
        w, d = self.W_att_ingre["w"], u_emb.shape[-1]
        ctx = u_emb @ w[d:2 * d] + (img_emb @ w[2 * d:]
                                    + self.W_att_ingre["b"])
        h = torch.tanh(ingre_emb @ w[:d] + ctx[..., None, :])
        a = (h @ self.h_att_ingre["w"])[..., 0]                # [*lead, L]
        slot = torch.arange(ingre_emb.shape[-2], device=a.device)
        a = torch.where(slot >= ingre_num[..., None], a - 1e12, a)
        weights = torch.softmax(a, dim=-1)
        return (weights[..., None, :] @ ingre_emb)[..., 0, :]

    def _attention_component_level(self, u_emb, comps):
        """(schgn.py:186-206) over comps [*lead, 4, D]; faithful mode
        re-reads the component-major flattened scores row-major."""
        u_tile = u_emb[..., None, :].expand(comps.shape)
        h = torch.tanh(torch.cat([u_tile, comps], dim=-1)
                       @ self.W_att_comp["w"] + self.W_att_comp["b"])
        scores = (h @ self.h_att_comp["w"])[..., 0]           # [*lead, 4]
        if self.faithful_interleave:
            # mixes the samples of the block: under a `data` mesh, the
            # global batch's (a train step's lead is the batch)
            scores = gather_batch_rows(scores)
            lead = scores.shape[:-1]
            scores = take_batch_rows(
                scores.reshape(-1, 4).T.reshape(lead + (4,)))
        weights = torch.softmax(scores, dim=-1)
        return (weights[..., None, :] @ comps)[..., 0, :]

    def _score(self, tables, users, items, generator=None, training=False,
               codes=None, mask=None):
        """compute_score (schgn.py:234-268) for int64 `users` and `items`
        that broadcast against each other; `training` applies the score
        dropout, drawn from `generator`, and a pre-drawn `mask` applies it
        in its stead. `codes`: the items' ingredient codes as a `RowIds`
        whose sorted order other gathers share."""
        with span("score"):
            u_gcn, i_gcn, g_gcn, h_gcn = tables
            if codes is None:
                codes = RowIds(self.ingre_codes[items])
            hl = self.cal_level[items]
            u_emb = self.user_embed[users] + u_gcn[users]
            i_emb = self.item_embed[items] + i_gcn[items]
            # table[ingre] + g_gcn[ingre], as one gather of the tables' sum
            ingre_emb = gather_rows(self._ingre_table() + g_gcn, codes)
            hl_emb = self.health_embed[hl] + h_gcn[hl]
            img_emb = (self.img[items] @ self.img_trans["w"]
                       + self.img_trans["b"])

            ingre_att = self._attention_ingredient_level(
                ingre_emb, u_emb, img_emb, self.ingre_num[items])
            lead = ingre_att.shape[:-1]
            comps = torch.stack([t.expand(ingre_att.shape) for t in
                                 (i_emb, ingre_att, img_emb, hl_emb)], dim=-2)
            u_emb = u_emb.expand(ingre_att.shape)
            item_att = self._attention_component_level(u_emb, comps)
            ui = torch.cat([u_emb, item_att, u_emb * item_att], dim=-1)
            hidden = ui @ self.W_concat["w"] + self.W_concat["b"]
            if mask is not None:
                hidden = apply_dropout_mask(hidden, mask, 0.5)
            elif training:
                hidden = dropout(hidden, 0.5, generator, rows=True)
            out = F.relu(hidden) @ self.output_mlp["w"]
            return out.reshape(lead)

    # ------------------------------------------------------------------- SSL
    def _ssl_loss(self, g_gcn_table, items, generator):
        """Masked-ingredient prediction (schgn.py:208-232) on sequences
        masked on the device."""
        with span("ssl"):
            seqs = self._ssl_seqs(items, generator)
            return self._ssl_loss_from_seqs(g_gcn_table, *seqs, generator)

    def _ssl_seqs(self, items, generator):
        """The items' (masked, positive, negative) ingredient sequences,
        drawn on the device."""
        return ssl_mask_ingredients(
            self.ingre_codes[items], self.ingre_num[items],
            self.n_ingredients, generator, masked_p=self.masked_p)

    def _ssl_loss_from_seqs(self, g_gcn_table, masked_seq, pos_seq, neg_seq,
                            generator=None, masks=None):
        """The SSL loss of given sequences; the encoder's dropout draws from
        `generator`, or takes `masks` (`bert_encoder_masks`)."""
        ingre_emb = gather_rows(g_gcn_table, masked_seq)
        attn_mask = ((masked_seq == self.n_ingredients).to(ingre_emb.dtype)
                     * -1e8)[:, None, None, :]
        enc = bert_encoder_apply(
            self.encoder, ingre_emb, attn_mask, self.nhead,
            act=self.hidden_act, hidden_dropout=self.hidden_dropout,
            attn_dropout=self.attn_dropout, generator=generator, masks=masks)
        ingre_table = self._ingre_table()
        mip = enc @ self.mip_norm["w"] + self.mip_norm["b"]

        def score(target):
            return torch.sigmoid((mip * gather_rows(ingre_table, target))
                                 .sum(-1))

        dist = torch.sigmoid(score(pos_seq) - score(neg_seq))
        bce = -torch.log(dist).clamp_min(-100.0)  # BCE against ones
        mip_mask = masked_seq == self.n_ingredients + 1
        return batch_sum(bce * mip_mask)

    # ------------------------------------------------------------------ loss
    def calculate_loss(self, user, pos_item, neg_item, generator=None,
                       weight=None, deterministic=False, ssl_seqs=None):
        """(bpr, reg, ssl) for one batch of int64 ids [B]; `generator` draws
        the score dropout, the SSL masks and the encoder's dropout. The
        losses take the JAX epoch's weighted formulas, with `weight` (the
        padded final batch's) or ones. Test seams, as the JAX package's:
        `deterministic` turns off the score dropout only, and
        `ssl_seqs=(masked, pos, neg)` replaces the SSL sequences drawn on
        the device. With `step_graphs` (a single-process Trainer's on the
        card) every draw is taken here, after the propagation, in the same
        order (`_loss_draws`), and `_loss_block` runs through it."""
        args = (user, pos_item, neg_item, weight, *self._gcn())
        if self.step_graphs is None:
            return self._loss_block(*args, None, None, *(ssl_seqs or ()),
                                    generator=generator,
                                    training=not deterministic)
        draws = self._loss_draws(pos_item, generator, not deterministic,
                                 ssl_seqs)
        return self.step_graphs.run(self, self._loss_block, args + draws)

    def _loss_draws(self, pos_item, generator, training, ssl_seqs):
        """The step's draws in the order the loss takes them: the
        positives' and the negatives' score dropout masks [B, D] (None
        without `training`); with the SSL on, its (masked, positive,
        negative) sequences (`ssl_seqs` where given) and its encoder's
        dropout masks."""
        b, d = pos_item.shape[0], self.embedding_size
        ones = self.user_embed.new_ones((b, d))
        draws = tuple(dropout(ones, 0.5, generator, rows=True) if training
                      else None for _ in "pn")
        if not self.use_ssl:
            return draws
        seqs = (tuple(ssl_seqs) if ssl_seqs is not None
                else self._ssl_seqs(pos_item, generator))
        masks = bert_encoder_masks(
            self.encoder, (b, self.ingre_codes.shape[1], d), self.nhead,
            self.hidden_dropout, self.attn_dropout, generator, ones.device,
            ones.dtype)
        return draws + seqs + tuple(masks)

    def _loss_block(self, user, pos_item, neg_item, weight, u_gcn, i_gcn,
                    g_gcn, h_gcn, pos_mask, neg_mask, *ssl_draws,
                    generator=None, training=False):
        """calculate_loss after the propagation, from its four tables and
        the draws of `_loss_draws`; where one is missing it is drawn from
        `generator`: the score dropout without `pos_mask` and `neg_mask`
        (where `training`), the SSL's sequences without `ssl_draws`, its
        encoder's dropout where `ssl_draws` holds the sequences alone."""
        weight = self.sample_weight(user, weight)
        tables = (u_gcn, i_gcn, g_gcn, h_gcn)
        # the score's and the reg's gathers share each side's sorted codes
        pos_codes = RowIds(self.ingre_codes[pos_item])
        neg_codes = RowIds(self.ingre_codes[neg_item])
        pos_scores = self._score(tables, user, pos_item, generator, training,
                                 codes=pos_codes, mask=pos_mask)
        neg_scores = self._score(tables, user, neg_item, generator, training,
                                 codes=neg_codes, mask=neg_mask)
        bpr = -batch_sum(F.logsigmoid(pos_scores - neg_scores) * weight)

        ingre_table = self._ingre_table()
        # the reference's l2 is sum(t ** 2), l2_loss halves it: x 2
        reg = self.regs * (
            l2_loss(self.user_embed[user], weight=weight)
            + l2_loss(self.item_embed[pos_item], weight=weight)
            + l2_loss(self.item_embed[neg_item], weight=weight)
            + l2_loss(gather_rows(ingre_table, pos_codes), weight=weight)
            + l2_loss(gather_rows(ingre_table, neg_codes), weight=weight)
        ) * 2.0
        reg = reg + self.reg_health * 2.0 * (
            l2_loss(self.health_embed[self.cal_level[pos_item]], weight=weight)
            + l2_loss(self.health_embed[self.cal_level[neg_item]],
                      weight=weight))
        reg = reg + self.reg_image * (self.img_trans["w"] ** 2).sum()
        reg = reg + self.reg_w * ((self.W_concat["w"] ** 2).sum()
                                  + (self.output_mlp["w"] ** 2).sum())
        reg = reg + self.reg_g * (self.gcn["w"] ** 2).sum()

        if not self.use_ssl:
            ssl = bpr.new_zeros(())
        elif ssl_draws:
            ssl = self.ssl * self._ssl_loss_from_seqs(
                g_gcn, *ssl_draws[:3], generator, masks=ssl_draws[3:] or None)
        else:
            ssl = self.ssl * self._ssl_loss(g_gcn, pos_item, generator)
        return bpr, reg, ssl

    # ------------------------------------------------------------------ eval
    def forward(self):
        return self._gcn()

    @torch.no_grad()
    def eval_cache(self):
        """The four propagated tables, detached: scoring runs per candidate."""
        return tuple(t.detach() for t in self._gcn())

    @torch.no_grad()
    def score_from_cache(self, cache, users, cand):
        return self._score(cache, users[:, None], cand)

    @torch.no_grad()
    def score_items(self, cache, users, items):
        return self._score(cache, users[:, None], items[None, :])

    @torch.no_grad()
    def full_sort_predict(self, user):
        """Scores [*user.shape, n_items] of the users against the whole
        catalog from a fresh `_gcn()` (schgn.py:318-345). The faithful
        interleave mixes the scores of the whole block, as the JAX
        package's does: a block of B users is not B single-user calls."""
        items = torch.arange(self.n_items, device=user.device)
        items = items.view((1,) * user.dim() + (self.n_items,))
        return self._score(self._gcn(), user[..., None], items)
