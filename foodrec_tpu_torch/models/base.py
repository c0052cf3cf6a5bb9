# coding: utf-8
"""Model contract (counterpart of `foodrec_tpu/models/base.py`; reference
FoodRec/common/abstract_recommender.py:8-91).

A model is an `nn.Module` that holds its parameters and, as registered
buffers, its graph tables and item side tables. It reads its arrays from the
dataset's `device_data` (a `DeviceData`, attached by the caller as in the
JAX package). Training calls

    calculate_loss(user, pos_item, neg_item, generator)
                                          -> tuple of scalar losses, summed
                                             for the gradient

and evaluation splits into

    eval_cache()                          -> (user_emb, item_emb), the graph
                                             propagation, once per evaluation
    score_from_cache(cache, users, cand)  -> [B, C] candidate scores
    score_items(cache, users, items)      -> [B, C] scores against one shared
                                             item list (full-catalog top-k)
"""

import torch
from torch import nn


class GeneralRecommender(nn.Module):
    def __init__(self, config, dataset):
        super().__init__()
        self.config = config
        self.device = torch.device(config["device"])
        self.dd = dataset.device_data
        self.n_users = dataset.n_users
        self.n_items = dataset.n_items
        self.embedding_size = config["embedding_size"]

    def forward(self):
        raise NotImplementedError

    def calculate_loss(self, user, pos_item, neg_item, generator=None):
        raise NotImplementedError

    @torch.no_grad()
    def eval_cache(self):
        return self.forward()[:2]

    def score_from_cache(self, cache, users, cand):
        user_emb, item_emb = cache[:2]
        return torch.einsum("bd,bcd->bc", user_emb[users], item_emb[cand])

    def score_items(self, cache, users, items):
        user_emb, item_emb = cache[:2]
        return user_emb[users] @ item_emb[items].T

    def score_candidates(self, users, cand):
        return self.score_from_cache(self.eval_cache(), users, cand)
