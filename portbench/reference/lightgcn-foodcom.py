"""Plain reference of LightGCN as configured in configs/lightgcn-foodcom.yaml
(flagD 1): float32 PyTorch, no kernels, after the upstream
FoodRec/models/lightgcn.py. The item ego embedding is a trainable linear
projection of the trainable text feature table (the upstream names that
table `image_embedding` whatever it holds); users and items propagate
`n_layers` hops over the symmetric-normalized user-item graph with a
layer-mean readout; the loss is BPR plus reg_weight times the L2 norms of
the batch's raw user and item rows (the free item table feeds only this
term).
"""

import math

import torch

from portbench.reference import plain

NAME = "LightGCN"


def init_spec(shapes, cfg):
    d = cfg["embedding_size"]
    nu, ni, dt = shapes["n_users"], shapes["n_items"], shapes["txt_dim"]
    return [
        ("user_embedding", (nu, d), "uniform", math.sqrt(6.0 / (nu + d))),
        ("item_embedding", (ni, d), "uniform", math.sqrt(6.0 / (ni + d))),
        ("image_embedding", (ni, dt), "table", "txt"),
        # torch's Linear init, U(-1/sqrt(in), 1/sqrt(in)) for both
        ("image_trs.w", (dt, d), "uniform", 1.0 / math.sqrt(dt)),
        ("image_trs.b", (d,), "uniform", 1.0 / math.sqrt(dt)),
    ]


class Reference:
    def __init__(self, data, cfg, device):
        self.cfg = cfg
        self.n_users = data["n_users"]
        self.ui = plain.ui_adjacency(data, device)

    def propagate(self, w):
        items = w["image_embedding"] @ w["image_trs.w"] + w["image_trs.b"]
        out = plain.propagate_mean(
            self.ui, torch.cat([w["user_embedding"], items]),
            self.cfg["n_layers"])
        return out[:self.n_users], out[self.n_users:]

    def eval_cache(self, w):
        with torch.no_grad():
            return self.propagate(w)

    @staticmethod
    def score(cache, users, cand):
        u, i = cache
        return torch.einsum("bd,bcd->bc", u[users], i[cand])

    @staticmethod
    def score_items(cache, users, items):
        u, i = cache
        return u[users] @ i[items].T

    def loss_parts(self, w, u, pos, neg, masks):
        """(mf, reg) of one batch, every row weighted 1; nothing random."""
        user_all, item_all = self.propagate(w)
        ue = user_all[u]
        mf = plain.bpr((ue * item_all[pos]).sum(1), (ue * item_all[neg]).sum(1))
        reg = plain.emb_loss(w["user_embedding"][u], w["item_embedding"][pos],
                             w["item_embedding"][neg])
        return mf, self.cfg["reg_weight"] * reg

    def mask_shapes(self, batch):
        return []
