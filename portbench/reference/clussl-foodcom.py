"""Plain reference of CLUSSL (PRICAI_ModelX) as configured in
configs/clussl-foodcom.yaml: float32 PyTorch (TF32 off through
plain.precision), no kernels, written from the upstream's equations
(FoodRec/models/pricai_modelx.py:56-86, 179-230, 263, 409-437):

  * three item-side bipartite graphs, each over [items; its extra nodes]:
    item-ingredient (the dataset's ri_graph.txt, the ingredient table
    without its pad row), item-image cluster and item-text cluster (the
    k-means edges of cluster/{image,text}_cluster_edge.txt, read here; the
    n_cluster prototypes of each modality are learnable nodes); each
    symmetric-normalized D^-1/2 A D^-1/2 over its deduplicated symmetrized
    edges, degrees + 1e-7
  * each graph propagated n_ri_layers hops with a layer-mean readout; the
    item rows of the three views summed feed n_ui_layers hops of
    user-item LightGCN (the same normalization, layer mean)
  * the loss: BPR over the propagated users and items (mean over the
    batch); loss_cl times the sum of the distance correlations of the
    view pairs (image, text), (image, ingredient), (ingredient, text) over
    the batch's positive then negative rows [2B]; reg_weight times the L2
    norms of the batch's raw user, positive and negative item rows over B
  * dCor as published: D = sqrt(max(r - 2 X X^T + r^T, 0) + 1e-8), double
    centered; dCov(a, b) = sqrt(max(sum(a * b) / n^2, 0) + 1e-8); dCor =
    dCov12 / sqrt(max(dCov11 * dCov22, 0) + 1e-10). The diagonal of D is
    left as the formula gives it (about 1e-4, and its rounding): nothing
    is "fixed" there

Departures from the upstream, each also the program's:

  * the prototypes are free tables (`use_center_embedding` unset, as
    shipped), not projections of the pretrained k-means centers
  * every row of a batch has weight 1 (the program's padded-tail weight
    is not used by the cell: its last batch has its exact size)

Nothing is random: `loss_parts` takes no draws.
"""

import math
import os

import numpy as np
import torch

from portbench.reference import plain

NAME = "PRICAI_ModelX"


def init_spec(shapes, cfg):
    """(name, shape, kind, value) of every parameter, named as the program
    names them; xavier uniform tables, as the program's."""
    d, nc = cfg["embedding_size"], int(cfg["n_cluster"])
    nu, ni = shapes["n_users"], shapes["n_items"]
    ning = shapes["n_ingredients"]

    def xavier(rows):
        return math.sqrt(6.0 / (rows + d))

    return [("user_embedding", (nu, d), "uniform", xavier(nu)),
            ("item_embedding", (ni, d), "uniform", xavier(ni)),
            ("ingre_embedding", (ning + 1, d), "uniform", xavier(ning + 1)),
            ("image_prototype_embedding", (nc, d), "uniform", xavier(nc)),
            ("text_prototype_embedding", (nc, d), "uniform", xavier(nc))]


def cluster_edges(data, modality):
    """(item, cluster) int64 pairs of the dataset's k-means graph."""
    base = os.path.dirname(data["img_path"])
    return np.loadtxt(os.path.join(base, "cluster",
                                   f"{modality}_cluster_edge.txt"),
                      dtype=np.int64, ndmin=2)


def correlation_distance(x, y):
    """The distance correlation of two [n, D] batches (pricai_modelx.py:
    409-437)."""

    def centered(X):
        r = (X * X).sum(1, keepdim=True)
        D = torch.sqrt(torch.clamp(r - 2 * X @ X.T + r.T, min=0.0) + 1e-8)
        return (D - D.mean(0, keepdim=True) - D.mean(1, keepdim=True)
                + D.mean())

    def dcov(a, b):
        n = a.shape[0]
        return torch.sqrt(torch.clamp((a * b).sum() / (n * n), min=0.0)
                          + 1e-8)

    a, b = centered(x), centered(y)
    return dcov(a, b) / torch.sqrt(
        torch.clamp(dcov(a, a) * dcov(b, b), min=0.0) + 1e-10)


class Reference:
    def __init__(self, data, cfg, device, dtype=torch.float32):
        self.cfg = cfg
        self.n_users, self.n_items = data["n_users"], data["n_items"]
        ni, nc = self.n_items, int(cfg["n_cluster"])

        def graph(rows, cols, n):
            r, c, v, n = plain.sym_adjacency(rows, cols, n, device)
            return r, c, v.to(dtype), n

        ri = data["ri"]
        self.ui = graph(data["train_u"], data["train_i"] + self.n_users,
                        self.n_users + ni)
        self.views = {"ingre": graph(ri[:, 1] + ni, ri[:, 0],
                                     ni + data["n_ingredients"])}
        for m in ("image", "text"):
            e = cluster_edges(data, m)
            self.views[m] = graph(e[:, 1] + ni, e[:, 0], ni + nc)

    def propagate(self, w):
        """(users, items) after the propagation, and the three item views
        {"image", "text", "ingre"}."""
        extra = {"ingre": w["ingre_embedding"][:-1],
                 "image": w["image_prototype_embedding"],
                 "text": w["text_prototype_embedding"]}
        views = {m: plain.propagate_mean(
            adj, torch.cat([w["item_embedding"], extra[m]]),
            self.cfg["n_ri_layers"])[:self.n_items]
            for m, adj in self.views.items()}
        items = views["ingre"] + views["image"] + views["text"]
        out = plain.propagate_mean(
            self.ui, torch.cat([w["user_embedding"], items]),
            self.cfg["n_ui_layers"])
        return out[:self.n_users], out[self.n_users:], views

    def eval_cache(self, w):
        with torch.no_grad():
            return self.propagate(w)[:2]

    @staticmethod
    def score(cache, users, cand):
        u, i = cache
        return torch.einsum("bd,bcd->bc", u[users], i[cand])

    @staticmethod
    def score_items(cache, users, items):
        u, i = cache
        return u[users] @ i[items].T

    def loss_parts(self, w, u, pos, neg, masks):
        """(mf, loss_cl * dCor, reg) of one batch, every row weighted 1;
        nothing random."""
        user_all, item_all, views = self.propagate(w)
        ue = user_all[u]
        mf = plain.bpr((ue * item_all[pos]).sum(1),
                       (ue * item_all[neg]).sum(1))
        rows = torch.cat([pos, neg])
        image, text, ingre = (views[m][rows] for m in ("image", "text",
                                                        "ingre"))
        cl = (correlation_distance(image, text)
              + correlation_distance(image, ingre)
              + correlation_distance(ingre, text))
        reg = plain.emb_loss(w["user_embedding"][u], w["item_embedding"][pos],
                             w["item_embedding"][neg])
        return mf, self.cfg["loss_cl"] * cl, self.cfg["reg_weight"] * reg

    def mask_shapes(self, batch):
        return []
