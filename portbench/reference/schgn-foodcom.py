"""Plain reference of SCHGN as configured in configs/schgn-foodcom.yaml:
float32 PyTorch (TF32 off through plain.precision), no kernels, written
from the upstream's equations (FoodRec/models/schgn.py; Song, Yang and Xu,
"Self-supervised Calorie-aware Heterogeneous Graph Networks for Food
Recommendation", ACM TOMM 2023):

  * nodes users | items | ingredients | calorie levels; directed edges
    item -> user (the user-recipe graph), ingredient -> item and calorie
    level -> item, read from the dataset's graph files
  * one GCNConv (PyG semantics): A_hat = A + I, deg = in-degree + 1 taken
    on the target, val = deg[src]^-1/2 deg[dst]^-1/2, out = A_hat (x W) + b,
    then tanh
  * the ingredient table [ingredients; 0 (the pad); the learnable mask
    token]; the propagated ingredient table is [propagated; 0; mask token]
  * the ingredient-level additive attention over the 20 slots:
    h = tanh([ingredient, user, image] W + b), a = h v, slots past the
    recipe's count lowered by 1e12, softmax, weighted sum
  * the component-level additive attention over [item, ingredients, image,
    calorie level]: h = tanh([user, component] W + b), a = h v; with
    `schgn_faithful_interleave` the scores are concatenated component by
    component ([4B]) and read back `.view(B, 4)`, as the upstream does, which
    mixes the scores of the whole batch; else per sample
  * score = relu(dropout([u, i, u * i] W + b)) w, the dropout of rate 0.5
    on whole rows of the batch
  * the masked-ingredient SSL over the positives' sequences: the post-LN
    encoder (additive -1e8 at the pad, LayerNorm eps 1e-12, exact-erf GELU,
    dropout on the attention probabilities and both sublayer outputs), a
    linear map, and the BCE against ones of sigmoid(sigmoid(<m, pos>) -
    sigmoid(<m, neg>)) (log clamped at -100) summed over the masked slots
  * losses: sum-form BPR, -sum log sigmoid(pos - neg); regs times the sum of
    squares of the batch's user, item and ingredient rows, reg_health of its
    calorie rows, reg_image, reg_w and reg_g of the image, scorer and GCN
    weights; ssl times the SSL sum

Departures from the upstream, each also the program's:

  * the user and item rows of every table read the raw row plus the
    propagated row (the upstream's `embedding + gcn output` sum), and the
    SSL reads the propagated ingredient table alone, as the upstream does
  * the SSL's masked, positive and negative sequences are given, not drawn
    here (the program's draws when judging the program); `draws` draws a
    set of its own for the control
  * the image table is a fixed input (the dataset's), not a parameter

Draws (`draws`, in call order): the keep mask of the positives' score
dropout [B, D], the negatives' [B, D], the SSL's (masked, positive,
negative) sequences [B, 20], then per encoder layer the keep masks of the
attention probabilities [B, H, 20, 20], the attention output [B, 20, D]
and the feed-forward output [B, 20, D].
"""

import math
import os
import pickle

import numpy as np
import torch

from portbench.reference import plain

NAME = "SCHGN"
SCORE_DROPOUT = 0.5
MASKED_P = 0.2


def init_spec(shapes, cfg):
    """(name, shape, kind, value) of every parameter, named as the program
    names them; each uniform draw has the spread of the program's
    initializer (truncated normals of the upstream's stds, torch's Linear
    for the SSL's map). `shapes` holds `n_cal_levels` besides the harness's
    sizes (the traffic adds it)."""
    d, inner = cfg["embedding_size"], cfg["inner_size"]
    nu, ni, ng = shapes["n_users"], shapes["n_items"], shapes["n_ingredients"]
    img, n_levels = shapes["img_dim"], shapes["n_cal_levels"]
    r3 = math.sqrt(3.0)

    def tn(std):
        return r3 * std

    spec = [("user_embed", (nu, d), "uniform", tn(0.01)),
            ("item_embed", (ni, d), "uniform", tn(0.01)),
            ("ingre_embed_first", (ng, d), "uniform", tn(0.01)),
            ("ingre_embed_mask", (1, d), "uniform", tn(0.01)),
            ("health_embed", (n_levels, d), "uniform", tn(0.01))]

    def linear(name, d_in, d_out, w_std, b_std=None, bias=True):
        out = [(name + ".w", (d_in, d_out), "uniform", tn(w_std))]
        if bias:
            out.append((name + ".b", (d_out,), "uniform",
                        tn(b_std or w_std)))
        return out

    spec += linear("gcn", d, d, math.sqrt(2.0 / (2 * d)))
    spec += linear("img_trans", img, d, math.sqrt(2.0 / (img + d)))
    spec += linear("W_att_ingre", 3 * d, d, math.sqrt(2.0 / (4 * d)),
                   math.sqrt(2.0 / (2 * d)))
    spec += [("h_att_ingre.w", (d, 1), "const", 1.0)]
    spec += linear("W_att_comp", 2 * d, d, math.sqrt(2.0 / (3 * d)),
                   math.sqrt(2.0 / (2 * d)))
    spec += [("h_att_comp.w", (d, 1), "const", 1.0)]
    spec += linear("W_concat", 3 * d, d, math.sqrt(2.0 / (4 * d)),
                   math.sqrt(2.0 / (2 * d)))
    spec += linear("output_mlp", d, 1, math.sqrt(2.0 / (2 * d)), bias=False)
    spec += [("mip_norm.w", (d, d), "uniform", 1.0 / math.sqrt(d)),
             ("mip_norm.b", (d,), "uniform", 1.0 / math.sqrt(d))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.{i}."
        for name, d_in, d_out in (("q", d, d), ("k", d, d), ("v", d, d),
                                  ("dense", d, d), ("ff1", d, inner),
                                  ("ff2", inner, d)):
            spec += [(p + name + "_w", (d_in, d_out), "uniform", tn(0.01)),
                     (p + name + "_b", (d_out,), "const", 0.0)]
        spec += [(p + "ln1_g", (d,), "const", 1.0),
                 (p + "ln1_b", (d,), "const", 0.0),
                 (p + "ln2_g", (d,), "const", 1.0),
                 (p + "ln2_b", (d,), "const", 0.0)]
    return spec


def _pairs(path):
    return np.loadtxt(path, delimiter="\t", dtype=np.int64, ndmin=2)


def graph_edges(data):
    """(src, dst, n_nodes) of the directed heterogeneous graph without its
    self loops, from the dataset's graph files."""
    base = os.path.dirname(data["img_path"])
    ur = _pairs(os.path.join(base, "graph_edge", "ur_graph.txt"))
    ri = _pairs(os.path.join(base, "graph_edge", "ri_graph.txt"))
    rc = _pairs(os.path.join(base, "graph_edge", "rc_graph.txt"))
    nu, ni, ng = data["n_users"], data["n_items"], data["n_ingredients"]
    n_levels = int(rc[:, 1].max()) + 1
    src = np.concatenate([ur[:, 1] + nu, ri[:, 1] + nu + ni,
                          rc[:, 1] + nu + ni + ng])
    dst = np.concatenate([ur[:, 0], ri[:, 0] + nu, rc[:, 0] + nu])
    return src, dst, nu + ni + ng + n_levels


class Reference:
    def __init__(self, data, cfg, device, dtype=torch.float32):
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.nu, self.ni = data["n_users"], data["n_items"]
        self.ng = data["n_ingredients"]
        src, dst, n = graph_edges(data)
        self.n_levels = n - self.nu - self.ni - self.ng
        loop = np.arange(n)
        src, dst = np.concatenate([src, loop]), np.concatenate([dst, loop])
        deg = np.bincount(dst, minlength=n).astype(np.float64)
        vals = deg[src] ** -0.5 * deg[dst] ** -0.5
        self.adj = (torch.from_numpy(dst).to(device),
                    torch.from_numpy(src).to(device),
                    torch.from_numpy(vals).to(device, dtype), n)
        base = os.path.dirname(data["img_path"])
        with open(os.path.join(base, "graph_edge",
                               "recipe_cal_level_dict.pkl"), "rb") as f:
            levels = pickle.load(f)
        self.cal = torch.tensor([levels[i] for i in range(self.ni)],
                                device=device)
        self.codes = torch.from_numpy(data["codes"]).to(device)
        self.num = torch.from_numpy(data["ingre_num"]).to(device)
        self.img = torch.from_numpy(np.load(data["img_path"])).to(device,
                                                                  dtype)
        self.nhead = cfg["num_attention_heads"]

    # -------------------------------------------------------------- model
    def _tables(self, w):
        """The raw and the propagated (user, item, ingredient, level)
        tables, each ingredient table [ingredients; 0; mask token]."""
        x = torch.cat([w["user_embed"], w["item_embed"],
                       w["ingre_embed_first"], w["health_embed"]])
        y = torch.tanh(plain.spmm(self.adj, x @ w["gcn.w"]) + w["gcn.b"])
        sizes = [self.nu, self.ni, self.ng, self.n_levels]
        zero = x.new_zeros(1, x.shape[1])
        mask = w["ingre_embed_mask"]
        raw = [w["user_embed"], w["item_embed"],
               torch.cat([w["ingre_embed_first"], zero, mask]),
               w["health_embed"]]
        u, i, g, h = y.split(sizes)
        return raw, [u, i, torch.cat([g, zero, mask]), h]

    @staticmethod
    def _drop(x, keep, rate):
        if keep.shape != x.shape:
            raise ValueError(f"dropout mask {tuple(keep.shape)} for a "
                             f"tensor {tuple(x.shape)}")
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def _score(self, w, raw, prop, u, items, keep):
        d = w["user_embed"].shape[1]
        ingre = self.codes[items]
        lvl = self.cal[items]
        ue = raw[0][u] + prop[0][u]
        ie = raw[1][items] + prop[1][items]
        ge = raw[2][ingre] + prop[2][ingre]
        he = raw[3][lvl] + prop[3][lvl]
        img = self.img[items] @ w["img_trans.w"] + w["img_trans.b"]
        b, L = ingre.shape

        # ingredient level
        cat = torch.cat([ge, ue[:, None].expand(b, L, d),
                         img[:, None].expand(b, L, d)], dim=-1)
        a = (torch.tanh(cat @ w["W_att_ingre.w"] + w["W_att_ingre.b"])
             @ w["h_att_ingre.w"])[..., 0]
        slot = torch.arange(L, device=a.device)[None, :]
        a = torch.where(slot >= self.num[items][:, None], a - 1e12, a)
        ing = (torch.softmax(a, dim=-1)[:, :, None] * ge).sum(1)

        # component level: the components concatenated component by
        # component, [4B, D], as the upstream concatenates them
        comps = [ie, ing, img, he]
        flat = torch.cat([torch.cat([ue, c], dim=-1) for c in comps])
        s = (torch.tanh(flat @ w["W_att_comp.w"] + w["W_att_comp.b"])
             @ w["h_att_comp.w"])[:, 0]
        if self.cfg["schgn_faithful_interleave"]:
            s = s.view(b, 4)
        else:
            s = s.view(4, b).T
        item = (torch.softmax(s, dim=-1)[:, :, None]
                * torch.stack(comps, dim=1)).sum(1)

        hid = (torch.cat([ue, item, ue * item], dim=-1) @ w["W_concat.w"]
               + w["W_concat.b"])
        hid = self._drop(hid, keep, SCORE_DROPOUT)
        return (torch.relu(hid) @ w["output_mlp.w"])[:, 0]

    @staticmethod
    def _ln(x, g, b, eps=1e-12):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return g * (x - mu) / torch.sqrt(var + eps) + b

    def _encoder(self, w, x, pad, draws):
        b, L, d = x.shape
        h = self.nhead
        dh = d // h
        att_rate = self.cfg["attention_probs_dropout_prob"]
        hid_rate = self.cfg["hidden_dropout_prob"]
        add = torch.where(pad, -1e8, 0.0).to(x.dtype)[:, None, None, :]

        def heads(t):
            return t.reshape(b, L, h, dh).transpose(1, 2)

        for i in range(self.cfg["num_hidden_layers"]):
            p = {k.split(".", 2)[2]: v for k, v in w.items()
                 if k.startswith(f"encoder.{i}.")}
            q, k, v = (heads(x @ p[n + "_w"] + p[n + "_b"])
                       for n in ("q", "k", "v"))
            attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh)
                                 + add, dim=-1)
            attn = self._drop(attn, draws.pop(0), att_rate)
            a = ((attn @ v).transpose(1, 2).reshape(b, L, d) @ p["dense_w"]
                 + p["dense_b"])
            x = self._ln(self._drop(a, draws.pop(0), hid_rate) + x,
                         p["ln1_g"], p["ln1_b"])
            f = x @ p["ff1_w"] + p["ff1_b"]
            f = 0.5 * f * (1.0 + torch.erf(f / math.sqrt(2.0)))
            f = f @ p["ff2_w"] + p["ff2_b"]
            x = self._ln(self._drop(f, draws.pop(0), hid_rate) + x,
                         p["ln2_g"], p["ln2_b"])
        return x

    def _ssl(self, w, raw, prop, seqs, draws):
        masked, pos_seq, neg_seq = seqs
        enc = self._encoder(w, prop[2][masked], masked == self.ng, draws)
        m = enc @ w["mip_norm.w"] + w["mip_norm.b"]

        def score(target):
            return torch.sigmoid((m * raw[2][target]).sum(-1))

        dist = torch.sigmoid(score(pos_seq) - score(neg_seq))
        bce = -torch.log(dist).clamp_min(-100.0)
        return (bce * (masked == self.ng + 1)).sum()

    def loss_parts(self, w, u, pos, neg, draws):
        """(bpr, reg, ssl) of one batch, every row weighted 1; `draws` (a
        list, consumed in call order) holds the batch's draws."""
        cfg = self.cfg
        raw, prop = self._tables(w)
        s_pos = self._score(w, raw, prop, u, pos, draws.pop(0))
        s_neg = self._score(w, raw, prop, u, neg, draws.pop(0))
        bpr = -torch.nn.functional.logsigmoid(s_pos - s_neg).sum()

        def sq(t):
            return (t ** 2).sum()

        ingre = raw[2]
        reg = cfg["regs"] * (sq(w["user_embed"][u]) + sq(w["item_embed"][pos])
                             + sq(w["item_embed"][neg])
                             + sq(ingre[self.codes[pos]])
                             + sq(ingre[self.codes[neg]]))
        reg = reg + cfg["reg_health"] * (sq(w["health_embed"][self.cal[pos]])
                                         + sq(w["health_embed"][self.cal[neg]]))
        reg = reg + cfg["reg_image"] * sq(w["img_trans.w"])
        reg = reg + cfg["reg_w"] * (sq(w["W_concat.w"]) + sq(w["output_mlp.w"]))
        reg = reg + cfg["reg_g"] * sq(w["gcn.w"])
        if cfg["SCHGN_ssl"]:
            ssl = cfg["ssl"] * self._ssl(w, raw, prop, draws.pop(0), draws)
        else:
            ssl = bpr.new_zeros(())
        return bpr, reg, ssl

    # ------------------------------------------------------------- draws
    def draws(self, u, pos, neg, generator):
        """A set of draws of the reference's own for one batch, in call
        order (the control's): dropout keep masks and the SSL sequences
        (each real slot masked with probability 0.2; its negative a uniform
        ingredient that is none of the recipe's)."""
        cfg, dev = self.cfg, self.device
        b, d = u.shape[0], cfg["embedding_size"]
        L, h = plain.MAX_INGRE_LEN, self.nhead

        def keep(shape, rate):
            return torch.rand(shape, generator=generator, device=dev) >= rate

        out = [keep((b, d), SCORE_DROPOUT), keep((b, d), SCORE_DROPOUT)]
        if not cfg["SCHGN_ssl"]:
            return out
        codes = self.codes[pos]
        real = torch.arange(L, device=dev)[None, :] < self.num[pos][:, None]
        do = (torch.rand((b, L), generator=generator, device=dev)
              < MASKED_P) & real
        masked = torch.where(do, self.ng + 1, codes)
        neg_seq = codes.clone()
        todo = do.clone()
        while todo.any():
            cand = torch.randint(0, self.ng, (b, L), generator=generator,
                                 device=dev)
            clash = ((cand[..., None] == torch.where(real, codes, -1)
                      [:, None, :]).any(-1))
            take = todo & ~clash
            neg_seq = torch.where(take, cand, neg_seq)
            todo &= ~take
        out.append((masked, codes, neg_seq))
        for _ in range(cfg["num_hidden_layers"]):
            out += [keep((b, h, L, L), cfg["attention_probs_dropout_prob"]),
                    keep((b, L, d), cfg["hidden_dropout_prob"]),
                    keep((b, L, d), cfg["hidden_dropout_prob"])]
        return out
