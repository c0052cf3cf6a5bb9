"""Plain reference of CIKM_Model (HealthRec) as configured in
configs/cikm-foodcom.yaml: float32 PyTorch, no kernels, written from the
model's published description and the upstream code's semantics
(FoodRec/models/cikm_model.py), including its quirks:

  * recipe-ingredient propagation (n_layers hops, layer mean) over
    [items; ingredients without the pad row] feeds the item side of the
    user-item propagation (ui_layers hops, layer mean)
  * a post-LN transformer encoder (torch nn.TransformerEncoder semantics,
    exact-erf GELU, -inf at padded keys, a fully padded row's NaN set to 0)
    over the 20-slot ingredient sequences of the batch's items, dropout on
    the attention probabilities and the three sublayer outputs
  * two target attentions with a per-head LayerNorm (eps 1e-12) on queries
    and keys; the ingredient padding masked with float32(-2^32 + 1)
  * F.normalize of 3-D tensors along dim 1; item_know sums all 20 positions
    and divides by the true ingredient count
  * losses (mf, loss_health * health BCE in logit space clamped at -100,
    loss_kd * max(0, 1 - mean cos - kd_threshold), reg_weight * the L2
    norms of the batch's embeddings with the ingredient pad row detached)

Dropout masks are given (`masks`, bool keep masks in call order): the
program's draws when judging the program, or draws of the caller's own.
"""

import math

import torch

from portbench.reference import plain

NAME = "CIKM_Model"


def init_spec(shapes, cfg):
    """(name, shape, kind, value) of every parameter, named as the program
    names them; each initializer matches its layer's in scale (xavier
    uniform tables and encoder weights, torch Linear projections)."""
    d = cfg["embedding_size"]
    nu, ni, ning = shapes["n_users"], shapes["n_items"], shapes["n_ingredients"]

    def xavier(fan_out, fan_in):
        return math.sqrt(6.0 / (fan_in + fan_out))

    spec = [("user_embedding", (nu, d), "uniform", xavier(nu, d)),
            ("item_embedding", (ni, d), "uniform", xavier(ni, d)),
            ("ingre_embedding", (ning + 1, d), "uniform", xavier(ning + 1, d)),
            ("image_embedding", (ni, shapes["img_dim"]), "table", "img"),
            ("text_embedding", (ni, shapes["txt_dim"]), "table", "txt")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.{i}."
        spec += [(p + "in_proj_w", (d, 3 * d), "uniform", xavier(3 * d, d)),
                 (p + "in_proj_b", (3 * d,), "const", 0.0),
                 (p + "out_proj_w", (d, d), "uniform", xavier(d, d)),
                 (p + "out_proj_b", (d,), "const", 0.0),
                 (p + "ff1_w", (d, 4 * d), "uniform", xavier(4 * d, d)),
                 (p + "ff1_b", (4 * d,), "const", 0.0),
                 (p + "ff2_w", (4 * d, d), "uniform", xavier(d, 4 * d)),
                 (p + "ff2_b", (d,), "const", 0.0),
                 (p + "ln1_g", (d,), "const", 1.0),
                 (p + "ln1_b", (d,), "const", 0.0),
                 (p + "ln2_g", (d,), "const", 1.0),
                 (p + "ln2_b", (d,), "const", 0.0)]
    dh = d // cfg["num_attention_heads"]
    for t in ("mm_target_atten", "ingre_target_atten"):
        spec += [(t + ".ln_g", (dh,), "const", 1.0),
                 (t + ".ln_b", (dh,), "const", 0.0)]
    nh = shapes["n_health"]
    spec += [("health_mlp.l1.w", (d, d), "uniform", xavier(d, d)),
             ("health_mlp.l1.b", (d,), "const", 0.0),
             ("health_mlp.l2.w", (d, nh), "uniform", xavier(nh, d)),
             ("health_mlp.l2.b", (nh,), "const", 0.0)]
    for t, dim in (("image_trs", shapes["img_dim"]),
                   ("text_trs", shapes["txt_dim"])):
        # xavier normal's spread as a uniform draw; torch's Linear bias
        spec += [(t + ".w", (dim, d), "uniform",
                  math.sqrt(3.0) * math.sqrt(2.0 / (dim + d))),
                 (t + ".b", (d,), "uniform", 1.0 / math.sqrt(dim))]
    return spec


class Reference:
    def __init__(self, data, cfg, device):
        self.cfg = cfg
        self.device = device
        self.n_users, self.n_items = data["n_users"], data["n_items"]
        self.n_ingr = data["n_ingredients"]
        self.ui = plain.ui_adjacency(data, device)
        ri = data["ri"]
        self.ri = plain.sym_adjacency(ri[:, 1] + self.n_items, ri[:, 0],
                                      self.n_items + self.n_ingr, device)
        self.codes = torch.from_numpy(data["codes"]).to(device)
        self.ingre_num = torch.from_numpy(data["ingre_num"]).to(device)
        self.health = torch.from_numpy(data["health_mh"]).to(device)
        self.nhead = cfg["num_attention_heads"]
        self.rate = cfg["attention_probs_dropout_prob"]

    # -------------------------------------------------------------- model
    def propagate(self, w):
        ir = plain.propagate_mean(
            self.ri, torch.cat([w["item_embedding"],
                                w["ingre_embedding"][:-1]]),
            self.cfg["n_layers"])
        ui = plain.propagate_mean(
            self.ui, torch.cat([w["user_embedding"], ir[:self.n_items]]),
            self.cfg["ui_layers"])
        return ui[:self.n_users], ui[self.n_users:]

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

    # --------------------------------------------------------------- loss
    def _drop(self, x, masks):
        keep = masks.pop(0)
        if keep.shape != x.shape:
            raise ValueError(f"dropout mask {tuple(keep.shape)} for a "
                             f"tensor {tuple(x.shape)}")
        return torch.where(keep, x / (1.0 - self.rate), 0.0)

    @staticmethod
    def _ln(x, g, b, eps):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return g * (x - mu) / torch.sqrt(var + eps) + b

    def _encoder(self, w, x, pad, masks):
        b, L, d = x.shape
        h = self.nhead
        dh = d // h
        for i in range(self.cfg["num_hidden_layers"]):
            p = {k.split(".", 2)[2]: v for k, v in w.items()
                 if k.startswith(f"encoder.{i}.")}
            q, k, v = (x @ p["in_proj_w"] + p["in_proj_b"]).split(d, dim=-1)
            q, k, v = (t.reshape(b, L, h, dh).transpose(1, 2)
                       for t in (q, k, v))
            logits = q @ k.transpose(-1, -2) / math.sqrt(dh)
            logits = logits.masked_fill(pad[:, None, None, :], -math.inf)
            attn = torch.softmax(logits, dim=-1)
            attn = torch.nan_to_num(attn, nan=0.0)
            attn = self._drop(attn, masks)
            a = (attn @ v).transpose(1, 2).reshape(b, L, d)
            a = a @ p["out_proj_w"] + p["out_proj_b"]
            x = self._ln(x + self._drop(a, masks), p["ln1_g"], p["ln1_b"],
                         1e-5)
            f = x @ p["ff1_w"] + p["ff1_b"]
            f = 0.5 * f * (1.0 + torch.erf(f / math.sqrt(2.0)))
            f = self._drop(f, masks) @ p["ff2_w"] + p["ff2_b"]
            x = self._ln(x + self._drop(f, masks), p["ln2_g"], p["ln2_b"],
                         1e-5)
        return x

    def _target(self, w, prefix, query, kv, pad=None):
        b, lq, d = query.shape
        lk = kv.shape[1]
        h = self.nhead
        dh = d // h
        g, bb = w[prefix + ".ln_g"], w[prefix + ".ln_b"]
        q = self._ln(query.reshape(b, lq, h, dh).transpose(1, 2), g, bb, 1e-12)
        kh = kv.reshape(b, lk, h, dh).transpose(1, 2)
        k = self._ln(kh, g, bb, 1e-12)
        logits = q @ k.transpose(-1, -2) * dh ** -0.5
        if pad is not None:
            fill = float(torch.tensor(-(2.0 ** 32) + 1, dtype=torch.float32))
            logits = logits.masked_fill(pad[:, None, None, :], fill)
        out = torch.softmax(logits, dim=-1) @ kh
        return out.transpose(1, 2).reshape(b, lq, d)

    @staticmethod
    def _normalize(x, dim):
        return x / x.norm(dim=dim, keepdim=True).clamp_min(1e-12)

    def loss_parts(self, w, u, pos, neg, masks):
        """(mf, health, kd, reg) of one batch, every row weighted 1."""
        cfg = self.cfg
        items2 = torch.cat([pos, neg])
        ingr = self.codes[items2]
        pad = ingr == self.n_ingr
        user_all, item_all = self.propagate(w)
        enc = self._encoder(w, w["ingre_embedding"][ingr], pad, masks)
        mm = torch.stack(
            [w["image_embedding"][items2] @ w["image_trs.w"] + w["image_trs.b"],
             w["text_embedding"][items2] @ w["text_trs.w"] + w["text_trs.b"]],
            dim=1)
        item_health = self._target(w, "mm_target_atten", mm, enc, pad)
        item_mm = self._target(w, "ingre_target_atten", enc, mm)
        know = (self._normalize(item_mm, 1).sum(1)
                / self.ingre_num[items2][:, None])

        hid = torch.relu(self._normalize(item_health, 1).mean(1)
                         @ w["health_mlp.l1.w"] + w["health_mlp.l1.b"])
        z = hid @ w["health_mlp.l2.w"] + w["health_mlp.l2.b"]
        zero = torch.zeros_like(z)
        log_p = (-torch.logaddexp(-z, zero)).clamp_min(-100.0)
        log_q = (-torch.logaddexp(z, zero)).clamp_min(-100.0)
        hl = self.health[items2]
        health = -(hl * log_p + (1 - hl) * log_q).sum()

        ue, pe, ne = user_all[u], item_all[pos], item_all[neg]
        mf = plain.bpr((ue * pe).sum(1), (ue * ne).sum(1))
        other = torch.cat([pe, ne])
        cos = (know * other).sum(-1) / (
            know.norm(dim=-1).clamp_min(1e-8)
            * other.norm(dim=-1).clamp_min(1e-8))
        kd = (1 - cos.mean() - cfg["kd_threshold"]).clamp_min(0.0)

        table = w["ingre_embedding"]
        reg_table = torch.cat([table[:-1], table[-1:].detach()])
        reg = plain.emb_loss(w["user_embedding"][u], w["item_embedding"][pos],
                             w["item_embedding"][neg],
                             reg_table[self.codes[pos]],
                             reg_table[self.codes[neg]])
        return (mf, cfg["loss_health"] * health, cfg["loss_kd"] * kd,
                cfg["reg_weight"] * reg)

    def mask_shapes(self, batch):
        """Shapes of one step's dropout masks, in call order."""
        d, h, L = self.cfg["embedding_size"], self.nhead, plain.MAX_INGRE_LEN
        b = 2 * batch
        return [(b, h, L, L), (b, L, d), (b, L, 4 * d),
                (b, L, d)] * self.cfg["num_hidden_layers"]
