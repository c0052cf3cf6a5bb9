# coding: utf-8
"""Attention and MLP blocks of CIKM_Model and SCHGN, plain PyTorch
(counterpart of `foodrec_tpu/common/module.py`).

  * `transformer_encoder_*`: torch nn.TransformerEncoder semantics (post-LN,
    multi-head attention with a key-padding mask), written out in einsums as
    the JAX package writes it -- the ingredient encoder
    (cikm_model.py:27-32, 228-238).
  * `target_attention_*`: multi-head attention with a per-head LayerNorm on
    Q and K and the additive -2^32+1 padding mask (cikm_model.py:311-369).
  * `bert_encoder_*`: the reference's from-scratch post-LN encoder with an
    additive attention mask (module.py:48-194), SCHGN's masked-ingredient
    encoder.
  * `mlp_2layer_*`: Linear, ReLU, Linear.
  * `mlp_layers_*`: the reference's MLPLayers stack of [Dropout, Linear,
    activation] (no shipped model reads it).

Parameters are dicts of tensors in the JAX package's layout (linear weights
[in, out]); the model wraps them as `nn.ParameterDict`s. Dropout draws from
an explicit `torch.Generator` on the tensors' device, at each site as the
block reaches it, or comes pre-drawn: `*_masks` draw an encoder call's masks
through `dropout` in the order its sites take them, and the encoder applies
them (`masks=`) bit for bit as the generator path would, so that a block
can run without a generator (a CUDA graph's replay, common/step_graph.py).
"""

import math

import torch
import torch.nn.functional as F

from foodrec_tpu_torch.common.init import (
    linear_apply,
    linear_params,
    truncated_normal,
    xavier_uniform,
)
from foodrec_tpu_torch.parallel.mesh import batch_draw


def gelu(x):
    """The exact erf GELU written out, x * (1 + erf(x / sqrt(2))) / 2, as the
    reference's formula (module.py:13-22) and the JAX package take it; not
    the tanh approximation. F.gelu's fused CPU kernel computes the same
    function with more float32 rounding error."""
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


ACT = {
    "relu": torch.relu,
    "gelu": gelu,
    "swish": F.silu,
}

# target attention's additive pad value -2^32+1, taken as float32 (where it
# rounds to -2^32) as the JAX package takes it (module.py:167)
_TARGET_PAD = float(torch.tensor(-(2.0 ** 32) + 1, dtype=torch.float32))


def layer_norm(x, gamma, beta, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)  # biased, as jnp.var
    return gamma * (x - mu) * torch.rsqrt(var + eps) + beta


def dropout(x, rate, generator, rows=False):
    """Inverted dropout: keep with probability 1 - rate, scale by 1/(1-rate).
    `rows`: x's leading dim holds the batch's rows, so that under a `data`
    mesh the mask is this rank's rows of the global batch's mask."""
    if rate == 0.0:
        return x

    def draw(shape):
        return torch.rand(shape, generator=generator, device=x.device,
                          dtype=x.dtype)

    keep = (batch_draw(draw, x.shape) if rows else draw(x.shape)) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def apply_dropout_mask(x, mask, rate):
    """`dropout(x, rate, ...)` with its draw taken from `mask`, which is
    `dropout` of ones (1 / (1 - rate) where it keeps, 0 where it drops):
    the same values bit for bit."""
    return torch.where(mask != 0, x / (1.0 - rate), 0.0)


def _dropper(generator, masks):
    """drop(x, rate) for the dropout sites of one encoder call, in order:
    each drawn from `generator` as `dropout(..., rows=True)` draws it, or,
    with `masks`, the next pre-drawn mask applied. A rate of 0 draws
    nothing and takes no mask."""
    if masks is None:
        return lambda x, rate: dropout(x, rate, generator, rows=True)
    it = iter(masks)

    def drop(x, rate):
        return x if rate == 0.0 else apply_dropout_mask(x, next(it), rate)

    return drop


def _draw_masks(sites, generator, device, dtype):
    """The mask of each (shape, rate) site with a rate, in order: `dropout`
    of ones, as the encoders draw it."""
    return [dropout(torch.ones(shape, device=device, dtype=dtype), rate,
                    generator, rows=True)
            for shape, rate in sites if rate != 0.0]


# ---------------------------------------------------------------------------
# torch nn.TransformerEncoder semantics
# ---------------------------------------------------------------------------


def transformer_encoder_params(generator, d_model, dim_ff, n_layers):
    """Per-layer params as the reference's xavier_uniform re-init pass leaves
    them (cikm_model.py:81): xavier_uniform weights, zero biases, LayerNorms
    (1, 0)."""
    layers = []
    for _ in range(n_layers):
        def w(d_out, d_in):
            return xavier_uniform((d_out, d_in), generator).T.contiguous()

        layers.append({
            "in_proj_w": w(3 * d_model, d_model),
            "in_proj_b": torch.zeros(3 * d_model),
            "out_proj_w": w(d_model, d_model),
            "out_proj_b": torch.zeros(d_model),
            "ff1_w": w(dim_ff, d_model),
            "ff1_b": torch.zeros(dim_ff),
            "ff2_w": w(d_model, dim_ff),
            "ff2_b": torch.zeros(d_model),
            "ln1_g": torch.ones(d_model), "ln1_b": torch.zeros(d_model),
            "ln2_g": torch.ones(d_model), "ln2_b": torch.zeros(d_model),
        })
    return layers


def _mha(p, x, nhead, pad_mask, drop_rate, drop):
    """Multi-head self-attention: x [B, L, D], pad_mask [B, L] True at
    padding; -inf at padded keys; `drop` (`_dropper`) takes the attention
    probabilities' dropout."""
    b, L, d = x.shape
    dh = d // nhead
    qkv = x @ p["in_proj_w"] + p["in_proj_b"]          # [B, L, 3D]
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):
        return t.reshape(b, L, nhead, dh).transpose(1, 2)  # [B, H, L, dh]

    q, k, v = heads(q), heads(k), heads(v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dh)
    if pad_mask is not None:
        logits = torch.where(pad_mask[:, None, None, :], -math.inf, logits)
    attn = torch.softmax(logits, dim=-1)
    # a fully padded row softmaxes to NaN; keep it finite (module.py:100-102)
    attn = torch.where(torch.isnan(attn), 0.0, attn)
    attn = drop(attn, drop_rate)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
    out = out.transpose(1, 2).reshape(b, L, d)
    return out @ p["out_proj_w"] + p["out_proj_b"]


def transformer_encoder_apply(params, x, nhead, pad_mask=None, act="gelu",
                              drop_rate=0.0, generator=None, masks=None):
    """Post-LN encoder stack (torch's default norm_first=False):
    x = LN1(x + Drop(MHA(x))); x = LN2(x + Drop(FF2(Drop(Act(FF1(x)))))).
    The dropouts draw from `generator`, or take `masks`
    (`transformer_encoder_masks`)."""
    act_fn = ACT[act]
    drop = _dropper(generator, masks)
    for p in params:
        a = _mha(p, x, nhead, pad_mask, drop_rate, drop)
        x = layer_norm(x + drop(a, drop_rate), p["ln1_g"], p["ln1_b"])
        h = drop(act_fn(x @ p["ff1_w"] + p["ff1_b"]), drop_rate)
        h = h @ p["ff2_w"] + p["ff2_b"]
        x = layer_norm(x + drop(h, drop_rate), p["ln2_g"], p["ln2_b"])
    return x


def transformer_encoder_masks(params, shape, nhead, drop_rate, generator,
                              device, dtype):
    """The dropout masks `transformer_encoder_apply` draws from `generator`
    over an x of `shape` [B, L, D], drawn in its order: per layer the
    attention probabilities' [B, H, L, L], the attention output's, the
    feed-forward's inner [B, L, dim_ff] and its output's."""
    b, L, d = shape
    sites = []
    for p in params:
        sites += [((b, nhead, L, L), drop_rate), ((b, L, d), drop_rate),
                  ((b, L, p["ff1_w"].shape[1]), drop_rate),
                  ((b, L, d), drop_rate)]
    return _draw_masks(sites, generator, device, dtype)


# ---------------------------------------------------------------------------
# target attention (cikm_model.py:311-369)
# ---------------------------------------------------------------------------


def target_attention_params(num_split):
    """Only the per-head LayerNorm carries parameters: the reference's q/k/v
    linears are dead weight (linear_projection=False in both uses)."""
    return {"ln_g": torch.ones(num_split), "ln_b": torch.zeros(num_split)}


def target_attention_apply(p, query, kv, num_head, seq_ids=None,
                           padding_idx=None):
    """query [B, Lq, D], kv [B, Lk, D] -> [B, Lq, D].

    Per-head LayerNorm (eps 1e-12) on Q and K, scaled dot product, and an
    optional key padding mask from seq_ids == padding_idx."""
    b, lq, d = query.shape
    lk = kv.shape[1]
    dh = d // num_head

    def heads(t, L):
        return t.reshape(b, L, num_head, dh).transpose(1, 2)

    q = layer_norm(heads(query, lq), p["ln_g"], p["ln_b"], eps=1e-12)
    k = layer_norm(heads(kv, lk), p["ln_g"], p["ln_b"], eps=1e-12)
    v = heads(kv, lk)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (dh ** -0.5)
    if seq_ids is not None:
        pad = seq_ids == padding_idx                      # [B, Lk]
        logits = torch.where(pad[:, None, None, :], _TARGET_PAD, logits)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
    return out.transpose(1, 2).reshape(b, lq, d)


# ---------------------------------------------------------------------------
# from-scratch post-LN encoder with an additive attention mask
# (reference: FoodRec/common/module.py:48-194)
# ---------------------------------------------------------------------------


def bert_encoder_params(generator, d_model, inner_size, n_layers):
    """Per layer: q / k / v / dense projections, a two-layer feed-forward
    and two LayerNorms. Every Linear re-initialized as the reference does
    (schgn.py:130-138): truncated-normal std 0.01 weights (drawn [out, in],
    stored [in, out]) and zero biases; LayerNorms (1, 0)."""
    def w(d_out, d_in):
        return truncated_normal((d_out, d_in), generator,
                                std=0.01).T.contiguous()

    layers = []
    for _ in range(n_layers):
        layers.append({
            "q_w": w(d_model, d_model), "q_b": torch.zeros(d_model),
            "k_w": w(d_model, d_model), "k_b": torch.zeros(d_model),
            "v_w": w(d_model, d_model), "v_b": torch.zeros(d_model),
            "dense_w": w(d_model, d_model), "dense_b": torch.zeros(d_model),
            "ff1_w": w(inner_size, d_model), "ff1_b": torch.zeros(inner_size),
            "ff2_w": w(d_model, inner_size), "ff2_b": torch.zeros(d_model),
            "ln1_g": torch.ones(d_model), "ln1_b": torch.zeros(d_model),
            "ln2_g": torch.ones(d_model), "ln2_b": torch.zeros(d_model),
        })
    return layers


def bert_encoder_apply(params, x, attn_mask, nhead, act="gelu",
                       hidden_dropout=0.0, attn_dropout=0.0, generator=None,
                       layer_norm_eps=1e-12, masks=None):
    """x [B, L, D]; attn_mask additive [B, 1, 1, L] (0 keep, -1e8 drop,
    module.py:96-101). Post-LN with the residual inside both sublayers;
    dropout on the attention probabilities and on both sublayer outputs,
    drawn from `generator`, or taken from `masks` (`bert_encoder_masks`)."""
    act_fn = ACT[act]
    drop = _dropper(generator, masks)
    b, L, d = x.shape
    dh = d // nhead

    def heads(t):
        return t.reshape(b, L, nhead, dh).transpose(1, 2)  # [B, H, L, dh]

    for p in params:
        q = heads(x @ p["q_w"] + p["q_b"])
        k = heads(x @ p["k_w"] + p["k_b"])
        v = heads(x @ p["v_w"] + p["v_b"])
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dh)
        attn = torch.softmax(logits + attn_mask, dim=-1)
        attn = drop(attn, attn_dropout)
        ctx = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        h = ctx.transpose(1, 2).reshape(b, L, d) @ p["dense_w"] + p["dense_b"]
        h = drop(h, hidden_dropout)
        x = layer_norm(h + x, p["ln1_g"], p["ln1_b"], eps=layer_norm_eps)

        h = act_fn(x @ p["ff1_w"] + p["ff1_b"]) @ p["ff2_w"] + p["ff2_b"]
        h = drop(h, hidden_dropout)
        x = layer_norm(h + x, p["ln2_g"], p["ln2_b"], eps=layer_norm_eps)
    return x


def bert_encoder_masks(params, shape, nhead, hidden_dropout, attn_dropout,
                       generator, device, dtype):
    """The dropout masks `bert_encoder_apply` draws from `generator` over an
    x of `shape` [B, L, D], drawn in its order: per layer the attention
    probabilities' [B, H, L, L] and both sublayer outputs'."""
    b, L, d = shape
    sites = []
    for _ in params:
        sites += [((b, nhead, L, L), attn_dropout),
                  ((b, L, d), hidden_dropout), ((b, L, d), hidden_dropout)]
    return _draw_masks(sites, generator, device, dtype)


# ---------------------------------------------------------------------------
# two-layer MLP (reference: FoodRec/common/module.py:197-263)
# ---------------------------------------------------------------------------


def mlp_2layer_params(generator, d_in, d_hidden, d_out):
    """nn.Sequential(Linear, ReLU, Linear) re-initialized to xavier_uniform
    weights and zero biases by the model's init pass."""
    return {"l1": linear_params(d_in, d_hidden, generator, init=xavier_uniform),
            "l2": linear_params(d_hidden, d_out, generator, init=xavier_uniform)}


def mlp_2layer_apply(p, x):
    return linear_apply(p["l2"], torch.relu(linear_apply(p["l1"], x)))


# ---------------------------------------------------------------------------
# generic MLP stack (reference: FoodRec/common/module.py:197-263)
# ---------------------------------------------------------------------------

MLP_ACT = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "leakyrelu": F.leaky_relu,
    "none": lambda v: v,
}


def mlp_layers_params(generator, layers, init_method=None):
    """[Dropout, Linear, ReLU] per consecutive (in, out) pair of `layers`:
    a list of {'w': [in, out], 'b': [out]}. `init_method='norm'` draws
    N(0, 0.01) weights and zero biases (module.py:246-252); the default is
    torch's Linear init, U(-1/sqrt(in), 1/sqrt(in)) for both."""
    params = []
    for d_in, d_out in zip(layers[:-1], layers[1:]):
        if init_method == "norm":
            w = 0.01 * torch.randn((d_out, d_in), generator=generator)
            b = torch.zeros(d_out)
        else:
            bound = 1.0 / math.sqrt(d_in)
            w = torch.empty(d_out, d_in).uniform_(-bound, bound,
                                                  generator=generator)
            b = torch.empty(d_out).uniform_(-bound, bound,
                                            generator=generator)
        params.append({"w": w.T.contiguous(), "b": b})
    return params


def mlp_layers_apply(params, x, drop_rate=0.0, activation="relu",
                     last_activation=True, generator=None):
    """The stack on x: per layer dropout (drawn from `generator`), the
    linear map and the activation, which the last layer skips when
    `last_activation` is False."""
    act = MLP_ACT[activation or "none"]
    for i, p in enumerate(params):
        x = dropout(x, drop_rate, generator)
        x = linear_apply(p, x)
        if last_activation or i < len(params) - 1:
            x = act(x)
    return x
