# coding: utf-8
"""Embedding and gradient diagnostics: the cosine probe of
`calcu_cos_similarity` (counterpart of `foodrec_tpu/utils/diagnostics.py`;
reference FoodRec/common/trainer.py:584-629).

The reference reads `model.id_emb / text_emb / image_emb` and their .grad;
here the same-width tables and their gradients are passed in, and the same
six numbers come back:

  (cos(id, text), cos(g_id, g_text), cos(id, image), cos(g_id, g_image),
   frac(unit(text) > unit(id)), frac(unit(image) > unit(id)))
"""

import torch


def _cos_rows(a, b, eps=1e-8):
    na = torch.linalg.vector_norm(a, dim=-1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=-1).clamp_min(eps)
    return (a * b).sum(-1) / (na * nb)


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def embedding_cos_similarity(id_emb, text_emb, image_emb,
                             id_grad, text_grad, image_grad):
    """The probe's six scalars (0-d tensors) for [N, D] tables and their
    gradients, in the tables' dtype."""
    return (_cos_rows(id_emb, text_emb).mean(),
            _cos_rows(id_grad, text_grad).mean(),
            _cos_rows(id_emb, image_emb).mean(),
            _cos_rows(id_grad, image_grad).mean(),
            ((_unit(text_emb) - _unit(id_emb)) > 0).to(id_emb.dtype).mean(),
            ((_unit(image_emb) - _unit(id_emb)) > 0).to(id_emb.dtype).mean())
