# coding: utf-8
"""The flagship step (counterpart of `__graft_entry__.py:16-63`, `entry`):
CIKM_Model's summed loss on the toy synthetic, as a function of the model
and a batch.

    fn, (model, batch) = entry()        # on the card; entry("cpu") on the CPU
    fn(model, batch).backward()

The set-up is the JAX package's: 32 users x 64 items, 10 negatives, image
width 16, text width 8, the model's parameters drawn from seed 0; the batch
is the first 16 train pairs, each with the next item as its negative and a
weight of one, and seed 1 for the encoder's dropout. `fn` seeds a fresh
generator from the batch on every call, as the JAX step reads its key, so
two calls on the same model and batch give the same loss. On the card the
graphs go through the CUDA SpMM (`spmm_impl: kernel`), where `auto` would
take ELL on graphs this small.
"""

import os
import tempfile

import torch

N_USERS, N_ITEMS, NEG_NUM, IMG_DIM, TXT_DIM = 32, 64, 10, 16, 8
BATCH = 16


def loss_fn(model, batch):
    """The summed loss parts of `model.calculate_loss` on `batch`."""
    generator = torch.Generator(device=model.device).manual_seed(
        batch["seed"])
    return sum(model.calculate_loss(batch["u_id"], batch["pos_i_id"],
                                    batch["neg_i_id"], generator=generator,
                                    weight=batch["weight"]))


def entry(device="cuda"):
    """(fn, (model, batch)): `fn(model, batch)` is the summed loss, a scalar
    tensor that autograd differentiates. Raises where `device` is "cuda"
    and CUDA is not available."""
    from foodrec_tpu_torch.config import Config
    from foodrec_tpu_torch.data import synthetic
    from foodrec_tpu_torch.data.dataset import FoodData, derive_data_paths
    from foodrec_tpu_torch.data.device import DeviceData
    from foodrec_tpu_torch.models import get_model
    from foodrec_tpu_torch.utils.device import resolve_device

    on_card = resolve_device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        synthetic.generate(os.path.join(tmp, "Synth"), n_users=N_USERS,
                           n_items=N_ITEMS, neg_num=NEG_NUM, img_dim=IMG_DIM,
                           txt_dim=TXT_DIM)
        cfg = Config("CIKM_Model", "Synth", {
            "data_path": tmp + "/", "neg_sample_num": NEG_NUM,
            "use_gpu": on_card, "spmm_impl": "kernel" if on_card else "auto"})
        derive_data_paths(cfg, "Synth")
        data = FoodData(cfg)
        data.device_data = dd = DeviceData.from_food_data(data)
    model = get_model("CIKM_Model")(cfg, data,
                                    torch.Generator().manual_seed(0))

    def ids(a):
        return torch.as_tensor(a[:BATCH]).to(model.device, torch.int64)

    pos = ids(dd.train_i)
    batch = {"u_id": ids(dd.train_u), "pos_i_id": pos,
             "neg_i_id": (pos + 1) % dd.num_items,
             "weight": torch.ones(BATCH, device=model.device), "seed": 1}
    return loss_fn, (model, batch)
