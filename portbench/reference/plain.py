"""Plain PyTorch and NumPy pieces shared by the configurations' references.

Nothing here imports the program under test. The references read the
dataset's files themselves, build their graphs themselves, and compute in
float32 with TF32 off unless a caller asks for TF32 (the precision control).
"""

import contextlib
import os
import pickle

import numpy as np
import torch

NEG_INF = -1e30
# slots of an item's ingredient sequence (the dataset pads to this)
MAX_INGRE_LEN = 20


# ----------------------------------------------------------------- dataset
def _ratings(path):
    """(users, items) int64 of a tab-separated rating file."""
    if os.path.getsize(path) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    arr = np.loadtxt(path, delimiter="\t", usecols=(0, 1), ndmin=2,
                     dtype=np.int64)
    return arr[:, 0], arr[:, 1]


def _negatives(path):
    """One int64 array of negatives per line "(u:..)\\tn1\\t...\\tnK"."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                rest = line.partition("\t")[2]
                out.append(np.array(rest.split("\t"), dtype=np.int64)
                           if rest else np.zeros(0, np.int64))
    return out


def load_dataset(root):
    """The dataset's arrays under `root`/processed_dataset/, read from the
    files the generator wrote."""
    base = os.path.join(root, "processed_dataset")
    tr_u, tr_i = _ratings(os.path.join(base, "data.train.rating"))
    va_u, va_i = _ratings(os.path.join(base, "data.valid.rating"))
    te_u, te_i = _ratings(os.path.join(base, "data.test.rating"))
    n_users = int(max(tr_u.max(), va_u.max(initial=0), te_u.max())) + 1
    n_items = int(max(tr_i.max(), va_i.max(initial=0), te_i.max())) + 1
    codes = np.load(os.path.join(base, "data_ingre_code_file.npy"))
    ingre_num = np.loadtxt(os.path.join(base, "data_id_ingre_num_file"),
                           delimiter="\t", dtype=np.int64, ndmin=2)[:, 1]
    ri = np.loadtxt(os.path.join(base, "ri_graph.txt"), dtype=np.int64,
                    ndmin=2)
    with open(os.path.join(base, "graph_edge",
                           "recipe_health_level_multi_hot_dict.pkl"),
              "rb") as f:
        mh = pickle.load(f)
    health_mh = np.zeros((n_items, len(mh[0])), np.float32)
    for k, v in mh.items():
        health_mh[k] = v
    test_neg = _negatives(os.path.join(base, "data.test.negative"))
    return {
        "n_users": n_users, "n_items": n_items,
        "n_ingredients": int(codes.max()),  # the pad id
        "train_u": tr_u, "train_i": tr_i,
        "pos_u": np.concatenate([tr_u, va_u, te_u]),
        "pos_i": np.concatenate([tr_i, va_i, te_i]),
        "test_u": te_u, "test_i": te_i, "test_neg": test_neg,
        "codes": codes.astype(np.int64), "ingre_num": ingre_num,
        "ri": ri, "health_mh": health_mh,
        "img_path": os.path.join(base, "data_image_features_float.npy"),
        "txt_path": os.path.join(base, "data_text_features_t5.npy"),
    }


def positives_mask(data, users, items):
    """True where (users[j], items[j]) is a train, valid or test pair."""
    key = data["pos_u"] * data["n_items"] + data["pos_i"]
    return np.isin(np.asarray(users) * data["n_items"] + np.asarray(items),
                   key)


def test_candidates(data, width_multiple=128):
    """The by-user test lists: per user its test positives, then its
    negatives with the first occurrence of each positive dropped; (cand
    [U, W] zero-padded, n_pos [U], n_cand [U]) for users 0..U-1."""
    n = data["n_users"]
    pos = [[] for _ in range(n)]
    for u, i in zip(data["test_u"].tolist(), data["test_i"].tolist()):
        pos[u].append(i)
    rows = []
    for u in range(n):
        negs = np.asarray(data["test_neg"][u])
        _, first = np.unique(negs, return_index=True)
        drop = np.zeros(len(negs), bool)
        drop[first] = np.isin(negs[first], pos[u])
        rows.append(pos[u] + negs[~drop].tolist())
    width = max(len(p) for p in pos) + max(len(x) for x in data["test_neg"])
    width = -(-width // width_multiple) * width_multiple
    cand = np.zeros((n, width), np.int64)
    for u, r in enumerate(rows):
        cand[u, :len(r)] = r
    return (cand, np.array([len(p) for p in pos]),
            np.array([len(r) for r in rows]))


# ------------------------------------------------------------------ graphs
def sym_adjacency(rows, cols, n, device):
    """D^-1/2 A D^-1/2 over the deduplicated symmetrized edges, degrees
    + 1e-7, values in float64 then float32: (rows, cols, vals, n) on
    `device`."""
    r = np.concatenate([rows, cols]).astype(np.int64)
    c = np.concatenate([cols, rows]).astype(np.int64)
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    d = np.power(np.bincount(r, minlength=n).astype(np.float64) + 1e-7, -0.5)
    vals = (d[r] * d[c]).astype(np.float32)
    return (torch.from_numpy(r).to(device), torch.from_numpy(c).to(device),
            torch.from_numpy(vals).to(device), n)


def spmm(adj, x):
    """A @ x by a gather and an index_add."""
    rows, cols, vals, n = adj
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add(0, rows, x[cols] * vals[:, None])


def propagate_mean(adj, x, hops):
    """The mean of x, A x, ..., A^hops x."""
    acc = x
    for _ in range(hops):
        x = spmm(adj, x)
        acc = acc + x
    return acc / (hops + 1)


def ui_adjacency(data, device):
    n_u = data["n_users"]
    return sym_adjacency(data["train_u"], data["train_i"] + n_u,
                         n_u + data["n_items"], device)


def nnz(rows, cols, n):
    """Edges of the symmetrized deduplicated graph."""
    r = np.concatenate([rows, cols]).astype(np.int64)
    c = np.concatenate([cols, rows]).astype(np.int64)
    return len(np.unique(r * n + c))


# ---------------------------------------------------------------- weights
def make_weights(spec, seed, device, data=None):
    """{name: tensor} from `spec`, a list of (name, shape, kind, value):
    kind "uniform" draws U(-value, value), "const" fills value, "table"
    loads the dataset's feature table named by value ("img" or "txt"). The
    draws are one uniform call over all uniform leaves on `device`, from a
    generator seeded with `seed`. Tables need `data`."""
    sizes = [int(np.prod(s)) for _, s, k, _ in spec if k == "uniform"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0,
                                                            generator=gen)
    out, at = {}, 0
    for name, shape, kind, value in spec:
        if kind == "uniform":
            n = int(np.prod(shape))
            out[name] = (flat[at:at + n] * value).view(shape)
            at += n
        elif kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
        elif data is not None:
            out[name] = torch.from_numpy(
                np.load(data[value + "_path"])).to(device)
    return out


# ---------------------------------------------------------------- losses
def bpr(pos, neg):
    return (-torch.log(1e-10 + torch.sigmoid(pos - neg))).mean()


def emb_loss(*embeddings):
    """The sum of each tensor's L2 norm (sqrt(sum + 1e-24)) over the rows
    of the batch."""
    n = embeddings[0].shape[0]
    return sum(torch.sqrt((e ** 2).sum() + 1e-24) for e in embeddings) / n


def adam(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step in place (no weight decay); `state` holds t, m, v."""
    state["t"] = t = state.get("t", 0) + 1
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            if g is None:
                continue
            m = state.setdefault(("m", k), torch.zeros_like(p))
            v = state.setdefault(("v", k), torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** t)).sqrt() + eps
            p.sub_(lr / (1 - b1 ** t) * m / denom)


# ---------------------------------------------------------------- metrics
def by_user_metrics(scores, n_pos, n_cand, neg_num, max_k=20):
    """Per-user AUC (strict <, over n_pos * neg_num pairs), Recall@10/20 and
    NDCG@10/20 (ties to the lower slot); float64 numpy [U] each."""
    s = scores.double()
    b, c = s.shape
    slot = torch.arange(c, device=s.device)[None, :]
    valid = slot < n_cand[:, None]
    is_pos = slot < n_pos[:, None]
    is_neg = valid & ~is_pos
    pair = ((s[:, None, :] < s[:, :, None]) & is_pos[:, :, None]
            & is_neg[:, None, :])
    n_pos1 = n_pos.clamp_min(1).double()
    out = {"AUC": pair.sum(dim=(1, 2)).double() / (n_pos1 * neg_num)}
    masked = torch.where(valid, s, torch.full_like(s, NEG_INF))
    order = torch.sort(-masked, dim=1, stable=True).indices[:, :max_k]
    hit = (order < n_pos[:, None]).double()
    gain = 1.0 / torch.log2(torch.arange(max_k, device=s.device).double() + 2)
    for k in (10, 20):
        ideal = (torch.arange(k, device=s.device)[None, :]
                 < n_pos[:, None].clamp_max(k)).double()
        out[f"NDCG@{k}"] = ((hit[:, :k] * gain[:k]).sum(1)
                            / (ideal * gain[:k]).sum(1).clamp_min(1e-12))
        out[f"Recall@{k}"] = hit[:, :k].sum(1) / n_pos1
    return {k: v.cpu().numpy() for k, v in out.items()}


# --------------------------------------------------------------- precision
@contextlib.contextmanager
def precision(tf32):
    """float32 matrix products with TF32 off (the configurations' stated
    precision), or on (the control, the next precision below)."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
