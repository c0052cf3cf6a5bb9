# coding: utf-8
"""Offline data pipeline: raw interactions and per-item metadata -> the
on-disk contract `FoodData` reads (the reference's dataset_process
notebooks as functions).

Counterpart of `foodrec_tpu/data/preprocess.py`, stage for stage and name
for name, with numpy (no pandas, no scikit-learn): a *table* is a dict of
column name -> numpy array of equal length, in row order. On the same
inputs every file it writes is byte-identical to the JAX package's, except
`cluster/` and `mm_cluster/`, whose k-means runs on the device
(`kmeans.py`, the algorithm of scikit-learn's MiniBatchKMeans, not its
random stream). The stages:

  * iterative k-core interaction filtering            (foodcom cell 0)
  * temporal 60/10/30 split keeping users in train∩test (cell 2); a stable
    sort by date, as pandas' sort_values gives on day-resolution ties
  * sorted-classes id re-encoding                     (cell 3)
  * tab-separated .rating files                       (cell 5)
  * ingredient id filtering + padded code matrix + ri_graph (cells 7-8)
  * popularity^0.7-biased 500-negative eval files, seed 2024 (cell 18)
  * train COO pickle, ur graph                        (cells 24-26)
  * calorie levels int(cal/50) label-encoded -> rc_graph + dict (cell 28)
  * WHO-style health criteria -> rh_graph + scalar/multi-hot dicts
    + nutrition-overlap>=4 rr_health graph            (cells 29-31)
  * mini-batch k-means cluster graphs on the device: 2000 clusters, 10-NN
    computed, top-6 written, centers saved            (kmeans cells 0-3)

The T5 / ResNet-50 feature extractors (cells 9-17) take an injected model
or import `transformers` / `torchvision` when called; their weights must be
downloaded, so `build_dataset` takes the feature matrices as inputs.
"""

import os
import pickle
import shutil
from collections import defaultdict

import numpy as np
import scipy.sparse as sp

MAX_INGRE_LEN = 20


# ------------------------------------------------------------------ tables
def _n_rows(table):
    return len(next(iter(table.values())))


def _rows(table, index):
    """The rows `index` (a mask, indices or a slice) of every column."""
    return {k: v[index] for k, v in table.items()}


def _isin(col, values):
    """`col` element in the set `values`, as pandas' isin compares."""
    if col.dtype.kind in "iuf":
        return np.isin(col, np.fromiter(values, dtype=col.dtype,
                                        count=len(values)))
    return np.fromiter((v in values for v in col.tolist()), dtype=bool,
                       count=len(col))


def _stable_argsort(col):
    """The stable order of `col`, NaN last: pandas' order for sort_values on
    day-resolution dates, whose ties keep their row order."""
    if col.dtype == object:
        vals = col.tolist()
        if all(isinstance(v, str) for v in vals):
            return np.argsort(np.asarray(vals, dtype=str), kind="stable")
        return np.asarray(sorted(
            range(len(vals)),
            key=lambda r: ((1, 0) if vals[r] != vals[r] else (0, vals[r]))),
            dtype=np.int64)
    return np.argsort(col, kind="stable")


def _stable_lexsort(cols):
    """Stable order by `cols[0]`, then `cols[1]`, ... (pandas' multi-key
    sort_values)."""
    order = np.arange(len(cols[0]))
    for col in reversed(cols):
        order = order[_stable_argsort(col[order])]
    return order


def _groups(keys, values):
    """dict key -> list of `values` in row order, keys as Python scalars
    (pandas' groupby(...).apply(list))."""
    out = defaultdict(list)
    for k, v in zip(keys.tolist(), values.tolist()):
        out[k].append(v)
    return out


# --------------------------------------------------------------------- core
def k_core_filter(table, user_col="user_id", item_col="recipe_id", k=5):
    """Iteratively drop users/items with < k interactions until stable
    (foodcom_process.ipynb cell 0)."""
    while True:
        keep = np.ones(_n_rows(table), dtype=bool)
        for col in (user_col, item_col):
            _, inverse, counts = np.unique(table[col], return_inverse=True,
                                           return_counts=True)
            keep &= counts[inverse.reshape(-1)] >= k
        if keep.all():
            return table
        table = _rows(table, keep)


def temporal_split(table, date_col="date", user_col="user_id",
                   ratios=(0.6, 0.1, 0.3)):
    """Sort by date (stable), split 60/10/30, keep only users present in
    both train and test (cell 2)."""
    table = _rows(table, _stable_argsort(table[date_col]))
    n = _n_rows(table)
    a = int(ratios[0] * n)
    b = int((ratios[0] + ratios[1]) * n)
    train, valid, test = (_rows(table, slice(0, a)), _rows(table, slice(a, b)),
                          _rows(table, slice(b, n)))
    keep = set(train[user_col].tolist()) & set(test[user_col].tolist())
    return tuple(_rows(s, _isin(s[user_col], keep))
                 for s in (train, valid, test))


def encode_ids(splits, user_col="user_id", item_col="recipe_id"):
    """Remap raw ids to 0..n-1 with sorted-classes semantics (LabelEncoder
    parity, cell 3). Returns (remapped splits, user_to_idx, item_to_idx),
    the dicts keyed by the raw ids as Python scalars."""
    users = sorted(set().union(*[set(s[user_col].tolist()) for s in splits]))
    items = sorted(set().union(*[set(s[item_col].tolist()) for s in splits]))
    user_to_idx = {v: i for i, v in enumerate(users)}
    item_to_idx = {v: i for i, v in enumerate(items)}
    out = []
    for s in splits:
        s = dict(s)
        for col, new, to_idx in ((user_col, "u", user_to_idx),
                                 (item_col, "i", item_to_idx)):
            s[new] = np.fromiter((to_idx[v] for v in s[col].tolist()),
                                 dtype=np.int64, count=len(s[col]))
        out.append(s)
    return out, user_to_idx, item_to_idx


def write_rating_files(out_dir, train, valid, test, rating=5.0):
    """`u \t i \t rating \t 0` rows sorted by (u, i) (the loaders expect
    consecutive per-user runs, dataset.py:137-155)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, split in (("train", train), ("valid", valid), ("test", test)):
        order = np.lexsort((split["i"], split["u"]))
        tail = f"\t{rating}\t0\n"
        with open(os.path.join(out_dir, f"data.{name}.rating"), "w") as f:
            f.write("".join(f"{u}\t{i}{tail}" for u, i in zip(
                split["u"][order].tolist(), split["i"][order].tolist())))


# --------------------------------------------------------------- ingredients
def build_ingredient_codes(item_to_ingres, n_items, out_dir,
                           max_len=MAX_INGRE_LEN):
    """Filter to ingredients seen in the corpus, re-encode sorted, emit the
    padded code matrix (pad id = n_ingredients), counts file, and ri_graph
    (cells 7-8). `item_to_ingres`: dict item_idx -> list of raw ingre ids."""
    final = sorted(set(x for lst in item_to_ingres.values() for x in lst))
    ingre_to_idx = {v: i for i, v in enumerate(final)}
    pad = len(final)
    width = max(max((len(v) for v in item_to_ingres.values()), default=1),
                1)
    width = min(width, max_len)
    codes = np.full((n_items, width), pad, dtype=np.int64)
    nums = np.zeros(n_items, dtype=np.int64)
    ri = []
    for i in range(n_items):
        lst = [ingre_to_idx[x] for x in item_to_ingres.get(i, [])][:width]
        nums[i] = len(lst)
        codes[i, :len(lst)] = lst
        ri.extend((i, g) for g in lst)

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "data_ingre_code_file.npy"), codes)
    with open(os.path.join(out_dir, "data_id_ingre_num_file"), "w") as f:
        f.write("".join(f"{i}\t{c}\n" for i, c in enumerate(nums.tolist())))
    np.savetxt(os.path.join(out_dir, "ri_graph.txt"),
               np.asarray(ri, dtype=np.int64), fmt="%d")
    return codes, nums, ingre_to_idx


# ----------------------------------------------------------------- negatives
def sample_eval_negatives(train, eval_split, n_items, out_path, n_neg=500,
                          alpha=0.7, seed=2024, all_user_positives=None):
    """Popularity^alpha-biased negatives per eval user, excluding that
    user's *train* positives, written as `(u:[pos..])\tn1..nK` rows in user
    order (cell 18 semantics: draws 2K candidates by popularity without
    replacement, removes the user's train items, keeps K). The draws, and
    the Python set whose iteration order picks the K kept, are the JAX
    package's, so the file is too."""
    rng = np.random.RandomState(seed)
    all_items, counts = np.unique(train["i"], return_counts=True)
    pop = counts / counts.sum()
    prob = pop ** alpha
    prob = prob / prob.sum()

    user_train = {u: set(v)
                  for u, v in _groups(train["u"], train["i"]).items()}
    eval_pos = _groups(eval_split["u"], eval_split["i"])

    with open(out_path, "w") as f:
        for u in sorted(eval_pos):
            seq = user_train.get(u, set())
            if len(all_items) - len(seq) < n_neg:
                raise ValueError(
                    f"user {u}: only {len(all_items) - len(seq)} candidate "
                    f"items for {n_neg} negatives — reduce n_neg")
            samples = []
            while len(samples) < n_neg:
                draw = rng.choice(all_items, min(2 * n_neg, len(all_items)),
                                  replace=False, p=prob)
                samples = list(set(draw.tolist()) - seq)
            samples = samples[:n_neg]
            negs = "\t".join(str(int(x)) for x in samples)
            f.write(f"(u:{eval_pos[u]})\t{negs}\n")


# -------------------------------------------------------------------- graphs
def write_train_artifacts(train, n_users, n_items, base_dir):
    """inter_coo_matrix.pkl + graph_edge/ur_graph.txt (cells 24-26)."""
    coo = sp.coo_matrix(
        (np.ones(len(train["u"]), np.float32), (train["u"], train["i"])),
        shape=(n_users, n_items))
    with open(os.path.join(base_dir, "inter_coo_matrix.pkl"), "wb") as f:
        pickle.dump(coo, f)
    gdir = os.path.join(base_dir, "graph_edge")
    os.makedirs(gdir, exist_ok=True)
    np.savetxt(os.path.join(gdir, "ur_graph.txt"),
               np.stack([train["u"], train["i"]], axis=1), fmt="%d")
    return coo


def build_calorie_levels(calories_by_item, base_dir, bucket=50):
    """int(cal/bucket) label-encoded to dense levels -> rc_graph.txt +
    recipe_cal_level_dict.pkl + level map (cell 28)."""
    buckets = {i: int(c // bucket) for i, c in calories_by_item.items()}
    classes = sorted(set(buckets.values()))
    to_idx = {v: k for k, v in enumerate(classes)}
    cal_dict = {i: to_idx[b] for i, b in sorted(buckets.items())}

    gdir = os.path.join(base_dir, "graph_edge")
    os.makedirs(gdir, exist_ok=True)
    rc = np.asarray(sorted(cal_dict.items()), dtype=np.int64)
    np.savetxt(os.path.join(gdir, "rc_graph.txt"), rc, fmt="%d")
    with open(os.path.join(gdir, "recipe_cal_level_dict.pkl"), "wb") as f:
        pickle.dump(cal_dict, f)
    with open(os.path.join(gdir, "recipe_cal_level_map.pkl"), "wb") as f:
        pickle.dump(to_idx, f)
    return cal_dict


# WHO-style criteria (foodcom cell 29; %DV thresholds), each over a table's
# columns at once (a NaN passes no criterion)
FOODCOM_HEALTH_CRITERIA = (
    lambda r: (15 <= r["fat"]) & (r["fat"] <= 30),
    lambda r: r["sugar"] < 10,
    lambda r: r["sodium"] < 83,
    lambda r: (10 <= r["protein"]) & (r["protein"] <= 15),
    lambda r: r["saturated_fat"] < 10,
    lambda r: (55 <= r["carbohydrates"]) & (r["carbohydrates"] <= 75),
)

# Allrecipes variant (allrecipes_process.ipynb cells 28-29): sugar/sodium are
# absolute amounts rather than %DV, and a 7th fiber criterion is added.
ALLRECIPES_HEALTH_CRITERIA = (
    lambda r: (15 <= r["fat"]) & (r["fat"] <= 30),
    lambda r: r["sugar"] < 5,
    lambda r: r["sodium"] < 2000,
    lambda r: (10 <= r["protein"]) & (r["protein"] <= 15),
    lambda r: r["saturated_fat"] < 10,
    lambda r: (55 <= r["carbohydrates"]) & (r["carbohydrates"] <= 75),
    lambda r: r["fiber"] > 10,
)


def _shared_criteria_pairs(flags, threshold):
    """(row, col, count) for every pair of distinct items that satisfy more
    than `threshold` criteria in common, rows ascending and each row's
    columns ascending: the entries of scipy's m·mᵀ with the diagonal set to
    0 and counts <= threshold dropped (cell 31), found per distinct pattern
    of satisfied criteria instead of per pair of items."""
    bits = (flags != 0).astype(np.int64) @ (1 << np.arange(flags.shape[1]))
    patterns, inverse = np.unique(bits, return_inverse=True)
    members = [np.flatnonzero(inverse == p) for p in range(len(patterns))]
    shared = np.array([[bin(int(p & q)).count("1") for q in patterns]
                       for p in patterns], dtype=np.int64).reshape(
                           len(patterns), len(patterns))
    rows, cols, counts = [], [], []
    for p, items in enumerate(members):
        # a pair sharing no criterion has no entry in m·mᵀ
        q = np.flatnonzero(shared[p] > max(threshold, 0))
        if not len(q):
            continue
        cand = np.concatenate([members[x] for x in q])
        cand_count = np.repeat(shared[p, q], [len(members[x]) for x in q])
        order = np.argsort(cand, kind="stable")
        cand, cand_count = cand[order], cand_count[order]
        r = np.repeat(items, len(cand))
        c = np.tile(cand, len(items))
        off_diag = r != c
        rows.append(r[off_diag])
        cols.append(c[off_diag])
        counts.append(np.tile(cand_count, len(items))[off_diag])
    if not rows:
        return np.zeros((0, 3), dtype=np.int64)
    rows, cols, counts = (np.concatenate(a) for a in (rows, cols, counts))
    order = np.argsort(rows, kind="stable")
    return np.stack([rows[order], cols[order], counts[order]], axis=1)


def build_health_levels(nutrition_df, base_dir,
                        criteria=FOODCOM_HEALTH_CRITERIA,
                        rr_overlap_threshold=3):
    """Scalar health score + multi-hot dict + rh_graph + rr_health co-graph
    (cells 29-31). `nutrition_df`: a table with one row per item idx `i`
    and the nutrient columns the criteria read."""
    nutrition = _rows(nutrition_df, _stable_argsort(nutrition_df["i"]))
    items = nutrition["i"].astype(np.int64)
    n_items = int(items.max()) + 1
    flags = np.zeros((n_items, len(criteria)), dtype=np.float32)
    for k, c in enumerate(criteria):
        flags[items, k] = np.where(c(nutrition), 1.0, 0.0)
    score = flags.sum(axis=1).astype(np.int64)

    gdir = os.path.join(base_dir, "graph_edge")
    os.makedirs(gdir, exist_ok=True)
    np.savetxt(os.path.join(gdir, "rh_graph.txt"),
               np.stack([np.arange(n_items), score], axis=1), fmt="%d")
    with open(os.path.join(gdir, "recipe_health_level_dict.pkl"), "wb") as f:
        pickle.dump({i: int(score[i]) for i in range(n_items)}, f)
    with open(os.path.join(gdir, "recipe_health_level_multi_hot_dict.pkl"),
              "wb") as f:
        pickle.dump({i: flags[i].tolist() for i in range(n_items)}, f)
    np.savetxt(os.path.join(gdir, "rr_health_graph.txt"),
               _shared_criteria_pairs(flags, rr_overlap_threshold), fmt="%d")
    return score, flags


# keyword tag sets shared by both reference notebooks (foodcom cell 27 /
# allrecipes cell 24): ingredients whose *name* contains the same keyword
# get pairwise ii edges
INGRE_KEYWORD_SETS = (
    ("white", "black", "red", "green", "yellow"),                 # colors
    ("slice", "dice", "minced", "powder", "roll", "shred"),       # shapes
    ("deep-fry", "dry", "fry", "steam", "boil", "pickle"),        # cooking
)


def keyword_tag_edges(names_by_idx, keyword_sets=INGRE_KEYWORD_SETS,
                      singleton_keep_p=None, seed=2024):
    """Ingredient-ingredient edges from shared name keywords (foodcom
    cell 27): per keyword, every pair of ingredients whose name contains it
    gets an (i<j) edge; pairs are deduped across keywords and written in
    BOTH directions. `singleton_keep_p` reproduces the Allrecipes variant
    (cell 24): edges supported by exactly one keyword are kept with that
    probability, one draw per such edge in the order the pairs were first
    seen. Returns an int64 [E, 2] array (possibly empty)."""
    edge_count = defaultdict(int)
    for kwset in keyword_sets:
        for kw in kwset:
            members = [i for i, name in names_by_idx.items() if kw in name]
            for a in range(len(members)):
                for b in range(a + 1, len(members)):
                    edge_count[(members[a], members[b])] += 1
    rng = np.random.RandomState(seed)
    edges = []
    for (i, j), count in edge_count.items():
        if (singleton_keep_p is not None and count == 1
                and rng.rand() >= singleton_keep_p):
            continue
        edges.append([i, j])
        edges.append([j, i])
    return (np.asarray(edges, dtype=np.int64) if edges
            else np.zeros((0, 2), dtype=np.int64))


def cooccurrence_graph(item_tags, n_nodes, threshold=0):
    """Generic tag-co-occurrence edges (the reference's ii keyword graph,
    foodcom cell 27): nodes sharing > threshold tags get an edge."""
    tag_ids = {t: k for k, t in enumerate(
        sorted(set(t for tags in item_tags.values() for t in tags)))}
    m = sp.lil_matrix((n_nodes, len(tag_ids)), dtype=np.float32)
    for i, tags in item_tags.items():
        for t in tags:
            m[i, tag_ids[t]] = 1.0
    m = m.tocsr()
    co = (m @ m.T).tolil()
    co.setdiag(0)
    co = co.tocsr()
    co.data[co.data <= threshold] = 0
    co.eliminate_zeros()
    coo = co.tocoo()
    return np.stack([coo.row, coo.col], axis=1)


# -------------------------------------------------------------------- kmeans
def kmeans_cluster_edges(features, out_dir, modality, n_clusters=2000,
                         top_k=6, knn_k=10, seed=2024, chunk=2048,
                         device="cuda"):
    """Mini-batch k-means (2000 clusters, init_size 512, batch 1024, 3
    inits, seed 2024) over the feature matrix on `device`; per item the 10
    nearest centers are computed and the top-6 written as edges; centers
    saved in the features' dtype (kmeans cells 0-3). Returns (edges,
    KMeansResult): the JAX package returns the centers in its place, here
    `.centers` beside the fit's inertia and steps."""
    from .kmeans import minibatch_kmeans, nearest_centers

    n_clusters = min(n_clusters, len(features))
    km = minibatch_kmeans(features, n_clusters, seed=seed, device=device)
    nearest = nearest_centers(features, km.centers, knn_k, device=device,
                              chunk=chunk)[:, :top_k]
    arr = np.stack([np.repeat(np.arange(len(nearest)), nearest.shape[1]),
                    nearest.reshape(-1)], axis=1).astype(np.int64)
    os.makedirs(out_dir, exist_ok=True)
    np.savetxt(os.path.join(out_dir, f"{modality}_cluster_edge.txt"), arr,
               fmt="%d")
    np.save(os.path.join(out_dir, f"{modality}_center.npy"), km.centers)
    return arr, km


# ------------------------------------------------------------------ features
def t5_text_features(texts, model_name="t5-small", batch_size=64,
                     tokenizer=None, encoder=None, device="cuda"):
    """Mean-pooled T5 encoder features (cells 9-14) on `device`. Without an
    injected `tokenizer` and `encoder`, `transformers` is imported and the
    weights are downloaded. Contract: float32 [N, D] (D = the encoder's
    hidden size, 512 for t5-small), attention-mask-weighted mean pooling
    over the sequence axis."""
    import torch

    from ..utils.device import resolve_device

    device = resolve_device(device)
    if tokenizer is None or encoder is None:
        try:
            from transformers import T5EncoderModel, T5Tokenizer
        except ImportError as e:
            raise ImportError(
                "t5_text_features needs the `transformers` package unless "
                "a tokenizer and an encoder are injected") from e
        tokenizer = T5Tokenizer.from_pretrained(model_name)
        encoder = T5EncoderModel.from_pretrained(model_name).eval()
    tok, enc = tokenizer, encoder
    if isinstance(enc, torch.nn.Module):
        enc = enc.to(device)
    out = []
    with torch.no_grad():
        for s in range(0, len(texts), batch_size):
            batch = tok(texts[s:s + batch_size], return_tensors="pt",
                        padding=True, truncation=True)
            batch = {k: v.to(device) for k, v in batch.items()}
            h = enc(**batch).last_hidden_state
            mask = batch["attention_mask"][..., None]
            out.append(((h * mask).sum(1) / mask.sum(1)).cpu().numpy())
    return np.concatenate(out).astype(np.float32)


def resnet50_image_features(image_paths, batch_size=32, backbone=None,
                            transform=None, device="cuda"):
    """ResNet-50 (fc=Identity) 2048-d features (cells 16-17) on `device`.
    Without an injected `backbone` (and `transform`), `torchvision` is
    imported and the weights are downloaded. Contract: float32 [N, D] (D =
    the backbone's output width), 256-resize / 224-center-crop /
    ImageNet-normalized inputs; images are read with PIL."""
    import torch

    from ..utils.device import resolve_device

    device = resolve_device(device)

    def vision():
        try:
            import torchvision
        except ImportError as e:
            raise ImportError(
                "resnet50_image_features needs the `torchvision` package "
                "unless a backbone and a transform are injected") from e
        return torchvision

    if backbone is None:
        backbone = vision().models.resnet50(weights="IMAGENET1K_V2")
        backbone.fc = torch.nn.Identity()
    model = backbone.eval().to(device)
    if transform is None:
        tv = vision()
        transform = tv.transforms.Compose([
            tv.transforms.Resize(256),
            tv.transforms.CenterCrop(224),
            tv.transforms.ToTensor(),
            tv.transforms.Normalize([0.485, 0.456, 0.406],
                                    [0.229, 0.224, 0.225]),
        ])
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("resnet50_image_features needs the `PIL` (Pillow) "
                          "package to read images") from e

    out = []
    with torch.no_grad():
        for s in range(0, len(image_paths), batch_size):
            imgs = torch.stack([transform(Image.open(p).convert("RGB"))
                                for p in image_paths[s:s + batch_size]])
            out.append(model(imgs.to(device)).cpu().numpy())
    return np.concatenate(out).astype(np.float32)


# -------------------------------------------------------------------- driver
def build_dataset(out_root, interactions, item_to_ingres, image_features,
                  text_features, calories_by_item=None, nutrition_df=None,
                  date_col="date", user_col="user_id", item_col="recipe_id",
                  k_core=5, n_neg=500, n_clusters=2000, seed=2024,
                  presplit=None, cal_bucket=50,
                  health_criteria=FOODCOM_HEALTH_CRITERIA,
                  ingre_names=None, ii_singleton_keep_p=None,
                  write_health_sample=False, device="cuda"):
    """Full offline pipeline: a raw interaction table + raw-id-keyed
    per-item metadata -> the on-disk contract consumed by FoodData.

    `interactions`: a table with `user_col`, `item_col` and `date_col`.
    `item_to_ingres`: dict raw_item_id -> list of raw ingredient ids.
    `image_features` / `text_features`: dict raw_item_id -> 1-D vector.
    `calories_by_item`: dict raw_item_id -> calories.
    `nutrition_df`: a table with `item_col` + the nutrient columns.
    `presplit`: optional (train, valid, test) raw tables — skips the
        k-core filter and temporal split (the Allrecipes path, which ships
        its own core splits, allrecipes_process.ipynb cell 2).
    `cal_bucket`: calorie bucket width (foodcom 50 / allrecipes 30).
    `health_criteria`: column-wise predicates (FOODCOM_/ALLRECIPES_).
    `ingre_names`: dict raw_ingre_id -> name; enables the keyword ii_graph
        (FGCN input, foodcom cell 27 / allrecipes cell 24) with optional
        `ii_singleton_keep_p` subsampling of single-keyword edges.
    `write_health_sample`: also emit graph_edge/health_sample_dict.pkl
        (health-stratified second-negative buckets, the shape the runtime
        loads; the reference repo consumes but never generates this file).
    `device`: where the k-means runs ("cuda" unless "cpu" is asked for).

    Returns the counts, the id maps, the base directory, the two
    KMeansResults (`kmeans`) and the seconds of each stage (`stage_s`).
    """
    import time

    stage_s = defaultdict(float)
    t = [time.perf_counter()]

    def lap(stage):
        now = time.perf_counter()
        stage_s[stage] += now - t[0]
        t[0] = now

    base = os.path.join(out_root, "processed_dataset")
    os.makedirs(base, exist_ok=True)

    if presplit is not None:
        train, valid, test = presplit
    else:
        df = k_core_filter(interactions, user_col, item_col, k=k_core)
        lap("k_core")
        train, valid, test = temporal_split(df, date_col, user_col)
        lap("split")
    (train, valid, test), user_to_idx, item_to_idx = encode_ids(
        [train, valid, test], user_col, item_col)
    n_users = len(user_to_idx)
    n_items = len(item_to_idx)
    write_rating_files(base, train, valid, test)
    lap("encode")

    sample_eval_negatives(train, valid, n_items,
                          os.path.join(base, "data.valid.negative"),
                          n_neg=n_neg, seed=seed)
    sample_eval_negatives(train, test, n_items,
                          os.path.join(base, "data.test.negative"),
                          n_neg=n_neg, seed=seed)
    lap("negatives")

    raw_in_idx_order = sorted(item_to_idx, key=item_to_idx.get)
    image_features = np.stack([np.asarray(image_features[r], np.float32)
                               for r in raw_in_idx_order])
    text_features = np.stack([np.asarray(text_features[r], np.float32)
                              for r in raw_in_idx_order])
    np.save(os.path.join(base, "data_image_features_float.npy"),
            image_features)
    np.save(os.path.join(base, "data_text_features_t5.npy"), text_features)
    lap("features")

    item_to_ingres = {item_to_idx[r]: v for r, v in item_to_ingres.items()
                      if r in item_to_idx}
    _, _, ingre_to_idx = build_ingredient_codes(item_to_ingres, n_items, base)
    with open(os.path.join(base, "mapping_dict.pkl"), "wb") as f:
        pickle.dump((user_to_idx, item_to_idx, ingre_to_idx), f)
    # graph_edge copy of ri_graph (non-small_ingre path)
    gdir = os.path.join(base, "graph_edge")
    os.makedirs(gdir, exist_ok=True)
    shutil.copy(os.path.join(base, "ri_graph.txt"),
                os.path.join(gdir, "ri_graph.txt"))

    if ingre_names is not None:
        names_by_idx = {ingre_to_idx[r]: str(ingre_names[r])
                        for r in ingre_to_idx if r in ingre_names}
        ii = keyword_tag_edges(names_by_idx,
                               singleton_keep_p=ii_singleton_keep_p,
                               seed=seed)
        np.savetxt(os.path.join(gdir, "ii_graph.txt"), ii, fmt="%d")

    write_train_artifacts(train, n_users, n_items, base)
    if calories_by_item is not None:
        build_calorie_levels(
            {item_to_idx[r]: c for r, c in calories_by_item.items()
             if r in item_to_idx}, base, bucket=cal_bucket)
    lap("ingredients_graphs")
    if nutrition_df is not None:
        ndf = _rows(nutrition_df, _isin(nutrition_df[item_col], item_to_idx))
        ndf["i"] = np.fromiter((item_to_idx[r] for r in
                                ndf[item_col].tolist()), dtype=np.int64,
                               count=len(ndf[item_col]))
        score, _ = build_health_levels(ndf, base, criteria=health_criteria)
        if write_health_sample:
            # runtime contract (dataset.py:286-292 / reference
            # dataloader.py:22-25): (neg_sample_set, health_0..health_5);
            # scores above 5 fold into the top bucket
            by_level = [[] for _ in range(6)]
            for i, s in enumerate(score.tolist()):
                by_level[min(s, 5)].append(i)
            neg_sample_set = set(train["u"].tolist())
            with open(os.path.join(gdir, "health_sample_dict.pkl"),
                      "wb") as f:
                pickle.dump((neg_sample_set, *by_level), f)
        lap("health")

    cluster_dir = os.path.join(base, "cluster")
    kmeans = {}
    for modality, feats in (("image", image_features),
                            ("text", text_features)):
        _, kmeans[modality] = kmeans_cluster_edges(
            feats, cluster_dir, modality, n_clusters=n_clusters, seed=seed,
            device=device)
        lap(f"kmeans_{modality}")
    # CLUSSL's pretrained-center location (pricai_modelx.py:78-80)
    mm_dir = os.path.join(base, "mm_cluster")
    os.makedirs(mm_dir, exist_ok=True)
    for modality in ("image", "text"):
        shutil.copy(os.path.join(cluster_dir, f"{modality}_center.npy"),
                    os.path.join(mm_dir, f"{modality}_center.npy"))

    return {"n_users": n_users, "n_items": n_items,
            "user_to_idx": user_to_idx, "item_to_idx": item_to_idx,
            "base": base, "kmeans": kmeans, "stage_s": dict(stage_s)}
