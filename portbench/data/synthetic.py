# coding: utf-8
"""The benchmark's frozen copy of the port's synthetic dataset generator
(`foodrec_tpu_torch/data/synthetic.py` as of the benchmark's first
version): the FoodRec on-disk dataset contract at any scale, from a seed.
Later changes to the port's generator do not move the benchmark's data.

The one departure from the port's generator: the study splits (cold/warm,
sense/unsense, per-health-level), which no benchmark configuration reads,
are not written. They came last in the generator's draws, so every file
written here is byte-identical to the port's generator's at the same
arguments.

Conventions reproduced:
  * rating files are tab-separated "user\titem\trating", users in consecutive
    sorted runs starting at 0 for train/test (FoodRec/utils/dataset.py:137-155)
  * .negative rows are "(u:[pos..])\tneg1\t...\tnegK" (dataset.py:245-256)
  * ingredient code matrix is [n_items, 20] padded with n_ingredients
    (dataloader.py:127; foodcom_process.ipynb cell 8)
  * graph txt files are whitespace int pairs (dataset.py:341-343)
"""

import os
import pickle

import numpy as np
import scipy.sparse as sp

MAX_INGRE_LEN = 20


def generate(root, n_users=24, n_items=60, n_ingredients=12, n_cal_levels=4,
             n_health_levels=6, n_clusters=5, img_dim=16, txt_dim=8,
             neg_num=20, seed=0, train_per_user=(2, 6), valid_per_user=(0, 3),
             test_per_user=(1, 3), latent_dim=0):
    """Write a full synthetic dataset under `root/processed_dataset/`.

    Scale knobs (`n_users=7596, n_items=29943, n_ingredients=4963,
    img_dim=2048, txt_dim=512, neg_num=500, train_per_user=(20, 31)`)
    reproduce the Foodcom footprint from BASELINE.md for benchmarking.

    `latent_dim > 0` plants a learnable signal: users/items get latent
    factors, each user's positives are their highest-scoring items among a
    random candidate pool, and the image/text features are noisy linear
    images of the item factors — so CF models reach AUC >> 0.5 and accuracy
    parity between frameworks becomes measurable.
    """
    rng = np.random.default_rng(seed)
    z_u = z_i = None
    if latent_dim:
        z_u = rng.normal(size=(n_users, latent_dim)) / np.sqrt(latent_dim)
        z_i = rng.normal(size=(n_items, latent_dim)) / np.sqrt(latent_dim)
    base = os.path.join(root, "processed_dataset")
    graph_dir = os.path.join(base, "graph_edge")
    cluster_dir = os.path.join(base, "cluster")
    os.makedirs(graph_dir, exist_ok=True)
    os.makedirs(cluster_dir, exist_ok=True)

    # --- interactions: every user has train + test items; 80% have valid ----
    train_rows, valid_rows, test_rows = [], [], []
    user_pos = {}
    for u in range(n_users):
        n_tr = int(rng.integers(*train_per_user))
        n_va = (int(rng.integers(*valid_per_user))
                if (valid_per_user[1] > 1 and rng.random() < 0.8) else 0)
        n_te = int(rng.integers(*test_per_user))
        k = n_tr + n_va + n_te
        if z_u is not None:
            # positives = the user's top-k items from a random candidate pool
            pool = rng.choice(n_items, size=min(8 * k, n_items),
                              replace=False)
            scores = z_i[pool] @ z_u[u]
            items = pool[np.argsort(scores)[::-1][:k]]
            items = rng.permutation(items)
        else:
            items = rng.choice(n_items, size=k, replace=False)
        tr, va, te = items[:n_tr], items[n_tr:n_tr + n_va], items[n_tr + n_va:]
        user_pos[u] = set(items.tolist())
        train_rows += [(u, int(i)) for i in sorted(tr)]
        valid_rows += [(u, int(i)) for i in sorted(va)]
        test_rows += [(u, int(i)) for i in sorted(te)]
    # pin the id range: make sure items 0 and n_items-1 appear in train
    train_rows[0] = (0, 0)
    train_rows[-1] = (n_users - 1, n_items - 1)
    user_pos[0].add(0)
    user_pos[n_users - 1].add(n_items - 1)
    # dedupe (pinning may collide with a sampled pair); keeps user runs intact
    train_rows = list(dict.fromkeys(train_rows))

    def write_ratings(path, rows):
        with open(path, "w") as f:
            for u, i in rows:
                f.write(f"{u}\t{i}\t5.0\t0\n")

    write_ratings(os.path.join(base, "data.train.rating"), train_rows)
    write_ratings(os.path.join(base, "data.valid.rating"), valid_rows)
    write_ratings(os.path.join(base, "data.test.rating"), test_rows)

    # --- negatives -----------------------------------------------------------
    def sample_negs(u):
        cand = np.setdiff1d(np.arange(n_items), np.fromiter(user_pos[u], dtype=int))
        return rng.choice(cand, size=neg_num, replace=False)

    valid_users = sorted({u for u, _ in valid_rows})
    with open(os.path.join(base, "data.valid.negative"), "w") as f:
        for u in valid_users:
            negs = "\t".join(str(int(x)) for x in sample_negs(u))
            f.write(f"(u:{u})\t{negs}\n")
    with open(os.path.join(base, "data.test.negative"), "w") as f:
        for u in range(n_users):
            negs = "\t".join(str(int(x)) for x in sample_negs(u))
            f.write(f"(u:{u})\t{negs}\n")

    # --- modality features ---------------------------------------------------
    if z_i is not None:
        img = (z_i @ rng.normal(size=(z_i.shape[1], img_dim))
               + 0.5 * rng.normal(size=(n_items, img_dim)))
        txt = (z_i @ rng.normal(size=(z_i.shape[1], txt_dim))
               + 0.5 * rng.normal(size=(n_items, txt_dim)))
    else:
        img = rng.normal(size=(n_items, img_dim))
        txt = rng.normal(size=(n_items, txt_dim))
    np.save(os.path.join(base, "data_image_features_float.npy"),
            img.astype(np.float32))
    np.save(os.path.join(base, "data_text_features_t5.npy"),
            txt.astype(np.float32))

    # --- ingredients ----------------------------------------------------------
    ingre_codes = np.full((n_items, MAX_INGRE_LEN), n_ingredients, dtype=np.int64)
    ingre_num = np.zeros(n_items, dtype=np.int64)
    for i in range(n_items):
        k = int(rng.integers(1, min(7, n_ingredients)))
        ingre_num[i] = k
        ingre_codes[i, :k] = rng.choice(n_ingredients, size=k, replace=False)
    # ensure the max code value equals n_ingredients (the pad) so
    # num_ingredients = max(codes) holds (dataset.py:53)
    np.save(os.path.join(base, "data_ingre_code_file.npy"), ingre_codes)
    with open(os.path.join(base, "data_id_ingre_num_file"), "w") as f:
        for i in range(n_items):
            f.write(f"{i}\t{int(ingre_num[i])}\n")

    # --- train COO pickle -----------------------------------------------------
    tr_u = np.array([u for u, _ in train_rows])
    tr_i = np.array([i for _, i in train_rows])
    coo = sp.coo_matrix((np.ones(len(tr_u), np.float32), (tr_u, tr_i)),
                        shape=(n_users, n_items))
    with open(os.path.join(base, "inter_coo_matrix.pkl"), "wb") as f:
        pickle.dump(coo, f)

    # --- graphs ----------------------------------------------------------------
    def write_pairs(path, pairs):
        with open(path, "w") as f:
            for a, b in pairs:
                f.write(f"{int(a)}\t{int(b)}\n")

    write_pairs(os.path.join(graph_dir, "ur_graph.txt"), train_rows)
    ri_pairs = [(i, int(c)) for i in range(n_items)
                for c in ingre_codes[i, :ingre_num[i]]]
    write_pairs(os.path.join(graph_dir, "ri_graph.txt"), ri_pairs)
    write_pairs(os.path.join(base, "ri_graph.txt"), ri_pairs)  # small_ingre path
    ii_pairs = [(int(rng.integers(n_ingredients)), int(rng.integers(n_ingredients)))
                for _ in range(3 * n_ingredients)]
    write_pairs(os.path.join(graph_dir, "ii_graph.txt"), ii_pairs)

    cal_level = {i: int(rng.integers(n_cal_levels)) for i in range(n_items)}
    # every level must appear so num_calories_level = max+1 is stable
    for lvl in range(n_cal_levels):
        cal_level[lvl % n_items] = lvl
    write_pairs(os.path.join(graph_dir, "rc_graph.txt"),
                [(i, cal_level[i]) for i in range(n_items)])
    health_level = {i: int(rng.integers(n_health_levels)) for i in range(n_items)}
    for lvl in range(n_health_levels):
        health_level[lvl % n_items] = lvl
    write_pairs(os.path.join(graph_dir, "rh_graph.txt"),
                [(i, health_level[i]) for i in range(n_items)])

    with open(os.path.join(graph_dir, "recipe_cal_level_dict.pkl"), "wb") as f:
        pickle.dump(cal_level, f)
    with open(os.path.join(graph_dir, "recipe_health_level_dict.pkl"), "wb") as f:
        pickle.dump(health_level, f)
    multi_hot = {i: rng.integers(0, 2, size=n_health_levels).astype(np.float32)
                 for i in range(n_items)}
    with open(os.path.join(graph_dir, "recipe_health_level_multi_hot_dict.pkl"),
              "wb") as f:
        pickle.dump(multi_hot, f)

    # health-stratified second-negative buckets (dataloader.py:22-25):
    # pickle = (neg_sample_set, health_0, ..., health_5); always 6 buckets
    by_level = [[i for i in range(n_items) if health_level[i] == lvl]
                for lvl in range(6)]
    neg_sample_set = set(range(0, n_users, 2))
    with open(os.path.join(graph_dir, "health_sample_dict.pkl"), "wb") as f:
        pickle.dump((neg_sample_set, *by_level), f)

    # --- kmeans cluster graphs (CLUSSL input; 6 edges/item upstream, fewer here)
    mm_cluster_dir = os.path.join(base, "mm_cluster")
    os.makedirs(mm_cluster_dir, exist_ok=True)
    for modality in ("image", "text"):
        pairs = [(i, int(rng.integers(n_clusters)))
                 for i in range(n_items) for _ in range(2)]
        with open(os.path.join(cluster_dir, f"{modality}_cluster_edge.txt"), "w") as f:
            for a, b in pairs:
                f.write(f"{a} {b}\n")
        # pretrained center path read by PRICAI_ModelX when
        # use_center_embedding (pricai_modelx.py:78-80)
        np.save(os.path.join(mm_cluster_dir, f"{modality}_center.npy"),
                rng.normal(size=(n_clusters, img_dim if modality == "image" else txt_dim)
                           ).astype(np.float32))

    # Completion sentinel, written LAST. Generation at scale takes minutes
    # and writes data.train.rating first — a concurrent reader that keys
    # "dataset exists" off any data file can load a half-written dataset
    # (observed: health_level dicts land ~5 min after the rating files at
    # the 68.8k-user Allrecipes scale). Readers must key off this file.
    with open(os.path.join(base, "_GEN_COMPLETE"), "w") as f:
        f.write("ok\n")

    return {
        "n_users": n_users, "n_items": n_items, "n_ingredients": n_ingredients,
        "n_cal_levels": n_cal_levels, "n_health_levels": n_health_levels,
        "n_clusters": n_clusters, "neg_num": neg_num,
        "n_train": len(train_rows), "n_valid": len(valid_rows),
        "n_test": len(test_rows),
    }
