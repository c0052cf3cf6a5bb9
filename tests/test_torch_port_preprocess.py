"""PyTorch port: the offline pipeline's stages (foodrec_tpu_torch.data.
preprocess) against the JAX package's on the same inputs, on the CPU.

  * every stage on a tie-heavy raw table (thousands of rows on a few dozen
    day-resolution dates): the same rows in the same order, and
    byte-identical files and pickles
  * build_dataset on both sides: every file byte-identical except cluster/
    and mm_cluster/, whose k-means differs by design
  * the cluster edge step on the *same* centers (scikit-learn's
    MiniBatchKMeans replaced by a fake that returns them, so the JAX loop
    runs): equal edge files, in float64
  * the port's mini-batch k-means: inertia within 1.02x of scikit-learn's
    (median over 3 seeds) on clustered data
  * the T5 / ResNet-50 extractors with the JAX tests' fakes, within 1e-6

A table is a dict of column -> numpy array; a pandas DataFrame becomes one
through `_table`. Torch runs on one thread (the suite's workers share the
machine's cores).
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from foodrec_tpu.data import preprocess as jpp
from foodrec_tpu_torch.data import kmeans as pkm
from foodrec_tpu_torch.data import preprocess as ppp
from torch_port_fixtures import device  # noqa: F401

N_DATES = 30


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: the suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(df):
    return {c: df[c].to_numpy() for c in df.columns}


def _same_table(table, df):
    assert list(table) == list(df.columns)
    for c in df.columns:
        want = df[c].to_numpy()
        assert table[c].dtype.kind == want.dtype.kind or (
            table[c].dtype == object), c
        np.testing.assert_array_equal(table[c], want, err_msg=c)


def _raw(seed=0, n_users=300, n_items=150, n_rows=6000):
    """Tie-heavy interactions: thousands of rows on N_DATES dates, Zipf-ish
    users and items, repeated (user, item) pairs dropped."""
    rng = np.random.default_rng(seed)
    u = 1000 + np.minimum(rng.zipf(1.3, n_rows), n_users) - 1
    i = 5000 + rng.integers(0, n_items, n_rows)
    days = rng.integers(1, N_DATES + 1, n_rows)
    df = pd.DataFrame({"user_id": u, "recipe_id": i,
                       "date": [f"2020-03-{d:02d}" for d in days]})
    return df.drop_duplicates(["user_id", "recipe_id"]).reset_index(drop=True)


def _metadata(raw, seed=3, n_ingredients=200):
    rng = np.random.default_rng(seed)
    items = sorted(set(raw["recipe_id"]))
    item_to_ingres = {r: rng.choice(n_ingredients, size=int(
        rng.integers(2, 25)), replace=False).tolist() for r in items}
    img = {r: rng.normal(size=16).astype(np.float32) for r in items}
    txt = {r: rng.normal(size=8).astype(np.float32) for r in items}
    cals = {r: float(rng.integers(50, 900)) for r in items}
    ndf = pd.DataFrame([{
        "recipe_id": r, "fat": float(rng.integers(10, 35)),
        "sugar": float(rng.integers(0, 15)),
        "sodium": float(rng.integers(0, 100)),
        "protein": float(rng.integers(8, 18)),
        "saturated_fat": float(rng.integers(0, 15)),
        "carbohydrates": float(rng.integers(50, 80)),
        "fiber": float(rng.integers(0, 20))} for r in items])
    ndf.loc[::7, "fat"] = np.nan   # a NaN passes no criterion
    names = {g: f"{['red', 'white', 'dry', 'plain'][g % 4]} thing {g}"
             for g in range(n_ingredients)}
    return item_to_ingres, img, txt, cals, ndf, names


def _split(df):
    core = jpp.k_core_filter(df, k=3)
    return core, jpp.temporal_split(core)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_files(got_dir, want_dir, skip=()):
    got, want = _files(got_dir), _files(want_dir)
    got = {k: v for k, v in got.items() if not k.startswith(skip)}
    want = {k: v for k, v in want.items() if not k.startswith(skip)}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    return sorted(want)


def test_k_core_and_split_keep_pandas_rows_and_tie_order():
    df = _raw()
    assert df["date"].value_counts().min() > 50   # heavy ties
    core, (jtr, jva, jte) = _split(df)
    pcore = ppp.k_core_filter(_table(df), k=3)
    _same_table(pcore, core)
    ptr, pva, pte = ppp.temporal_split(pcore)
    for got, want in ((ptr, jtr), (pva, jva), (pte, jte)):
        _same_table(got, want)
    # a different stable order would show: the ties are in row order
    assert not np.array_equal(
        np.argsort(pcore["date"].astype(str), kind="quicksort"),
        np.argsort(pcore["date"].astype(str), kind="stable"))


def test_encode_ids_maps_and_columns():
    _, splits = _split(_raw())
    (jtr, jva, jte), ju, ji = jpp.encode_ids(list(splits))
    (ptr, pva, pte), pu, pi = ppp.encode_ids([_table(s) for s in splits])
    assert pickle.dumps((pu, pi)) == pickle.dumps((ju, ji))
    for got, want in ((ptr, jtr), (pva, jva), (pte, jte)):
        np.testing.assert_array_equal(got["u"], want["u"].to_numpy())
        np.testing.assert_array_equal(got["i"], want["i"].to_numpy())


@pytest.fixture(scope="module")
def encoded():
    _, splits = _split(_raw())
    (jtr, jva, jte), ju, ji = jpp.encode_ids(list(splits))
    ports = [_table(s) for s in (jtr, jva, jte)]
    return (jtr, jva, jte), ports, len(ju), len(ji)


def test_rating_and_negative_files_are_byte_identical(encoded, tmp_path):
    (jtr, jva, jte), (ptr, pva, pte), n_users, n_items = encoded
    jpp.write_rating_files(str(tmp_path / "j"), jtr, jva, jte)
    ppp.write_rating_files(str(tmp_path / "p"), ptr, pva, pte)
    for split, psplit, name in ((jva, pva, "valid"), (jte, pte, "test")):
        jpp.sample_eval_negatives(jtr, split, n_items,
                                  str(tmp_path / "j" / f"{name}.negative"),
                                  n_neg=20, seed=2024)
        ppp.sample_eval_negatives(ptr, psplit, n_items,
                                  str(tmp_path / "p" / f"{name}.negative"),
                                  n_neg=20, seed=2024)
    names = _assert_same_files(str(tmp_path / "p"), str(tmp_path / "j"))
    assert len(names) == 5
    text = (tmp_path / "p" / "test.negative").read_text()
    assert "np.int64" not in text and text.count("\n") > 10


def test_train_artifacts_and_calorie_levels(encoded, tmp_path):
    (jtr, _, _), (ptr, _, _), n_users, n_items = encoded
    cals = {i: float(c) for i, c in enumerate(
        np.random.default_rng(5).integers(0, 2000, n_items))}
    for pkg, train, d in ((jpp, jtr, "j"), (ppp, ptr, "p")):
        os.makedirs(tmp_path / d)
        pkg.write_train_artifacts(train, n_users, n_items, str(tmp_path / d))
        pkg.build_calorie_levels(cals, str(tmp_path / d), bucket=30)
    names = _assert_same_files(str(tmp_path / "p"), str(tmp_path / "j"))
    assert "inter_coo_matrix.pkl" in names


def test_ingredient_codes_and_keyword_edges(tmp_path):
    rng = np.random.default_rng(2)
    item_to_ingres = {i: [f"g{x}" for x in rng.choice(
        60, size=int(rng.integers(0, 30)), replace=False)]
        for i in range(50) if i != 7}
    for pkg, d in ((jpp, "j"), (ppp, "p")):
        _, _, to_idx = pkg.build_ingredient_codes(item_to_ingres, 50,
                                                  str(tmp_path / d))
    _assert_same_files(str(tmp_path / "p"), str(tmp_path / "j"))
    names = {k: v for k, v in enumerate(
        ["red pepper", "dry red wine", "white rice", "sliced white bread",
         "deep-fry oil", "fried egg", "steamed bun", "black pickle",
         "minced green chili", "salt", "yellow powder", "dry rub"] * 3)}
    for p in (None, 0.3, 0.6):
        np.testing.assert_array_equal(
            ppp.keyword_tag_edges(names, singleton_keep_p=p),
            jpp.keyword_tag_edges(names, singleton_keep_p=p))
    tags = {i: set(rng.choice(8, size=3).tolist()) for i in range(30)}
    for thr in (0, 1):
        np.testing.assert_array_equal(
            ppp.cooccurrence_graph(tags, 32, threshold=thr),
            jpp.cooccurrence_graph(tags, 32, threshold=thr))


@pytest.mark.parametrize("variant", ["foodcom", "allrecipes"])
def test_health_levels_are_byte_identical(variant, tmp_path):
    *_, ndf, _ = _metadata(_raw())
    ndf = ndf.sample(frac=1.0, random_state=0)   # rows out of item order
    ndf["i"] = np.arange(len(ndf))[::-1]
    ndf = ndf.iloc[3:]                            # items without a row
    crit = {"foodcom": (jpp.FOODCOM_HEALTH_CRITERIA,
                        ppp.FOODCOM_HEALTH_CRITERIA),
            "allrecipes": (jpp.ALLRECIPES_HEALTH_CRITERIA,
                           ppp.ALLRECIPES_HEALTH_CRITERIA)}[variant]
    js, jf = jpp.build_health_levels(ndf, str(tmp_path / "j"),
                                     criteria=crit[0])
    ps, pf = ppp.build_health_levels(_table(ndf), str(tmp_path / "p"),
                                     criteria=crit[1])
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pf, jf)
    _assert_same_files(str(tmp_path / "p"), str(tmp_path / "j"))
    rr = np.loadtxt(tmp_path / "p" / "graph_edge" / "rr_health_graph.txt",
                    dtype=np.int64, ndmin=2)
    assert len(rr) > 100 and rr[:, 2].min() > 3


def test_build_dataset_writes_identical_files(tmp_path):
    raw = _raw(seed=4)
    item_to_ingres, img, txt, cals, ndf, names = _metadata(raw, seed=4)
    kw = dict(calories_by_item=cals, k_core=3, n_neg=20, n_clusters=6,
              ingre_names=names, ii_singleton_keep_p=0.5,
              write_health_sample=True)
    jout = jpp.build_dataset(str(tmp_path / "J"), raw, item_to_ingres, img,
                             txt, nutrition_df=ndf, **kw)
    pout = ppp.build_dataset(str(tmp_path / "P"), _table(raw),
                             item_to_ingres, img, txt,
                             nutrition_df=_table(ndf), device="cpu", **kw)
    assert (pout["n_users"], pout["n_items"]) == \
        (jout["n_users"], jout["n_items"])
    names = _assert_same_files(pout["base"], jout["base"],
                               skip=("cluster", "mm_cluster"))
    assert len(names) == 23, names
    for modality in ("image", "text"):
        edges = np.loadtxt(os.path.join(pout["base"], "cluster",
                                        f"{modality}_cluster_edge.txt"),
                           dtype=np.int64)
        assert edges.shape == (6 * pout["n_items"], 2)
        centers = np.load(os.path.join(pout["base"], "mm_cluster",
                                       f"{modality}_center.npy"))
        assert centers.shape[0] == 6 and centers.dtype == np.float32
        km = pout["kmeans"][modality]
        assert km.inertia <= km.init_inertia


class _FixedKMeans:
    """scikit-learn's MiniBatchKMeans, replaced: fit() keeps given centers."""
    centers = None

    def __init__(self, **kwargs):
        pass

    def fit(self, x):
        self.cluster_centers_ = self.centers
        return self


def test_edge_step_matches_jax_for_the_same_centers(monkeypatch, tmp_path):
    import sklearn.cluster

    rng = np.random.default_rng(7)
    x = rng.normal(size=(700, 24))
    centers = rng.normal(size=(40, 24))
    monkeypatch.setattr(_FixedKMeans, "centers", centers)
    monkeypatch.setattr(sklearn.cluster, "MiniBatchKMeans", _FixedKMeans)
    monkeypatch.setattr(pkm, "minibatch_kmeans", lambda *a, **k:
                        pkm.KMeansResult(centers, 0.0, 0.0, 0))
    jpp.kmeans_cluster_edges(x, str(tmp_path / "j"), "image",
                             n_clusters=40, chunk=256)
    ppp.kmeans_cluster_edges(x, str(tmp_path / "p"), "image",
                             n_clusters=40, chunk=256, device="cpu")
    _assert_same_files(str(tmp_path / "p"), str(tmp_path / "j"))
    got = pkm.nearest_centers(x, centers, 10, device="cpu")
    d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got, np.argsort(d, axis=1)[:, :10])


def test_kmeans_inertia_within_2_percent_of_sklearn():
    from sklearn.cluster import MiniBatchKMeans

    rng = np.random.default_rng(11)
    means = rng.normal(scale=6.0, size=(20, 32))
    x = (means[rng.integers(0, 20, 2000)]
         + rng.normal(size=(2000, 32))).astype(np.float32)
    ours, theirs = [], []
    for seed in (0, 1, 2):
        km = pkm.minibatch_kmeans(x, 20, seed=seed, device="cpu")
        assert km.centers.shape == (20, 32) and km.centers.dtype == np.float32
        assert km.inertia < km.init_inertia and km.n_steps > 1
        ours.append(km.inertia)
        theirs.append(MiniBatchKMeans(
            n_clusters=20, init_size=512, batch_size=1024, random_state=seed,
            n_init=3).fit(x).inertia_)
    assert np.median(ours) <= 1.02 * np.median(theirs), (ours, theirs)


def test_kmeans_reassigns_and_fills_every_cluster(device):
    """More clusters than the data's blobs: the low-count reassignment keeps
    no centre empty, and the fit stops early (on the card, from the CUDA
    generator's draws)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3000, 8))
    km = pkm.minibatch_kmeans(x, 300, seed=5, device=device)
    assert km.centers.dtype == np.float64
    labels, inertia = pkm.labels_inertia(torch.from_numpy(x),
                                         torch.from_numpy(km.centers))
    assert float(inertia) == pytest.approx(km.inertia)
    assert len(np.unique(labels.numpy())) > 250
    assert km.n_steps < pkm.MAX_ITER * 3000 // pkm.BATCH_SIZE


def test_pipeline_entry_points_ask_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pkm.minibatch_kmeans(np.zeros((4, 2), np.float32), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ppp.t5_text_features(["a"], tokenizer=object(), encoder=object())


def test_extractors_match_jax_with_the_fakes(tmp_path):
    from test_feature_extractors import (FakeBackbone, FakeEncoder,
                                               FakeTokenizer, _write_images)

    texts = [f"recipe number {i}" for i in range(7)]
    kw = dict(batch_size=3, tokenizer=FakeTokenizer(),
              encoder=FakeEncoder(hidden=512))
    want = jpp.t5_text_features(texts, **kw)
    got = ppp.t5_text_features(texts, device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == (7, 512)
    np.testing.assert_allclose(got, want, rtol=1e-6)

    paths = _write_images(tmp_path, 5)

    def ident(img):
        return torch.as_tensor(
            np.asarray(img, dtype=np.float32) / 255.0).permute(2, 0, 1)

    kw = dict(batch_size=2, backbone=FakeBackbone(), transform=ident)
    want = jpp.resnet50_image_features(paths, **kw)
    got = ppp.resnet50_image_features(paths, device="cpu", **kw)
    assert got.shape == (5, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_extractors_name_the_missing_package(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(ImportError, match="transformers"):
        ppp.t5_text_features(["a"], device="cpu")
    with pytest.raises(ImportError, match="torchvision"):
        ppp.resnet50_image_features(["x.jpg"], device="cpu")
