# coding: utf-8
"""Offline-pipeline CLI: raw dataset files -> the on-disk contract, the
k-means on the card.

Counterpart of `foodrec_tpu/data/preprocess_cli.py`, with the same formats
and flags plus `--device`; CSVs are parsed with the `csv` module (quoted,
multi-line fields included) into tables of numpy columns, typed as pandas'
read_csv types them:

    python -m foodrec_tpu_torch.data.preprocess_cli --format foodcom \
        --raw-dir /data/Foodcom/raw_dataset --out /data/Foodcom \
        [--image-dir /data/Foodcom/image_dataset] [--features extract]

    python -m foodrec_tpu_torch.data.preprocess_cli --format allrecipes \
        --raw-dir /data/Allrecipes/raw_dataset --out /data/Allrecipes

    python -m foodrec_tpu_torch.data.preprocess_cli --format generic \
        --raw-dir my_raw/ --out /data/MyDS [--device cpu]

Raw inputs per format:

* foodcom (Kaggle "Food.com Recipes and Interactions";
  foodcom_process.ipynb cells 0-32): RAW_interactions.csv
  (user_id, recipe_id, date, ...), PP_recipes.csv (id, ingredient_ids as a
  stringified list), RAW_recipes.csv (id, nutrition as a stringified 7-list
  [cal, fat, sugar, sodium, protein, saturated_fat, carbohydrates]),
  optional ingr_map.pkl (a pickled pandas DataFrame with id, processed —
  enables the keyword ii_graph and text extraction; reading it needs
  pandas), optional --image-dir with <recipe_id>.jpg (restricts items to
  those with images, cell 1).
* allrecipes (Kaggle foodRecSys-V1; allrecipes_process.ipynb cells 0-30):
  core-data-{train,valid,test}_rating.csv (user_id, recipe_id, rating,
  dateLastModified — the dataset's own splits are kept, no k-core/temporal
  re-split), core-data_recipe.csv (recipe_id, recipe_name, ingredients
  '^'-separated names, nutritions as a stringified dict). Calorie bucket is
  30 (vs foodcom's 50) and the 7-criterion health variant applies.
* generic: interactions.csv (user_id, item_id, date[, rating]),
  ingredients.csv (item_id, ingredients '^'-separated names), optional
  calories.csv (item_id, calories), optional nutrition.csv (item_id, fat,
  sugar, sodium, protein, saturated_fat, carbohydrates[, fiber]), optional
  images/<item_id>.jpg.

Feature modes: `--features synthesize` (default) writes seeded random
normal features of --image-dim/--text-dim — the dataset loads and trains
everywhere, but modality signal is noise; use only for smoke/scale testing.
`--features extract` runs the T5-small / ResNet-50 extractors on --device
(preprocess.t5_text_features / resnet50_image_features; needs
`transformers` / `torchvision`, downloadable weights and an image dir).
Reference text semantics are kept: item text feature = mean(ingredient-name
embeddings + title embedding) (foodcom cells 9-14).
"""

import argparse
import ast
import csv
import os
import re
import sys
import time

import numpy as np

from . import preprocess as pp

# foodcom RAW_recipes.csv `nutrition` list layout (cells 28-29)
_FOODCOM_NUTRI_COLS = ("cal", "fat", "sugar", "sodium", "protein",
                       "saturated_fat", "carbohydrates")
# the strings pandas' read_csv reads as missing by default
_NA = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"))
_INT = re.compile(r"[+-]?\d+\Z")


def _column(values):
    """A numpy column of parsed values, typed as pandas types a column:
    int64 when every value is an int, float64 when every value is a number
    or missing (NaN), else object."""
    if all(type(v) is int for v in values):
        return np.array(values, dtype=np.int64)
    if all(type(v) in (int, float) or v is None for v in values):
        return np.array([np.nan if v is None else v for v in values],
                        dtype=np.float64)
    return np.array([np.nan if v is None else v for v in values],
                    dtype=object)


def _typed(strings):
    """A CSV column of strings as pandas' read_csv types it: int64, float64
    (missing values NaN) or object strings (missing values NaN)."""
    if strings and all(map(str.isdigit, strings)) and \
            all(map(str.isascii, strings)):
        return np.fromiter(map(int, strings), dtype=np.int64,
                           count=len(strings))
    present = [s for s in strings if s not in _NA]
    if present and all(_INT.match(s) for s in present) and \
            len(present) == len(strings):
        return np.array([int(s) for s in strings], dtype=np.int64)
    try:
        return np.array([np.nan if s in _NA else float(s) for s in strings],
                        dtype=np.float64)
    except ValueError:
        return np.array([np.nan if s in _NA else s for s in strings],
                        dtype=object)


def _read_csv(path, usecols=None):
    """A CSV file with a header row -> table (dict column -> numpy array) of
    the columns `usecols` (all when None)."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        names = header if usecols is None else [c for c in usecols
                                                 if c in header]
        rows = [row for row in reader if row]
    return {name: _typed([r[j] if j < len(r) else "" for r in rows])
            for name, j in ((c, header.index(c)) for c in names)}


def _to_number(v):
    if isinstance(v, (int, float, np.integer, np.floating)) and \
            not isinstance(v, bool):
        return float(v)
    if isinstance(v, str) and "_" not in v:
        try:
            return float(v)
        except ValueError:
            pass
    return np.nan


def _clean_numeric(values, default=None):
    """Allrecipes %DV cleanup (cell 27): '< 1' -> 0, numbers coerced (NaN
    where a value does not parse), NaN -> the column's median (0 when
    every value is NaN)."""
    s = np.array([_to_number("0" if isinstance(v, str) and v == "< 1" else v)
                  for v in values], dtype=np.float64)
    present = s[~np.isnan(s)]
    fill = (float(np.median(present)) if len(present) else np.nan) \
        if default is None else default
    s[np.isnan(s)] = 0.0 if np.isnan(fill) else fill
    return s


def load_foodcom_raw(raw_dir, image_dir=None):
    """-> dict of build_dataset inputs (foodcom_process.ipynb cells 0-1,
    7, 28-29)."""
    inter = _read_csv(os.path.join(raw_dir, "RAW_interactions.csv"),
                     usecols=("user_id", "recipe_id", "date"))
    ppr = _read_csv(os.path.join(raw_dir, "PP_recipes.csv"),
                   usecols=("id", "ingredient_ids"))
    inter = pp._rows(inter, pp._isin(inter["recipe_id"],
                                     set(ppr["id"].tolist())))
    if image_dir is not None:
        have = set()
        for fn in os.listdir(image_dir):
            stem = os.path.splitext(fn)[0]
            if stem.lstrip("-").isdigit():
                have.add(int(stem))
        inter = pp._rows(inter, pp._isin(inter["recipe_id"], have))

    item_to_ingres = {
        int(i): list(ids) for i, ids in zip(ppr["id"].tolist(), (
            ast.literal_eval(str(x)) for x in ppr["ingredient_ids"].tolist()))}

    raw_recipes = _read_csv(os.path.join(raw_dir, "RAW_recipes.csv"),
                           usecols=("id", "name", "nutrition"))
    nutri = [ast.literal_eval(str(x))
             for x in raw_recipes["nutrition"].tolist()]
    width = len(_FOODCOM_NUTRI_COLS)
    if any(len(v) > width for v in nutri):
        raise ValueError(f"a nutrition list has more than {width} values")
    ndf = {c: _column([v[k] if k < len(v) else None for v in nutri])
           for k, c in enumerate(_FOODCOM_NUTRI_COLS)}
    ndf["recipe_id"] = raw_recipes["id"]
    calories = dict(zip(ndf["recipe_id"].tolist(), ndf["cal"].tolist()))

    ingre_names = None
    ingr_map_path = os.path.join(raw_dir, "ingr_map.pkl")
    if os.path.isfile(ingr_map_path):
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError(
                f"{ingr_map_path} is a pickled pandas DataFrame: reading it "
                "needs the `pandas` package") from e
        imap = pd.read_pickle(ingr_map_path)
        ingre_names = {}
        for rid, name in zip(imap["id"].tolist(), imap["processed"].tolist()):
            rid = int(rid)
            ingre_names[rid] = ingre_names.get(rid, "") + str(name)

    names = raw_recipes.get("name")
    titles = dict(zip(raw_recipes["id"].tolist(),
                      [""] * len(raw_recipes["id"]) if names is None
                      else [str(v) for v in names.tolist()]))
    return dict(interactions=inter, item_to_ingres=item_to_ingres,
                calories_by_item=calories, nutrition_df=ndf,
                date_col="date", user_col="user_id", item_col="recipe_id",
                cal_bucket=50, health_criteria=pp.FOODCOM_HEALTH_CRITERIA,
                ingre_names=ingre_names, ii_singleton_keep_p=None,
                titles=titles, presplit=None)


def _allrec_nutri_field(d, key, sub):
    try:
        return d[key][sub]
    except (KeyError, TypeError, IndexError):
        return np.nan


def load_allrecipes_raw(raw_dir):
    """-> dict of build_dataset inputs (allrecipes_process.ipynb cells
    0-6, 25-29). Keeps the dataset's own core splits."""
    splits = []
    for name in ("train", "valid", "test"):
        t = _read_csv(os.path.join(raw_dir, f"core-data-{name}_rating.csv"))
        splits.append(pp._rows(t, pp._stable_lexsort(
            [t["user_id"], t["dateLastModified"]])))
    train, valid, test = splits
    # users come from train (cell 2); valid/test rows outside are dropped
    users = set(train["user_id"].tolist())
    valid = pp._rows(valid, pp._isin(valid["user_id"], users))
    test = pp._rows(test, pp._isin(test["user_id"], users))

    recipes = _read_csv(os.path.join(raw_dir, "core-data_recipe.csv"),
                       usecols=("recipe_id", "recipe_name", "ingredients",
                                "nutritions"))
    item_to_ingres = {
        int(r): str(ing).split("^")[:20]
        for r, ing in zip(recipes["recipe_id"].tolist(),
                          recipes["ingredients"].tolist())}
    # ingredient "ids" are their names here, so the keyword graph applies
    # to them directly (cell 24), singleton edges kept with p=0.025
    names = sorted(set(x for lst in item_to_ingres.values() for x in lst))
    ingre_names = {n: n for n in names}

    nutris = [ast.literal_eval(str(x))
              for x in recipes["nutritions"].tolist()]
    fields = (("cal", "calories", "amount"),
              ("fat", "fat", "percentDailyValue"),
              ("sugar", "sugars", "amount"), ("sodium", "sodium", "amount"),
              ("protein", "protein", "percentDailyValue"),
              ("saturated_fat", "saturatedFat", "percentDailyValue"),
              ("carbohydrates", "carbohydrates", "percentDailyValue"),
              ("fiber", "fiber", "percentDailyValue"))
    ndf = {"recipe_id": recipes["recipe_id"]}
    for col, key, sub in fields:
        ndf[col] = _clean_numeric([_allrec_nutri_field(d, key, sub)
                                   for d in nutris])
    calories = dict(zip(ndf["recipe_id"].tolist(), ndf["cal"].tolist()))

    rnames = recipes.get("recipe_name")
    titles = dict(zip(recipes["recipe_id"].tolist(),
                      [""] * len(recipes["recipe_id"]) if rnames is None
                      else [str(v) for v in rnames.tolist()]))
    return dict(interactions=None, item_to_ingres=item_to_ingres,
                calories_by_item=calories, nutrition_df=ndf,
                date_col="dateLastModified", user_col="user_id",
                item_col="recipe_id", cal_bucket=30,
                health_criteria=pp.ALLRECIPES_HEALTH_CRITERIA,
                ingre_names=ingre_names, ii_singleton_keep_p=0.025,
                titles=titles, presplit=(train, valid, test))


def load_generic_raw(raw_dir):
    """-> dict of build_dataset inputs from the documented generic CSVs."""
    inter = _read_csv(os.path.join(raw_dir, "interactions.csv"))
    ing = _read_csv(os.path.join(raw_dir, "ingredients.csv"),
                   usecols=("item_id", "ingredients"))
    item_to_ingres = {
        int(i): str(g).split("^")[:20]
        for i, g in zip(ing["item_id"].tolist(), ing["ingredients"].tolist())}
    names = sorted(set(x for lst in item_to_ingres.values() for x in lst))
    ingre_names = {n: n for n in names}

    calories = None
    cal_path = os.path.join(raw_dir, "calories.csv")
    if os.path.isfile(cal_path):
        cdf = _read_csv(cal_path, usecols=("item_id", "calories"))
        calories = dict(zip(cdf["item_id"].tolist(),
                            cdf["calories"].tolist()))

    ndf = None
    criteria = pp.FOODCOM_HEALTH_CRITERIA
    nut_path = os.path.join(raw_dir, "nutrition.csv")
    if os.path.isfile(nut_path):
        ndf = {("recipe_id" if k == "item_id" else k): v
               for k, v in _read_csv(nut_path).items()}
        if "fiber" in ndf:
            criteria = pp.ALLRECIPES_HEALTH_CRITERIA

    titles = {i: f"item {i}" for i in item_to_ingres}
    inter = {("recipe_id" if k == "item_id" else k): v
             for k, v in inter.items()}
    return dict(interactions=inter, item_to_ingres=item_to_ingres,
                calories_by_item=calories, nutrition_df=ndf, date_col="date",
                user_col="user_id", item_col="recipe_id", cal_bucket=50,
                health_criteria=criteria, ingre_names=ingre_names,
                ii_singleton_keep_p=None, titles=titles, presplit=None)


LOADERS = {"foodcom": load_foodcom_raw, "allrecipes": load_allrecipes_raw,
           "generic": load_generic_raw}


def _item_ids(raw):
    """All raw item ids that can survive encoding (union over splits)."""
    if raw["presplit"] is not None:
        ids = set()
        for s in raw["presplit"]:
            ids |= set(s[raw["item_col"]].tolist())
        return ids
    return set(raw["interactions"][raw["item_col"]].tolist())


def make_features(raw, mode, image_dir, image_dim, text_dim, seed,
                  device="cuda"):
    """-> (image_features, text_features) dicts raw_item_id -> vector.
    `synthesize` draws the JAX package's RandomState(seed) normals (all the
    image rows, then all the text rows, in sorted raw id order); `extract`
    runs the extractors on `device`."""
    ids = sorted(_item_ids(raw))
    if mode == "synthesize":
        print("WARNING: --features synthesize writes seeded random "
              "modality features; models will train but the image/text "
              "signal is pure noise. Use --features extract with real "
              "weights for research results.", file=sys.stderr)
        rng = np.random.RandomState(seed)
        # one draw of n·dim normals is the stream of n draws of dim each
        out = []
        for dim in (image_dim, text_dim):
            block = np.empty((len(ids), dim), dtype=np.float32)
            for s in range(0, len(ids), 4096):
                rows = min(4096, len(ids) - s)
                block[s:s + rows] = rng.normal(0, 0.1, (rows, dim))
            out.append(dict(zip(ids, block)))
        return out[0], out[1]

    # extract: reference text semantics (cells 9-14) = mean of the item's
    # ingredient-name embeddings + its title embedding
    names_of = raw["item_to_ingres"]
    ingre_names = raw["ingre_names"] or {}
    uniq = sorted(set(x for lst in names_of.values() for x in lst))
    texts = [str(ingre_names.get(x, x)) for x in uniq]
    ingre_vecs = pp.t5_text_features(texts, device=device)
    by_raw = dict(zip(uniq, ingre_vecs))
    titles = raw["titles"]
    title_vecs = pp.t5_text_features([titles.get(i, "") for i in ids],
                                     device=device)
    txt = {}
    for k, i in enumerate(ids):
        parts = [by_raw[x] for x in names_of.get(i, []) if x in by_raw]
        parts.append(title_vecs[k])
        txt[i] = np.mean(parts, axis=0).astype(np.float32)

    if image_dir is None:
        raise SystemExit("--features extract requires --image-dir")
    paths, kept = [], []
    for i in ids:
        p = os.path.join(image_dir, f"{i}.jpg")
        if os.path.isfile(p):
            paths.append(p)
            kept.append(i)
    missing = set(ids) - set(kept)
    if missing:
        raise SystemExit(
            f"--features extract: {len(missing)} items have no "
            f"{image_dir}/<id>.jpg (e.g. {sorted(missing)[:5]}); filter "
            "interactions to downloaded images first (foodcom cell 1 / "
            "--image-dir on the foodcom loader)")
    vecs = pp.resnet50_image_features(paths, device=device)
    img = dict(zip(kept, vecs))
    return img, txt


def main(argv=None):
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m foodrec_tpu_torch.data.preprocess_cli",
        description="Raw dataset files -> the processed_dataset contract "
                    "(reference notebooks as a runnable command)")
    ap.add_argument("--format", required=True, choices=sorted(LOADERS))
    ap.add_argument("--raw-dir", required=True)
    ap.add_argument("--out", required=True,
                    help="dataset root; writes <out>/processed_dataset/ "
                         "(point --data_path at its parent, -d at its name)")
    ap.add_argument("--image-dir", default=None,
                    help="foodcom: restrict items to <id>.jpg present; "
                         "extract: image source")
    ap.add_argument("--features", default="synthesize",
                    choices=["synthesize", "extract"])
    ap.add_argument("--image-dim", type=int, default=2048)
    ap.add_argument("--text-dim", type=int, default=512)
    ap.add_argument("--k-core", type=int, default=5)
    ap.add_argument("--n-neg", type=int, default=500)
    ap.add_argument("--n-clusters", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--health-sample-dict", action="store_true",
                    help="also write graph_edge/health_sample_dict.pkl "
                         "(health-stratified negative buckets)")
    ap.add_argument("--device", default="cuda",
                    help="where the k-means and the extractors run "
                         "(cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    raw = LOADERS[args.format](args.raw_dir, args.image_dir) \
        if args.format == "foodcom" else LOADERS[args.format](args.raw_dir)
    t1 = time.perf_counter()
    img, txt = make_features(raw, args.features, args.image_dir,
                             args.image_dim, args.text_dim, args.seed,
                             device=device)
    t2 = time.perf_counter()

    out = pp.build_dataset(
        args.out, raw["interactions"], raw["item_to_ingres"], img, txt,
        calories_by_item=raw["calories_by_item"],
        nutrition_df=raw["nutrition_df"], date_col=raw["date_col"],
        user_col=raw["user_col"], item_col=raw["item_col"],
        k_core=args.k_core, n_neg=args.n_neg, n_clusters=args.n_clusters,
        seed=args.seed, presplit=raw["presplit"],
        cal_bucket=raw["cal_bucket"],
        health_criteria=raw["health_criteria"],
        ingre_names=raw["ingre_names"],
        ii_singleton_keep_p=raw["ii_singleton_keep_p"],
        write_health_sample=args.health_sample_dict, device=device)
    out["stage_s"] = {"parse": t1 - t0, "make_features": t2 - t1,
                      **out["stage_s"]}
    print(f"wrote {out['base']}: {out['n_users']} users x "
          f"{out['n_items']} items")
    return out


if __name__ == "__main__":
    main()
