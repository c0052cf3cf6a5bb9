# coding: utf-8
"""Host-side dataset layer: the on-disk FoodRec data contract, serving part.

Counterpart of `foodrec_tpu/data/dataset.py` (reference
FoodRec/utils/dataset.py:11-370) with the attributes serving reads, parsed
with numpy alone (no pandas, no native extension):

  data.{train,valid,test}.rating    tab-separated "user \t item \t rating ..."
  data.{valid,test}.negative        "(u:[...])\t neg1 ... negK" per user row
  data_ingre_code_file.npy          [n_items, 20] int, pad id = n_ingredients
  data_id_ingre_num_file            "item \t count" per line
  inter_coo_matrix.pkl              scipy.sparse train COO
  ri_graph.txt                      recipe-ingredient int pairs (small_ingre)
  recipe_health_level_multi_hot_dict.pkl

The modality feature tables, the other graphs, the study splits and the
per-user training dicts arrive with training (ROADMAP.md).
"""

import os
import pickle

import numpy as np


def _read_rating_file(path):
    """Parse a tab-separated rating file -> (users, items, ratings)."""
    if os.path.getsize(path) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float64))
    arr = np.loadtxt(path, delimiter="\t", usecols=(0, 1, 2), ndmin=2,
                     dtype=np.float64)
    return arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64), arr[:, 2]


def _group_by_consecutive_user(users, items):
    """Group items by user in file order (users appear in sorted runs).

    Returns (arrays, user_ids): one int64 array per distinct user, in order
    of appearance (reference load_valid_file_as_list, dataset.py:115-135).
    """
    if len(users) == 0:
        return [], []
    starts = np.concatenate([[0], np.flatnonzero(np.diff(users) != 0) + 1])
    return np.split(items, starts[1:]), users[starts].tolist()


def _read_negative_file(path):
    """Parse a .negative file: each row "(u:[pos..])\tn1\t...\tnK" -> one
    int64 array of negatives per non-empty row."""
    negatives = []
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            rest = line.partition("\t")[2]
            negatives.append(np.fromstring(rest, dtype=np.int64, sep="\t")
                             if rest else np.zeros(0, np.int64))
    return negatives


class FoodData:
    """The dataset attributes that serving reads (reference: dataset.py:11-370)."""

    def __init__(self, config):
        self.args_config = config
        interaction_path = config["interaction_data_path"]
        ingre_path = config["ingre_data_path"]

        tr_u, tr_i, _ = _read_rating_file(interaction_path + "data.train.rating")
        va_u, va_i, _ = _read_rating_file(interaction_path + "data.valid.rating")
        te_u, te_i, _ = _read_rating_file(interaction_path + "data.test.rating")

        # train-file-derived shape (dataset.py:157-176)
        self.num_users = int(tr_u.max()) + 1
        self.num_items = int(tr_i.max()) + 1

        self.testRatings, _ = _group_by_consecutive_user(te_u, te_i)
        self.testNegatives = _read_negative_file(
            interaction_path + "data.test.negative")
        if len(self.testRatings) != len(self.testNegatives):
            raise ValueError("test ratings and negatives cover different users")
        self.validRatings, self.valid_users = _group_by_consecutive_user(
            va_u, va_i)
        self.validNegatives = _read_negative_file(
            interaction_path + "data.valid.negative")
        if len(self.validRatings) != len(self.validNegatives):
            raise ValueError("valid ratings and negatives cover different users")

        # id ranges over all splits (dataset.py:218-231)
        users = np.concatenate([tr_u, va_u, te_u])
        items = np.concatenate([tr_i, va_i, te_i])
        self.n_users = int(users.max() - users.min() + 1)
        self.n_items = int(items.max() - items.min() + 1)

        self.ingredientNum = self._load_ingredient_num(
            ingre_path + "data_id_ingre_num_file")
        self.ingredientCodeDict = np.load(ingre_path + "data_ingre_code_file.npy")
        # pad id == n_ingredients (dataset.py:53)
        self.num_ingredients = int(np.max(self.ingredientCodeDict))

        if config["interaction_data_path"] != config["graph_data_path"]:
            coo_path = config["interaction_data_path"] + "inter_coo_matrix.pkl"
        else:
            coo_path = config["graph_data_path"] + "inter_coo_matrix.pkl"
        # a pickle this dataset's own generator or preprocessing wrote
        with open(coo_path, "rb") as f:
            self.train_coo_matrix = pickle.load(f).astype(np.float32)

        graph_path = config["graph_data_path"]
        if config["load_RecipeIngre_graph"]:
            ri_dir = ingre_path if config["small_ingre"] else graph_path
            self.rIngre_triples = np.loadtxt(ri_dir + "ri_graph.txt",
                                             dtype=np.int64, ndmin=2)
        if config["use_health_level_multi_hot"]:
            with open(graph_path + "recipe_health_level_multi_hot_dict.pkl",
                      "rb") as f:
                self.health_level_multi_hot = pickle.load(f)

    @staticmethod
    def _load_ingredient_num(path):
        return np.loadtxt(path, delimiter="\t", dtype=np.int64,
                          ndmin=2)[:, 1].tolist()


def derive_data_paths(config, dataset_name):
    """Path derivation from quick_start.py:21-23."""
    base = config["data_path"] + dataset_name + "/processed_dataset/"
    config["interaction_data_path"] = base
    config["graph_data_path"] = base + "graph_edge/"
    config["ingre_data_path"] = base
    return config
