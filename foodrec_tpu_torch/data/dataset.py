# coding: utf-8
"""Host-side dataset layer: the on-disk FoodRec data contract, the part that
the ported models (CIKM_Model, LightGCN, BM3, FGCN, PRICAI_ModelX, SCHGN)
read.

Counterpart of `foodrec_tpu/data/dataset.py` (reference
FoodRec/utils/dataset.py:11-370), parsed with numpy alone (no pandas, no
native extension):

  data.{train,valid,test}.rating    tab-separated "user \t item \t rating ..."
  data.{valid,test}.negative        "(u:[...])\t neg1 ... negK" per user row
  data_image_features_float.npy     [n_items, 2048] float (memory-mapped)
  data_text_features_t5.npy         [n_items, 512] float (memory-mapped)
  data_ingre_code_file.npy          [n_items, 20] int, pad id = n_ingredients
  data_id_ingre_num_file            "item \t count" per line
  inter_coo_matrix.pkl              scipy.sparse train COO
  graph_edge/{ur,ii}_graph.txt      user-recipe, ingredient-ingredient int
                                    pairs (FGCN)
  ri_graph.txt                      recipe-ingredient int pairs (graph_edge/,
                                    or the dataset root when small_ingre)
  graph_edge/rc_graph.txt           recipe-calorie-level int pairs (SCHGN)
  graph_edge/rh_graph.txt           recipe-health-level int pairs; the levels'
                                    count sizes CIKM_Model's scalar health head
  graph_edge/rr_graph.txt           recipe-recipe int pairs
  graph_edge/rr_{co,ing,health}_graph.txt
                                    recipe-recipe triples, read as floats
  cluster/{image,text}_cluster_edge.txt
                                    (item, k-means cluster) pairs, read as
                                    floats (PRICAI_ModelX)
  recipe_health_level_multi_hot_dict.pkl
  recipe_health_level_dict.pkl      item -> scalar health level
  recipe_cal_level_dict.pkl         item -> calorie level (SCHGN)
  health_sample_dict.pkl            (neg_sample_set, health_0..health_5): the
                                    health-stratified negatives' buckets

  cold_start/data.{cold,warm}.{rating,negative}, sense_user/data.{sense,
  unsense}.{rating,negative}, health_level/data_health{0..5}.{rating,
  negative}                         the study splits, under cold_study,
                                    sense_study and health_level_study

Every flag of the JAX package's GraphData is read; `preprocess.py` (and
its CLI, `preprocess_cli.py`) writes these files from raw datasets.
"""

import os
import pickle
from collections import defaultdict

import numpy as np


def _read_rating_file(path):
    """Parse a tab-separated rating file -> (users, items, ratings)."""
    if os.path.getsize(path) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float64))
    arr = np.loadtxt(path, delimiter="\t", usecols=(0, 1, 2), ndmin=2,
                     dtype=np.float64)
    return arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64), arr[:, 2]


def _read_pairs(path):
    """Whitespace-separated int pairs, one per line -> int64 [n, 2]."""
    return np.loadtxt(path, dtype=np.int64, ndmin=2)


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


def _load_pickle(path):
    # a pickle this dataset's own generator or preprocessing wrote
    with open(path, "rb") as f:
        return pickle.load(f)


def _read_study_split(path):
    """(per-user item arrays, user ids, per-user negatives) of one study
    split: `{path}.rating` grouped by user and `{path}.negative`."""
    ratings, users = _group_by_consecutive_user(
        *_read_rating_file(path + ".rating")[:2])
    return ratings, users, _read_negative_file(path + ".negative")


class FoodData:
    """The dataset attributes the ported models, the trainer's evaluations
    and the studies read (reference: dataset.py:11-370)."""

    def __init__(self, config):
        self.args_config = config
        interaction_path = config["interaction_data_path"]
        ingre_path = config["ingre_data_path"]

        tr_u, tr_i, tr_r = _read_rating_file(interaction_path + "data.train.rating")
        va_u, va_i, _ = _read_rating_file(interaction_path + "data.valid.rating")
        te_u, te_i, _ = _read_rating_file(interaction_path + "data.test.rating")

        # train-file-derived shape (dataset.py:157-176)
        self.num_users = int(tr_u.max()) + 1
        self.num_items = int(tr_i.max()) + 1
        # implicit 0/1: only rating > 0 trains (dataset.py:92-94)
        keep = tr_r > 0
        self._train_u = tr_u[keep]
        self._train_i = tr_i[keep]
        # the distinct train items in the JAX package's set order
        # (dataset.py:258-270): the health sampler's uniform fallback
        self.train_item_list = list(set(self._train_i.tolist()))

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

        # valid and test positives per user, excluded from negative sampling
        # (dataset.py:115-119)
        self.validTestRatings = {u: set() for u in range(self.num_users)}
        for u, i in zip(np.concatenate([va_u, te_u]).tolist(),
                        np.concatenate([va_i, te_i]).tolist()):
            self.validTestRatings[u].add(i)

        # id ranges over all splits (dataset.py:218-231); the JAX package
        # takes the item range after shifting the items past the users
        # (dataset.py:195-203), so item_range is in that id space
        users = np.concatenate([tr_u, va_u, te_u])
        items = np.concatenate([tr_i, va_i, te_i]) + int(users.max()) + 1
        self.user_range = (int(users.min()), int(users.max()))
        self.item_range = (int(items.min()), int(items.max()))
        self.n_users = int(users.max() - users.min() + 1)
        self.n_items = int(items.max() - items.min() + 1)
        self.n_train, self.n_valid, self.n_test = len(tr_u), len(va_u), len(te_u)
        self.inter_num = self.n_train + self.n_valid + self.n_test

        # memory-mapped: the image table is 245 MB at Foodcom scale
        self.embImage = np.load(
            interaction_path + "data_image_features_float.npy", mmap_mode="r")
        self.embText = np.load(ingre_path + "data_text_features_t5.npy",
                               mmap_mode="r")

        self.ingredientNum = self._load_ingredient_num(
            ingre_path + "data_id_ingre_num_file")
        self.ingredientCodeDict = np.load(ingre_path + "data_ingre_code_file.npy")
        # pad id == n_ingredients (dataset.py:53)
        self.num_ingredients = int(np.max(self.ingredientCodeDict))

        if config["interaction_data_path"] != config["graph_data_path"]:
            coo_path = config["interaction_data_path"] + "inter_coo_matrix.pkl"
        else:
            coo_path = config["graph_data_path"] + "inter_coo_matrix.pkl"
        self.train_coo_matrix = _load_pickle(coo_path).astype(np.float32)

        # the study splits (dataset.py:155-181)
        if config["cold_study"]:
            p = interaction_path + "cold_start/data."
            (self.coldRatings, self.cold_users,
             self.coldNegatives) = _read_study_split(p + "cold")
            (self.warmRatings, self.warm_users,
             self.warmNegatives) = _read_study_split(p + "warm")
        if config["sense_study"]:
            p = interaction_path + "sense_user/data."
            (self.senseRatings, self.sense_users,
             self.senseNegatives) = _read_study_split(p + "sense")
            (self.unsenseRatings, self.unsense_users,
             self.unsenseNegatives) = _read_study_split(p + "unsense")
        if config["health_level_study"]:
            p = interaction_path + "health_level/data_health"
            self.healthRatings = defaultdict(list)
            self.healthNegatives = defaultdict(list)
            self.healthUsers = defaultdict(list)
            for hl in range(6):
                (self.healthRatings[hl], self.healthUsers[hl],
                 self.healthNegatives[hl]) = _read_study_split(p + str(hl))

        # flag-gated graphs (dataset.py:243-300)
        graph_path = config["graph_data_path"]
        if config["load_UserRecipe_graph"]:
            self.uRecipe_triples = _read_pairs(graph_path + "ur_graph.txt")
        if config["load_RecipeRecipe_graph"]:
            self.rRecipe_triples = _read_pairs(graph_path + "rr_graph.txt")
        if config["load_RecipeIngre_graph"]:
            ri_dir = ingre_path if config["small_ingre"] else graph_path
            self.rIngre_triples = _read_pairs(ri_dir + "ri_graph.txt")
        if config["load_IngreIngre_graph"]:
            self.iIngre_triples = _read_pairs(graph_path + "ii_graph.txt")
        self.num_calories_level = 0
        if config["load_RecipeCalories_graph"]:
            self.rCalories_triples = _read_pairs(graph_path + "rc_graph.txt")
            self.num_calories_level = int(self.rCalories_triples[:, 1].max()) + 1
        self.num_health_level = 0
        if config["load_RecipeHealth_graph"]:
            self.rHealth_triples = _read_pairs(graph_path + "rh_graph.txt")
            self.num_health_level = int(self.rHealth_triples[:, 1].max()) + 1
        if config["use_cal_level"]:
            self.cal_level = _load_pickle(graph_path + "recipe_cal_level_dict.pkl")
        if config["use_health_level"]:
            self.health_level = _load_pickle(
                graph_path + "recipe_health_level_dict.pkl")
        if config["use_health_level_multi_hot"]:
            self.health_level_multi_hot = _load_pickle(
                graph_path + "recipe_health_level_multi_hot_dict.pkl")
        # floats, as the JAX package reads them with np.loadtxt
        for name, flag in (("rr_co", "load_RecipeRecipeCo_graph"),
                           ("rr_ing", "load_RecipeRecipeIng_graph"),
                           ("rr_health", "load_RecipeRecipeHealth_graph")):
            if config[flag]:
                setattr(self, f"{name}_triples",
                        np.loadtxt(f"{graph_path}{name}_graph.txt"))
        if config["health_neg_sample"]:
            # the health-stratified negatives' buckets (dataloader.py:22-25)
            (self.neg_sample_set, self.health_0, self.health_1,
             self.health_2, self.health_3, self.health_4,
             self.health_5) = _load_pickle(graph_path + "health_sample_dict.pkl")
        # floats, as the JAX package reads them; the model casts the ids
        for modality, flag in (("image", "load_ImageCluster_graph"),
                               ("text", "load_TextCluster_graph")):
            if config[flag]:
                setattr(self, f"{modality}_cluster_triples", np.loadtxt(
                    f"{interaction_path}cluster/{modality}_cluster_edge.txt"))

    @staticmethod
    def _load_ingredient_num(path):
        return np.loadtxt(path, delimiter="\t", dtype=np.int64,
                          ndmin=2)[:, 1].tolist()

    def __str__(self):
        info = [str(self.args_config["dataset"])]
        info.append(f"The number of users: {self.n_users}")
        info.append(f"Average actions of users: {self.inter_num / self.n_users}")
        info.append(f"The number of items: {self.n_items}")
        info.append(f"Average actions of items: {self.inter_num / self.n_items}")
        info.append(f"The number of inters: {self.inter_num}")
        sparsity = 1 - self.inter_num / self.n_users / self.n_items
        info.append(f"The sparsity of the dataset: {sparsity * 100}%")
        return "\n".join(info)


def derive_data_paths(config, dataset_name):
    """Path derivation from quick_start.py:21-23."""
    base = config["data_path"] + dataset_name + "/processed_dataset/"
    config["interaction_data_path"] = base
    config["graph_data_path"] = base + "graph_edge/"
    config["ingre_data_path"] = base
    return config
