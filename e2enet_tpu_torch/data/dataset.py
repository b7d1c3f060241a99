"""Preprocessed-dataset management: lazy case index, npz->npy unpacking for
memmap reads, seeded 5-fold splits.

Parity: reference e2enet/training/dataloading/dataset_loading.py
(load_dataset :97-118, unpack_dataset/npz->npy :60-72) and the split logic in
nnUNetTrainer_simple.do_split (:588-651; seeded KFold(5, shuffle,
random_state=12345) cached in splits_final.pkl).

The port's own copy of e2enet_tpu/data/dataset.py, with one change: the
seeded 5-fold split is computed here (_kfold_splits, sklearn's
KFold(5, shuffle=True, random_state=12345) step by step: the indices
shuffled by RandomState(12345), cut into 5 consecutive folds, the first
n % 5 one longer, each fold's train and val indices in ascending order),
since the card's machine has no sklearn. splits_final.pkl comes out
byte for byte as the JAX package writes it. The port imports nothing of
the JAX package.
"""
import os
from collections import OrderedDict
from typing import List

import numpy as np

from ..utils.files import (isfile, join, load_pickle, save_pickle, subfiles)

SPLIT_SEED = 12345
NUM_FOLDS = 5


def get_case_identifiers(folder) -> List[str]:
    return [os.path.basename(i)[:-4] for i in
            subfiles(folder, join=False, suffix="npz")
            if not i.endswith("_segFromPrevStage.npz")]


def load_dataset(folder) -> "OrderedDict[str, dict]":
    case_identifiers = get_case_identifiers(folder)
    case_identifiers.sort()
    dataset = OrderedDict()
    for c in case_identifiers:
        dataset[c] = OrderedDict()
        dataset[c]["data_file"] = join(folder, f"{c}.npz")
        dataset[c]["properties_file"] = join(folder, f"{c}.pkl")
    return dataset


def unpack_dataset(folder):
    """Decompress every npz into a flat .npy next to it so the sampler can
    memmap instead of decompressing per batch."""
    npz_files = subfiles(folder, True, None, ".npz", True)
    for f in npz_files:
        npy = f[:-4] + ".npy"
        if not isfile(npy):
            a = np.load(f)["data"]
            np.save(npy, a)


def delete_npy(folder):
    for f in subfiles(folder, True, None, ".npy", True):
        os.remove(f)


def load_case(entry, memmap_mode="r") -> np.ndarray:
    npy = entry["data_file"][:-4] + ".npy"
    if isfile(npy):
        return np.load(npy, mmap_mode=memmap_mode)
    return np.load(entry["data_file"])["data"]


def _kfold_indices(n: int):
    """(train, val) index arrays of sklearn's KFold(NUM_FOLDS,
    shuffle=True, random_state=SPLIT_SEED) over n samples."""
    if NUM_FOLDS > n:
        raise ValueError(f"Cannot have number of splits n_splits="
                         f"{NUM_FOLDS} greater than the number of samples: "
                         f"n_samples={n}.")
    indices = np.arange(n)
    np.random.RandomState(SPLIT_SEED).shuffle(indices)
    fold_sizes = np.full(NUM_FOLDS, n // NUM_FOLDS, dtype=int)
    fold_sizes[:n % NUM_FOLDS] += 1
    current = 0
    for size in fold_sizes:
        val = np.zeros(n, dtype=bool)
        val[indices[current:current + size]] = True
        yield np.arange(n)[~val], np.arange(n)[val]
        current += size


def _kfold_splits(keys: List[str]):
    splits = []
    keys = np.sort(list(keys))
    for tr_idx, te_idx in _kfold_indices(len(keys)):
        splits.append(OrderedDict(
            train=np.array(keys)[tr_idx], val=np.array(keys)[te_idx]))
    return splits


def do_split(dataset: dict, fold, splits_file: str):
    """Returns (train_keys, val_keys). fold='all' -> train == val == all.
    Splits are created once with the seeded KFold and cached (parity:
    nnUNetTrainer_simple.do_split)."""
    if fold == "all":
        keys = sorted(dataset.keys())
        return keys, keys

    if not isfile(splits_file):
        print("Creating new split...")
        splits = _kfold_splits(list(dataset.keys()))
        save_pickle(splits, splits_file)
    splits = load_pickle(splits_file)

    if fold < len(splits):
        tr_keys = list(splits[fold]["train"])
        val_keys = list(splits[fold]["val"])
    else:
        # more folds requested than splits exist: random 80:20 (reference
        # fallback path)
        rnd = np.random.RandomState(seed=SPLIT_SEED + fold)
        keys = np.sort(list(dataset.keys()))
        idx_tr = rnd.choice(len(keys), int(len(keys) * 0.8), replace=False)
        idx_val = [i for i in range(len(keys)) if i not in idx_tr]
        tr_keys = [keys[i] for i in idx_tr]
        val_keys = [keys[i] for i in idx_val]
    return tr_keys, val_keys
