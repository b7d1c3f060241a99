"""Small file helpers (JSON / pickle / directory listing).

Replaces the reference's batchgenerators.utilities.file_and_folder_operations
dependency with a tiny local implementation.

The port's own copy of e2enet_tpu/utils/files.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
import gzip
import json
import os
import pickle

import numpy as np


def maybe_mkdir_p(d):
    os.makedirs(d, exist_ok=True)


def subfiles(folder, join=True, prefix=None, suffix=None, sort=True):
    res = [i for i in os.listdir(folder)
           if os.path.isfile(os.path.join(folder, i))
           and (prefix is None or i.startswith(prefix))
           and (suffix is None or i.endswith(suffix))]
    if sort:
        res.sort()
    if join:
        res = [os.path.join(folder, i) for i in res]
    return res


def subdirs(folder, join=True, prefix=None, suffix=None, sort=True):
    res = [i for i in os.listdir(folder)
           if os.path.isdir(os.path.join(folder, i))
           and (prefix is None or i.startswith(prefix))
           and (suffix is None or i.endswith(suffix))]
    if sort:
        res.sort()
    if join:
        res = [os.path.join(folder, i) for i in res]
    return res


class _NumpyJSONEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (tuple, set)):
            return list(o)
        return super().default(o)


def save_json(obj, path, indent=2, sort_keys=True):
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent, sort_keys=sort_keys,
                  cls=_NumpyJSONEncoder)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def save_pickle(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return pickle.load(f)


def isfile(p):
    return os.path.isfile(p)


def isdir(p):
    return os.path.isdir(p)


def join(*args):
    return os.path.join(*args)
