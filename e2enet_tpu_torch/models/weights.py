"""Reference parameters -> port state_dict (numpy only; no jax needed).

`from_jax_params` takes the reference ShiftUNetPlusPlus `params` pytree as
nested dicts of numpy arrays (optionally under a top-level "params" key)
and returns a state_dict for models/unetpp.ShiftUNetPlusPlus, to be loaded
with strict=True. The port key is the flax path joined with '.'. Layouts:

  conv kernel        (kh, kw, Cin, Cout)      -> (Cout, Cin, kh, kw)
                                                 transpose (3, 2, 0, 1)
  transp-conv kernel (sd, sh, sw, Cin, Cout)  -> (Cin, Cout, sd, sh, sw)
                                                 transpose (3, 4, 0, 1, 2)
  seg-head kernel    (Cin, K)                 -> (K, Cin), transpose (1, 0)
  bias, norm_scale, norm_bias (C,)            -> unchanged

`to_jax_params` is its inverse: a port state_dict (tensors or numpy) back
to the reference's nested params tree of float32 numpy arrays, which the
JAX package's checkpoint loader reads.
"""
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_KERNEL_PERM = {4: (3, 2, 0, 1), 5: (3, 4, 0, 1, 2), 2: (1, 0)}
_KERNEL_UNPERM = {n: tuple(int(i) for i in np.argsort(p))
                  for n, p in _KERNEL_PERM.items()}


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(key),))
        else:
            yield prefix + (str(key),), v


def from_jax_params(params) -> Dict[str, torch.Tensor]:
    tree = params
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, leaf in _leaves(tree):
        a = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            if a.ndim not in _KERNEL_PERM:
                raise ValueError(f"{'/'.join(path)}: unexpected kernel rank "
                                 f"{a.ndim}")
            a = np.transpose(a, _KERNEL_PERM[a.ndim])
        elif path[-1] not in ("bias", "norm_scale", "norm_bias"):
            raise ValueError(f"{'/'.join(path)}: unknown parameter")
        key = ".".join(path)
        assert key not in sd, key
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def to_jax_params(state_dict) -> dict:
    """The reference's params tree (nested dicts, float32 numpy) of a port
    state_dict; to_jax_params(from_jax_params(p)) == p."""
    tree: dict = {}
    for key, t in state_dict.items():
        a = (t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor)
             else np.asarray(t, np.float32))
        *path, leaf = key.split(".")
        if leaf == "kernel":
            if a.ndim not in _KERNEL_UNPERM:
                raise ValueError(f"{key}: unexpected kernel rank {a.ndim}")
            a = np.transpose(a, _KERNEL_UNPERM[a.ndim])
        elif leaf not in ("bias", "norm_scale", "norm_bias"):
            raise ValueError(f"{key}: unknown parameter")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        assert leaf not in node, key
        node[leaf] = np.ascontiguousarray(a, np.float32)
    return tree
