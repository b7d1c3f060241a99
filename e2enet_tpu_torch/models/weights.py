"""Reference parameters -> port state_dict (numpy only; no jax needed).

`from_jax_params` takes a reference network's `params` pytree
(ShiftUNetPlusPlus, ShiftUNet or ResidualUNet) as nested dicts of numpy
arrays (optionally under a top-level "params" key) and returns a
state_dict for the port's network, to be loaded with strict=True. The port
key is the flax path joined with '.'. The layout follows the module and
the leaf name, not the rank alone (a full 3D conv kernel and a transposed
conv kernel are both rank 5):

  conv kernel        (kh, kw, Cin, Cout)      -> (Cout, Cin, kh, kw)
                     (kd, kh, kw, Cin, Cout)  -> (Cout, Cin, kd, kh, kw)
  transp-conv kernel (sd, sh, sw, Cin, Cout)  -> (Cin, Cout, sd, sh, sw)
    (the `kernel` of a module named up*: up{z}_{k}, up_{u}, up{i})
  seg-head kernel    (Cin, K)                 -> (K, Cin)
  ResidualUNet's conv1, conv2, skip_conv, initial_conv: conv kernels
  bias, norm_scale, norm_bias, frn_tau and ResidualUNet's vectors (C,)
                                              -> unchanged

`to_jax_params` is its inverse: a port state_dict (tensors or numpy) back
to the reference's nested params tree of float32 numpy arrays, which the
JAX package's checkpoint loader reads.
"""
from collections.abc import Mapping
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

CONV_LEAVES = ("kernel", "conv1", "conv2", "skip_conv", "initial_conv")
VECTOR_LEAVES = ("bias", "norm_scale", "norm_bias", "frn_tau",
                 "bias1", "scale1", "nbias1", "bias2", "scale2", "nbias2",
                 "skip_scale", "skip_nbias", "initial_bias",
                 "initial_scale", "initial_nbias")
_CONV_PERM = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2), 2: (1, 0)}
_TRANSP_PERM = (3, 4, 0, 1, 2)


def is_transposed(path: Sequence[str]) -> bool:
    """Whether the kernel at `path` (module names, then the leaf) is a
    transposed conv's: the reference names every up-link module up*."""
    return (len(path) >= 2 and path[-1] == "kernel"
            and str(path[-2]).startswith("up"))


def kernel_perm(path: Sequence[str], ndim: int) -> Tuple[int, ...]:
    """The transpose taking the flax layout of the kernel at `path` (rank
    ndim) to the port's."""
    if is_transposed(path):
        if ndim != 5:
            raise ValueError(f"{'/'.join(path)}: a transposed conv kernel "
                             f"of rank {ndim}")
        return _TRANSP_PERM
    if ndim not in _CONV_PERM:
        raise ValueError(f"{'/'.join(path)}: unexpected kernel rank {ndim}")
    return _CONV_PERM[ndim]


def kernel_unperm(path: Sequence[str], ndim: int) -> Tuple[int, ...]:
    """kernel_perm's inverse: the port's layout back to the flax one."""
    return tuple(int(i) for i in np.argsort(kernel_perm(path, ndim)))


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(key),))
        else:
            yield prefix + (str(key),), v


def _check_leaf(path: Sequence[str]) -> None:
    if path[-1] not in CONV_LEAVES + VECTOR_LEAVES:
        raise ValueError(f"{'/'.join(path)}: unknown parameter")


def from_jax_params(params) -> Dict[str, torch.Tensor]:
    tree = params
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, leaf in _leaves(tree):
        _check_leaf(path)
        a = np.asarray(leaf, dtype=np.float32)
        if path[-1] in CONV_LEAVES:
            a = np.transpose(a, kernel_perm(path, a.ndim))
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
        path = key.split(".")
        _check_leaf(path)
        if path[-1] in CONV_LEAVES:
            a = np.transpose(a, kernel_unperm(path, a.ndim))
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        assert path[-1] not in node, key
        node[path[-1]] = np.ascontiguousarray(a, np.float32)
    return tree
