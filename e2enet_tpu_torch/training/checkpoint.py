"""Checkpoints in the JAX package's format, read and written with numpy.

The format (e2enet_tpu/training/checkpoint.py:30-80): `{Tconv}_model_
{latest,best,final_checkpoint}.model` is a pickle (protocol 4) of

  {"epoch": int,
   "state": {"params": nested dicts of numpy arrays (the flax tree),
             "momentum": SGD's momentum tree, same layout, or the
                         optimizer's state: a RangerState or AdamState of
                         such trees and an int32 step,
             "masks": {'|'-joined flax path: (in, out) array, or an
                       element mask of its kernel's flax shape} or None,
             "rng": numpy array, "step": int},
   "metadata": dict}

with a `.pkl` sidecar {init, name, class, plans} beside it. Nothing in it
needs jax to unpickle as long as the writer stored numpy and Python
objects, but for Ranger's and Adam's states, which the pickle names by the
JAX package's classes (e2enet_tpu.training.ranger.RangerState,
e2enet_tpu.training.train_state.AdamState, NamedTuples). The port reads
those two names as its own NamedTuples of the same fields in the same
order (training/ranger.RangerState, training/train_state.AdamState)
without importing anything, and writes its own under the JAX names
through pickle's Python pickler (the C pickler imports a class's module
to check it), so that either package loads the other's file.
load_checkpoint refuses a payload that holds anything else of jax, flax
or e2enet_tpu and names the key, instead of importing them.

load_checkpoint returns the trees as numpy and the masks as a dict; the
model's weights come from params through models/weights.from_jax_params.
save_checkpoint writes the same format from numpy trees (a model's
through models/weights.to_jax_params), which the JAX package loads.

A trainer's whole state (training/train_state.TrainState; reference
state_to_numpy :30, save_checkpoint :60) goes through state_to_numpy and
save_train_state: params and the optimizer's buffers in the flax layout
by the same mapping (to_jax_params, transposes included), the masks by
'|'-joined flax path (an element mask transposed as its kernel,
models/masks.masks_to_flax), the step, and the reference's uint32[2] PRNG key.
The port's own draws come from a torch.Generator: its state goes into the
metadata under GENERATOR_KEY as a uint8 array, which the JAX loader
ignores (a JAX trainer's save does not keep it; the port then seeds its
generator from the key). load_train_state puts a checkpoint of either
package back into a TrainState in place, the masks checked against the
model.
"""
import os
import pickle
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.masks import masks_for_model, masks_to_flax
from ..models.weights import from_jax_params, to_jax_params
from ..utils.files import save_pickle
from .ranger import RangerState
from .train_state import AdamState

GENERATOR_KEY = "torch_generator_state"

_REFUSED_MODULES = ("jax", "jaxlib", "flax", "e2enet_tpu")
# the JAX package's optimizer states, by the (module, name) its pickles
# give them, and the port's NamedTuples of the same fields
_JAX_OPT_STATES = {
    ("e2enet_tpu.training.ranger", "RangerState"): RangerState,
    ("e2enet_tpu.training.train_state", "AdamState"): AdamState}
_JAX_NAME_OF = {cls: key for key, cls in _JAX_OPT_STATES.items()}


class _Refused:
    """Stands in for a class or function the payload names from a refused
    module, so that the whole pickle loads and the refusal can name its
    key."""
    qualname = ""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _JAX_OPT_STATES:
            return _JAX_OPT_STATES[module, name]
        if module.split(".")[0] in _REFUSED_MODULES:
            return type("Refused", (_Refused,),
                        {"qualname": f"{module}.{name}"})
        return super().find_class(module, name)


class _Pickler(pickle._Pickler):
    """pickle's Python pickler, writing the port's optimizer states under
    the JAX package's class names, without importing that package."""

    def save_global(self, obj, name=None):
        key = _JAX_NAME_OF.get(obj)
        if key is None:
            return super().save_global(obj, name)
        self.save(key[0])
        self.save(key[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _find_refused(tree, path=()):
    """(key path, refused name) of the first stand-in in the tree, or
    None."""
    if isinstance(tree, _Refused):
        return path, tree.qualname
    if isinstance(tree, type) and issubclass(tree, _Refused):
        return path, tree.qualname
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return None
    for k, v in items:
        hit = _find_refused(v, path + (str(k),))
        if hit is not None:
            return hit
    return None


def _read_payload(path: str) -> Dict[str, Any]:
    """The unpickled checkpoint; raises ValueError naming the key whose
    value would need jax, flax or e2enet_tpu to unpickle."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    hit = _find_refused(payload)
    if hit is not None:
        key, name = hit
        raise ValueError(f"{path}: key {'/'.join(key) or '(top)'} holds a "
                         f"{name} object, which needs that package to "
                         f"unpickle; store it as numpy or Python values")
    return payload


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], int, dict]:
    """(state, epoch, metadata) of a checkpoint: state holds "params" as
    nested dicts of numpy arrays, "momentum" as such a tree (SGD's) or a
    RangerState / AdamState of such trees and a numpy step, "masks" as
    {'|'-joined flax path: float32 array in the flax layout, (in, out) or
    element-granular} or None, "rng" and "step"."""
    payload = _read_payload(path)
    d = payload["state"]
    masks = d.get("masks")
    if masks is not None:
        masks = {str(k): np.asarray(v, np.float32) for k, v in masks.items()}
    state = {
        "params": _to_numpy(d["params"]),
        "momentum": _opt_to_numpy(d.get("momentum")),
        "masks": masks,
        "rng": np.asarray(d["rng"]) if d.get("rng") is not None else None,
        "step": int(d.get("step", 0)),
    }
    return state, payload["epoch"], payload.get("metadata", {})


def save_checkpoint(path: str, params, epoch: int, masks=None,
                    momentum=None, rng=None, step: int = 0,
                    metadata: Optional[dict] = None,
                    sidecar: Optional[dict] = None) -> None:
    """Write the JAX package's checkpoint from numpy trees: params (and
    momentum, zeros of params' shapes when None; or a RangerState /
    AdamState of such trees and a step) as nested dicts in the flax
    layout, masks as {'|'-joined flax path: (in, out) or an element mask
    in the flax layout} or None, rng a
    uint32 key array (that of PRNGKey(0) when None)."""
    params = _to_numpy(params)
    if momentum is None:
        momentum = _map(np.zeros_like, params)
    if rng is None:
        rng = np.zeros(2, np.uint32)
    if masks is not None:
        masks = {str(k): np.asarray(v) for k, v in masks.items()}
    payload = {
        "epoch": epoch,
        "state": {"params": params, "momentum": _opt_to_numpy(momentum),
                  "masks": masks, "rng": np.asarray(rng),
                  "step": int(step)},
        "metadata": metadata or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _Pickler(f, protocol=4).dump(payload)
    os.replace(tmp, path)
    if sidecar is not None:
        save_pickle(sidecar, path + ".pkl")


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_numpy(tree):
    if tree is None:
        return None
    return _map(np.asarray, tree)


def _map_opt(fn, opt):
    """fn of SGD's momentum tree, or a RangerState / AdamState with fn of
    each of its trees and its step an int32 scalar array, as the JAX
    package stores them."""
    if not isinstance(opt, tuple):
        return fn(opt)
    return type(opt)(*(np.asarray(v, np.int32) if f == "step" else fn(v)
                       for f, v in zip(opt._fields, opt)))


def _opt_to_numpy(opt):
    return _map_opt(_to_numpy, opt)


def _opt_kind(opt) -> str:
    return type(opt).__name__ if isinstance(opt, tuple) else "SGD momentum"


def state_to_numpy(state) -> Dict[str, Any]:
    """A TrainState as the JAX package stores one (reference
    state_to_numpy, checkpoint.py:30-42): params and momentum as the flax
    trees, masks by '|'-joined flax path in the flax layout (None without
    masks), rng the uint32[2] key, step an int."""
    masks = None if state.masks is None else masks_to_flax(state.masks)
    rng = (np.zeros(2, np.uint32) if state.rng is None
           else np.asarray(state.rng, np.uint32))
    return {"params": to_jax_params(state.params),
            "momentum": _map_opt(to_jax_params, state.momentum),
            "masks": masks, "rng": rng, "step": int(state.step)}


def save_train_state(path: str, state, epoch: int,
                     metadata: Optional[dict] = None,
                     sidecar: Optional[dict] = None) -> None:
    """Write a TrainState as the JAX package's checkpoint (reference
    save_checkpoint, checkpoint.py:60-73); the generator's state goes into
    the metadata under GENERATOR_KEY."""
    d = state_to_numpy(state)
    metadata = dict(metadata or {})
    metadata[GENERATOR_KEY] = state.generator.get_state().numpy().copy()
    save_checkpoint(path, d["params"], epoch, masks=d["masks"],
                    momentum=d["momentum"], rng=d["rng"], step=d["step"],
                    metadata=metadata, sidecar=sidecar)


def load_train_state(path: str, state, model) -> Tuple[int, dict]:
    """Load a checkpoint of either package into `state` (and `model`,
    whose parameters state.params are) in place: the parameters, the
    optimizer's state (refused unless it is of the state's optimizer), the
    masks (refused unless they fit the model; None stays
    None), the step and the rng key; the generator from the metadata's
    GENERATOR_KEY, or seeded from the key where a JAX run wrote it.
    Returns (epoch, metadata)."""
    d, epoch, metadata = load_checkpoint(path)
    model.load_state_dict(from_jax_params(d["params"]), strict=True)
    opt = d["momentum"]
    if _opt_kind(opt) != _opt_kind(state.momentum):
        raise ValueError(f"{path}: the optimizer state is a "
                         f"{_opt_kind(opt)}, this trainer's optimizer keeps "
                         f"a {_opt_kind(state.momentum)}")
    pairs = ([(opt, state.momentum)] if not isinstance(opt, tuple) else
             [(a, b) for f, a, b in zip(opt._fields, opt, state.momentum)
              if f != "step"])
    for tree, bufs in pairs:
        got = from_jax_params(tree)
        if set(got) != set(bufs):
            raise ValueError(f"{path}: the optimizer state's leaves are "
                             f"not the model's parameters")
        with torch.no_grad():
            for name, buf in bufs.items():
                buf.copy_(got[name])
    if isinstance(opt, tuple):
        state.momentum = state.momentum._replace(step=int(opt.step))
    state.masks = None
    if d["masks"] is not None:
        dev = next(iter(state.params.values())).device
        state.masks = {n: torch.from_numpy(m).to(dev) for n, m in
                       masks_for_model(d["masks"], model,
                                       f"the masks of {path}").items()}
    state.step = d["step"]
    state.rng = (None if d["rng"] is None
                 else np.asarray(d["rng"], np.uint32))
    gen = metadata.get(GENERATOR_KEY)
    if gen is not None:
        state.generator.set_state(torch.from_numpy(
            np.asarray(gen, np.uint8).copy()))
    elif state.rng is not None:
        state.generator.manual_seed(int(state.rng.astype(np.uint64)[0]) << 32
                                    | int(state.rng[1]))
    return epoch, metadata
