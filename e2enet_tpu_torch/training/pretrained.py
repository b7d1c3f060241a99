"""Transfer pretrained weights between runs.

Parity: reference run/load_pretrained_weights.py (:16-60): load a checkpoint
and copy only the shape-matching encoder ('conv_blocks'/'context') params
into a freshly initialized network — used to warm-start cascades or
fine-tuning on new tasks.

The port's counterpart of e2enet_tpu/training/pretrained.py, on the port's
parameters: {name: tensor} under the flax paths joined by '.'
(`context{d}.block{b}.kernel`, ...; models/unetpp.py), as
dict(model.named_parameters()) or model.state_dict() give them. A
checkpoint of either package is read by the port's load_checkpoint and
carried to the port's layout by models/weights.from_jax_params, so a
leaf's shape matches exactly where its flax shape does. A library
function: no CLI path calls it, as in the reference.
"""
from typing import Dict, Tuple

import torch

from ..models.weights import from_jax_params
from .checkpoint import load_checkpoint

# the encoder: the first element of a transferred leaf's path
PREFIX = "context"


def transfer_matching_params(target_params, source_params,
                             verbose: bool = True
                             ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Copy the encoder's leaves (path starting with 'context') whose
    shape matches. target_params: the port's {name: tensor};
    source_params: a flax tree (nested dicts of arrays, optionally under
    "params"), as a checkpoint of either package holds it. Returns
    (new_params, n_transferred): new_params holds, by the target's names,
    a copy of the source leaf in the target leaf's dtype and on its device
    where it was transferred, else the target's own tensor."""
    src = from_jax_params(source_params)
    new, n = {}, 0
    for name, leaf in target_params.items():
        keys = name.split(".")
        s = src.get(name)
        if (keys[0].startswith(PREFIX) and s is not None
                and tuple(s.shape) == tuple(leaf.shape)):
            with torch.no_grad():
                new[name] = torch.empty_like(leaf.detach()).copy_(
                    s.detach())
            n += 1
            if verbose:
                print("transferred", "/".join(keys))
        else:
            new[name] = leaf
    return new, n


def load_pretrained_weights(target_params, checkpoint_path: str,
                            verbose: bool = True
                            ) -> Dict[str, torch.Tensor]:
    """transfer_matching_params from the parameters of a checkpoint of
    either package; load the result with model.load_state_dict."""
    state, _epoch, _meta = load_checkpoint(checkpoint_path)
    new_params, n = transfer_matching_params(target_params, state["params"],
                                             verbose)
    print(f"loaded {n} pretrained tensors from {checkpoint_path}")
    return new_params
