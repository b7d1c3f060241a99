"""Reference PyTorch checkpoints <-> the reference's params tree (numpy
only): the port's copy of e2enet_tpu/models/torch_import.py.

Maps Generic_UNetPlusPlus state_dict names (unetpp_d.py:307-438; checkpoint
format nnUNetTrainer_simple.py:1140-1176) onto the flax params tree of
ShiftUNetPlusPlus, with the layout transposes:
    conv weight       (out, in, 1, kh, kw)  -> (kh, kw, in, out)
    transpconv weight (in, out, kd, kh, kw) -> (kd, kh, kw, in, out)
    seg head weight   (out, in, 1, 1, 1)    -> (in, out)
models/weights.from_jax_params then takes the tree to the port's
state_dict. export_unetpp_state_dict is the inverse, a port-trained model
as a reference state_dict.
"""
from typing import Dict

import numpy as np


def _conv_w(w):
    w = np.asarray(w)
    assert w.ndim == 5 and w.shape[2] == 1, \
        f"expected (o,i,1,kh,kw), got {w.shape}"
    return np.transpose(w[:, :, 0], (2, 3, 1, 0))    # (kh,kw,in,out)


def _transp_w(w):
    return np.transpose(np.asarray(w), (2, 3, 4, 0, 1))   # (kd,kh,kw,in,out)


def _seg_w(w):
    return np.transpose(np.asarray(w)[:, :, 0, 0, 0], (1, 0))   # (in,out)


def _block(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": _conv_w(sd[f"{prefix}.conv.weight"]),
        "bias": np.asarray(sd[f"{prefix}.conv.bias"]),
        "norm_scale": np.asarray(sd[f"{prefix}.instnorm.weight"]),
        "norm_bias": np.asarray(sd[f"{prefix}.instnorm.bias"]),
    }


def convert_unetpp_state_dict(sd: Dict[str, np.ndarray], num_pool: int,
                              num_conv_per_stage: int = 2) -> dict:
    """The flax `params` dict of ShiftUNetPlusPlus from a reference
    Generic_UNetPlusPlus state_dict (numpy values)."""
    P = num_pool
    params = {}
    for d in range(P):
        params[f"context{d}"] = {
            f"block{i}": _block(sd, f"conv_blocks_context.{d}.blocks.{i}")
            for i in range(num_conv_per_stage)}
    # bottleneck: Sequential(Stacked(num - 1), Stacked(1))
    params[f"context{P}a"] = {
        f"block{i}": _block(sd, f"conv_blocks_context.{P}.0.blocks.{i}")
        for i in range(num_conv_per_stage - 1)}
    params[f"context{P}b"] = {
        "block0": _block(sd, f"conv_blocks_context.{P}.1.blocks.0")}
    for z in range(P):
        for k in range(P - z):
            params[f"up{z}_{k}"] = {
                "kernel": _transp_w(sd[f"up{z}.{k}.weight"])}
            params[f"loc{z}_{k}"] = {
                f"block{i}": _block(sd, f"loc{z}.{k}.0.blocks.{i}")
                for i in range(num_conv_per_stage - 1)}
            if z == 0:
                params[f"loc{z}_{k}_final"] = {
                    "block0": _block(sd, f"loc{z}.{k}.1.blocks.0")}
    # seg_outputs.{i} is seg_head{i} (both index by level)
    for i in range(min(4, P)):
        params[f"seg_head{i}"] = {
            "kernel": _seg_w(sd[f"seg_outputs.{i}.weight"])}
    return params


def _inv_conv_w(w):
    return np.transpose(np.asarray(w), (3, 2, 0, 1))[:, :, None]


def _inv_transp_w(w):
    return np.transpose(np.asarray(w), (3, 4, 0, 1, 2))


def _inv_seg_w(w):
    return np.transpose(np.asarray(w), (1, 0))[:, :, None, None, None]


def _inv_block(blk, prefix: str):
    return {
        f"{prefix}.conv.weight": _inv_conv_w(blk["kernel"]),
        f"{prefix}.conv.bias": np.asarray(blk["bias"]),
        f"{prefix}.instnorm.weight": np.asarray(blk["norm_scale"]),
        f"{prefix}.instnorm.bias": np.asarray(blk["norm_bias"]),
    }


def export_unetpp_state_dict(params: dict, num_pool: int,
                             num_conv_per_stage: int = 2
                             ) -> Dict[str, np.ndarray]:
    """convert_unetpp_state_dict's inverse: a ShiftUNetPlusPlus params tree
    (models/weights.to_jax_params of a port state_dict) as a reference
    Generic_UNetPlusPlus state_dict (numpy values; wrap them in torch
    tensors to torch.save it)."""
    P = num_pool
    sd = {}
    for d in range(P):
        for i in range(num_conv_per_stage):
            sd.update(_inv_block(params[f"context{d}"][f"block{i}"],
                                 f"conv_blocks_context.{d}.blocks.{i}"))
    for i in range(num_conv_per_stage - 1):
        sd.update(_inv_block(params[f"context{P}a"][f"block{i}"],
                             f"conv_blocks_context.{P}.0.blocks.{i}"))
    sd.update(_inv_block(params[f"context{P}b"]["block0"],
                         f"conv_blocks_context.{P}.1.blocks.0"))
    for z in range(P):
        for k in range(P - z):
            sd[f"up{z}.{k}.weight"] = _inv_transp_w(
                params[f"up{z}_{k}"]["kernel"])
            for i in range(num_conv_per_stage - 1):
                sd.update(_inv_block(params[f"loc{z}_{k}"][f"block{i}"],
                                     f"loc{z}.{k}.0.blocks.{i}"))
            if z == 0:
                sd.update(_inv_block(params[f"loc{z}_{k}_final"]["block0"],
                                     f"loc{z}.{k}.1.blocks.0"))
    for i in range(min(4, P)):
        sd[f"seg_outputs.{i}.weight"] = _inv_seg_w(
            params[f"seg_head{i}"]["kernel"])
    return sd
