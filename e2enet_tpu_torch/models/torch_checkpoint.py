"""Reference-trained PyTorch checkpoints into the port: the counterpart of
e2enet_tpu/models/torch_checkpoint.py.

A reference checkpoint '{Tconv}_model_*.model' is a torch.save dict with a
CPU state_dict (nnUNetTrainer_simple.py:1157-1167) beside a '.model.pkl'
sidecar {init, name, class, plans} (model_restore.py:44-99).
load_reference_checkpoint reads both and converts the state_dict
(models/torch_import.py); convert_reference_model_to_native writes it as a
checkpoint of the port's format (training/checkpoint.py, the JAX package's
format), which inference/predictor.ModelBundle and the predict CLI serve.
"""
import os
from typing import Optional

import torch

from ..plans import Plans
from ..training.checkpoint import save_checkpoint
from ..utils.files import isfile, load_pickle
from .torch_import import convert_unetpp_state_dict


def load_reference_checkpoint(model_file: str,
                              sidecar_file: Optional[str] = None):
    """(params tree of numpy arrays, Plans, info dict) of a reference
    checkpoint; info holds epoch, num_pool, stage and trainer_name."""
    sidecar_file = sidecar_file or model_file + ".pkl"
    assert isfile(model_file), model_file
    ckpt = torch.load(model_file, map_location="cpu", weights_only=False)
    sd = {k[7:] if k.startswith("module.") else k: v.cpu().numpy()
          for k, v in ckpt["state_dict"].items()}
    assert isfile(sidecar_file), (
        f"sidecar {sidecar_file} missing: cannot recover plans/init args")
    sidecar = load_pickle(sidecar_file)
    plans = Plans.from_reference_pickle(sidecar["plans"])
    stage = max(plans.plans_per_stage.keys())
    num_pool = len(plans.plans_per_stage[stage].pool_op_kernel_sizes)
    params = convert_unetpp_state_dict(sd, num_pool=num_pool,
                                       num_conv_per_stage=plans.conv_per_stage)
    info = {"epoch": ckpt.get("epoch"), "num_pool": num_pool,
            "stage": stage, "trainer_name": sidecar.get("name")}
    return params, plans, info


def convert_reference_model_to_native(model_file: str, output_file: str,
                                      tconv: str = "shiftConvPP",
                                      base_num_features: int = 48,
                                      fold=0) -> str:
    """Write a checkpoint of the port's format (and its sidecar) from a
    reference .model file. The sidecar's init records the plan's
    conv_per_stage as num_conv_per_stage, so the predictor builds the
    network the weights belong to."""
    params, plans, info = load_reference_checkpoint(model_file)
    sidecar = {
        "init": {"fold": fold, "stage": info["stage"], "tconv": tconv,
                 "batch_dice": True, "base_num_features": base_num_features,
                 "cascade": False,
                 "num_conv_per_stage": int(plans.conv_per_stage)},
        "name": "TPUTrainer",
        "class": "e2enet_tpu_torch.training.trainer.Trainer",
        "plans": plans.to_dict(),
        "converted_from": os.path.abspath(model_file),
    }
    save_checkpoint(output_file, params, info.get("epoch") or 0,
                    metadata={"converted_from": model_file},
                    sidecar=sidecar)
    print(f"converted {model_file} -> {output_file}")
    return output_file
