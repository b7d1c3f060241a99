"""Folder prediction: case discovery, preprocessing, fold-ensemble
sliding-window inference, export. Counterpart of
e2enet_tpu/inference/predictor.py (:34-373) on the port's channels-last
model and its kernels.

Parity: reference inference/predict.py (predict_from_folder :675-771,
predict_cases :194-356, case discovery by the _0000.nii.gz convention
:639-672, multi-process sharding [part_id::num_parts] :745) and
training/model_restore.py (restore all fold params :44-154, Tconv from the
checkpoint name :144-148).

Every fold's checkpoint (training/checkpoint.py, the JAX package's format)
becomes one model on the device with its DSFF masks baked into the weights;
the network is the one the fold was trained with: the Tconv, and the
architecture switches of the sidecar's `init` (models/unetpp.
ARCH_DEFAULTS; a switch the sidecar lacks, as the JAX package writes it,
takes its default). The row-sparse plan of a shiftConvPP network is
attached when every fold shares it, as the JAX package does. Per tile the
mirror passes run as flip-free forwards (mirror_apply_fns_for) whenever
TTA runs and the network has mirrored operators; a network without them
(resenc, full 3D kernels) flips the data. The fold average is taken on
the host. A background thread preprocesses the next case while the device
predicts the current one (the reference's Queue(1) pipeline, :93-128).

Accumulators follow the reference: float16 only with all_in_gpu (its fast
mode, which also takes the bfloat16 probs head, and bfloat16 per-pass
probabilities on the data-flip path), float32 otherwise. Every entry point
takes `device`; "cuda" without a card raises, and nothing falls back to
the CPU unless device="cpu" is asked for.
"""
import os
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models.masks import bake_masks, masks_for_model
from ..models.unetpp import ARCH_DEFAULTS, build_network
from ..models.weights import from_jax_params
from ..ops.sliding import flip_combinations, predict_volume_tiled
from ..plans import Plans
from ..preprocessing.preprocessor import GenericPreprocessor
from ..training.checkpoint import load_checkpoint
from ..utils.files import (isdir, isfile, join, load_pickle, maybe_mkdir_p,
                           subfiles)
from .export import save_segmentation_nifti, \
    save_segmentation_nifti_from_softmax

MULTI_DEVICE_ITEM = "ROADMAP Queue 1 item 7 (multi-GPU)"


def require_device(device) -> torch.device:
    """The device to run on; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card, or on "
                           "the CPU when device='cpu' is asked for")
    return dev


def check_input_folder_and_return_caseIDs(input_folder: str,
                                          expected_num_modalities: int):
    """Case discovery by the _XXXX.nii.gz convention (predict.py:639-672)."""
    files = subfiles(input_folder, join=False, suffix=".nii.gz", sort=True)
    maybe_case_ids = np.unique([i[:-12] for i in files])
    remaining = set(files)
    missing = []
    for c in maybe_case_ids:
        for n in range(expected_num_modalities):
            expected = f"{c}_{n:04d}.nii.gz"
            if expected in remaining:
                remaining.remove(expected)
            else:
                missing.append(expected)
    assert len(missing) == 0, f"missing modality files: {missing}"
    if len(remaining):
        print("WARNING: unexpected files:", sorted(remaining))
    return list(maybe_case_ids)


class ModelBundle:
    """All folds of one trained model, restored from checkpoints: one model
    per fold on `device`, the network of the sidecar's Tconv and switches,
    its masks baked into its weights."""

    def __init__(self, model_folder: str, folds: Sequence, tconv: str,
                 checkpoint_name: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        self.device = require_device(device)
        self.model_folder = model_folder
        self.tconv = tconv
        self.compute_dtype = compute_dtype
        checkpoint_name = checkpoint_name or f"{tconv}_model_final_checkpoint"

        if folds is None or (isinstance(folds, (list, tuple))
                             and folds[0] == "all"):
            fold_dirs = [join(model_folder, "all")] if isdir(
                join(model_folder, "all")) else sorted(
                [join(model_folder, d) for d in os.listdir(model_folder)
                 if d.startswith("fold_")])
        else:
            fold_dirs = [join(model_folder, f"fold_{f}") for f in folds]
        assert len(fold_dirs) > 0, f"no folds found in {model_folder}"

        states, sidecar = [], None
        for fd in fold_dirs:
            ckpt = join(fd, checkpoint_name + ".model")
            assert isfile(ckpt), f"checkpoint missing: {ckpt}"
            states.append((ckpt, load_checkpoint(ckpt)[0]))
            if sidecar is None and isfile(ckpt + ".pkl"):
                sidecar = load_pickle(ckpt + ".pkl")
        assert sidecar is not None, "checkpoint sidecar pkl missing"
        self.sidecar_init = sidecar["init"]
        self.plans = Plans.from_dict(sidecar["plans"])
        self.stage = sidecar["init"].get("stage", 0) or 0
        self.stage_plan = self.plans.plans_per_stage[self.stage]
        self.num_classes = self.plans.num_classes + 1
        num_in = self.plans.num_modalities
        if sidecar["init"].get("cascade", False):
            num_in += self.num_classes - 1
        self.patch_size = tuple(int(i) for i in self.stage_plan.patch_size)
        init = sidecar["init"]
        self.arch = {k: init[k] for k, v in ARCH_DEFAULTS.items()
                     if init.get(k, v) != v}

        self.fold_models = []
        fold_plans = []
        for ckpt, state in states:
            net = build_network(
                self.stage_plan, num_in, self.num_classes, tconv=tconv,
                base_num_features=sidecar["init"].get("base_num_features",
                                                      48),
                compute_dtype=compute_dtype, device=self.device, **self.arch)
            net.load_state_dict(from_jax_params(state["params"]),
                                strict=True)
            net.eval()
            plan = None
            if state["masks"] is not None:
                masks = masks_for_model(state["masks"], net,
                                        f"the masks of {ckpt}")
                plan = bake_masks(net, masks)
            fold_plans.append(plan)
            self.fold_models.append(net)
        # DSFF row-sparse inference where every fold shares one plan (a
        # single fold, or identically-structured masks); otherwise dense
        # masked, as the JAX package runs them
        self.sparse_plan = (fold_plans[0]
                            if tconv in ("shiftConvPP", "shiftConvPP_noshift")
                            and fold_plans[0] is not None
                            and all(p == fold_plans[0] for p in fold_plans)
                            else None)
        if self.sparse_plan is not None:
            for net in self.fold_models:
                net.set_sparse_plan(self.sparse_plan)

    def make_preprocessor(self) -> GenericPreprocessor:
        """The reference builds GenericPreprocessor whatever the plan's
        preprocessor_name (e2enet_tpu/inference/predictor.py:127-132)."""
        return GenericPreprocessor(
            self.plans.normalization_schemes,
            self.plans.use_mask_for_norm,
            self.plans.transpose_forward,
            self.plans.intensity_properties)


def sidecar_requires_cascade(bundle: ModelBundle) -> bool:
    return bool(bundle.sidecar_init.get("cascade", False))


def append_prev_stage_onehot(data: np.ndarray, out_file: str,
                             prev_stage_folder: str, transpose_forward,
                             fg_labels):
    """Load the lowres prediction for this case, bring it to the
    preprocessed geometry (transpose + label-safe resize) and append one-hot
    channels (reference predict.py cascade path)."""
    from ..io.nifti import read_nifti
    from ..preprocessing.resampling import resize_segmentation
    case = os.path.basename(out_file)
    prev_file = join(prev_stage_folder, case)
    assert isfile(prev_file), f"missing lowres prediction {prev_file}"
    seg = read_nifti(prev_file).array.astype(np.float32)
    seg = seg.transpose([int(i) for i in transpose_forward])
    if seg.shape != data.shape[1:]:
        seg = resize_segmentation(seg, data.shape[1:], order=1)
    onehot = np.stack([(seg == l).astype(np.float32) for l in fg_labels])
    return np.concatenate([data, onehot], axis=0)


def mirror_apply_fns_for(model, mirror_axes: Sequence[int] = (0, 1, 2)
                         ) -> List[Callable[[torch.Tensor], torch.Tensor]]:
    """Flip-free mirror TTA: one statically mirrored forward per flip
    combination, in ops/sliding.flip_combinations order, all sharing the
    model's parameters: fns[m](x) == flip_m(model(flip_m(x))) through the
    mirrored operators of model.forward(..., flips=...), so the
    sliding-window predictor never flips data (reference
    mirror_apply_fns_for)."""
    fns = []
    for c in flip_combinations(mirror_axes):
        f = tuple(a in c for a in (0, 1, 2))
        fns.append(lambda x, _f=f: model(x, do_ds=False, flips=_f))
    return fns


def predict_case(bundle: ModelBundle, data: np.ndarray,
                 do_tta: bool = True, step_size: float = 0.5,
                 num_devices: int = 1,
                 all_in_gpu: bool = False) -> np.ndarray:
    """Fold-ensemble class probabilities (K, X, Y, Z) of preprocessed data
    (C, X, Y, Z), in float16 with all_in_gpu and float32 otherwise.

    all_in_gpu is the reference's fast mode (neural_network.py:337-363):
    float16 accumulators, and for a bfloat16 model the bfloat16 probs head
    under flip-free TTA or bfloat16 per-pass probabilities under data-flip
    TTA. Otherwise float32 logits and float32 accumulators. TTA runs
    flip-free (the reference's default) where the network has mirrored
    operators, and flips the data otherwise (resenc, full 3D kernels: the
    reference's predictor asserts there). Each fold model's head is set for
    the mode (a network without a probs head keeps its logits)."""
    if num_devices > 1:
        raise NotImplementedError(f"num_devices={num_devices}: "
                                  f"{MULTI_DEVICE_ITEM}")
    flip_free = do_tta and bundle.fold_models[0].mirrored_operators()
    bf16 = bundle.compute_dtype == torch.bfloat16
    head = torch.bfloat16 if all_in_gpu and flip_free and bf16 else None
    accum = torch.float16 if all_in_gpu else torch.float32
    prob_dtype = (torch.bfloat16 if all_in_gpu and not flip_free and bf16
                  else None)
    softmax_sum = None
    with torch.no_grad():
        for net in bundle.fold_models:
            if hasattr(net, "head_probs_dtype"):
                net.head_probs_dtype = head
            probs = predict_volume_tiled(
                lambda x, _n=net: _n(x, do_ds=False), data,
                bundle.patch_size, bundle.num_classes,
                device=bundle.device, step_size=step_size,
                do_mirroring=do_tta, accum_dtype=accum,
                mirror_apply_fns=(mirror_apply_fns_for(net) if flip_free
                                  else None),
                prob_dtype=prob_dtype)
            softmax_sum = probs if softmax_sum is None else softmax_sum + probs
    return softmax_sum / len(bundle.fold_models)


def predict_from_folder(model_folder: str, input_folder: str,
                        output_folder: str, folds, save_npz: bool,
                        do_tta: bool = True, step_size: float = 0.5,
                        checkpoint_name: Optional[str] = None,
                        tconv: str = "shiftConvPP",
                        part_id: int = 0, num_parts: int = 1,
                        overwrite_existing: bool = True,
                        disable_postprocessing: bool = False,
                        mode: str = "normal",
                        segs_from_prev_stage_folder: Optional[str] = None,
                        num_devices: int = 1,
                        all_in_gpu: bool = False,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        device="cuda",
                        timings: Optional[list] = None) -> List[str]:
    """mode (reference predict_cases/_fast/_fastest, predict.py:194,362,514):
      normal : resample the full softmax back to original geometry (order 1)
      fast   : argmax at network resolution, resample the label map only
      fastest: like fast, and TTA disabled
    Returns the written segmentation files. timings, when a list, gets one
    dict per case: its seconds in preprocessing (on the background thread),
    in predict_case and in export."""
    assert mode in ("normal", "fast", "fastest")
    if num_devices > 1:
        raise NotImplementedError(f"num_devices={num_devices}: "
                                  f"{MULTI_DEVICE_ITEM}")
    if mode == "fastest":
        do_tta = False
    maybe_mkdir_p(output_folder)
    bundle = ModelBundle(model_folder, folds, tconv, checkpoint_name,
                         compute_dtype=compute_dtype, device=device)
    expected_num_modalities = bundle.plans.num_modalities
    case_ids = check_input_folder_and_return_caseIDs(
        input_folder, expected_num_modalities)
    case_ids = case_ids[part_id::num_parts]

    all_files = subfiles(input_folder, join=False, suffix=".nii.gz",
                         sort=True)
    list_of_lists = [
        [join(input_folder, f) for f in all_files
         if f[:len(c)].startswith(c) and len(f) == len(c) + 12]
        for c in case_ids]
    output_files = [join(output_folder, f"{c}.nii.gz") for c in case_ids]

    if not overwrite_existing:
        keep = [i for i, o in enumerate(output_files) if not isfile(o)]
        list_of_lists = [list_of_lists[i] for i in keep]
        output_files = [output_files[i] for i in keep]
        case_ids = [case_ids[i] for i in keep]

    cascade = bool(sidecar_requires_cascade(bundle))
    if cascade:
        assert segs_from_prev_stage_folder is not None, (
            "this is a cascade model: pass the lowres predictions via "
            "segs_from_prev_stage_folder (predict with -m 3d_cascade_fullres "
            "to run the lowres stage automatically)")
    preprocessor = bundle.make_preprocessor()
    target_spacing = bundle.stage_plan.current_spacing

    # background preprocessing: overlap host prep of case i+1 with device
    # inference of case i (reference Queue(1) pipeline, predict.py:93-128)
    q: "queue.Queue" = queue.Queue(maxsize=1)

    def producer():
        try:
            for files, ofile in zip(list_of_lists, output_files):
                t0 = time.perf_counter()
                d, _s, props = preprocessor.preprocess_test_case(
                    files, target_spacing)
                if cascade:
                    d = append_prev_stage_onehot(
                        d, ofile, segs_from_prev_stage_folder,
                        bundle.plans.transpose_forward,
                        list(range(1, bundle.num_classes)))
                q.put((d, props, ofile, time.perf_counter() - t0))
            q.put(None)
        except Exception as e:  # noqa: BLE001 - raised by the consumer
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    pp_file = join(model_folder, "postprocessing.json")
    postprocess = None
    if not disable_postprocessing and isfile(pp_file):
        from ..postprocessing.connected_components import \
            load_postprocessing_fn
        postprocess = load_postprocessing_fn(pp_file)

    results = []
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, Exception):
            t.join()
            raise item
        data, props, ofile, prep_s = item
        print("predicting", os.path.basename(ofile))
        t0 = time.perf_counter()
        softmax = predict_case(bundle, data, do_tta=do_tta,
                               all_in_gpu=all_in_gpu, step_size=step_size,
                               num_devices=num_devices)
        t1 = time.perf_counter()
        transpose_backward = bundle.plans.transpose_backward
        softmax = softmax.transpose(
            [0] + [int(i) + 1 for i in transpose_backward])
        npz_file = ofile[:-7] + ".npz" if save_npz else None
        if mode in ("fast", "fastest"):
            seg = softmax.argmax(0).astype(np.uint8)
            save_segmentation_nifti(seg, ofile, props, 1)
        elif postprocess is not None:
            save_segmentation_nifti_from_softmax(
                softmax, ofile, props, 1, None, postprocess["fn"],
                postprocess["args"], npz_file)
        else:
            save_segmentation_nifti_from_softmax(
                softmax, ofile, props, 1, None, None, None, npz_file)
        if timings is not None:
            timings.append({"case": os.path.basename(ofile)[:-7],
                            "preprocess_s": prep_s, "predict_s": t1 - t0,
                            "export_s": time.perf_counter() - t1})
        results.append(ofile)
    t.join()
    return results
