"""Predict CLI, the port's counterpart of e2enet_tpu/cli/predict.py: the
same flags, and --device.

Parity: reference simple_predict.py (:25-233): fold selection, TTA toggle,
step size, multi-process sharding (--part_id/--num_parts), checkpoint name
prefixed with Tconv (:152), save_npz for later ensembling, and the
3d_cascade_fullres model's automatic lowres run (:194-211).

Usage:
  python -m e2enet_tpu_torch.cli.predict -i IN_FOLDER -o OUT_FOLDER -t 4 \
      -m 3d_fullres -f 0 --Tconv shiftConvPP [--disable_tta] \
      [--step_size .5] [--device cuda|cpu]

Models are read from $RESULTS_FOLDER/<model>/<task>/<trainer>__<plans>, in
the JAX package's checkpoint format: --Tconv names the network (every Tconv
of the train CLI) and the checkpoint's sidecar its architecture switches.
TTA is flip-free (mirrored operators) except for networks without them
(resenc, a full 3D kernel), whose TTA flips the data. A reference-trained
PyTorch .model converts first (models/torch_checkpoint.
convert_reference_model_to_native). --device defaults to the card
(`cuda`), which must be present; `--device cpu` runs the plain torch
versions of every kernel. --num_devices above 1 raises (ROADMAP Queue 1
item 7).
"""
import argparse

from .. import paths
from ..inference.predictor import predict_from_folder
from ..utils.files import join
from ..utils.task_names import convert_id_to_task_name


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-i", "--input_folder", required=True)
    parser.add_argument("-o", "--output_folder", required=True)
    parser.add_argument("-t", "--task_name", required=True)
    parser.add_argument("-m", "--model", default="3d_fullres",
                        choices=["2d", "3d_lowres", "3d_fullres",
                                 "3d_cascade_fullres"])
    parser.add_argument("-f", "--folds", nargs="+", default=None,
                        help="fold indices or 'all'; default: all found")
    parser.add_argument("-tr", "--trainer_class_name", default="TPUTrainer")
    parser.add_argument("-p", "--plans_identifier",
                        default="nnUNetPlansv2.1")
    parser.add_argument("--Tconv", type=str, default="shiftConvPP")
    parser.add_argument("-chk", "--checkpoint_name", default=None,
                        help="default: {Tconv}_model_final_checkpoint")
    parser.add_argument("-z", "--save_npz", action="store_true")
    parser.add_argument("--disable_tta", action="store_true")
    parser.add_argument("--step_size", type=float, default=0.5)
    parser.add_argument("--part_id", type=int, default=0)
    parser.add_argument("--num_parts", type=int, default=1)
    parser.add_argument("--overwrite_existing", type=int, default=1)
    parser.add_argument("--disable_postprocessing", action="store_true")
    parser.add_argument("--all_in_gpu", type=str, default="False",
                        help="None/False/True (reference flag): True keeps "
                             "f16 sliding-window accumulators on device "
                             "(the reference's fp16 fast mode)")
    parser.add_argument("--mode", default="normal",
                        choices=["normal", "fast", "fastest"])
    parser.add_argument("--num_devices", type=int, default=1,
                        help="devices to shard each volume's tiles over; "
                             "only 1 is ported (ROADMAP Queue 1 item 7)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default; the card must "
                             "be present) or cpu")
    a = parser.parse_args(args)

    task = a.task_name
    if not task.startswith("Task"):
        task = convert_id_to_task_name(int(task))
    folds = a.folds
    if folds is not None and folds != ["all"]:
        folds = [int(f) for f in folds]

    results_dir = paths.require(paths.get_results_dir(), "RESULTS_FOLDER")
    model_folder = join(results_dir, a.model, task,
                        a.trainer_class_name + "__" + a.plans_identifier)
    print("using model stored in", model_folder)

    assert a.all_in_gpu in ("None", "False", "True")
    all_in_gpu = a.all_in_gpu == "True"
    segs_prev = None
    if a.model == "3d_cascade_fullres":
        # auto-run the lowres stage first (simple_predict.py:194-211)
        lowres_folder = join(a.output_folder + "_lowres")
        lowres_model = join(results_dir, "3d_lowres", task,
                            a.trainer_class_name + "__" + a.plans_identifier)
        print("cascade: predicting 3d_lowres ->", lowres_folder)
        predict_from_folder(
            lowres_model, a.input_folder, lowres_folder, folds, False,
            do_tta=not a.disable_tta, step_size=a.step_size,
            checkpoint_name=a.checkpoint_name, tconv=a.Tconv,
            part_id=a.part_id, num_parts=a.num_parts,
            overwrite_existing=bool(a.overwrite_existing),
            disable_postprocessing=True, mode="fast",
            all_in_gpu=all_in_gpu, num_devices=a.num_devices,
            device=a.device)
        segs_prev = lowres_folder

    return predict_from_folder(
        model_folder, a.input_folder, a.output_folder, folds, a.save_npz,
        do_tta=not a.disable_tta, step_size=a.step_size,
        checkpoint_name=a.checkpoint_name, tconv=a.Tconv,
        part_id=a.part_id, num_parts=a.num_parts,
        overwrite_existing=bool(a.overwrite_existing),
        disable_postprocessing=a.disable_postprocessing, mode=a.mode,
        segs_from_prev_stage_folder=segs_prev, all_in_gpu=all_in_gpu,
        num_devices=a.num_devices, device=a.device)


if __name__ == "__main__":
    main()
