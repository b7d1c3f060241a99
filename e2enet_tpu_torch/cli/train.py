"""Train CLI, the port's counterpart of e2enet_tpu/cli/train.py: the same
flags, with --device.

Parity: reference simple_main.py (:33-220): resolves the task/plans,
instantiates the trainer (Tconv dispatch), optional DSFF sparse config
(sparselearning add_sparse_args flags, core_channel.py:17-31), runs training
(+ optional validation only / continue), then validates the fold.

Usage:
  python -m e2enet_tpu_torch.cli.train --task 4 --fold 0 \
      --Tconv shiftConvPP --sparse True --density 0.2 \
      --update_frequency 1200 --epochs 1000 --batches 250 \
      [--network 3d_fullres|2d|3d_lowres|3d_cascade_fullres] \
      [-tr nnUNetTrainerV2_Ranger_lr3en4] [--growth gradient] \
      [--device cuda|cpu] [-c]

Reads $nnUNet_preprocessed/<task>/ (the plans file, the stage folder,
splits_final.pkl, gt_segmentations/), the folder that `python -m
e2enet_tpu_torch.cli.plan_and_preprocess -t <id>` writes from the raw
task, and writes the fold under
$RESULTS_FOLDER/nnUNet/<network>/<task>/TPUTrainer__<plans>/, in the JAX
package's checkpoint format: either package continues the other's run and
predicts with its folds. --device defaults to the card (`cuda`), which
must be present; `--device cpu` trains the plain torch versions of every
kernel. --network 2d trains the task's 2D plan (nnUNetPlansv2.1_plans_2D,
patch depth 1, which `-pl2d ExperimentPlanner2D_v21` writes) without the
depth shift (shiftConvPP_noshift) and without batch dice; --Tconv
shiftConvPP_noshift turns the shift off on a 3D plan, and every other
Tconv of the JAX CLI trains: shiftConvPP_313 / shiftConvPP_331 (the (3,1,3)
/ (3,3,1) kernels), ori and shiftConvPP_nodff (models/unet.ShiftUNet),
resenc (models/resenc.ResidualUNet). On a two-stage
plan, --network 3d_lowres trains the first stage and then writes each
validation case's prediction, resampled to the last stage's geometry, as
<case>_segFromPrevStage.npz into the last stage's folder
(training/cascade.predict_next_stage; with --fold all it covers every
case), and --network 3d_cascade_fullres trains the last stage with those
segmentations as one-hot input channels (the cascade); both raise on a
one-stage plan, as the JAX CLI does. -tr names a
preset of training/variants.py whose keys go to the trainer as the JAX
CLI maps them (variant_kwargs): optimizers, learning
rates and their schedules, momentum, losses, epochs, precision, batch
dice, augmentation levels, the deep-supervision mode, per-epoch
validation, export options, regions (the BraTS region trainers:
sigmoid heads, region targets, summary.csv by region), the Tconv and the
architecture switches (norm_op, nonlin, nonlin_before_norm,
num_conv_per_stage, seg_bias, conv_kernel): all 95 presets train. Every DSFF
setting of the JAX trainer trains: --sparse_init
uniform|dense|uniform_ori|ERK|GMP|lottery_ticket, --prune_mode
local|global (global on element masks), --granularity
auto|kernel|element|row (row with uniform), --growth random|gradient,
--final_density with --init-prune-epoch / --final-prune-epoch (the global
prune's schedule, GMP's window) and --multiplier (GMP).
--device_augment augments the training batches on the card
(ops/device_augment.py: the pipeline queues raw crops, the card warps them
trilinear and nearest and runs the JAX chain's intensity transforms);
with the cascade, regions, ds_mode none or dummy_load it is refused, as
the JAX trainer cannot train those so. --num_devices n above 1 trains
data parallel: the CLI spawns n ranks (parallel/mesh.launch: NCCL, one
card each, on cuda; gloo on the CPU), each runs this CLI inside the
process group (Trainer(num_devices=n): every rank augments the whole batch
and keeps its rows, the losses and gradients are reduced over the ranks),
and rank 0 alone writes the fold and validates it. More ranks than cards
raises, and so does --da_threads above 1 with it (only one augmentation
thread gives every rank the same batches). Refused, naming the ROADMAP item that ports it: --spatial_parallel
above 1 (item 7 (ii)). --fused, --no_fused and --remat choose between XLA
programs of the JAX package and are rejected.
"""
import argparse
import sys

from .. import paths
from ..inference.predictor import require_device
from ..parallel import mesh
from ..plans import Plans
from ..training.cascade import predict_next_stage
from ..training.dsff import DSFFConfig
from ..training.trainer import (SPATIAL_PARALLEL_ITEM, Trainer,
                                refuse_unported)
from ..training.variants import resolve_variant
from ..utils.files import isfile, join
from ..utils.task_names import convert_id_to_task_name

# the preset keys that reach the trainer under their own names (reference
# cli/train.py:159-168)
PRESET_KEYS = ("max_num_epochs", "loss_name", "momentum", "initial_lr",
               "da_level", "dummy_load", "fp16", "cascade", "optimizer",
               "norm_op", "nonlin", "lr_schedule", "momentum_schedule",
               "loss_kwargs", "loss_schedule", "num_conv_per_stage",
               "seg_bias", "nonlin_before_norm", "batch_dice",
               "base_num_features", "regions", "ds_mode", "validate_every",
               "export_kwargs", "conv_kernel")


def str2bool(v):
    return str(v).lower() in ("yes", "true", "t", "1")


def variant_kwargs(name: str) -> dict:
    """The trainer arguments of the -tr preset `name` as the JAX CLI maps
    them (reference cli/train.py:156-173): its PRESET_KEYS as they are,
    tconv, `da` as da_level and `loss` as loss_name."""
    preset = resolve_variant(name)
    kwargs = {k: v for k, v in preset.items() if k in PRESET_KEYS}
    for key, arg in (("tconv", "tconv"), ("da", "da_level"),
                     ("loss", "loss_name")):
        if key in preset:
            kwargs[arg] = preset[key]
    return kwargs


def get_default_configuration(network: str, task: str,
                              plans_identifier: str = "nnUNetPlansv2.1"):
    """Resolve plans file / output dir / stage for a task (parity:
    run/default_configuration.py:34-80)."""
    preproc_dir = join(paths.require(paths.get_preprocessing_output_dir(),
                                     "preprocessed dir"), task)
    suffix = "_plans_2D" if network == "2d" else "_plans_3D"
    plans_json = join(preproc_dir, plans_identifier + suffix + ".json")
    plans_pkl = join(preproc_dir, plans_identifier + suffix + ".pkl")
    plans_file = plans_json if isfile(plans_json) else plans_pkl
    plans = Plans.load(plans_file)
    possible_stages = sorted(plans.plans_per_stage.keys())
    if network in ("3d_lowres",) and len(possible_stages) == 1:
        raise RuntimeError("3d_lowres only applies to multi-stage plans")
    if network in ("3d_cascade_fullres",) and len(possible_stages) == 1:
        raise RuntimeError(
            "3d_cascade_fullres requires multi-stage plans (3d_lowres)")
    stage = (possible_stages[0] if network == "3d_lowres"
             else possible_stages[-1])
    results_dir = paths.require(paths.get_results_dir(), "RESULTS_FOLDER")
    output_folder = join(results_dir, network, task,
                         "TPUTrainer__" + plans_identifier)
    batch_dice = network != "2d"
    return plans, output_folder, preproc_dir, stage, batch_dice


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--network", type=str, default="3d_fullres")
    parser.add_argument("--task", type=str, required=True)
    parser.add_argument("--fold", type=str, default="0",
                        help="0..4 or 'all'")
    parser.add_argument("--Tconv", type=str, default="shiftConvPP")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--batches", type=int, default=250,
                        help="batches per epoch")
    parser.add_argument("--val_batches", type=int, default=50)
    parser.add_argument("--base_features", type=int, default=48)
    parser.add_argument("-c", "--continue_training", action="store_true")
    parser.add_argument("--validation_only", action="store_true")
    parser.add_argument("--valbest", action="store_true")
    parser.add_argument("--fp32", action="store_true",
                        help="the plain float32 model (default: bf16 on "
                             "the kernels)")
    parser.add_argument("--fused", action="store_true",
                        help="rejected: chooses an XLA program of the JAX "
                             "package")
    parser.add_argument("--remat", default=None,
                        help="rejected: chooses an XLA program of the JAX "
                             "package")
    parser.add_argument("--no_fused", action="store_true",
                        help="rejected: chooses an XLA program of the JAX "
                             "package")
    parser.add_argument("-p", "--plans_identifier", type=str,
                        default="nnUNetPlansv2.1")
    parser.add_argument("-tr", "--trainer_variant", type=str,
                        default="TPUTrainer",
                        help="a preset of training/variants.py")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel ranks, one per device (spawned "
                             "by this CLI)")
    parser.add_argument("--spatial_parallel", type=int, default=1,
                        help=f"only 1 is ported ({SPATIAL_PARALLEL_ITEM})")
    parser.add_argument("--device_augment", action="store_true",
                        help="augment the training batches on the device "
                             "(trilinear spatial; see ops/device_augment.py "
                             "for where it differs from the host chain)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--da_threads", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default; the card must "
                             "be present) or cpu")
    # DSFF flags (parity: add_sparse_args)
    parser.add_argument("--sparse", type=str2bool, default=False)
    parser.add_argument("--sparse_init", type=str, default="uniform")
    parser.add_argument("--growth", type=str, default="random")
    parser.add_argument("--death", type=str, default="magnitude")
    parser.add_argument("--death-rate", dest="death_rate", type=float,
                        default=0.5)
    parser.add_argument("--density", type=float, default=0.3)
    parser.add_argument("--final_density", type=float, default=0.05)
    parser.add_argument("--update_frequency", type=int, default=1200)
    parser.add_argument("--fix", type=str2bool, default=False)
    parser.add_argument("--prune_mode", type=str, default="local",
                        choices=("local", "global"))
    parser.add_argument("--init-prune-epoch", dest="init_prune_epoch",
                        type=int, default=0)
    parser.add_argument("--final-prune-epoch", dest="final_prune_epoch",
                        type=int, default=1000)
    parser.add_argument("--multiplier", type=int, default=1,
                        help="GMP epoch-window multiplier")
    parser.add_argument("--granularity", type=str, default="auto",
                        choices=("auto", "kernel", "element", "row"))
    a = parser.parse_args(args)

    for flag, given in (("--fused", a.fused), ("--no_fused", a.no_fused),
                        ("--remat", a.remat is not None)):
        if given:
            parser.error(f"{flag} chooses between XLA programs of the JAX "
                         f"package and has no meaning in the port (one "
                         f"path: the CUDA kernels at bf16, or --fp32)")
    refuse_unported(spatial_parallel=a.spatial_parallel)
    if (a.num_devices or 1) > 1 and a.da_threads > 1:
        parser.error("--num_devices above 1 takes one --da_threads: every "
                     "rank must see the same seeded batches")
    if (a.num_devices or 1) > 1 and not mesh.is_initialized():
        mesh.check_num_devices(a.num_devices, a.device)
        mesh.launch(_rank_main, a.num_devices, a.device,
                    list(sys.argv[1:] if args is None else args))
        return None
    device = require_device(a.device)
    preset = variant_kwargs(a.trainer_variant)

    task = a.task
    if not task.startswith("Task"):
        task = convert_id_to_task_name(int(task))
    fold = a.fold if a.fold == "all" else int(a.fold)

    plans, output_folder, preproc_dir, stage, batch_dice = \
        get_default_configuration(a.network, task, a.plans_identifier)

    dsff_cfg = None
    if a.sparse:
        dsff_cfg = DSFFConfig(
            sparse=True, sparse_init=a.sparse_init, growth=a.growth,
            death=a.death, death_rate=a.death_rate, density=a.density,
            final_density=a.final_density,
            update_frequency=a.update_frequency, fix=a.fix,
            prune_mode=a.prune_mode, init_prune_epoch=a.init_prune_epoch,
            final_prune_epoch=a.final_prune_epoch, multiplier=a.multiplier,
            granularity=a.granularity)

    kwargs = dict(
        stage=stage, batch_dice=batch_dice, tconv=a.Tconv,
        cascade=a.network == "3d_cascade_fullres",
        max_num_epochs=a.epochs, num_batches_per_epoch=a.batches,
        num_val_batches_per_epoch=a.val_batches, fp16=not a.fp32,
        dsff_config=dsff_cfg, seed=a.seed, num_da_threads=a.da_threads,
        base_num_features=a.base_features, num_devices=a.num_devices,
        spatial_parallel=a.spatial_parallel,
        device_augment=a.device_augment, device=device)
    kwargs.update(preset)
    trainer = Trainer(plans, fold, output_folder,
                      dataset_directory=preproc_dir, **kwargs)
    trainer.initialize(not a.validation_only)

    if not a.validation_only:
        if a.continue_training and isfile(trainer.checkpoint_path("latest")):
            trainer.load_checkpoint_file("latest")
        trainer.run_training()
    else:
        which = "best" if a.valbest else "final_checkpoint"
        trainer.load_checkpoint_file(which, train=False)
    trainer.validate()

    if a.network == "3d_lowres" and not a.validation_only:
        # cascade: predict this fold's validation cases at the fullres
        # stage geometry (simple_main.py:213-215 / run_training.py); rank 0
        # alone, as it validates
        next_stage_folder = join(
            preproc_dir, plans.data_identifier
            + "_stage%d" % sorted(plans.plans_per_stage.keys())[-1])
        if trainer.is_main:
            predict_next_stage(trainer, next_stage_folder)
        mesh.barrier()
    return trainer


def _rank_main(argv):
    """One rank of --num_devices: this CLI inside the process group."""
    main(argv)


if __name__ == "__main__":
    main()
