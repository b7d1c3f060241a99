"""Trainer — the E2ENet training orchestrator on the port: the counterpart
of e2enet_tpu/training/trainer.py (TPUTrainer), registered under the name
its checkpoints' sidecar records ("TPUTrainer").

Parity: reference nnUNetTrainer_simple (training/network_training/
nnUNetTrainer_simple.py): plans ingestion (:1029-1103), DA setup (:682-733),
DS loss weights (:200-215), generators (:735-754), SGD(1e-2, .99 nesterov,
wd 3e-5) + poly LR (:367-371, :756-771), epoch loop with online foreground
Dice (:929-1020, :373-423), checkpoints named
'{Tconv}_model_{latest,best,final_checkpoint}.model' (:1140-1176), DSFF
mask.step() per iteration with cosine death-rate decay and periodic
truncate_weights (sparselearning/core_channel.py:290-317), matplotlib
progress plot (network_trainer.py:188-223), debug.json field dump
(:886-906).

On the port: one device (the card unless device="cpu"); the model's
forward and backward through the CUDA kernels at bf16 (fp16=True, the
default) or the plain float32 model (fp16=False); batches from the
background-thread augmentation pipeline (data/pipeline.py, the C++ warp of
native/); the loss, the online counts and the DSFF masks stay on the
device until the epoch ends, so no step waits for the card. Checkpoints
are the JAX package's format, the whole train state
(training/checkpoint.save_train_state): either package continues the
other's. Validation predicts every validation case by the sliding window
(ops/sliding.predict_volume_tiled, flip-free mirror TTA where the network
has mirrored operators, data flips otherwise), exports it
(inference/export.py), scores it (evaluation/) and decides the
postprocessing (postprocessing/connected_components.py).

The variants' options (training/variants.py, the train CLI's -tr): the
optimizer (SGD, Ranger, Adam), the learning-rate schedule (poly, warmup,
fixed, fixed2, cycle, plateau: ReduceLROnPlateau stepped on
train_loss_MA), the momentum and its reduction, the loss (any name of
ops/losses.LOSS_REGISTRY with its kwargs) and the CE -> Dice transition.
DSFF (training/dsff.py), every setting of the reference trainer: the
kernel-pair, row and element inits (uniform, dense, uniform_ori, ERK),
GMP with its per-epoch prune, the lottery ticket; the local prune at row,
kernel or element granularity, grown by random draws or by gradient (a
plain gradient of the loss on the update step's batch, make_grad_step);
the global prune with its gradual-density schedule. snip and GraSP need a
data batch and are library functions (dsff.init_masks_element,
dsff.init_masks_grasp), as in the reference.

The cascade (cascade=True, the 3d_cascade_fullres stage): the previous
stage's segmentation (<case>_segFromPrevStage.npz beside each case, which
training/cascade.predict_next_stage writes from a 3d_lowres trainer)
enters as num_classes - 1 one-hot input channels, in training (corrupted
by the cascade augmentation of data/augment.py) and in validation.

The variants' other knobs: da_level (training/variants.apply_da_level on
the training batches' AugmentParams; validation's mirroring does not read
it), ds_mode "none" (the full-resolution head alone: one loss weight, one
target, each step's forward with do_ds=False), validate_every (a
validation without mirroring or postprocessing into
validation_ep{epoch:03d} after every such epoch) and export_kwargs (the
export's interpolation orders and separate-z switch). The region trainers
(regions: "brats" or {name: labels}): one sigmoid head per region
(training/regions.py), targets one 0/1 channel per region, the online
counts per region, validation's tile loop under the sigmoid, the export
by regions_class_order and evaluate_regions' summary.csv in place of the
label-wise scores and the postprocessing. The validation batches get the
region targets too: the reference gives them the labels, on which its
region losses cannot run (ROADMAP Queue 3).

The architecture switches (norm_op, nonlin, num_conv_per_stage, seg_bias,
nonlin_before_norm, conv_kernel) and every Tconv of models/unetpp.
build_network train; the checkpoint sidecar's `init` records those away
from their default under these names (a default network's sidecar is the
JAX trainer's), so the predictor builds the network the fold was trained
with. A network with mirrored operators validates with flip-free TTA, one
without (resenc, a full 3D kernel) with data flips.

device_augment=True: the training pipeline queues raw crops at the
generator patch (data/pipeline.BatchPipeline(raw=True)), which go to the
device through pinned memory without waiting (the segmentation as int8)
and are augmented there by ops/device_augment.py, with the JAX trainer's
arguments (its defaults but do_mirror, do_rotation, do_scaling and
do_gamma, read from the augmentation parameters after the da_level);
validation keeps the host pipeline. The modes in which the JAX trainer
cannot train so are refused at initialize (_DEVICE_AUGMENT_REFUSED).

num_devices=n above 1 trains inside a process group of n ranks
(parallel/mesh.launch; the train CLI's --num_devices spawns them), on the
JAX trainer's ("data", "space") mesh: spatial_parallel=S splits the ranks
into a grid of n / S data rows of S ranks (mesh.make_grid), each rank one
H slab of its row's samples. Every rank runs the same seeded pipeline
(host or device augmentation) on the whole batch and keeps its rows and
slab (mesh.shard_batch), the state is broadcast from rank 0 at start, and
the steps exchange halo rows and reduce their norms' statistics, losses,
counts and gradients over the grid (training/train_state.py), so every
rank holds the same state. As the JAX trainer, one device ignores
spatial_parallel (it logs so). Rank 0
alone writes checkpoints, logs, plots, debug.json and the validations;
the other ranks wait at a barrier while it validates. A checkpoint
continued with -c is loaded by every rank from the same file. The same
batches on every rank need one augmentation thread (data/pipeline.py:
only one gives a fixed order), so num_da_threads above 1 with num_devices
above 1 raises.

`fused` and `remat` choose between XLA programs of the reference and
have no meaning here.
"""
import json
import os
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..data.augment import AugmentParams, get_patch_size
from ..data.dataset import do_split, load_case, load_dataset, unpack_dataset
from ..data.pipeline import BatchPipeline
from ..data.sampler import PatchSampler3D
from ..inference.predictor import mirror_apply_fns_for, require_device
from ..models.masks import masks_density, masks_for_model, masks_to_flax
from ..models.unetpp import (ARCH_DEFAULTS, build_network,
                             deep_supervision_scales, ds_loss_weights)
from ..ops.device_augment import make_device_augmenter
from ..parallel import mesh
from ..plans import Plans
from ..utils.files import (isfile, join, load_pickle, maybe_mkdir_p,
                           save_json)
from ..utils.logger import RunLogger
from ..utils.registry import TRAINERS
from . import dsff
from .cascade import move_seg_as_onehot_to_data
from .checkpoint import load_train_state, save_train_state
from .lr import (ReduceLROnPlateau, ce_to_dice_weights, cycle_at_end_lr,
                 fixed_schedule2_lr, fixed_schedule_lr, poly_lr,
                 reduce_momentum, warmup_poly_lr)
from .regions import resolve_regions
from .train_state import (apply_new_masks, create_train_state, make_eval_step,
                          make_grad_step, make_mask_update_step,
                          make_train_step, replicate_state)
from .variants import apply_da_level

# the reference's defaults of the options the port refuses otherwise
_REFUSED = (
    ("profile_dir", None, "not ported (a step's device time by kernel: "
     "python -m e2enet_tpu_torch.profile_forward --train)"),)
# the modes the JAX trainer cannot train with device_augment (ROADMAP
# Queue 3), each with what goes wrong there
_DEVICE_AUGMENT_REFUSED = {
    "cascade": "its device augmentation feeds the network the data "
               "channels alone, without the previous stage's one-hot "
               "channels, and its first train step raises",
    "regions": "its device augmentation gives the region losses the "
               "labels, not the region targets, and their first train "
               "step raises",
    "ds_mode none": "it builds no device augmenter without "
                    "deep-supervision scales (TypeError at initialize)",
    "dummy_load": "its random batches carry no 'seg' for the device "
                  "augmentation (KeyError at the first train step)"}


def refuse_unported(**options) -> None:
    """Raise for the first option (by the reference trainer's name) that is
    not the reference's default, naming the ROADMAP item that ports it.
    fused and remat are refused with the reason they have no meaning here;
    an unknown name is a TypeError."""
    unknown = set(options) - {n for n, _, _ in _REFUSED} - {"fused", "remat"}
    if unknown:
        raise TypeError(f"unexpected trainer options {sorted(unknown)}")
    for name, default, item in _REFUSED:
        v = options.get(name, default)
        if v != default:
            raise NotImplementedError(f"{name}={v!r}: {item}")
    for name in ("fused", "remat"):
        if options.get(name) is not None:
            raise ValueError(
                f"{name}={options[name]!r} chooses between XLA programs of "
                f"the JAX package; the port has one path (the CUDA kernels "
                f"at bf16, the plain float32 model with fp16=False)")


@TRAINERS.register("TPUTrainer")
class Trainer:
    def __init__(self, plans: Plans, fold, output_folder: str,
                 dataset_directory: Optional[str] = None, stage: int = 0,
                 batch_dice: bool = True, tconv: str = "shiftConvPP",
                 max_num_epochs: int = 200, num_batches_per_epoch: int = 250,
                 num_val_batches_per_epoch: int = 50, unpack_data: bool = True,
                 fp16: bool = True,
                 dsff_config: Optional[dsff.DSFFConfig] = None,
                 seed: int = 0, num_da_threads: int = 1,
                 base_num_features: int = 48, initial_lr: float = 1e-2,
                 dummy_load: bool = False, loss_name: str = "dc_ce",
                 momentum: float = 0.99, optimizer: str = "sgd",
                 lr_schedule: str = "poly",
                 momentum_schedule: Optional[str] = None,
                 loss_kwargs: Optional[dict] = None,
                 loss_schedule: Optional[str] = None,
                 cascade: bool = False, da_level: Optional[str] = None,
                 regions=None, ds_mode: str = "standard",
                 validate_every: Optional[int] = None,
                 export_kwargs: Optional[dict] = None,
                 norm_op: str = "instance", nonlin: str = "lrelu",
                 num_conv_per_stage: Optional[int] = None,
                 seg_bias: bool = False, nonlin_before_norm: bool = False,
                 conv_kernel=None, device_augment: bool = False,
                 num_devices: Optional[int] = None,
                 spatial_parallel: int = 1, device="cuda", **options):
        """The reference's arguments (TPUTrainer.__init__, trainer.py:47-76)
        with `device`; cascade=True trains the 3d_cascade_fullres stage on
        the previous stage's one-hot segmentation; any of the reference's
        other options (its architecture switches, profile_dir) away from
        its default raises (refuse_unported). lr_schedule: poly | warmup |
        fixed | fixed2 | cycle | plateau; momentum_schedule: None |
        'reduce'; loss_schedule: None | 'ce_to_dice'; da_level: a level of
        training/variants.apply_da_level; regions: 'brats' or {name:
        labels}; ds_mode: 'standard' | 'none'; validate_every: epochs
        between validations without mirroring; export_kwargs:
        interpolation_order, interpolation_order_z, force_separate_z;
        norm_op, nonlin, num_conv_per_stage, seg_bias, nonlin_before_norm,
        conv_kernel: the architecture switches of build_network;
        device_augment: the training batches augmented on the device
        (ops/device_augment.py); num_devices: a process group of that many
        ranks (None or 1: this device alone), spatial_parallel of them per
        data row, each an H slab (the module's docstring)."""
        refuse_unported(**options)
        if ds_mode not in ("standard", "none"):
            raise ValueError(f"ds_mode {ds_mode!r}: 'standard' or 'none'")
        self.device = require_device(device)
        self.num_devices = num_devices or 1
        if self.num_devices > 1 and num_da_threads > 1:
            raise ValueError(
                f"num_devices={self.num_devices} with num_da_threads="
                f"{num_da_threads}: every rank must see the same seeded "
                f"batches, and only one augmentation thread gives a fixed "
                f"order (data/pipeline.py)")
        self.spatial_parallel = int(spatial_parallel or 1)
        self._ignored_spatial = None
        if self.num_devices == 1 and self.spatial_parallel > 1:
            # the JAX trainer builds no mesh on one device
            # (trainer.py:274-275): spatial_parallel has no effect
            self._ignored_spatial = self.spatial_parallel
            self.spatial_parallel = 1
        mesh.check_grid(self.num_devices, self.spatial_parallel)
        self.group = (mesh.make_grid(self.num_devices, self.spatial_parallel)
                      if self.num_devices > 1 else None)
        self.is_main = self.group is None or mesh.rank() == 0
        self.plans = plans
        self.fold = fold
        self.stage = stage
        self.tconv = tconv
        self.batch_dice = batch_dice
        self.max_num_epochs = max_num_epochs
        self.num_batches_per_epoch = num_batches_per_epoch
        self.num_val_batches_per_epoch = num_val_batches_per_epoch
        self.unpack_data = unpack_data
        self.fp16 = fp16
        self.dsff_config = dsff_config
        self.seed = seed
        self.num_da_threads = num_da_threads
        self.base_num_features = base_num_features
        self.cascade = cascade
        self.device_augment = device_augment
        self.arch = dict(norm_op=norm_op, nonlin=nonlin,
                         num_conv_per_stage=num_conv_per_stage,
                         seg_bias=seg_bias,
                         nonlin_before_norm=nonlin_before_norm,
                         conv_kernel=(tuple(int(k) for k in conv_kernel)
                                      if conv_kernel else None))

        self.output_folder_base = output_folder
        self.output_folder = join(output_folder, f"fold_{fold}")
        maybe_mkdir_p(self.output_folder)
        self.dataset_directory = dataset_directory
        self.gt_niftis_folder = (join(dataset_directory, "gt_segmentations")
                                 if dataset_directory else None)

        self.logger = (RunLogger(self.output_folder) if self.is_main
                       else RunLogger(None, also_print=False))
        self.initial_lr = initial_lr
        self.dummy_load = dummy_load
        self.loss_name = loss_name
        self.momentum = momentum
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.momentum_schedule = momentum_schedule
        self.loss_kwargs = dict(loss_kwargs) if loss_kwargs else None
        self.loss_schedule = loss_schedule
        self.da_level = da_level
        # region-based training (BraTS competition trainers): sigmoid
        # heads over label-union regions (training/regions.py)
        self.regions = None
        self.regions_class_order = None
        if regions is not None:
            self.regions = resolve_regions(regions)
            self.regions_class_order = tuple(
                range(1, len(self.regions) + 1))
        self.ds_mode = ds_mode
        self.validate_every = validate_every
        self.export_kwargs = dict(export_kwargs) if export_kwargs else None
        self.oversample_foreground_percent = 0.33
        self.train_loss_MA = None            # network_trainer.py:95-105
        self.train_loss_MA_alpha = 0.93
        self._plateau = None
        if lr_schedule == "plateau":
            self._plateau = ReduceLROnPlateau(initial_lr, factor=0.2,
                                              patience=30, threshold=1e-3)

        self.stage_plan = plans.plans_per_stage[stage]
        self.patch_size = np.array(self.stage_plan.patch_size)
        self.batch_size = int(self.stage_plan.batch_size)
        mesh.check_grid(
            self.num_devices, self.spatial_parallel, self.batch_size,
            int(self.patch_size[1]),
            int(np.prod([p[1] for p in self.stage_plan.pool_op_kernel_sizes])))
        self.num_classes = plans.num_classes + 1  # incl. background
        self.num_modalities = plans.num_modalities

        self.epoch = 0
        self.all_tr_losses = []
        self.all_val_losses = []
        self.all_val_eval_metrics = []
        self.best_val_eval_criterion_MA = None
        self.val_eval_criterion_MA = None
        self.val_eval_criterion_alpha = 0.9
        self.save_every = 50   # reference nnUNetTrainer_simple:168
        # one entry per validated case: seconds in prediction and export
        self.validation_timings = []

        self.was_initialized = False

    # ----------------------------------------------------------- setup
    def initialize(self, training: bool = True):
        if self.was_initialized:
            return
        if self.device_augment:
            for mode, on in (("cascade", self.cascade),
                             ("regions", self.regions is not None),
                             ("ds_mode none", self.ds_mode == "none"),
                             ("dummy_load", self.dummy_load)):
                if on:
                    raise ValueError(
                        f"device_augment with {mode}: the JAX trainer "
                        f"cannot train so ({_DEVICE_AUGMENT_REFUSED[mode]})")
        num_in = self.num_modalities
        if self.cascade:
            # prev-stage seg arrives as one-hot fg-class channels
            num_in += self.num_classes - 1
        # region-based trainers: one sigmoid head channel per region
        # (nnUNetTrainerV2BraTSRegions.process_plans :78-80)
        self.net_num_classes = (len(self.regions) if self.regions
                                else self.num_classes)
        self.network = build_network(
            self.stage_plan, num_in, self.net_num_classes, tconv=self.tconv,
            base_num_features=self.base_num_features,
            compute_dtype=torch.bfloat16 if self.fp16 else torch.float32,
            device=self.device, **self.arch)
        self.network.reset_parameters(self.seed)
        self.num_pool = len(self.stage_plan.pool_op_kernel_sizes)
        n_out = self.network.num_ds_outputs()
        self.ds_weights = ds_loss_weights(self.num_pool, n_out)
        self.ds_scales = deep_supervision_scales(
            self.stage_plan.pool_op_kernel_sizes, n_out)
        do_ds = self.ds_mode != "none"
        if not do_ds:
            # nnUNetTrainerV2_noDeepSupervision: the full-resolution head
            # alone, its loss unweighted
            self.ds_weights = [1.0]
            self.ds_scales = None

        self.setup_da_params()

        masks = None
        self.fired_masks = None
        if self.dsff_config is not None and self.dsff_config.sparse:
            masks = self._init_masks(self.dsff_config)
            # ITOP fired-mask bookkeeping (core_channel.py:861-876)
            self.fired_masks = {k: v.clone() for k, v in masks.items()}
            self._regrow_ratio = 1.01   # reference initial (:97)
            self.t_max = self.max_num_epochs * self.num_batches_per_epoch
        self.state = create_train_state(self.network, masks, seed=self.seed,
                                        optimizer=self.optimizer)
        if self._ignored_spatial:
            self.logger.log(f"spatial_parallel={self._ignored_spatial} on "
                            f"one device: ignored, as the JAX trainer "
                            f"builds no mesh there")
        if self.group is not None:
            replicate_state(self.state, self.group)
            dp = self.num_devices // self.spatial_parallel
            backend = torch.distributed.get_backend(self.group.world)
            grid = (f", a {dp} x {self.spatial_parallel} (data x space) "
                    f"grid" if self.spatial_parallel > 1 else "")
            self.logger.log(f"data parallel over {self.num_devices} ranks "
                            f"({backend}){grid}")
        ce_to_dice = self.loss_schedule == "ce_to_dice"
        self.train_step = make_train_step(
            self.network, self.ds_weights, self.batch_dice,
            loss_name=self.loss_name, momentum=self.momentum,
            optimizer=self.optimizer, loss_kwargs=self.loss_kwargs,
            dynamic_loss_weights=ce_to_dice,
            dynamic_momentum=self.momentum_schedule == "reduce",
            do_ds=do_ds, group=self.group)
        self.eval_step = make_eval_step(
            self.network, self.ds_weights, self.batch_dice,
            loss_name=self.loss_name, loss_kwargs=self.loss_kwargs,
            dynamic_loss_weights=ce_to_dice, do_ds=do_ds,
            regions=self.regions is not None, group=self.group)
        if masks is not None:
            cfg = self.dsff_config
            made = dsff.mask_granularity(masks, self.network)
            self.mask_granularity = (cfg.granularity
                                     if cfg.granularity != "auto" else made)
            if cfg.granularity not in ("auto", "row", made):
                raise ValueError(f"--granularity {cfg.granularity}: "
                                 f"sparse_init {cfg.sparse_init!r} makes "
                                 f"{made} masks")
            if (cfg.prune_mode == "global"
                    and self.mask_granularity != "element"):
                raise ValueError(
                    f"--prune_mode global: global prune/grow runs on "
                    f"element-granular (full-shape) masks; sparse_init "
                    f"{cfg.sparse_init!r} at granularity "
                    f"{self.mask_granularity!r} does not make them "
                    f"(uniform_ori, ERK, GMP or lottery_ticket do)")
            self.mask_update = make_mask_update_step(
                self.network, cfg.growth, prune_mode=cfg.prune_mode,
                granularity=self.mask_granularity)
            # gradient growth and the global grow read the gradient of the
            # loss on the update step's batch (the reference's weight.grad)
            self._dsff_grad_step = None
            if cfg.growth == "gradient" or cfg.prune_mode == "global":
                self._dsff_grad_step = make_grad_step(
                    self.network, self.ds_weights, self.batch_dice,
                    loss_name=self.loss_name, do_ds=do_ds, group=self.group)

        if self.device_augment:
            self.device_aug = make_device_augmenter(
                tuple(int(i) for i in self.patch_size),
                tuple(int(i) for i in self.basic_generator_patch_size),
                self.num_classes, self.ds_scales,
                do_mirror=self.da_params.do_mirror,
                do_rotation=self.da_params.do_rotation,
                do_scaling=self.da_params.do_scaling,
                do_gamma=self.da_params.do_gamma)
            # the draws (host) and the noise (device); like the JAX
            # trainer's _aug_key they are not in the checkpoints, so a
            # resumed run starts them again from the seed
            self._aug_gen = torch.Generator().manual_seed(self.seed + 7)
            self._aug_noise_gen = torch.Generator(
                device=self.device).manual_seed(self.seed + 7)

        if training:
            self._setup_generators()
        self.was_initialized = True
        self.logger.log(f"initialized Trainer Tconv={self.tconv} "
                        f"patch={[int(i) for i in self.patch_size]} "
                        f"batch={self.batch_size} classes={self.num_classes} "
                        f"device={self.device} "
                        f"{'bf16' if self.fp16 else 'float32'}")

    def _init_masks(self, cfg: dsff.DSFFConfig):
        """The initial masks of cfg.sparse_init, drawn from a generator
        seeded with seed + 1, with the reference trainer's refusals and
        note (trainer.py:231-262)."""
        mode = cfg.sparse_init
        gen = torch.Generator().manual_seed(self.seed + 1)
        if cfg.granularity == "row":
            if mode != "uniform":
                raise ValueError("row granularity supports "
                                 "sparse_init='uniform'")
            masks = dsff.init_masks_row(self.network, cfg.density, gen)
        elif mode in ("uniform", "dense"):
            # kernel-granular engine (core_channel.py)
            masks = dsff.init_masks(self.network, cfg.density, gen,
                                    mode=mode)
        elif mode in ("uniform_ori", "ERK"):
            # element-granular engine (core.py)
            masks = dsff.init_masks_element(self.network, cfg.density, gen,
                                            mode=mode)
        elif mode == "GMP":
            masks = dsff.init_masks_gmp(self.network)
        elif mode == "lottery_ticket":
            masks = dsff.init_masks_lottery(self.network, cfg.density)
        else:
            raise ValueError(
                f"sparse_init '{mode}' not supported from the trainer "
                "(uniform/dense/uniform_ori/ERK/GMP/lottery_ticket; "
                "snip and GraSP need a data batch — use "
                "dsff.init_masks_element / init_masks_grasp directly)")
        if (cfg.prune_mode == "local" and mode != "GMP"
                and cfg.final_density != cfg.density):
            self.logger.log(
                "NOTE: final_density has no effect with "
                "prune_mode='local' (the per-layer engine is density-"
                "preserving, as in the reference); use "
                "--prune_mode global for the gradual-density schedule")
        return masks

    def setup_da_params(self):
        rot = (-30.0 / 360 * 2 * np.pi, 30.0 / 360 * 2 * np.pi)
        do_dummy_2d = bool(self.stage_plan.do_dummy_2D_data_aug)
        if do_dummy_2d:
            rot_x = (-180.0 / 360 * 2 * np.pi, 180.0 / 360 * 2 * np.pi)
            basic = get_patch_size(self.patch_size[1:], rot_x,
                                   (0, 0), (0, 0), (0.7, 1.4))
            self.basic_generator_patch_size = np.array(
                [self.patch_size[0]] + list(basic))
            rot = rot_x
        else:
            self.basic_generator_patch_size = get_patch_size(
                self.patch_size, rot, rot, rot, (0.7, 1.4))
        self.da_params = AugmentParams(
            patch_size=tuple(int(i) for i in self.patch_size),
            rotation_x=rot, do_dummy_2D=do_dummy_2d,
            mask_was_used_for_normalization=self.plans.use_mask_for_norm,
            move_last_seg_channel_to_data=self.cascade,
            all_segmentation_labels=self._cascade_labels(),
            cascade_do_cascade_augmentations=self.cascade,
            deep_supervision_scales=self.ds_scales,
            regions=self._region_labels())
        if self.da_level is not None:
            apply_da_level(self.da_params, self.da_level)

    def _region_labels(self):
        """The regions' label tuples, in order, else None."""
        return tuple(self.regions.values()) if self.regions else None

    def _cascade_labels(self):
        """The foreground labels of the cascade's one-hot channels, else
        None."""
        return list(range(1, self.num_classes)) if self.cascade else None

    def _setup_generators(self):
        if self.dummy_load:
            # benchmarking trainer: random tensors, bypassing I/O + DA
            # (nnUNetTrainerV2_dummyLoad)
            self.tr_gen = self._dummy_generator()
            self.val_gen = self._dummy_generator()
            self.dataset_val = OrderedDict()
            return
        folder = join(self.dataset_directory,
                      self.plans.data_identifier + "_stage%d" % self.stage)
        self.folder_with_preprocessed_data = folder
        splits_file = join(self.dataset_directory, "splits_final.pkl")

        def unpack_and_split():
            if self.unpack_data:
                unpack_dataset(folder)
            dataset = load_dataset(folder)
            return dataset, do_split(dataset, self.fold, splits_file)
        if self.group is None or self.is_main:
            dataset, (tr_keys, val_keys) = unpack_and_split()
        if self.group is not None:
            # rank 0 writes the unpacked arrays and the split once; the
            # others read them after it (no two ranks write one file)
            mesh.barrier()
            if not self.is_main:
                dataset, (tr_keys, val_keys) = unpack_and_split()
        self.dataset_tr = OrderedDict((k, dataset[k]) for k in tr_keys)
        self.dataset_val = OrderedDict((k, dataset[k]) for k in val_keys)
        self.logger.log(f"fold {self.fold}: {len(tr_keys)} train / "
                        f"{len(val_keys)} val cases")

        if self.cascade:
            missing = [k for k in dataset
                       if not isfile(dataset[k]["data_file"][:-4]
                                     + "_segFromPrevStage.npz")]
            assert len(missing) == 0, (
                "cascade requires segFromPrevStage files for all cases; run "
                "predict_next_stage for every 3d_lowres fold first. Missing: "
                f"{missing[:5]}...")
        sampler_tr = PatchSampler3D(
            self.dataset_tr, self.basic_generator_patch_size,
            self.patch_size, self.batch_size, has_prev_stage=self.cascade,
            oversample_foreground_percent=self.oversample_foreground_percent,
            seed=self.seed)
        sampler_val = PatchSampler3D(
            self.dataset_val, self.patch_size, self.patch_size,
            self.batch_size, has_prev_stage=self.cascade,
            oversample_foreground_percent=self.oversample_foreground_percent,
            seed=self.seed + 100)
        self.tr_gen = BatchPipeline(sampler_tr, self.da_params,
                                    validation=False,
                                    num_threads=self.num_da_threads,
                                    seed=self.seed, raw=self.device_augment)
        val_params = AugmentParams(
            patch_size=tuple(int(i) for i in self.patch_size),
            mask_was_used_for_normalization=self.plans.use_mask_for_norm,
            move_last_seg_channel_to_data=self.cascade,
            all_segmentation_labels=self._cascade_labels(),
            deep_supervision_scales=self.ds_scales,
            regions=self._region_labels())
        self.val_gen = BatchPipeline(sampler_val, val_params,
                                     validation=True, num_threads=1,
                                     seed=self.seed + 1)

    def _dummy_generator(self):
        rng = np.random.RandomState(0)
        num_in = self.num_modalities + (self.num_classes - 1
                                        if self.cascade else 0)
        shape = (self.batch_size, num_in, *[int(i) for i in self.patch_size])
        factors = [[int(round(1 / s)) for s in sc] for sc in self.ds_scales]

        class _Gen:
            def __next__(gs):
                data = rng.randn(*shape).astype(np.float32)
                targets = [rng.randint(
                    0, self.num_classes,
                    (self.batch_size,
                     *[int(p) // f for p, f in zip(self.patch_size, fa)])
                    ).astype(np.int32) for fa in factors]
                return {"data": data, "target": targets}

            def stop(gs):
                pass
        return _Gen()

    # ------------------------------------------------------------ loops
    def _put(self, a):
        """An array on the device. To the card through pinned memory,
        without waiting: a copy from pageable memory would wait for the
        steps already queued."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _rows(self, data, targets, h_axis: int = 2):
        """This rank's rows of the batch and, on a grid with spatial
        parallelism, their H slab (all of it on one device); h_axis: the
        data's H (3 in the host batch (B, C, D, H, W))."""
        if self.group is None:
            return data, targets
        return mesh.shard_batch(data, targets, self.group, h_axis)

    def _to_device(self, batch):
        """The augmented batch (this rank's rows and slab) channels-last
        on the device."""
        data, targets = self._rows(batch["data"], tuple(batch["target"]),
                                   h_axis=3)
        return (self._put(np.moveaxis(data, 1, -1)),
                tuple(self._put(t) for t in targets))

    def _augment_on_device(self, batch):
        """A raw batch on the device (the segmentation's first channel as
        int8 labels, int16 past 127 classes; -1 outside the case),
        augmented there: (data channels-last, targets), this rank's rows
        of the whole batch's augmentation."""
        seg = batch["seg"][:, 0].astype(
            np.int8 if self.num_classes <= 127 else np.int16)
        return self._rows(*self.device_aug(
            self._aug_gen, self._aug_noise_gen, self._put(batch["data"]),
            self._put(seg)))

    def run_iteration(self, gen, lr, do_backprop=True,
                      run_online_evaluation=False):
        batch = next(gen)
        if do_backprop and self.device_augment:
            data, targets = self._augment_on_device(batch)
        else:
            data, targets = self._to_device(batch)
        extras = self._step_extras()
        if do_backprop:
            self.state, metrics = self.train_step(
                self.state, data, targets, lr,
                *(extras + self._momentum_extra()))
            self._maybe_dsff_step(data, targets)
            return metrics["loss"]
        m = self.eval_step(data, targets, *extras)
        if run_online_evaluation:
            self._online_tp.append(m["tp"])
            self._online_fp.append(m["fp"])
            self._online_fn.append(m["fn"])
        return m["loss"]

    def _maybe_dsff_step(self, data=None, targets=None):
        """The mask update every update_frequency steps (reference
        _maybe_dsff_step, trainer.py:484-524): the local prune, growth by
        random draws or by the gradient on this step's batch, or the global
        prune with the regrow ratio of the gradual-density schedule from
        the live counts. GMP prunes per epoch instead."""
        cfg = self.dsff_config
        if self.state.masks is None or cfg is None or cfg.fix:
            return
        if cfg.sparse_init == "GMP":
            return  # GMP prunes per epoch (_maybe_gmp_epoch_prune)
        step = int(self.state.step)
        freq = cfg.update_frequency
        if freq and step % freq == 0:
            dr = dsff.cosine_death_rate(step, cfg.death_rate, self.t_max)
            grads = None
            if self._dsff_grad_step is not None and data is not None:
                grads = self._dsff_grad_step(data, targets)
            if cfg.prune_mode == "global":
                masks = self.state.masks
                tw = float(sum(m.numel() for m in masks.values()))
                tn = float(sum(float(m.sum()) for m in masks.values()))
                self._regrow_ratio = dsff.grow_schedule_ratio(
                    step, freq, self.num_batches_per_epoch, cfg.density,
                    cfg.final_density, dr, tw, tn, tn / tw,
                    self._regrow_ratio, cfg.init_prune_epoch,
                    cfg.final_prune_epoch)
                self.state = self.mask_update(self.state, dr, grads,
                                              self._regrow_ratio)
            else:
                self.state = self.mask_update(self.state, dr, grads)
            self.fired_masks = dsff.update_fired(self.fired_masks,
                                                 self.state.masks)
            itop = dsff.fired_ratio(self.fired_masks)
            dens = masks_density(self.state.masks, self.network)
            extra = (f" regrow_ratio={self._regrow_ratio:.4f}"
                     if cfg.prune_mode == "global" else "")
            self.logger.log(f"DSFF update at step {step}: death_rate="
                            f"{dr:.4f} density={dens:.4f} "
                            f"itop_rate={itop:.4f}{extra}")

    def _maybe_gmp_epoch_prune(self):
        """GMP's prune after each epoch's train losses (reference
        trainer.py:526-547, truncate_weights_GMP of core_channel.py:
        436-467): the cubic magnitude-prune ramp toward 1 - density, no
        regrow; the parameters and the optimizer's state masked."""
        cfg = self.dsff_config
        if self.state.masks is None or cfg is None or not cfg.sparse:
            return
        if cfg.sparse_init != "GMP" or cfg.fix:
            return
        new_masks = dsff.gmp_prune_masks(
            self.network, self.state.masks, self.epoch, cfg.density,
            cfg.init_prune_epoch, cfg.final_prune_epoch, cfg.multiplier)
        self.state = apply_new_masks(self.state, new_masks)
        self.fired_masks = dsff.update_fired(self.fired_masks,
                                             self.state.masks)
        dens = masks_density(self.state.masks, self.network)
        self.logger.log(f"GMP prune at epoch {self.epoch}: "
                        f"density={dens:.4f}")

    def finish_online_evaluation(self):
        tp = np.sum([t.cpu().numpy() for t in self._online_tp], 0)
        fp = np.sum([t.cpu().numpy() for t in self._online_fp], 0)
        fn = np.sum([t.cpu().numpy() for t in self._online_fn], 0)
        dc_per_class = [2 * i / (2 * i + j + k) for i, j, k in
                        zip(tp, fp, fn) if (2 * i + j + k) > 0]
        mean_dc = float(np.mean(dc_per_class)) if dc_per_class else 0.0
        self.all_val_eval_metrics.append(mean_dc)
        self.logger.log("Average global foreground Dice:",
                        [np.round(i, 4) for i in dc_per_class])
        return mean_dc

    def _step_extras(self):
        """The epoch's (weight_ce, weight_dice) of the CE -> Dice
        transition, else ()."""
        if self.loss_schedule != "ce_to_dice":
            return ()
        return ce_to_dice_weights(self.epoch, self.max_num_epochs)

    def _momentum_extra(self):
        """The epoch's momentum of the momentum reduction, else ()."""
        if self.momentum_schedule != "reduce":
            return ()
        return (reduce_momentum(self.epoch, self.momentum),)

    def maybe_update_lr(self, epoch=None):
        """The epoch's learning rate by lr_schedule (reference
        trainer.py:575-598); 'plateau' reads the scheduler, which
        update_train_loss_MA steps."""
        ep = self.epoch + 1 if epoch is None else epoch
        if self.lr_schedule == "plateau":
            self.lr = self._plateau.lr
        elif self.lr_schedule == "warmup":
            self.lr = warmup_poly_lr(ep, self.max_num_epochs,
                                     self.initial_lr)
        elif self.lr_schedule == "fixed":
            self.lr = fixed_schedule_lr(ep, self.initial_lr)
        elif self.lr_schedule == "fixed2":
            self.lr = fixed_schedule2_lr(ep, self.max_num_epochs,
                                         self.initial_lr)
        elif self.lr_schedule == "cycle":
            self.lr = cycle_at_end_lr(ep, self.initial_lr)
        else:
            self.lr = poly_lr(ep, self.max_num_epochs, self.initial_lr, 0.9)
        self.logger.log("lr:", np.round(self.lr, decimals=6))

    def update_train_loss_MA(self):
        """network_trainer.update_train_loss_MA (:626-631); steps the
        plateau scheduler on it."""
        if self.train_loss_MA is None:
            self.train_loss_MA = self.all_tr_losses[-1]
        else:
            a = self.train_loss_MA_alpha
            self.train_loss_MA = (a * self.train_loss_MA
                                  + (1 - a) * self.all_tr_losses[-1])
        if self._plateau is not None:
            self._plateau.step(self.train_loss_MA)

    @staticmethod
    def _epoch_mean(losses) -> float:
        """The mean of an epoch's per-iteration losses, read from the
        device once, averaged as the reference does (numpy, float32)."""
        return float(np.mean(torch.stack(losses).cpu().numpy()))

    def run_training(self):
        if not self.was_initialized:
            self.initialize(True)
        self.save_debug_information()
        while self.epoch < self.max_num_epochs:
            t0 = time.time()
            self.logger.log(f"\nepoch: {self.epoch}")
            self.maybe_update_lr(self.epoch)

            losses = []
            for _ in range(self.num_batches_per_epoch):
                losses.append(self.run_iteration(self.tr_gen, self.lr, True))
            tr_loss = self._epoch_mean(losses)
            self.all_tr_losses.append(tr_loss)
            self.logger.log("train loss : %.4f" % tr_loss)
            self.update_train_loss_MA()
            self._maybe_gmp_epoch_prune()

            self._online_tp, self._online_fp, self._online_fn = [], [], []
            val_losses = []
            for _ in range(self.num_val_batches_per_epoch):
                val_losses.append(self.run_iteration(
                    self.val_gen, self.lr, False, True))
            val_loss = self._epoch_mean(val_losses)
            self.all_val_losses.append(val_loss)
            self.logger.log("validation loss: %.4f" % val_loss)
            self.finish_online_evaluation()

            self.update_eval_criterion_MA()
            self.epoch += 1
            self.logger.log("This epoch took %f s" % (time.time() - t0))

            if (self.validate_every
                    and self.epoch % self.validate_every == 0
                    and not self.dummy_load):
                # nnUNetTrainerV2_fullEvals: a validation every epoch
                self.validate(
                    do_mirroring=False,
                    validation_folder_name=f"validation_ep{self.epoch:03d}",
                    run_postprocessing_on_folds=False)
            if self.save_every and (self.epoch % self.save_every == 0):
                self.save_checkpoint("latest")
            if (self.best_val_eval_criterion_MA is None
                    or self.val_eval_criterion_MA
                    >= self.best_val_eval_criterion_MA):
                self.best_val_eval_criterion_MA = self.val_eval_criterion_MA
                self.save_checkpoint("best")
            self.plot_progress()
        self.save_checkpoint("final_checkpoint")
        self.tr_gen.stop()
        self.val_gen.stop()

    def update_eval_criterion_MA(self):
        v = self.all_val_eval_metrics[-1] if self.all_val_eval_metrics \
            else -self.all_val_losses[-1]
        if self.val_eval_criterion_MA is None:
            self.val_eval_criterion_MA = v
        else:
            a = self.val_eval_criterion_alpha
            self.val_eval_criterion_MA = a * self.val_eval_criterion_MA \
                + (1 - a) * v

    # ------------------------------------------------------- persistence
    def checkpoint_path(self, which: str) -> str:
        return join(self.output_folder, f"{self.tconv}_model_{which}.model")

    def save_checkpoint(self, which: str):
        """Rank 0 writes the checkpoint (the other ranks hold the same
        state)."""
        if not self.is_main:
            return
        sidecar = {
            "init": {"fold": self.fold, "stage": self.stage,
                     "tconv": self.tconv, "batch_dice": self.batch_dice,
                     "base_num_features": self.base_num_features,
                     "cascade": self.cascade,
                     **{k: v for k, v in self.arch.items()
                        if v != ARCH_DEFAULTS[k]}},
            "name": "TPUTrainer",
            "class": f"{self.__class__.__module__}."
                     f"{self.__class__.__name__}",
            "plans": self.plans.to_dict(),
        }
        metadata = {
            "all_tr_losses": self.all_tr_losses,
            "all_val_losses": self.all_val_losses,
            "all_val_eval_metrics": self.all_val_eval_metrics,
            "best_val_eval_criterion_MA": self.best_val_eval_criterion_MA,
            "val_eval_criterion_MA": self.val_eval_criterion_MA,
        }
        if self.fired_masks is not None:
            # '/'-joined flax paths, element masks in the flax layout, as
            # the reference's trainer writes them
            metadata["fired_masks"] = masks_to_flax(self.fired_masks, "/")
        save_train_state(self.checkpoint_path(which), self.state, self.epoch,
                         metadata, sidecar)
        self.logger.log(f"saved checkpoint {which}")

    def load_checkpoint_file(self, which_or_path: str, train: bool = True):
        path = which_or_path if os.path.sep in which_or_path \
            else self.checkpoint_path(which_or_path)
        if not self.was_initialized:
            self.initialize(train)
        epoch, metadata = load_train_state(path, self.state, self.network)
        self.epoch = epoch
        self.all_tr_losses = metadata.get("all_tr_losses", [])
        self.all_val_losses = metadata.get("all_val_losses", [])
        self.all_val_eval_metrics = metadata.get("all_val_eval_metrics", [])
        self.best_val_eval_criterion_MA = metadata.get(
            "best_val_eval_criterion_MA")
        self.val_eval_criterion_MA = metadata.get("val_eval_criterion_MA")
        dev = self.device
        if metadata.get("fired_masks") is not None:
            self.fired_masks = {n: torch.from_numpy(m).to(dev) for n, m in
                                masks_for_model(
                                    metadata["fired_masks"], self.network,
                                    f"the fired masks of {path}",
                                    sep="/").items()}
        elif self.state.masks is not None:
            self.fired_masks = {k: v.clone()
                                for k, v in self.state.masks.items()}
        self.logger.log(f"restored checkpoint {path} at epoch {epoch}")

    def plot_progress(self):
        if not self.is_main:
            return
        try:
            import matplotlib
            matplotlib.use("agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(10, 6))
            x = list(range(len(self.all_tr_losses)))
            ax.plot(x, self.all_tr_losses, label="loss_tr")
            ax.plot(x, self.all_val_losses, label="loss_val")
            if self.all_val_eval_metrics:
                ax2 = ax.twinx()
                ax2.plot(x, self.all_val_eval_metrics, color="g",
                         label="evaluation metric")
                ax2.set_ylabel("evaluation metric")
            ax.set_xlabel("epoch")
            ax.set_ylabel("loss")
            ax.legend()
            fig.savefig(join(self.output_folder, "progress.png"))
            plt.close(fig)
        except Exception as e:  # noqa: BLE001 - no matplotlib: log, go on
            self.logger.log("failed to plot:", e)

    # ----------------------------------------------------- validation set
    def validate(self, *args, **kwargs):
        """Sliding-window predict every val case -> export -> evaluate ->
        determine postprocessing. Parity: nnUNetTrainer_simple.validate
        (:1309-1479). The region trainers: sigmoid probabilities, labels
        by regions_class_order, evaluate_regions' summary.csv and no
        postprocessing (nnUNetTrainerV2BraTSRegions.validate :160-166).
        Each case's seconds in prediction and export go to
        self.validation_timings. Arguments: _validate's. Data parallel:
        rank 0 validates on its device, as the JAX trainer validates on
        one, while the other ranks wait at a barrier."""
        if self.is_main:
            self._validate(*args, **kwargs)
        if self.group is not None:
            mesh.barrier()

    def _validate(self, do_mirroring: bool = True, step_size: float = 0.5,
                  save_softmax: bool = False,
                  validation_folder_name: str = "validation_raw",
                  run_postprocessing_on_folds: bool = True):
        from ..evaluation.evaluator import aggregate_scores
        from ..inference.export import save_segmentation_nifti_from_softmax
        from ..ops.sliding import predict_volume_tiled
        from ..postprocessing.connected_components import \
            determine_postprocessing

        assert self.was_initialized
        if self.dummy_load:
            self.logger.log("dummy_load trainer: skipping validation")
            return
        if not hasattr(self, "dataset_val"):
            folder = join(self.dataset_directory,
                          self.plans.data_identifier
                          + "_stage%d" % self.stage)
            dataset = load_dataset(folder)
            splits_file = join(self.dataset_directory, "splits_final.pkl")
            _, val_keys = do_split(dataset, self.fold, splits_file)
            self.dataset_val = OrderedDict((k, dataset[k])
                                           for k in val_keys)
        output_folder = join(self.output_folder, validation_folder_name)
        maybe_mkdir_p(output_folder)

        net = self.network
        patch = tuple(int(i) for i in self.patch_size)
        # flip-free TTA where the network has mirrored operators, data
        # flips otherwise (resenc, full 3D kernels)
        fns = (mirror_apply_fns_for(net)
               if do_mirroring and net.mirrored_operators() else None)
        pred_gt_tuples = []
        for k in self.dataset_val.keys():
            props = load_pickle(self.dataset_val[k]["properties_file"])
            fname = props["list_of_data_files"][0].split(os.sep)[-1][:-12]
            data = np.asarray(load_case(self.dataset_val[k]))[:-1]
            if self.cascade:
                prev = np.load(self.dataset_val[k]["data_file"][:-4]
                               + "_segFromPrevStage.npz")["data"]
                data = move_seg_as_onehot_to_data(
                    data[None], prev[None], self._cascade_labels())[0]
            t0 = time.perf_counter()
            with torch.no_grad():
                softmax = predict_volume_tiled(
                    lambda x: net(x, do_ds=False), data, patch,
                    self.net_num_classes, device=self.device,
                    step_size=step_size, do_mirroring=do_mirroring,
                    mirror_apply_fns=fns,
                    nonlin="sigmoid" if self.regions else "softmax")
            t1 = time.perf_counter()
            transpose_backward = self.plans.transpose_backward
            softmax = softmax.transpose(
                [0] + [int(i) + 1 for i in transpose_backward])
            softmax_fname = (join(output_folder, fname + ".npz")
                             if save_softmax else None)
            ek = self.export_kwargs or {}
            save_segmentation_nifti_from_softmax(
                softmax, join(output_folder, fname + ".nii.gz"), props,
                ek.get("interpolation_order", 1), self.regions_class_order,
                None, None, softmax_fname, None,
                force_separate_z=ek.get("force_separate_z", None),
                interpolation_order_z=ek.get("interpolation_order_z", 0))
            self.validation_timings.append(
                {"case": fname, "predict_s": t1 - t0,
                 "export_s": time.perf_counter() - t1})
            pred_gt_tuples.append(
                [join(output_folder, fname + ".nii.gz"),
                 join(self.gt_niftis_folder, fname + ".nii.gz")])

        if self.regions:
            from ..evaluation.region_based_evaluation import \
                evaluate_regions
            evaluate_regions(output_folder, self.gt_niftis_folder,
                             self.regions)
            self.logger.log("validation (regions) done ->", output_folder)
            return
        aggregate_scores(
            pred_gt_tuples, labels=list(range(self.num_classes)),
            json_output_file=join(output_folder, "summary.json"),
            json_name=f"{self.tconv} fold {self.fold}",
            num_threads=2)

        if run_postprocessing_on_folds:
            determine_postprocessing(self.output_folder,
                                     self.gt_niftis_folder,
                                     validation_folder_name,
                                     final_subf_name=validation_folder_name
                                     + "_postprocessed")
        self.logger.log("validation done ->", output_folder)

    def save_debug_information(self):
        if not self.is_main:
            return
        dct = {}
        for k, v in self.__dict__.items():
            if k in ("plans", "state", "network", "logger", "tr_gen",
                     "val_gen", "dataset_tr", "dataset_val", "train_step",
                     "eval_step", "mask_update", "da_params",
                     "_dsff_grad_step", "_plateau", "device_aug",
                     "_aug_gen", "_aug_noise_gen"):
                continue
            try:
                json.dumps(v)
                dct[k] = v
            except TypeError:
                dct[k] = str(v)
        save_json(dct, join(self.output_folder, "debug.json"))
