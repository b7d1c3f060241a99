"""Named trainer variants: the reference's ablation-trainer zoo as
configuration presets, the port of e2enet_tpu/training/variants.py
(VARIANTS, apply_da_level and resolve_variant).

Reference training/network_training/nnUNet_variants/ (~60 subclasses):
each reference variant subclasses nnUNetTrainerV2 and overrides one knob
(loss, optimizer, DA level, momentum, epochs...). Here they are
declarative presets that the train CLI's -tr maps onto the trainer's
arguments (cli/train.variant_kwargs); the same names resolve as in the
JAX package. The trainer applies a preset's augmentation level (`da`) to
its AugmentParams with apply_da_level. A preset whose knob the port does
not train (an architecture switch) raises in the trainer, naming its
ROADMAP item (training/trainer.refuse_unported).
"""
from typing import Any, Dict

VARIANTS: Dict[str, Dict[str, Any]] = {
    # --- default
    "TPUTrainer": {},
    "nnUNetTrainerV2": {},
    # --- benchmarking (expected_epoch_times.md methodology)
    "nnUNetTrainerV2_2epochs": {"max_num_epochs": 2},
    "nnUNetTrainerV2_5epochs": {"max_num_epochs": 5},
    "nnUNetTrainerV2_dummyLoad": {"dummy_load": True},
    # --- losses (nnUNet_variants/loss_function/*)
    "nnUNetTrainerV2_Loss_DiceTopK10": {"loss": "dc_topk"},
    "nnUNetTrainerV2_Loss_Dice": {"loss": "dice"},
    "nnUNetTrainerV2_Loss_CE": {"loss": "ce"},
    "nnUNetTrainerV2_focalLoss": {"loss": "focal"},
    "nnUNetTrainerV2_Loss_GDL": {"loss": "gdl"},
    # --- optimizer / momentum (nnUNet_variants/optimizer_and_lr/*)
    "nnUNetTrainerV2_Ranger_lr3en4": {"optimizer": "ranger",
                                      "initial_lr": 3e-4},
    "nnUNetTrainerV2_Ranger_lr3en3": {"optimizer": "ranger",
                                      "initial_lr": 3e-3},
    "nnUNetTrainerV2_Ranger_lr1en2": {"optimizer": "ranger",
                                      "initial_lr": 1e-2},
    "nnUNetTrainerV2_Adam": {"optimizer": "adam"},
    "nnUNetTrainerV2_Adam_lr_3en4": {"optimizer": "adam",
                                     "initial_lr": 3e-4},
    "nnUNetTrainerV2_momentum09": {"momentum": 0.9},
    "nnUNetTrainerV2_momentum095": {"momentum": 0.95},
    "nnUNetTrainerV2_momentum098": {"momentum": 0.98},
    "nnUNetTrainerV2_SGD_lr1en1": {"initial_lr": 1e-1},
    "nnUNetTrainerV2_SGD_lr1en3": {"initial_lr": 1e-3},
    # --- data augmentation levels (nnUNet_variants/data_augmentation/*)
    "nnUNetTrainerV2_noDA": {"da": "none"},
    "nnUNetTrainerV2_noMirroring": {"da": "no_mirror"},
    "nnUNetTrainerV2_insaneDA": {"da": "insane"},
    "nnUNetTrainerV2_DA2": {"da": "da2"},
    # --- precision
    "nnUNetTrainerV2_fp32": {"fp16": False},
    # --- cascade
    "nnUNetTrainerV2_CascadeFullRes": {"cascade": True},
    # --- losses (cont.)
    "nnUNetTrainerV2_Loss_MCC": {"loss": "mcc"},
    "nnUNetTrainerV2_Loss_MCCnoBG": {"loss": "mcc"},
    # --- architectural variants (nnUNet_variants/architectural_variants/*:
    # norm_op/nonlin knobs on the network)
    "nnUNetTrainerV2_BN": {"norm_op": "batch"},
    "nnUNetTrainerV2_GN": {"norm_op": "group"},
    "nnUNetTrainerV2_FRN": {"norm_op": "frn"},
    "nnUNetTrainerV2_NoNormalization": {"norm_op": "none"},
    "nnUNetTrainerV2_ReLU": {"nonlin": "relu"},
    "nnUNetTrainerV2_GeLU": {"nonlin": "gelu"},
    "nnUNetTrainerV2_Mish": {"nonlin": "mish"},
    "nnUNetTrainerV2_BN_ReLU": {"norm_op": "batch", "nonlin": "relu"},
    "nnUNetTrainerV2_FRN_LReLU": {"norm_op": "frn"},
    "nnUNetTrainerV2_NoNormalization_lr1en3": {"norm_op": "none",
                                               "initial_lr": 1e-3},
    # nnUNetTrainerV2_LReLU_slope_2en1.py (negative_slope 0.2)
    "nnUNetTrainerV2_LReLU_slope_2en1": {"nonlin": "lrelu2e1"},
    # *_biasInSegOutput.py (seg_output_use_bias=True)
    "nnUNetTrainerV2_ReLU_biasInSegOutput": {"nonlin": "relu",
                                             "seg_bias": True},
    "nnUNetTrainerV2_lReLU_biasInSegOutput": {"seg_bias": True},
    # *_convReLUIN.py (ConvDropoutNonlinNorm block order)
    "nnUNetTrainerV2_ReLU_convReLUIN": {"nonlin": "relu",
                                        "nonlin_before_norm": True},
    "nnUNetTrainerV2_lReLU_convlReLUIN": {"nonlin_before_norm": True},
    # nnUNetTrainerV2_3ConvPerStage.py (conv_per_stage 3, base features 24
    # "otherwise we run out of VRAM"); _samefilters keeps the base count
    "nnUNetTrainerV2_3ConvPerStage": {"num_conv_per_stage": 3,
                                      "base_num_features": 24},
    "nnUNetTrainerV2_3ConvPerStageSameFilters": {"num_conv_per_stage": 3},
    # nnUNetTrainerV2_allConv3x3.py:44-46 (all kernels (3,3,3); the depth
    # shift auto-disables — torch_shift applies iff (1,3,3))
    "nnUNetTrainerV2_allConv3x3": {"conv_kernel": (3, 3, 3)},
    # residual-encoder UNet variants (models/resenc.py, FabiansUNet;
    # base 24 per default_base_num_features)
    "nnUNetTrainerV2_ResencUNet": {"tconv": "resenc",
                                   "base_num_features": 24},
    "nnUNetTrainerV2_ResencUNet_DA3": {"tconv": "resenc",
                                       "base_num_features": 24,
                                       "da": "da3"},
    "nnUNetTrainerV2_ResencUNet_DA3_BN": {"tconv": "resenc",
                                          "base_num_features": 24,
                                          "da": "da3",
                                          "norm_op": "batch"},
    # nnUNetTrainerV2_softDeepSupervision is DEAD in the reference: its
    # MyDSLoss4 comes from an external 'meddec' project and the trainer
    # raises "This aint ready for prime time yet" without it
    # (architectural_variants/nnUNetTrainerV2_softDeepSupervision.py:18-23,
    # :74-75) — excluded, matching the SURVEY dead-code policy.
    # --- optimizer / lr schedules (nnUNet_variants/optimizer_and_lr/*,
    # schedules in training/lr.py)
    "nnUNetTrainerV2_warmup": {"lr_schedule": "warmup",
                               "max_num_epochs": 1050},
    "nnUNetTrainerV2_SGD_fixedSchedule": {"lr_schedule": "fixed"},
    "nnUNetTrainerV2_SGD_fixedSchedule2": {"lr_schedule": "fixed2"},
    "nnUNetTrainerV2_cycleAtEnd": {"lr_schedule": "cycle",
                                   "max_num_epochs": 1100},
    "nnUNetTrainerV2_SGD_ReduceOnPlateau": {"lr_schedule": "plateau"},
    "nnUNetTrainerV2_Adam_ReduceOnPlateau": {"optimizer": "adam",
                                             "lr_schedule": "plateau"},
    "nnUNetTrainerV2_reduceMomentumDuringTraining": {
        "momentum_schedule": "reduce"},
    # momentum 0.9 in 2D, 0.99 in 3D (applied by the 2D pipeline; the 3D
    # run is the plain trainer)
    "nnUNetTrainerV2_momentum09in2D": {"momentum": 0.9},
    "nnUNetTrainerV2_fp16": {"fp16": True},
    # --- losses (nnUNet_variants/loss_function/*, cont.)
    "nnUNetTrainerV2_Loss_CEGDL": {"loss": "gdl_ce"},
    "nnUNetTrainerV2_Loss_DiceCE_noSmooth": {"loss": "dc_ce",
                                             "loss_kwargs": {"smooth": 0.0}},
    "nnUNetTrainerV2_Loss_Dice_squared": {"loss": "dice_squared",
                                          "initial_lr": 1e-3,
                                          "loss_kwargs": {"smooth": 1e-5}},
    "nnUNetTrainerV2_Loss_TopK10": {"loss": "topk"},
    "nnUNetTrainerV2_Loss_Dice_LR1en3": {"loss": "dice",
                                         "initial_lr": 1e-3},
    "nnUNetTrainerV2_graduallyTransitionFromCEToDice": {
        "loss_schedule": "ce_to_dice"},
    # ForceBD/ForceSD (loss_function/nnUNetTrainerV2_Force{B,S}D.py):
    # batch dice forced on/off regardless of the plan
    "nnUNetTrainerV2_ForceBD": {"batch_dice": True},
    "nnUNetTrainerV2_ForceSD": {"batch_dice": False},
    # --- data augmentation (cont.)
    "nnUNetTrainerV2_DA3": {"da": "da3"},
    "nnUNetTrainerV2_DA5": {"da": "da5"},
    "nnUNetTrainerV2_independentScalePerAxis": {"da": "independent_scale"},
    "nnUNetTrainerV2_noDeepSupervision": {"ds_mode": "none"},
    # --- cascade ablations (nnUNet_variants/cascade/*)
    "nnUNetTrainerV2CascadeFullRes_lowerLR": {"cascade": True,
                                              "initial_lr": 1e-3},
    "nnUNetTrainerV2CascadeFullRes_shorter": {"cascade": True,
                                              "max_num_epochs": 500},
    "nnUNetTrainerV2CascadeFullRes_shorter_lowerLR": {
        "cascade": True, "max_num_epochs": 500, "initial_lr": 1e-3},
    "nnUNetTrainerV2CascadeFullRes_noConnComp": {"cascade": True,
                                                 "da": "cascade_noconncomp"},
    "nnUNetTrainerV2CascadeFullRes_smallerBinStrel": {
        "cascade": True, "da": "cascade_smallstrel"},
    "nnUNetTrainerV2CascadeFullRes_EducatedGuess": {"cascade": True,
                                                    "da": "cascade_eg"},
    "nnUNetTrainerV2CascadeFullRes_EducatedGuess2": {"cascade": True,
                                                     "da": "cascade_eg2"},
    "nnUNetTrainerV2CascadeFullRes_EducatedGuess3": {"cascade": True,
                                                     "da": "cascade_eg3"},
    # --- older-generation trainers (nnUNet_variants root)
    "nnUNetTrainerCE": {"loss": "ce"},
    "nnUNetTrainerNoDA": {"da": "none"},
    # --- copies (nnUNet_variants/copies/nnUNetTrainerV2_copies.py — used
    # by the reference for seeding experiments; byte-identical trainers)
    "nnUNetTrainerV2_copy1": {},
    "nnUNetTrainerV2_copy2": {},
    "nnUNetTrainerV2_copy3": {},
    "nnUNetTrainerV2_copy4": {},
    "nnUNetTrainerV2_Loss_TopK10_copy1": {"loss": "topk"},
    "nnUNetTrainerV2_Loss_TopK10_copy2": {"loss": "topk"},
    "nnUNetTrainerV2_Loss_TopK10_copy3": {"loss": "topk"},
    "nnUNetTrainerV2_Loss_TopK10_copy4": {"loss": "topk"},
    # --- competitions (competitions_with_custom_Trainers/)
    # BraTS2020: region-based training (sigmoid heads over WT/TC/ET
    # label sets, DC+BCE) — see training/regions.py
    "nnUNetTrainerV2BraTSRegions": {"regions": "brats",
                                    "loss": "dc_bce",
                                    "loss_kwargs": {"smooth": 0.0},
                                    "batch_dice": False},
    "nnUNetTrainerV2BraTSRegions_Dice": {"regions": "brats",
                                         "loss": "dice_regions",
                                         "batch_dice": False},
    "nnUNetTrainerV2BraTSRegions_moreDA": {"regions": "brats",
                                           "loss": "dc_bce",
                                           "loss_kwargs": {"smooth": 0.0},
                                           "batch_dice": False,
                                           "da": "insane"},
    "nnUNetTrainerV2BraTSRegions_BN": {"regions": "brats",
                                       "loss": "dc_bce",
                                       "loss_kwargs": {"smooth": 0.0},
                                       "batch_dice": False,
                                       "norm_op": "batch"},
    # MMS (cardiac MRI): BatchNorm network + insane DA + momentum 0.9
    # (nnUNetTrainerV2_MMS.py)
    "nnUNetTrainerV2_MMS": {"norm_op": "batch", "da": "insane",
                            "momentum": 0.9},
    # miscellaneous/nnUNetTrainerV2_fullEvals.py: validate every epoch
    # (BraTS-regions evaluation); mapped to per-epoch validation
    "nnUNetTrainerV2_fullEvals": {"regions": "brats", "loss": "dc_bce",
                                  "loss_kwargs": {"smooth": 0.0},
                                  "batch_dice": False,
                                  "validate_every": 1},
    # resampling/nnUNetTrainerV2_resample33.py: validation/export with
    # interpolation order 3 in-plane AND order 3 across z
    "nnUNetTrainerV2_resample33": {"export_kwargs": {
        "interpolation_order": 3, "interpolation_order_z": 3,
        "force_separate_z": None}},
}


def apply_da_level(da_params, level: str):
    """Mutate AugmentParams according to the named DA level (reference
    variants.py:206-263)."""
    if level == "none":
        da_params.do_rotation = False
        da_params.do_scaling = False
        da_params.do_mirror = False
        da_params.do_gamma = False
    elif level == "no_mirror":
        da_params.do_mirror = False
    elif level == "insane":
        da_params.p_rot = 0.7
        da_params.p_scale = 0.7
        da_params.scale_range = (0.5, 1.6)
    elif level == "da2":
        da_params.scale_range = (0.65, 1.6)
    elif level in ("da3", "da5"):
        # nnUNetTrainerV2_DA3.py:72-90; DA5 extends it with an elastic
        # deformation, which the reference leaves out too (its affine,
        # brightness and gamma parts are here)
        da_params.p_rot = 0.3
        da_params.scale_range = (0.65, 1.6)
        da_params.p_scale = 0.3
        da_params.independent_scale_per_axis = True
        da_params.p_independent_scale_per_axis = 0.3
        da_params.do_additive_brightness = True
        da_params.additive_brightness_mu = 0.0
        da_params.additive_brightness_sigma = 0.2
        da_params.additive_brightness_p_per_sample = 0.3
        da_params.additive_brightness_p_per_channel = 1.0
        if level == "da5":
            da_params.gamma_range = (0.5, 1.6)
    elif level == "independent_scale":
        # nnUNetTrainerV2_independentScalePerAxis.py:22
        da_params.independent_scale_per_axis = True
    elif level.startswith("cascade_"):
        # nnUNetTrainerV2CascadeFullRes_DAVariants.py:19-87
        da_params.cascade_do_cascade_augmentations = True
        knobs = {
            "cascade_noconncomp": (0.4, 1.0, (1, 8), 0.0, 0.15),
            "cascade_smallstrel": (0.4, 1.0, (1, 5), 0.2, 0.15),
            "cascade_eg": (0.5, 0.5, (1, 5), 0.2, 0.10),
            "cascade_eg2": (0.5, 0.5, (1, 5), 0.0, 0.10),
            "cascade_eg3": (1.0, 0.33, (1, 5), 0.0, 0.10),
        }[level]
        (da_params.cascade_random_binary_transform_p,
         da_params.cascade_random_binary_transform_p_per_label,
         da_params.cascade_random_binary_transform_size,
         da_params.cascade_remove_conn_comp_p,
         da_params.cascade_remove_conn_comp_max_size_percent_threshold) = \
            knobs
    return da_params


def resolve_variant(name: str) -> Dict[str, Any]:
    if name not in VARIANTS:
        raise KeyError(f"unknown trainer variant '{name}'; known: "
                       f"{sorted(VARIANTS)}")
    return dict(VARIANTS[name])
