"""PyTorch/CUDA port of e2enet_tpu's ShiftUNet++ sliding-window inference
and its DSFF training, for NVIDIA Hopper.

The JAX package `e2enet_tpu` is the reference; this package imports torch
and never jax. It computes channels-last (N, D, H, W, C) throughout, with
no quadrant or padded layout. The reference's TPU kernels on the serving
and training paths are hand-written CUDA kernels here (`csrc/`, bound in
`ops/_native.py`): the fused shift-conv block and its backward
(`ops/fused_block.py`), the lazy up-link block (`ops/qfused.py`), the
strided transition (`ops/qstride.py`), and the level links, the down-link's
backward and the seg head (`ops/qlink.py`); everything else is plain torch.

Users' entry points: folder prediction (`python -m
e2enet_tpu_torch.cli.predict`, `inference/predictor.py`) on checkpoints in
the JAX package's format (`training/checkpoint.py`); training (`python -m
e2enet_tpu_torch.cli.train`, `training/trainer.py`, with its data pipeline
in `data/` and the augmentation's C++ warp in `native/`) on a preprocessed
task in the JAX package's format, writing checkpoints both packages load;
`python -m e2enet_tpu_torch.cli.evaluate`; the bench (`python -m
e2enet_tpu_torch.bench`); and planning and preprocessing a raw task for
training (`python -m e2enet_tpu_torch.cli.plan_and_preprocess`,
`planning/`), with every dataset converter of the JAX package in
`dataset_conversion/` (NIfTI, MetaImage, NRRD, DICOM, PNG/TIFF and HDF5
sources, RAS reorientation in `preprocessing/reorientation.py`), overlay
PNGs (`utils/overlay_plots.py`), and trained folds packed into and
installed from a zip (`inference/pretrained_models.py`). The
port keeps its own copies of the host modules it needs (`plans.py`,
`paths.py`, `io/`, `preprocessing/`, `planning/`, `models/vram.py`,
`inference/export.py`, `postprocessing/`, `evaluation/`, `data/`,
`utils/`). Each entry point that computes on the card runs there and takes
`--device cpu` (or `device="cpu"`) to run the plain versions here; the
plan CLI and the evaluation are host work and need no card. Training and
prediction take `--num_devices N`: N ranks of a torch.distributed process
group, data parallel (`parallel/`: NCCL on the cards, gloo on the CPU).
"""
