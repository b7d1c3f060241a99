"""PyTorch/CUDA port of e2enet_tpu's dense ShiftUNet++ sliding-window
inference for NVIDIA Hopper.

The JAX package `e2enet_tpu` is the reference; this package imports torch
and never jax. It computes channels-last (N, D, H, W, C) throughout, with
no quadrant or padded layout. The reference's TPU kernels on the serving
path are hand-written CUDA kernels here (`csrc/`, bound in `ops/_native.py`):
the fused shift-conv block (`ops/fused_block.py`), the strided transition
(`ops/qstride.py`), and the level links and seg head (`ops/qlink.py`);
everything else is plain torch.
"""
