"""PyTorch/CUDA port of e2enet_tpu's dense ShiftUNet++ sliding-window
inference for NVIDIA Hopper.

The JAX package `e2enet_tpu` is the reference; this package imports torch
and never jax. Layout at the public edges follows the reference
(channels-last (N, D, H, W, C) activations). The stride-1 (1,3,3) shift-conv
blocks of levels 0 and 1 run through a hand-written CUDA kernel
(`csrc/fused_block.cu`, see `ops/fused_block.py`); everything else is plain
torch.
"""
