"""ShiftUNet in torch, channels-last (N, D, H, W, C): the counterpart of
e2enet_tpu/models/unet.py, the classic nnU-Net U-Net with depth-shifted
(1,3,3) convs.

Covers Tconv 'ori' (the reference's Generic_UNet with shift groups of 3)
and 'shiftConvPP_nodff' (UNet++ without the nest: this plain decoder, shift
groups of 5). Encoder stacks `context{d}` (the first conv of each strided
by the previous pool), the bottleneck `context{P}a` / `context{P}b`; decoder
stage u (level P-1-u) is `up_{u}` (k == s transposed conv), the concat with
the skip, `loc_{u}` and `loc_{u}_final`, and its head `seg_head{u}`. Deep
supervision returns num_pool outputs, full resolution first.

Every block is plain torch (ops/blocks.ShiftConvBlock): the reference runs
this network on its XLA path, never on its kernels, so it launches no
kernel (kernel_route() is False). forward(x, do_ds, flips) computes the
mirrored network flip_c(net(flip_c(x))) with the same parameters, for
flip-free TTA.
"""
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.blocks import SegHead, StackedConvBlocks, TranspConv
from ..ops.fused_block import NO_FLIPS, Flips
from .unetpp import MAX_NUM_FILTERS_3D, encoder_channels


class ShiftUNet(nn.Module):
    """forward(x (N, D, H, W, Cin), do_ds, flips) -> float32 logits
    (N, D, H, W, K), or the list of deep-supervision logits (finest first)
    when do_ds."""

    def __init__(self, input_channels: int, num_classes: int,
                 pool_op_kernel_sizes: Sequence[Tuple[int, int, int]],
                 base_num_features: int = 48,
                 max_num_features: int = MAX_NUM_FILTERS_3D,
                 num_conv_per_stage: int = 2, shift_size: int = 3,
                 do_shift: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 norm_op: str = "instance", nonlin: str = "lrelu",
                 nonlin_before_norm: bool = False, seg_bias: bool = False,
                 device=None):
        super().__init__()
        if device is None:
            raise ValueError("pass the device explicitly")
        self.pools = [tuple(int(k) for k in p) for p in pool_op_kernel_sizes]
        P = self.num_pool = len(self.pools)
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        enc = self.enc = encoder_channels(base_num_features, P,
                                          max_num_features)
        kw = dict(compute_dtype=compute_dtype, do_shift=do_shift,
                  device=device, shift_size=shift_size, norm_op=norm_op,
                  nonlin=nonlin, nonlin_before_norm=nonlin_before_norm)
        n = num_conv_per_stage
        for d in range(P):
            self.add_module(f"context{d}", StackedConvBlocks(
                input_channels if d == 0 else enc[d - 1], enc[d], n,
                first_stride=self.pools[d - 1] if d > 0 else (1, 1, 1),
                **kw))
        self.add_module(f"context{P}a", StackedConvBlocks(
            enc[P - 1], enc[P], n - 1, first_stride=self.pools[P - 1], **kw))
        self.add_module(f"context{P}b", StackedConvBlocks(
            enc[P], enc[P], 1, **kw))
        for u, lvl in enumerate(reversed(range(P))):
            self.add_module(f"up_{u}", TranspConv(
                enc[lvl + 1], enc[lvl], self.pools[lvl],
                compute_dtype=compute_dtype, device=device))
            self.add_module(f"loc_{u}", StackedConvBlocks(
                2 * enc[lvl], enc[lvl], n - 1, **kw))
            self.add_module(f"loc_{u}_final", StackedConvBlocks(
                enc[lvl], enc[lvl], 1, **kw))
            self.add_module(f"seg_head{u}", SegHead(
                enc[lvl], num_classes, compute_dtype=compute_dtype,
                device=device, use_bias=seg_bias))

    def num_ds_outputs(self) -> int:
        return self.num_pool

    @property
    def input_shape_must_be_divisible_by(self) -> np.ndarray:
        return np.prod(np.array(self.pools), 0)

    def kernel_route(self) -> bool:
        return False

    def mirrored_operators(self) -> bool:
        return True

    def reset_parameters(self, seed: int) -> None:
        """He-normal kernels, zero biases, unit norm scales, drawn in module
        order from one torch.Generator seeded with `seed`."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def forward(self, x: torch.Tensor, do_ds: bool = True,
                flips: Flips = NO_FLIPS):
        P = self.num_pool
        flips = tuple(bool(f) for f in flips)
        div = [int(d) for d in self.input_shape_must_be_divisible_by]
        if any(int(s) % d for s, d in zip(x.shape[1:4], div)):
            raise ValueError(f"input spatial shape {tuple(x.shape[1:4])} "
                             f"must be divisible by {tuple(div)} (pool "
                             f"kernels {self.pools})")
        h = x.to(self.compute_dtype)
        skips = []
        for d in range(P):
            h = getattr(self, f"context{d}")(h, flips)
            skips.append(h)
        h = getattr(self, f"context{P}a")(h, flips)
        h = getattr(self, f"context{P}b")(h, flips)
        seg_outputs = []
        for u, lvl in enumerate(reversed(range(P))):
            up = getattr(self, f"up_{u}")(h, flips)
            h = getattr(self, f"loc_{u}")([up, skips[lvl]], flips)
            h = getattr(self, f"loc_{u}_final")(h, flips)
            if do_ds or u == P - 1:
                seg_outputs.append(getattr(self, f"seg_head{u}")(h))
        if not do_ds:
            return seg_outputs[-1]
        # full resolution first, then decreasing resolution
        return [seg_outputs[-1]] + seg_outputs[:-1][::-1]
