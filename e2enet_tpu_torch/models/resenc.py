"""Residual-encoder U-Net in torch, channels-last (N, D, H, W, C): the
counterpart of e2enet_tpu/models/resenc.py (the reference's FabiansUNet,
"Residual Encoder, Plain conv decoder"), the network of the
nnUNetTrainerV2_ResencUNet presets.

Initial conv-norm-nonlin (`initial_conv`, `initial_bias`,
`initial_scale`, `initial_nbias`), then one ResidualLayer per stage
(`encoder{s}`, blocks (1, 2, 3, 4, 4, ...), the first block of each
strided by the previous pool). A ResidualBlock is conv-norm-nonlin-conv-norm
(`conv1`, `bias1`, `scale1`, `nbias1`, `conv2`, ...) plus a skip, a 1x1x1
strided conv and norm (`skip_conv`, `skip_scale`, `skip_nbias`) when the
stride or the width changes, and the nonlinearity after the add. The
decoder is plain: `up{i}` (k == s transposed conv), the concat with the
skip, `decoder{i}` (one (3,3,3) block without the shift), from the
bottleneck up; heads `seg_head{u}` on the min(4, P) finest decoder stages,
full resolution first.

Every conv is cuDNN's 3D conv (ops/blocks.conv3d_full): the reference runs
this network on its XLA path, so it launches no kernel (kernel_route() is
False), and it has no mirrored operators: its TTA flips the data.
"""
import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.blocks import (NONLINS, NORM_OPS, SegHead, StackedConvBlocks,
                          TranspConv, _he_normal_, conv3d_full)
from ..ops.fused_block import NO_FLIPS, Flips
from .unetpp import encoder_channels

# the reference's defaults (FabiansUNet; no preset sets another)
BLOCKS_ENCODER = (1, 2, 3, 4, 4, 4, 4, 4, 4, 4, 4)
BLOCKS_DECODER = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1)
KERNEL = (3, 3, 3)
MAX_NUM_FEATURES = 320


class ResidualBlock(nn.Module):
    """BasicResidualBlock (reference ResidualBlock)."""

    def __init__(self, in_channels: int, features: int,
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 norm_op: str = "instance", nonlin: str = "lrelu",
                 device=None):
        super().__init__()
        self.stride = tuple(int(s) for s in stride)
        self.compute_dtype = compute_dtype
        self.norm, self.act = NORM_OPS[norm_op], NONLINS[nonlin]
        f32 = dict(dtype=torch.float32, device=device)
        k = KERNEL
        self.conv1 = nn.Parameter(torch.empty(features, in_channels, *k,
                                              **f32))
        self.bias1 = nn.Parameter(torch.zeros(features, **f32))
        self.scale1 = nn.Parameter(torch.ones(features, **f32))
        self.nbias1 = nn.Parameter(torch.zeros(features, **f32))
        self.conv2 = nn.Parameter(torch.empty(features, features, *k, **f32))
        self.bias2 = nn.Parameter(torch.zeros(features, **f32))
        self.scale2 = nn.Parameter(torch.ones(features, **f32))
        self.nbias2 = nn.Parameter(torch.zeros(features, **f32))
        self.has_skip = (any(s != 1 for s in self.stride)
                         or in_channels != features)
        if self.has_skip:
            self.skip_conv = nn.Parameter(torch.empty(
                features, in_channels, 1, 1, 1, **f32))
            self.skip_scale = nn.Parameter(torch.ones(features, **f32))
            self.skip_nbias = nn.Parameter(torch.zeros(features, **f32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.dim() > 1:
                    _he_normal_(p, math.prod(p.shape[1:]), generator)
                else:
                    p.fill_(1.0 if "scale" in name else 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        out = conv3d_full(x, self.conv1, self.bias1, self.stride, cd)
        out = self.act(self.norm(out, self.scale1, self.nbias1))
        out = self.norm(conv3d_full(out, self.conv2, self.bias2, (1, 1, 1),
                                    cd), self.scale2, self.nbias2)
        if self.has_skip:
            residual = self.norm(
                conv3d_full(x, self.skip_conv, None, self.stride, cd),
                self.skip_scale, self.skip_nbias)
        else:
            residual = x
        return self.act(out + residual)


class ResidualLayer(nn.Module):
    """num_blocks ResidualBlocks `block{i}`; the stride rides on the
    first."""

    def __init__(self, in_channels: int, features: int, num_blocks: int,
                 first_stride: Tuple[int, int, int] = (1, 1, 1), **kw):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", ResidualBlock(
                in_channels if i == 0 else features, features,
                stride=first_stride if i == 0 else (1, 1, 1), **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ResidualUNet(nn.Module):
    """forward(x (N, D, H, W, Cin), do_ds) -> float32 logits (N, D, H, W,
    K), or the min(4, P) deep-supervision logits (finest first) when do_ds.
    pool_op_kernel_sizes are the strides between levels; the encoder has
    P + 1 stages."""

    def __init__(self, input_channels: int, num_classes: int,
                 pool_op_kernel_sizes: Sequence[Tuple[int, int, int]],
                 base_num_features: int = 24,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 norm_op: str = "instance", nonlin: str = "lrelu",
                 seg_bias: bool = False, device=None):
        super().__init__()
        if device is None:
            raise ValueError("pass the device explicitly")
        self.pools = [tuple(int(k) for k in p) for p in pool_op_kernel_sizes]
        P = self.num_pool = len(self.pools)
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.norm, self.act = NORM_OPS[norm_op], NONLINS[nonlin]
        enc = encoder_channels(base_num_features, P, MAX_NUM_FEATURES)
        be, bd = BLOCKS_ENCODER[:P + 1], BLOCKS_DECODER[:P]
        f32 = dict(dtype=torch.float32, device=device)
        self.initial_conv = nn.Parameter(torch.empty(
            enc[0], input_channels, *KERNEL, **f32))
        self.initial_bias = nn.Parameter(torch.zeros(enc[0], **f32))
        self.initial_scale = nn.Parameter(torch.ones(enc[0], **f32))
        self.initial_nbias = nn.Parameter(torch.zeros(enc[0], **f32))
        kw = dict(compute_dtype=compute_dtype, norm_op=norm_op,
                  nonlin=nonlin, device=device)
        widths = []
        cin = enc[0]
        for s in range(P + 1):
            feats = enc[min(s, P)]
            self.add_module(f"encoder{s}", ResidualLayer(
                cin, feats, be[s],
                first_stride=self.pools[s - 1] if s > 0 else (1, 1, 1),
                **kw))
            widths.append(feats)
            cin = feats
        for i, s in enumerate(range(P - 1, -1, -1)):
            self.add_module(f"up{i}", TranspConv(
                cin, widths[s], self.pools[s], compute_dtype=compute_dtype,
                device=device))
            self.add_module(f"decoder{i}", StackedConvBlocks(
                2 * widths[s], widths[s], bd[i], compute_dtype=compute_dtype,
                do_shift=False, device=device, kernel=KERNEL, norm_op=norm_op,
                nonlin=nonlin))
            cin = widths[s]
        for u in range(self.num_ds_outputs()):
            self.add_module(f"seg_head{u}", SegHead(
                widths[u], num_classes, compute_dtype=compute_dtype,
                device=device, use_bias=seg_bias))

    def num_ds_outputs(self) -> int:
        return min(4, self.num_pool)

    @property
    def input_shape_must_be_divisible_by(self) -> np.ndarray:
        return np.prod(np.array(self.pools), 0)

    def kernel_route(self) -> bool:
        return False

    def mirrored_operators(self) -> bool:
        return False

    def reset_parameters(self, seed: int) -> None:
        """He-normal kernels, zero biases, unit norm scales, drawn in module
        order from one torch.Generator seeded with `seed`."""
        gen = torch.Generator().manual_seed(seed)
        _he_normal_(self.initial_conv, math.prod(self.initial_conv.shape[1:]),
                    gen)
        with torch.no_grad():
            self.initial_bias.zero_()
            self.initial_scale.fill_(1.0)
            self.initial_nbias.zero_()
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def forward(self, x: torch.Tensor, do_ds: bool = True,
                flips: Flips = NO_FLIPS):
        if any(flips):
            raise ValueError("ResidualUNet has no mirrored operators: its "
                             "TTA flips the data")
        P = self.num_pool
        cd = self.compute_dtype
        h = conv3d_full(x.to(cd), self.initial_conv, self.initial_bias,
                        (1, 1, 1), cd)
        h = self.act(self.norm(h, self.initial_scale, self.initial_nbias))
        skips = []
        for s in range(P + 1):
            h = getattr(self, f"encoder{s}")(h)
            skips.append(h)
        seg_outputs = []
        for i, s in enumerate(range(P - 1, -1, -1)):
            h = getattr(self, f"up{i}")(h)
            h = getattr(self, f"decoder{i}")([h, skips[s]])
            seg_outputs.append(h)
        n_heads = 1 if not do_ds else self.num_ds_outputs()
        outputs = [getattr(self, f"seg_head{u}")(
            seg_outputs[len(seg_outputs) - 1 - u]) for u in range(n_heads)]
        return outputs if do_ds else outputs[0]
