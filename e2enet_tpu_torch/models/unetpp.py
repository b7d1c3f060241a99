"""ShiftUNetPlusPlus (E2ENet) forward in torch: the dense, non-quadrant
path of e2enet_tpu/models/unetpp.py.

UNet++ dense nest of shifted (1,3,3) conv stacks; encoder pooling is a
strided first conv, nest up-links are k == s transposed convs and nest
down-links are max pools. Node x(i, j) (level i, column j >= 1) fuses
concat[x(i, j-1), up(x(i+1, j-1)), maxpool(x(i-1, j-1))] (the pooled part
only for i > 0); reference names x(i, j) = loc{P-i-j}_{j-1}, with a
`_final` stack on the diagonal nodes (z == 0).

Stride-1 stacks at levels <= FUSED_MAX_LEVEL run the fused block op
(ops/fused_block.py): their outputs stay Pending, raw conv output plus
instance-norm statistics, and consumers apply norm + leaky relu on load.
With 5 pools one forward launches the fused block 13 times: context0 (2),
the five level-0 nest nodes and the final of x(0, 5) (6), the four level-1
nest nodes and the final of x(1, 4) (5). Everything else is plain torch.
The launches go through the name `fused_shift_conv_block` of ops/blocks.py,
so a caller can swap in the plain version there.

Parameter names follow the reference's flax tree (`context{d}.block{b}`,
`context{P}a/b`, `up{z}_{k}`, `loc{z}_{k}`, `loc{z}_{k}_final`,
`seg_head{i}`; leaves `kernel`, `bias`, `norm_scale`, `norm_bias`); see
models/weights.py for the layouts.
"""
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from ..ops.blocks import SegHead, StackedConvBlocks, TranspConv, max_pool
from ..ops.fused_block import (apply_norm_lrelu, norm_affine_from_stats,
                               pooled_part)

MAX_NUM_FILTERS_3D = 320
# deepest level whose stride-1 stacks run the fused block: the reference's
# default (e2enet_tpu/models/unetpp.py fused_max_level = 1)
FUSED_MAX_LEVEL = 1


class Pending(NamedTuple):
    """A fused-block output whose instance norm + leaky relu is not applied
    yet; channels-last raw (N, D, H, W, C)."""
    raw: torch.Tensor
    stats: torch.Tensor       # (N, C, 2) float32 (sum, sumsq)
    scale: torch.Tensor       # (C,) norm_scale
    nbias: torch.Tensor       # (C,) norm_bias


def encoder_channels(base: int, num_pool: int, max_features: int,
                     feat_mul: int = 2) -> List[int]:
    """Output channels per level 0..num_pool (bottleneck included)."""
    return [min(base * feat_mul ** d, max_features)
            for d in range(num_pool + 1)]


class ShiftUNetPlusPlus(nn.Module):
    """forward(x (N, D, H, W, Cin), do_ds) -> float32 logits (N, D, H, W, K),
    or the list of deep-supervision logits (finest first) when do_ds."""

    def __init__(self, input_channels: int, num_classes: int,
                 pool_op_kernel_sizes: Sequence[Tuple[int, int, int]],
                 base_num_features: int = 48,
                 max_num_features: int = MAX_NUM_FILTERS_3D,
                 num_conv_per_stage: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        if device is None:
            raise ValueError("pass the device explicitly")
        self.pools = [tuple(int(k) for k in p) for p in pool_op_kernel_sizes]
        P = self.num_pool = len(self.pools)
        self.num_classes = num_classes
        self.num_conv_per_stage = num_conv_per_stage
        self.compute_dtype = compute_dtype
        enc = self.enc = encoder_channels(base_num_features, P,
                                          max_num_features)
        kw = dict(compute_dtype=compute_dtype, device=device)

        for d in range(P):
            self.add_module(f"context{d}", StackedConvBlocks(
                input_channels if d == 0 else enc[d - 1], enc[d],
                num_conv_per_stage,
                first_stride=self.pools[d - 1] if d > 0 else (1, 1, 1),
                **kw))
        self.add_module(f"context{P}a", StackedConvBlocks(
            enc[P - 1], enc[P], num_conv_per_stage - 1,
            first_stride=self.pools[P - 1], **kw))
        self.add_module(f"context{P}b", StackedConvBlocks(
            enc[P], enc[P], 1, **kw))
        for j in range(1, P + 1):
            for i in range(P - j, -1, -1):
                z, k = P - i - j, j - 1
                self.add_module(f"up{z}_{k}", TranspConv(
                    enc[i + 1], enc[i], self.pools[i],
                    compute_dtype=compute_dtype, device=device))
                cin = 2 * enc[i] + (enc[i - 1] if i > 0 else 0)
                self.add_module(f"loc{z}_{k}", StackedConvBlocks(
                    cin, enc[i], num_conv_per_stage - 1, **kw))
                if z == 0:
                    self.add_module(f"loc{z}_{k}_final", StackedConvBlocks(
                        enc[i], enc[i], 1, **kw))
        for i in range(self.num_ds_outputs()):
            self.add_module(f"seg_head{i}", SegHead(
                enc[i], num_classes, compute_dtype=compute_dtype,
                device=device))

    def num_ds_outputs(self) -> int:
        return min(4, self.num_pool)

    def reset_parameters(self, seed: int) -> None:
        """He-normal kernels, zero biases, unit norm scales, drawn in module
        order from one torch.Generator seeded with `seed`."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def forward(self, x: torch.Tensor, do_ds: bool = True):
        P = self.num_pool
        pools, enc = self.pools, self.enc
        div = [math.prod(p[a] for p in pools) for a in range(3)]
        if any(int(s) % d for s, d in zip(x.shape[1:4], div)):
            raise ValueError(f"input spatial shape {tuple(x.shape[1:4])} "
                             f"must be divisible by {tuple(div)}")
        x = x.to(self.compute_dtype)
        level_size = [tuple(int(s) for s in x.shape[1:4])]
        for p in pools:
            level_size.append(tuple(s // k for s, k in
                                    zip(level_size[-1], p)))

        def n_vox(i):
            return math.prod(level_size[i])

        def affine_of(v: Pending, i):
            return norm_affine_from_stats(v.stats, n_vox(i), v.scale,
                                          v.nbias)

        def as_part(v, i):
            """(tensor, pending affine or None) for a fused consumer."""
            if isinstance(v, Pending):
                return v.raw, affine_of(v, i)
            return v, None

        def as_cl(v, i):
            """The normalised activation of a node."""
            if isinstance(v, Pending):
                return apply_norm_lrelu(v.raw, *affine_of(v, i))
            return v

        def fused(stack, part_list, i):
            parts = [p for p, _ in part_list]
            affines = [a for _, a in part_list]
            return stack.forward_fused(parts, affines, n_vox(i))

        # ---- encoder
        nodes: Dict[Tuple[int, int], object] = {}
        h = x
        for d in range(P):
            stack = getattr(self, f"context{d}")
            if d == 0:
                h = Pending(*fused(stack, [as_part(h, 0)], 0))
            else:
                h = stack(as_cl(h, max(d - 1, 0)))
            nodes[(d, 0)] = h
        h = getattr(self, f"context{P}a")(as_cl(h, P - 1))
        nodes[(P, 0)] = getattr(self, f"context{P}b")(h)

        # ---- dense nest
        for j in range(1, P + 1):
            for i in range(P - j, -1, -1):
                z, k = P - i - j, j - 1
                below = nodes[(i + 1, j - 1)]
                same = nodes[(i, j - 1)]
                above = nodes[(i - 1, j - 1)] if i > 0 else None
                up = getattr(self, f"up{z}_{k}")(as_cl(below, i + 1))
                # pooled down-link: maxpool(lrelu(norm(x(i-1, j-1))))
                if above is None:
                    down = None
                elif isinstance(above, Pending):
                    down = pooled_part(above.raw, *affine_of(above, i - 1),
                                       pools[i - 1])
                else:
                    down = max_pool(above, pools[i - 1])
                loc = getattr(self, f"loc{z}_{k}")
                if i <= FUSED_MAX_LEVEL:
                    part_list = [as_part(same, i), (up, None)]
                    if down is not None:
                        part_list.append((down, None))
                    out = Pending(*fused(loc, part_list, i))
                    if z == 0:
                        final = getattr(self, f"loc{z}_{k}_final")
                        out = Pending(*fused(final, [as_part(out, i)], i))
                else:
                    cat = [as_cl(same, i), up]
                    if down is not None:
                        cat.append(down)
                    out = loc(cat)
                    if z == 0:
                        out = getattr(self, f"loc{z}_{k}_final")(out)
                nodes[(i, j)] = out

        # ---- deep-supervision heads
        outputs = [getattr(self, f"seg_head{i}")(as_cl(nodes[(i, P - i)], i))
                   for i in range(self.num_ds_outputs())]
        return outputs if do_ds else outputs[0]


def fused_launches_per_forward(model: ShiftUNetPlusPlus) -> int:
    """Fused block calls in one forward: the stride-1 context0 stack, every
    nest stack at a fused level and the finals of the fused diagonal
    nodes."""
    P = model.num_pool
    n = model.num_conv_per_stage
    for j in range(1, P + 1):
        for i in range(P - j, -1, -1):
            if i <= FUSED_MAX_LEVEL:
                n += model.num_conv_per_stage - 1 + (1 if P - i - j == 0
                                                     else 0)
    return n
