"""ShiftUNetPlusPlus (E2ENet) forward in torch: the reference model of
e2enet_tpu/models/unetpp.py computed channels-last (N, D, H, W, C), with no
quadrant or padded layout.

UNet++ dense nest of shifted (1,3,3) conv stacks; encoder pooling is a
strided first conv, nest up-links are k == s transposed convs and nest
down-links are max pools. Node x(i, j) (level i, column j >= 1) fuses
concat[x(i, j-1), up(x(i+1, j-1)), maxpool(x(i-1, j-1))] (the pooled part
only for i > 0); reference names x(i, j) = loc{P-i-j}_{j-1}, with a
`_final` stack on the diagonal nodes (z == 0).

On the kernel route (kernel_route(): the reference's fused_ok / use_quad
test, models/unetpp.py:218-245: instance norm, leaky relu after it, a
(1,3,3) kernel) levels <= FUSED_MAX_LEVEL keep their outputs Pending (raw
conv output plus instance-norm statistics; consumers apply norm + leaky
relu on load), as the reference's quadrant path does (models/unetpp.py,
quadrant=True):
  * every stride-1 stack there runs the fused block op (ops/fused_block);
  * context1's strided first block is the strided transition
    (ops/qstride) on context0's pending output, its other blocks fused;
  * a level-0 node's up-link reads the pending level-1 node through the
    up-link op, a level-1 node's pooled part reads the pending level-0 node
    through the down-link op, and a pending node's seg head is the seg-head
    op (ops/qlink).
With 5 pools and do_ds=False one forward makes 14 fused-block calls
(context0 2, context1 1, the five level-0 nest nodes and the final of
x(0, 5) 6, the four level-1 nest nodes and the final of x(1, 4) 5), one
strided transition, 5 up-links, 4 down-links and one seg head. In bfloat16
(the lazy route, lazy_up_route()) every level-0 nest node reads its up-link
lazily, as the reference routes it (models/unetpp.py:382-405): its first
block is the lazy up-link op (ops/qfused), which computes the up-link on
load, so the forward makes 5 lazy calls, 9 fused-block calls and no
up-link call. lazy_up=False keeps the materialised route (up-link op, then
the fused block), which the reference takes only where it refuses the lazy
one. The choice is made up front from the dtype and the pool. Counts:
kernel_launches_per_forward. Everything else is plain torch. The kernel
sites go through the names of ops/blocks.py, so ops.blocks.plain_ops()
swaps in the plain versions. Off the kernel route (the architecture
switches norm_op, nonlin, nonlin_before_norm and conv_kernel away from the
defaults) every level materialises, as the reference's XLA path does: plain
torch (cuDNN convs on the card) and no kernel launch. The route is chosen
up front from the architecture, never by a failure. num_conv_per_stage and
seg_bias keep the kernel route; a seg head with a bias (seg_bias) never
returns probabilities, as the reference drops its probs head there.

set_sparse_plan(plan) wires the DSFF row-sparse plan (models/sparse_plan,
the reference's `sparse_plan` field and unetpp.py:434-575): nest convs
contract only their alive rows, up-links emit only the columns their
consumer reads, and every nest node emits only the union of what its
consumers read. The masks must be baked into the weights first
(models/masks.apply_masks); the plan is then exact up to summation order.

forward(x, do_ds, flips) with flips (fd, fh, fw) computes the mirrored
model, flip_c(net(flip_c(x))), with the same parameters (the reference's
net.clone(flips=c)); the sliding-window predictor runs one mirrored forward
per mirror pass instead of flipping data.

Training: with a gradient wanted every kernel site is an autograd op
(ops/blocks.py), so forward(x, do_ds=True) under autograd is the
reference's differentiable model; kernel_launches_per_train_step counts
the kernels of one step, ds_loss_weights and deep_supervision_scales give
the deep-supervision loss its weights and target scales. A model with a
sparse plan attached refuses a gradient (training is dense-masked).

do_shift=False (the reference's field) drops the depth shift: every block
takes one channel group of shift 0, the table every kernel site takes as
it takes shiftConvPP's five (shiftConvPP_noshift; 2D plans, patch depth 1,
whose first pool (1, 2, 2) takes the materialised up-link route).

build_network(plans_stage, ...) builds the model of a plan's stage by
Tconv name and architecture switches, as the reference's factory does:
shiftConvPP, shiftConvPP_noshift, shiftConvPP_313 / _331 (this model with
(3,1,3) / (3,3,1) kernels and no shift), ori and shiftConvPP_nodff
(models/unet.ShiftUNet) and resenc (models/resenc.ResidualUNet).

Parameter names follow the reference's flax tree (`context{d}.block{b}`,
`context{P}a/b`, `up{z}_{k}`, `loc{z}_{k}`, `loc{z}_{k}_final`,
`seg_head{i}`; leaves `kernel`, `bias`, `norm_scale`, `norm_bias`,
`frn_tau`); see models/weights.py for the layouts.
"""
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import blocks
from ..ops.blocks import SegHead, StackedConvBlocks, TranspConv, max_pool
from ..ops.autograd import needs_grad
from ..ops.fused_block import (NO_FLIPS, Flips, apply_norm_lrelu,
                               norm_affine_from_stats, pooled_part)
from ..ops.qfused import LAZY_STRIDE
from ..parallel.collectives import count, space_size
from .sparse_plan import Plan

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
    """forward(x (N, D, H, W, Cin), do_ds, flips) -> float32 logits
    (N, D, H, W, K), or the list of deep-supervision logits (finest first)
    when do_ds. head_probs_dtype (the reference's): with do_ds=False the
    level-0 head returns its class softmax in that dtype instead of
    logits. lazy_up: level-0 nest nodes read their up-link lazily where the
    lazy route applies (lazy_up_route); False keeps the materialised
    route. do_shift=False: no depth shift (shiftConvPP_noshift).
    norm_op, nonlin, nonlin_before_norm, conv_kernel: the blocks'
    (ops/blocks.ShiftConvBlock); seg_bias: the heads' bias."""

    def __init__(self, input_channels: int, num_classes: int,
                 pool_op_kernel_sizes: Sequence[Tuple[int, int, int]],
                 base_num_features: int = 48,
                 max_num_features: int = MAX_NUM_FILTERS_3D,
                 num_conv_per_stage: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 head_probs_dtype: Optional[torch.dtype] = None,
                 lazy_up: bool = True, do_shift: bool = True,
                 norm_op: str = "instance", nonlin: str = "lrelu",
                 nonlin_before_norm: bool = False, seg_bias: bool = False,
                 conv_kernel: Tuple[int, int, int] = (1, 3, 3),
                 device=None):
        super().__init__()
        if device is None:
            raise ValueError("pass the device explicitly")
        self.pools = [tuple(int(k) for k in p) for p in pool_op_kernel_sizes]
        P = self.num_pool = len(self.pools)
        self.num_classes = num_classes
        self.num_conv_per_stage = num_conv_per_stage
        self.compute_dtype = compute_dtype
        self.head_probs_dtype = head_probs_dtype
        self.lazy_up = lazy_up
        self.do_shift = do_shift
        self.norm_op, self.nonlin = norm_op, nonlin
        self.nonlin_before_norm = nonlin_before_norm
        self.seg_bias = seg_bias
        self.conv_kernel = tuple(int(k) for k in conv_kernel)
        self.sparse_plan: Optional[Plan] = None
        enc = self.enc = encoder_channels(base_num_features, P,
                                          max_num_features)
        kw = dict(compute_dtype=compute_dtype, do_shift=do_shift,
                  device=device, kernel=self.conv_kernel,
                  norm_op=norm_op, nonlin=nonlin,
                  nonlin_before_norm=nonlin_before_norm)

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
                device=device, use_bias=seg_bias))

    def num_ds_outputs(self) -> int:
        return min(4, self.num_pool)

    @property
    def input_shape_must_be_divisible_by(self) -> np.ndarray:
        """What each spatial input dim must be a multiple of: the product
        of the pool kernels per axis."""
        return np.prod(np.array(self.pools), 0)

    def kernel_route(self) -> bool:
        """Whether levels <= FUSED_MAX_LEVEL run the kernels: the blocks
        the kernels bake (instance norm, then leaky relu; a (1,3,3)
        kernel), the reference's fused_ok / use_quad test
        (models/unetpp.py:218-245). Otherwise every level materialises."""
        return (self.norm_op == "instance" and self.nonlin == "lrelu"
                and not self.nonlin_before_norm
                and self.conv_kernel == (1, 3, 3))

    def fused_levels(self) -> int:
        """How many levels, from level 0, keep their outputs pending."""
        return (min(self.num_pool, FUSED_MAX_LEVEL + 1)
                if self.kernel_route() else 0)

    def mirrored_operators(self) -> bool:
        """Whether forward(..., flips) computes the mirrored model: every
        kernel but a full 3D one (allConv3x3) has a flat axis to mirror
        (flip-free TTA); otherwise TTA flips the data."""
        return 1 in self.conv_kernel

    def lazy_up_route(self, spatial: Optional[int] = None) -> bool:
        """Whether the level-0 nest nodes read their up-link lazily: the
        lazy kernel computes bfloat16 stride-(2, 2, 2) up-links from a
        pending level 1, on whole volumes only (spatial: the ranks that
        split H, by default the active grid's; the lazy block takes no halo
        rows yet, ROADMAP)."""
        if spatial is None:
            spatial = space_size()
        return (self.lazy_up and self.compute_dtype == torch.bfloat16
                and self.fused_levels() > 1
                and self.pools[0] == LAZY_STRIDE and spatial == 1)

    def set_sparse_plan(self, plan: Optional[Plan]) -> None:
        """Wire the row-sparse plan (None: dense) into every nest stack and
        up-link, and derive the gathered weights. Bake the masks into the
        weights first; later weight changes re-derive them."""
        P, enc = self.num_pool, self.enc
        self.sparse_plan = plan
        lookup = dict(plan or ())
        emits = {}
        for j in range(1, P + 1):
            for i in range(P - j, -1, -1):
                emits[(i, j)] = _emit_union(lookup, enc, P, i, j,
                                            self.num_ds_outputs())
        for j in range(1, P + 1):
            for i in range(P - j, -1, -1):
                z, k = P - i - j, j - 1
                parts = (enc[i], enc[i]) + ((enc[i - 1],) if i > 0 else ())
                stack_kw, up_kw, fin, out_union = _node_sparse(
                    lookup, emits, enc, P, self.num_conv_per_stage, z, k, i,
                    parts)
                getattr(self, f"up{z}_{k}").set_sparse(**up_kw)
                getattr(self, f"loc{z}_{k}").set_sparse(**stack_kw)
                if z == 0:
                    fin_kw = {} if fin is None else dict(
                        sparse_in=(fin,), sparse_in_full=(enc[i],),
                        sparse_compact=(True,))
                    if out_union is not None:
                        fin_kw["sparse_out"] = out_union
                    getattr(self, f"loc{z}_{k}_final").set_sparse(**fin_kw)

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
        pools, enc = self.pools, self.enc
        flips = tuple(bool(f) for f in flips)
        if self.sparse_plan and needs_grad(self.parameters()):
            raise RuntimeError("a model with a sparse plan attached takes no "
                               "gradient: training is dense-masked "
                               "(set_sparse_plan(None))")
        div = [int(d) for d in self.input_shape_must_be_divisible_by]
        if any(int(s) % d for s, d in zip(x.shape[1:4], div)):
            raise ValueError(f"input spatial shape {tuple(x.shape[1:4])} "
                             f"must be divisible by {tuple(div)}")
        x = x.to(self.compute_dtype)
        level_size = [tuple(int(s) for s in x.shape[1:4])]
        for p in pools:
            level_size.append(tuple(s // k for s, k in
                                    zip(level_size[-1], p)))

        def n_vox(i):
            # the whole level's: under a space group x is an H slab
            return count(math.prod(level_size[i]), "space")

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

        def fused(stack, part_list):
            parts = [p for p, _ in part_list]
            affines = [a for _, a in part_list]
            return Pending(*stack.forward_fused(parts, affines, flips))

        # ---- encoder
        fl = self.fused_levels()
        lazy = self.lazy_up_route()
        nodes: Dict[Tuple[int, int], object] = {}
        h = x
        for d in range(P):
            stack = getattr(self, f"context{d}")
            if d < fl:
                # context0 from the input; context1's strided first block
                # reads context0's pending output
                h = fused(stack, [as_part(h, max(d - 1, 0))])
            else:
                h = stack(as_cl(h, d - 1), flips)
            nodes[(d, 0)] = h
        h = getattr(self, f"context{P}a")(as_cl(h, P - 1), flips)
        nodes[(P, 0)] = getattr(self, f"context{P}b")(h, flips)

        # ---- dense nest
        for j in range(1, P + 1):
            for i in range(P - j, -1, -1):
                z, k = P - i - j, j - 1
                below = nodes[(i + 1, j - 1)]
                same = nodes[(i, j - 1)]
                above = nodes[(i - 1, j - 1)] if i > 0 else None
                up_mod = getattr(self, f"up{z}_{k}")
                if isinstance(below, Pending):
                    up = up_mod.forward_pending(
                        below.raw, *affine_of(below, i + 1), flips,
                        lazy=lazy and i == 0)
                else:
                    up = up_mod(below, flips)
                # pooled down-link: maxpool(lrelu(norm(x(i-1, j-1))))
                if above is None:
                    down = None
                elif isinstance(above, Pending):
                    link = blocks.downlink if i == 1 else pooled_part
                    down = link(above.raw, *affine_of(above, i - 1),
                                pools[i - 1])
                else:
                    down = max_pool(above, pools[i - 1])
                loc = getattr(self, f"loc{z}_{k}")
                if i < fl:
                    part_list = [as_part(same, i), (up, None)]
                    if down is not None:
                        part_list.append((down, None))
                    out = fused(loc, part_list)
                    if z == 0:
                        final = getattr(self, f"loc{z}_{k}_final")
                        out = fused(final, [as_part(out, i)])
                else:
                    cat = [as_cl(same, i), up]
                    if down is not None:
                        cat.append(down)
                    out = loc(cat, flips)
                    if z == 0:
                        out = getattr(self, f"loc{z}_{k}_final")(out, flips)
                nodes[(i, j)] = out

        # ---- seg heads: only the ones returned
        def head(i, probs_dtype=None):
            v, mod = nodes[(i, P - i)], getattr(self, f"seg_head{i}")
            if isinstance(v, Pending):
                return mod.forward_pending(v.raw, *affine_of(v, i),
                                           probs_dtype)
            return mod(v, probs_dtype)

        if not do_ds:
            return head(0, None if self.seg_bias else self.head_probs_dtype)
        return [head(i) for i in range(self.num_ds_outputs())]


# build_network's architecture switches and their defaults (the JAX
# trainer's argument names); a checkpoint sidecar records those away from
# their default, and a sidecar without one means its default
ARCH_DEFAULTS = {"norm_op": "instance", "nonlin": "lrelu",
                 "num_conv_per_stage": None, "seg_bias": False,
                 "nonlin_before_norm": False, "conv_kernel": None}
TCONVS = ("shiftConvPP", "shiftConvPP_noshift", "shiftConvPP_313",
          "shiftConvPP_331", "resenc", "ori", "shiftConvPP_nodff")


def build_network(plans_stage, num_modalities: int, num_classes_incl_bg: int,
                  tconv: str = "shiftConvPP", base_num_features: int = 48,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  norm_op: str = "instance", nonlin: str = "lrelu",
                  num_conv_per_stage=None, seg_bias: bool = False,
                  nonlin_before_norm: bool = False, conv_kernel=None,
                  device=None) -> nn.Module:
    """The network of a plan's stage by Tconv name and architecture
    switches (reference models/unetpp.build_network,
    e2enet_tpu/models/unetpp.py:769-860), with the plan's pool kernels; its
    weights are not initialised (load a state_dict or reset_parameters).
    On a 2D plan (patch depth 1) shiftConvPP builds shiftConvPP_noshift and
    ori a ShiftUNet without the shift and max_num_features 480, as the
    reference never shifts in 2D. shiftConvPP_313 / _331 take (3,1,3) /
    (3,3,1) kernels without the shift; conv_kernel (allConv3x3: (3,3,3))
    sets every kernel of the nest. The switches a network does not take
    raise TypeError, as the reference's dataclass fields do; an unknown
    name raises KeyError."""
    if tconv not in TCONVS:
        raise KeyError(f"Unknown Tconv '{tconv}'")
    arch = dict(norm_op=norm_op, nonlin=nonlin)
    if num_conv_per_stage is not None:
        # nnUNetTrainerV2_3ConvPerStage[_samefilters]
        arch["num_conv_per_stage"] = int(num_conv_per_stage)
    if seg_bias:
        arch["seg_bias"] = True
    if nonlin_before_norm:
        arch["nonlin_before_norm"] = True
    if conv_kernel is not None:
        arch["conv_kernel"] = tuple(int(k) for k in conv_kernel)
    pools = tuple(tuple(int(k) for k in p)
                  for p in plans_stage.pool_op_kernel_sizes)
    common = dict(base_num_features=base_num_features,
                  compute_dtype=compute_dtype, device=device)
    if int(plans_stage.patch_size[0]) == 1:
        if tconv == "shiftConvPP":
            tconv = "shiftConvPP_noshift"
        elif tconv == "ori":
            from .unet import ShiftUNet
            return ShiftUNet(num_modalities, num_classes_incl_bg, pools,
                             do_shift=False, max_num_features=480,
                             **common, **arch)
    if tconv in ("shiftConvPP", "shiftConvPP_noshift"):
        return ShiftUNetPlusPlus(
            num_modalities, num_classes_incl_bg, pools,
            do_shift=tconv == "shiftConvPP", **common, **arch)
    if tconv in ("shiftConvPP_313", "shiftConvPP_331"):
        # the reference disables the shift for these ablations
        # (unetpp_d_313.py:102 'and False')
        arch["conv_kernel"] = ((3, 1, 3) if tconv.endswith("313")
                               else (3, 3, 1))
        return ShiftUNetPlusPlus(num_modalities, num_classes_incl_bg, pools,
                                 do_shift=False, **common, **arch)
    if tconv == "resenc":
        from .resenc import ResidualUNet
        arch.pop("conv_kernel", None)
        arch.pop("nonlin_before_norm", None)
        return ResidualUNet(num_modalities, num_classes_incl_bg, pools,
                            **common, **arch)
    from .unet import ShiftUNet
    return ShiftUNet(num_modalities, num_classes_incl_bg, pools,
                     shift_size=3 if tconv == "ori" else 5, **common,
                     **arch)


def _lazy_calls(model: ShiftUNetPlusPlus, spatial: int = 1) -> int:
    """Lazy up-link calls per forward: one per level-0 nest node on the
    lazy route."""
    return model.num_pool if model.lazy_up_route(spatial) else 0


def fused_launches_per_forward(model: ShiftUNetPlusPlus,
                               spatial: int = 1) -> int:
    """Fused block calls in one forward: the stride-1 blocks of the
    encoder stacks at fused levels (context1's first block is the strided
    transition), every nest stack at a fused level and the finals of the
    fused diagonal nodes, less the level-0 nest stacks' first blocks on the
    lazy route."""
    P, fl = model.num_pool, model.fused_levels()
    n = sum(model.num_conv_per_stage - (1 if d > 0 else 0)
            for d in range(fl))
    for j in range(1, P + 1):
        for i in range(P - j, -1, -1):
            if i < fl:
                n += model.num_conv_per_stage - 1 + (1 if P - i - j == 0
                                                     else 0)
    return n - _lazy_calls(model, spatial)


def kernel_launches_per_forward(model: nn.Module, do_ds: bool = False,
                                spatial: int = 1) -> Dict[str, int]:
    """Calls per forward of each kernel site (ops/blocks.KERNEL_OPS): the
    fused block, the lazy up-link block (level-0 nest nodes on the lazy
    route), the strided transition (context1), the materialised up-links
    into level 0 (the other route), the level-0 -> 1 down-links (one per
    level-1 nest node) and the seg heads of pending nodes. The sparse plan
    changes no count. A model off the kernel route (kernel_route() False:
    the architecture switches, ShiftUNet, ResidualUNet) launches none.
    spatial: the ranks that split H (no lazy route above 1)."""
    if not model.kernel_route():
        return {name: 0 for name in blocks.KERNEL_OPS}
    P = model.num_pool
    fused_levels = model.fused_levels()
    n_heads = model.num_ds_outputs() if do_ds else 1
    lazy = _lazy_calls(model, spatial)
    return {
        "fused_shift_conv_block": fused_launches_per_forward(model, spatial),
        "lazy_up_fused_block": lazy,
        "strided_fused": 1 if fused_levels > 1 else 0,
        "uplink": P - lazy if fused_levels > 1 else 0,
        "downlink": P - 1 if fused_levels > 1 else 0,
        "seghead": min(n_heads, fused_levels),
    }


def kernel_launches_per_train_step(model: nn.Module,
                                   do_ds: bool = True, spatial: int = 1
                                   ) -> Dict[str, Dict[str, int]]:
    """Kernel calls of one train step (a forward with do_ds, True unless
    the noDeepSupervision variant's step runs the full-resolution head
    alone, and its backward): {"forward": kernel_launches_per_forward(
    model, do_ds), "backward": ...}. The backward launches the block
    backward once per fused or lazy block call, the down-link backward
    once per down-link call, and the up-link kernel once per lazy call
    (the lazy block's backward materialises u); the strided transition,
    the materialised up-links and the seg heads differentiate their plain
    versions. spatial: per rank of an H-sharded step of that many slabs
    (the materialised up-links in place of the lazy block)."""
    fwd = kernel_launches_per_forward(model, do_ds=do_ds, spatial=spatial)
    bwd = {name: 0 for name in fwd}
    bwd["fused_shift_conv_block_bwd"] = (fwd["fused_shift_conv_block"]
                                         + fwd["lazy_up_fused_block"])
    bwd["downlink_bwd"] = fwd["downlink"]
    bwd["uplink"] = fwd["lazy_up_fused_block"]
    return {"forward": fwd, "backward": bwd}


def deep_supervision_scales(pools: Sequence[Tuple[int, int, int]],
                            num_outputs: int) -> List[List[float]]:
    """Relative resolution of each deep-supervision output (reference
    models/unetpp.py:737-745)."""
    scales = [[1.0, 1.0, 1.0]] + list(
        (1.0 / np.cumprod(np.vstack(pools), axis=0)).tolist())
    return [list(map(float, s)) for s in scales[:num_outputs]]


def ds_loss_weights(num_pool: int, num_outputs: int) -> np.ndarray:
    """Deep-supervision loss weights 1/2^i with the lowest level zeroed,
    normalised over the first num_pool entries, truncated to the output
    count (reference models/unetpp.py:748-757)."""
    weights = np.array([1.0 / (2 ** i) for i in range(num_pool)])
    mask = np.array([True] + [i < num_pool - 1
                              for i in range(1, num_pool)])
    weights[~mask] = 0.0
    weights = weights / weights.sum()
    return weights[:num_outputs]


# --------------------------------------------------------------------------
# the sparse plan's wiring: reference models/unetpp.py:437-575, as it is

def pad8(alive, full: int) -> Tuple[int, ...]:
    """An alive set padded with dead channels (zero weights: exact) to a
    multiple of 8, at least 8, at most `full`."""
    alive = sorted(int(c) for c in alive)
    want = min(max(-(-len(alive) // 8) * 8, 8), full)
    have = set(alive)
    dead = (c for c in range(full) if c not in have)
    while len(alive) < want:
        alive.append(next(dead))
    return tuple(sorted(alive))


def _emit_union(plan, enc, P, i, j, n_heads):
    """The union (pad8) of the channels x(i, j)'s consumers read, or None
    when it emits dense (an unmasked consumer, a seg head reads it, or
    everything is alive)."""
    if not plan or j == 0:
        return None
    if j == P - i and i < n_heads:
        return None                     # a seg head reads every channel
    needs = set()
    if j + 1 <= P - i:                  # the same-level consumer
        a = plan.get(f"loc{P - i - (j + 1)}_{j}/block0")
        if a is None:
            return None
        needs.update(c for c in a if c < enc[i])
    if i > 0 and j + 1 <= P - (i - 1):  # the up-link consumer
        a = plan.get(f"up{P - (i - 1) - (j + 1)}_{j}")
        if a is None:
            return None
        needs.update(a)
    if j + 1 <= P - (i + 1):            # the down-link consumer
        a = plan.get(f"loc{P - (i + 1) - (j + 1)}_{j}/block0")
        if a is None:
            return None
        off2 = 2 * enc[i + 1]
        needs.update(c - off2 for c in a if c >= off2)
    u = pad8(needs or {0}, enc[i])
    return None if len(u) >= enc[i] else u


def _node_sparse(plan, emits, enc, P, num_conv_per_stage, z, k, i,
                 part_channels):
    """(loc stack kwargs, up-link kwargs, final stack's alive rows or None,
    this node's emit union or None) of nest node x(i, k + 1)."""
    j = k + 1
    alive = plan.get(f"loc{z}_{k}/block0")
    out_union = emits.get((i, j))
    same_u = emits.get((i, j - 1))
    below_u = emits.get((i + 1, j - 1))
    above_u = emits.get((i - 1, j - 1))
    up_kw = {}
    if below_u is not None:
        # below emitted compact: contract its whole union (rows outside the
        # up mask have zero kernel rows), gather kernel rows only
        up_kw.update(sparse_in=below_u, sparse_in_compact=True,
                     sparse_in_full=enc[i + 1])
    elif plan.get(f"up{z}_{k}") is not None:
        up_kw["sparse_in"] = pad8(plan[f"up{z}_{k}"], enc[i + 1])
    fin0 = plan.get(f"loc{z}_{k}_final/block0")
    fin = pad8(fin0, enc[i]) if fin0 is not None else None
    if alive is None:
        assert same_u is None and above_u is None, \
            "pruned producer feeding an unmasked consumer"
        stack_kw = {} if fin is None else dict(sparse_out=fin)
        return stack_kw, up_kw, fin, out_union
    off = [sum(part_channels[:p]) for p in range(len(part_channels) + 1)]
    producer_u = (same_u, None, above_u)
    per_part, compact = [], []
    for p in range(len(part_channels)):
        own = tuple(int(c - off[p]) for c in alive
                    if off[p] <= c < off[p + 1])
        if p == 1:
            # the up part: emitted compact by the up-link's column prune
            ua = pad8(own, part_channels[p])
            if len(ua) < part_channels[p]:
                up_kw["sparse_out"] = ua
            per_part.append(ua)
            compact.append(len(ua) < part_channels[p])
        elif producer_u[p] is not None:
            # the producer emitted its consumers' union: take it as it is
            assert set(own) <= set(producer_u[p])
            per_part.append(producer_u[p])
            compact.append(True)
        elif i <= FUSED_MAX_LEVEL:
            # a dense producer feeding a fused level: keep the full part and
            # contract its dead rows (zero kernel rows) instead of gathering
            # the activations (reference unetpp.py:543-556)
            per_part.append(tuple(range(part_channels[p])))
            compact.append(False)
        else:
            per_part.append(pad8(own, part_channels[p]))
            compact.append(False)
    stack_kw = dict(sparse_in=tuple(per_part),
                    sparse_in_full=tuple(part_channels),
                    sparse_compact=tuple(compact))
    chain = tuple(
        (pad8(plan[f"loc{z}_{k}/block{b}"], enc[i])
         if plan.get(f"loc{z}_{k}/block{b}") is not None else None)
        for b in range(num_conv_per_stage - 1))
    if any(c is not None for c in chain[1:]):
        stack_kw["sparse_chain"] = chain
    if fin is not None:
        stack_kw["sparse_out"] = fin
    elif out_union is not None:
        # no final stack follows: the stack emits the consumers' union
        stack_kw["sparse_out"] = out_union
    return stack_kw, up_kw, fin, out_union
