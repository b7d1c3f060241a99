"""Channels-first fused depth shift + (1,3,3) conv (#12). Counterpart of
experiments/exp_cf_fused.py.

    reshape_hwc(x, C)     E1's probe: (H, W*C) -> (H*W, C) through shared
                          memory (the reference asked whether its compiler
                          lowers this relayout inside a kernel)
    cf_fused_shift_conv(x_cf, kernel, bias, H, W, mult=None, off=None,
                        do_stats=False)
                          `_cf_kernel` and `_cf_kernel_v2` as one function:
                          x_cf channels-first (N, D, C, H*W) ->
                          (y (N, D, CO, H*W), stats (N, CO, 2) or None)

Semantics, the reference's: mult/off are (C,), shared by the batch (#1's
are per (N, C)); the affine runs in float32 as max(a, 0.01 a) and is
rounded to x's dtype; depth rows outside [0, D) are zero after it; conv taps
outside H x W are zero; the bias (in x's dtype) is added to the float32
sums; y is stored in x's dtype; stats are (sum y, sum y^2) of the float32
sums, bias included, over d and H*W. The kernel is (CO, C, 3, 3). Any W (the
reference's HALO limits W to 255).

On CUDA tensors (bfloat16) csrc/cf_fused.cu; on CPU tensors the plain
versions. The channels-first block has two routes, chosen by the library's
rule (`_native.cf_route`): "tma" where tensor maps describe x and y (W % 8
== 0, 16-byte-aligned tensors), CO <= 48, C <= 80 and the shift groups fit
CF_SLOTS boxes of at most 16 channels; "ldg", the first design, otherwise.
For the TMA route the host computes, once per call, the boxes (each shift
group cut to slots of at most 16 channels, cf_slots: one TMA box each, at
the group's source depth) and the K order of the products (the channels in
order, padded with zero rows to a multiple of 16; the weights laid out for
wgmma's B by shift_conv.pack_weights_n48, as #11's TMA route lays them
out). `cf_fused_shift_conv.routes` counts the
launches per route.

    python -m e2enet_tpu_torch.experiments.exp_cf_fused [--v2] [--reps N]

runs E1, E4a (correctness) and E4b (timing at 1 x 128^3 x 48 -> 48), and
with --v2 E5a/E5b (affine and statistics on), against the plain version,
cuDNN's conv and the port's channels-last block #1 at the same shape.
"""
import argparse
import sys

import torch
import torch.nn.functional as F

from ..ops.autograd import check_device
from ..ops.blocks import conv3d_as_2d
from ..ops.fused_block import fused_shift_conv_block
from ..ops.shift import depth_shift_groups, group_shifts
from . import card_line, cuda_ms, require_cuda
from .shift_conv import bf16_close, pack_weights_n48

SHIFT_SIZE = 5
LRELU_SLOPE = 0.01
# the TMA route's boxes per tile (csrc/cf_fused.cu CF_SLOTS)
CF_SLOTS = 5


# ------------------------------------------------------------ E1: relayout
def reshape_hwc_ref(x: torch.Tensor, C: int) -> torch.Tensor:
    """Plain version: (H, W*C) -> (H*W, C), a copy."""
    return x.reshape(-1, C).clone()


def reshape_hwc(x: torch.Tensor, C: int) -> torch.Tensor:
    """(H, W*C) -> (H*W, C) by the staging kernel (CUDA, any dtype) or the
    plain version (CPU)."""
    H, WC = (int(s) for s in x.shape)
    if WC % C:
        raise ValueError(f"W*C = {WC} is not a multiple of C = {C}")
    if x.device.type == "cpu":
        return reshape_hwc_ref(x, C)
    check_device("reshape_hwc", [x])
    from ..ops import _native
    x = x.contiguous()
    y = torch.empty((H * (WC // C), C), dtype=x.dtype, device=x.device)
    _native.launch_reshape_hwc(x, y, H, WC // C, C)
    reshape_hwc.launches += 1
    return y


reshape_hwc.launches = 0


# ----------------------------------------------- channels-first shift+conv
def _check(x_cf, kernel, bias, H, W, mult, off):
    N, D, C, HW = (int(s) for s in x_cf.shape)
    if HW != H * W:
        raise ValueError(f"H*W = {H}*{W} != {HW}")
    CO = int(kernel.shape[0])
    if tuple(kernel.shape) != (CO, C, 3, 3) or tuple(bias.shape) != (CO,):
        raise ValueError(f"kernel {tuple(kernel.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit C={C}")
    if (mult is None) != (off is None):
        raise ValueError("mult and off go together")
    if mult is not None and (mult.numel() != C or off.numel() != C):
        raise ValueError("mult/off are (C,), shared by the batch")
    return N, D, C, CO


def cf_fused_shift_conv_ref(x_cf, kernel, bias, H, W, mult=None, off=None,
                            do_stats=False, shift_size=SHIFT_SIZE):
    """Plain version of cf_fused_shift_conv (same arguments and results)."""
    N, D, C, CO = _check(x_cf, kernel, bias, H, W, mult, off)
    dtype = x_cf.dtype
    x = x_cf.reshape(N, D, C, H, W).permute(0, 1, 3, 4, 2)
    if mult is not None:
        a = x.float() * mult.float().reshape(C) + off.float().reshape(C)
        x = torch.maximum(a, a * LRELU_SLOPE).to(dtype)
    s = depth_shift_groups(x, group_shifts(C, shift_size))
    acc = conv3d_as_2d(s.float(), kernel.to(dtype).float(), None, (1, 1, 1),
                       torch.float32) + bias.to(dtype).float()
    stats = (torch.stack([acc.sum(dim=(1, 2, 3)),
                          acc.square().sum(dim=(1, 2, 3))], dim=-1)
             if do_stats else None)
    y = acc.to(dtype).permute(0, 1, 4, 2, 3).reshape(N, D, CO, H * W)
    return y, stats


def cf_slots(C: int, shift_size: int = SHIFT_SIZE):
    """The TMA route's boxes: [(first channel, channels, shift)] per slot,
    each shift group of group_shifts(C, shift_size) cut into slots of at
    most 16 channels. A slot is staged as one box of the widest slot's
    channel planes from its first channel (TMA reads the neighbours, or
    zeros past C), at source depth d - shift; the products read only the
    slot's own channels."""
    return [(c, min(16, c1 - c), sh) for c0, c1, sh in
            group_shifts(C, shift_size) for c in range(c0, c1, 16)]


def cf_fused_shift_conv(x_cf, kernel, bias, H, W, mult=None, off=None,
                        do_stats=False, shift_size=SHIFT_SIZE):
    """The channels-first fused block: csrc/cf_fused.cu for CUDA tensors
    (bfloat16; the affine and the statistics are run-time switches of each
    route's kernel; the route by the library's rule, counted in
    cf_fused_shift_conv.routes), the plain version for CPU tensors. Returns
    (y, stats or None)."""
    if x_cf.device.type == "cpu":
        return cf_fused_shift_conv_ref(x_cf, kernel, bias, H, W, mult, off,
                                       do_stats, shift_size)
    N, D, C, CO = _check(x_cf, kernel, bias, H, W, mult, off)
    dev = check_device("cf_fused_shift_conv", [x_cf, kernel, bias] + (
        [] if mult is None else [mult, off]))
    bf = torch.bfloat16
    if x_cf.dtype != bf:
        raise TypeError("the CUDA cf_fused_shift_conv takes bfloat16")
    from ..ops import _native
    x_cf = x_cf.contiguous()
    aff = (None, None) if mult is None else (
        mult.float().reshape(C).contiguous(), off.float().reshape(C)
        .contiguous())
    y = torch.empty((N, D, CO, H * W), dtype=bf, device=dev)
    stats = (torch.zeros((N, CO, 2), dtype=torch.float32, device=dev)
             if do_stats else None)
    slots = cf_slots(C, shift_size)
    w2 = wpk = None
    if _native.cf_route(x_cf, y, H, W, slots) == "tma":
        wpk = pack_weights_n48(kernel.to(bf))
    else:           # (CO, 9*C): k = (3*kh + kw) * C + channel
        w2 = kernel.to(bf).permute(0, 2, 3, 1).reshape(CO, 9 * C).contiguous()
    route = _native.launch_cf_fused(
        x_cf, w2, wpk, bias.to(bf).contiguous(), *aff, y, stats,
        group_shifts(C, shift_size), slots, H, W)
    cf_fused_shift_conv.launches += 1
    cf_fused_shift_conv.routes[route] += 1
    return y, stats


cf_fused_shift_conv.launches = 0
cf_fused_shift_conv.routes = {"tma": 0, "ldg": 0}


# ---------------------------------------------------------------- main
def _inputs(gen, dev, N, D, H, W, C, CO):
    bf = torch.bfloat16
    x = torch.randn((N, D, C, H * W), generator=gen, device=dev).to(bf)
    kernel = torch.randn((CO, C, 3, 3), generator=gen, device=dev) * 0.1
    bias = torch.randn((CO,), generator=gen, device=dev) * 0.1
    mult = torch.randn((C,), generator=gen, device=dev) * 0.5 + 1.0
    off = torch.randn((C,), generator=gen, device=dev) * 0.1
    return x, kernel, bias, mult, off


def _correct(tag, x, kernel, bias, H, W, mult, off, do_stats) -> bool:
    y, s = cf_fused_shift_conv(x, kernel, bias, H, W, mult, off, do_stats)
    y_p, s_p = cf_fused_shift_conv_ref(x, kernel, bias, H, W, mult, off,
                                       do_stats)
    ok = bf16_close(y.transpose(2, 3), y_p.transpose(2, 3))
    msg = f"  {tag}: y within 2 bf16 steps of the plain version {ok}"
    if do_stats:
        rel = float((s - s_p).abs().max() / s_p.abs().max())
        ok = ok and rel <= 1e-4
        msg += f"; stats max rel err {rel:.2e}"
    print(msg, flush=True)
    return ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--v2", action="store_true",
                    help="E5: the affine on load and the statistics on")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_cuda("exp_cf_fused")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"[exp_cf_fused] {torch.cuda.get_device_name(0)} "
          f"[{card_line()}]", flush=True)
    with torch.inference_mode():
        xe = torch.arange(8 * 16 * 48, dtype=torch.float32,
                          device=dev).reshape(8, 16 * 48)
        ok = torch.equal(reshape_hwc(xe, 48), xe.reshape(8 * 16, 48))
        print(f"  E1 reshape (H,WC)->(HW,C): compiles, correct={ok}",
              flush=True)
        small = _inputs(gen, dev, 1, 8, 8, 16, 48, 48)
        v2 = args.v2
        ok = _correct("E5a" if v2 else "E4a", *small[:3], 8, 16,
                      *(small[3:] if v2 else (None, None)), v2) and ok
        if not ok:
            raise SystemExit("exp_cf_fused: correctness FAILED")
        S = 128
        x, kernel, bias, mult, off = _inputs(gen, dev, 1, S, S, S, 48, 48)
        m, o = (mult, off) if v2 else (None, None)
        x_cl = x.reshape(1, S, 48, S, S).permute(0, 1, 3, 4, 2).contiguous()
        kb = kernel.to(torch.bfloat16)
        x2 = x_cl.reshape(S, S, S, 48).permute(0, 3, 1, 2)
        w2 = kb.contiguous(memory_format=torch.channels_last)
        aff = [None] if m is None else [(m.expand(1, 48), o.expand(1, 48))]
        t = {
            "channels-first kernel": cuda_ms(lambda: cf_fused_shift_conv(
                x, kernel, bias, S, S, m, o, v2), args.reps),
            "plain version": cuda_ms(lambda: cf_fused_shift_conv_ref(
                x, kernel, bias, S, S, m, o, v2), args.reps),
            "cuDNN conv alone (channels-last, pre-shifted)": cuda_ms(
                lambda: F.conv2d(x2, w2, padding=1), args.reps),
            "channels-last block #1 (fused_shift_conv_block)": cuda_ms(
                lambda: fused_shift_conv_block([x_cl], kernel, bias, aff),
                args.reps),
        }
    tag = "E5b (affine + stats)" if v2 else "E4b"
    for k, v in t.items():
        print(f"  {tag} 1 x {S}^3 x 48 -> 48 bf16, {k}: {v:.4f} ms",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
