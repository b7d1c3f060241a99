#!/usr/bin/env python3
"""Run the e2enet_tpu_torch port once on one CUDA card and check it.

    python3 chip_smoke.py          # from the root of the repository

Phases (any failure ends the run with a non-zero exit):
  1. device   name, torch/CUDA versions, nvidia-smi name and power limit
  2. build    compile csrc/fused_block.cu for sm_90a into build/
  3. kernel   the fused shift-conv kernel against its plain torch version
              in bfloat16 at the five main-path shapes, one with every part
              pending, and four ragged ones (W=13, D=3, two CO tiles,
              W=200 in three W tiles)
  4. slice    ShiftUNet++ at the bench width (48 base features, 5 x (2,2,2)
              pools, 16 classes, bf16, random seeded weights): sliding-window
              inference of two seeded random 192^3 volumes with 128^3
              patches, step 0.5, 8 mirror passes and f16 accumulators;
              kernel launch count, normalised finite probabilities, one patch
              through the kernel path and the plain path against a float32
              run of the same weights, ms/volume of both paths
  5. report   one JSON line with the kernel's launches, error and times,
              the nvidia-smi line, and last {"ok": true, "device": {...}}

Needs torch built for CUDA and nvcc; never imports jax.
"""
import json
import subprocess
import sys
import time

import numpy as np

PATCH = (128, 128, 128)
VOLUME = (192, 192, 192)
NUM_CLASSES = 16
TTA = 8
# kernel vs plain: both sum exact bf16 products in float32 from identical
# bf16 operands and differ only in summation order (~1e-6 relative), so a
# stored bf16 value differs by at most one rounding step; allow 2 bf16 ulps
# of the channel's largest |y|. Stats: float32 sums whose order changes with
# the atomics, relative to sum|y| (for the sum) and sum y^2.
Y_ULPS = 2.0
STATS_RTOL = 1e-3
# whole model on one patch: the kernel path and the plain path (both bf16)
# against the same weights run in float32. Last-bit bf16 differences grow
# through ~25 layers of a random-weight net, so the two bf16 paths need not
# agree closely with each other; the kernel path must be as close to the
# float32 model as the plain path is: mean |dlogit| within 1.25x, argmax
# agreement within 0.5 points.
ERR_RATIO = 1.25
AGREE_SLACK = 0.005
PROB_SUM_ATOL = 1e-2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def f16_weights():
    """(the float16 Gaussian weight sum per voxel, tile count), as the
    predictor accumulates it. The Gaussian's tails fall below float16's
    normal range (2^-14) near the tile corners and its corners (~1e-11)
    underflow to 0, so voxels reached only by tile corners get few-bit or
    zero weights; the reference's float16 accumulation does the same."""
    from e2enet_tpu_torch.ops.sliding import (
        compute_steps_for_sliding_window, gaussian_importance_map)
    g = gaussian_importance_map(PATCH).astype(np.float16)
    w = np.zeros(VOLUME, np.float16)
    steps = compute_steps_for_sliding_window(PATCH, VOLUME, 0.5)
    starts = [(a, b, c) for a in steps[0] for b in steps[1] for c in steps[2]]
    for a, b, c in starts:
        w[a:a + PATCH[0], b:b + PATCH[1], c:c + PATCH[2]] += g
    return w, len(starts)


def bf16_ulp(v):
    """ulp of bfloat16 (8 significant bits) at |v|, elementwise."""
    import torch
    e = torch.floor(torch.log2(v.clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def kernel_case(name, N, D, H, W, part_c, affine, CO, gen, reps):
    """Kernel vs plain on random bf16 inputs; returns a result dict."""
    import torch
    from e2enet_tpu_torch.ops import fused_block as fb
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift)

    parts = [rnd(N, D, H, W, c).to(torch.bfloat16) for c in part_c]
    affines = [(rnd(N, c, scale=0.3, shift=1.0), rnd(N, c, scale=0.2))
               if a else None for c, a in zip(part_c, affine)]
    C = sum(part_c)
    kernel = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    bias = rnd(CO, scale=0.1)
    y_k, s_k = fb.fused_shift_conv_block(parts, kernel, bias, affines)
    y_p, s_p = fb.fused_shift_conv_block_ref(parts, kernel, bias, affines)
    torch.cuda.synchronize()
    yk, yp = y_k.float(), y_p.float()
    check(bool(torch.isfinite(yk).all()), f"{name}: non-finite kernel output")
    err = (yk - yp).abs()
    ch_max = yp.abs().amax(dim=(0, 1, 2, 3))
    tol = Y_ULPS * bf16_ulp(ch_max)
    y_ok = bool((err.amax(dim=(0, 1, 2, 3)) <= tol).all())
    abs_sum = yp.abs().sum(dim=(1, 2, 3))
    d1 = ((s_k[..., 0] - s_p[..., 0]).abs() / abs_sum.clamp_min(1e-30))
    d2 = ((s_k[..., 1] - s_p[..., 1]).abs()
          / s_p[..., 1].abs().clamp_min(1e-30))
    stats_rel = float(torch.maximum(d1, d2).max())
    # the library's bf16 conv of the already shifted, normalised operand:
    # context for the kernel's time, not a replacement for it
    x2 = torch.cat(parts, -1).reshape(N * D, H, W, C).permute(0, 3, 1, 2)
    w2 = kernel.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    cudnn_ms = cuda_ms(lambda: torch.nn.functional.conv2d(x2, w2, padding=1),
                       reps)
    res = dict(name=name, y_max_abs=float(err.max()),
               y_max_rel=float((err / yp.abs().clamp_min(1e-3)).max()),
               stats_max_rel=stats_rel,
               ms=cuda_ms(lambda: fb.fused_shift_conv_block(
                   parts, kernel, bias, affines), reps),
               plain_ms=cuda_ms(lambda: fb.fused_shift_conv_block_ref(
                   parts, kernel, bias, affines), reps))
    print(f"  {name}: N={N} D={D} H={H} W={W} C={part_c} "
          f"affine={affine} CO={CO}  y max abs {res['y_max_abs']:.3e} "
          f"(max rel {res['y_max_rel']:.3e})  stats max rel "
          f"{stats_rel:.3e}  kernel {res['ms']:.3f} ms  plain "
          f"{res['plain_ms']:.3f} ms  (cuDNN bf16 conv alone "
          f"{cudnn_ms:.3f} ms)", flush=True)
    check(y_ok, f"{name}: y differs by more than {Y_ULPS} bf16 ulps")
    check(stats_rel <= STATS_RTOL, f"{name}: stats rel err {stats_rel}")
    return res


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    try:
        from e2enet_tpu_torch.models.unetpp import (ShiftUNetPlusPlus,
                                                    fused_launches_per_forward)
        from e2enet_tpu_torch.ops import _native, blocks
        from e2enet_tpu_torch.ops import fused_block as fb
        from e2enet_tpu_torch.ops.sliding import predict_volume_tiled
    except ImportError as e:
        fail(f"e2enet_tpu_torch not importable ({e}); run from the "
             f"repository root")
    check("jax" not in sys.modules, "the port imported jax")

    # ---- 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}  count={torch.cuda.device_count()}  "
          f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"[device] nvidia-smi: {smi}", flush=True)

    # ---- 2. build
    t0 = time.time()
    lib_path = _native.library_path()
    _native.library()
    print(f"[build] {lib_path.name} ready in {time.time() - t0:.1f} s",
          flush=True)
    log = lib_path.with_name(lib_path.name + ".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 3. kernel vs plain
    print("[kernel] fused_shift_conv_block vs fused_shift_conv_block_ref "
          "(bf16)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        # the five main-path shapes, with the main path's pending affines
        ("l0_c1_to48", 1, 128, 128, 128, [1], [False], 48),
        ("l0_48_to48", 1, 128, 128, 128, [48], [True], 48),
        ("l0_48+48_to48", 1, 128, 128, 128, [48, 48], [True, False], 48),
        ("l1_96+96+48_to96", 1, 64, 64, 64, [96, 96, 48],
         [True, False, False], 96),
        ("l1_96_to96", 1, 64, 64, 64, [96], [True], 96),
        # every part pending, and the ragged edges
        ("l1_all_affine", 1, 64, 64, 64, [96, 96, 48], [True, True, True],
         96),
        ("ragged_w13", 2, 6, 8, 13, [5, 3], [True, False], 7),
        ("ragged_d3", 1, 3, 16, 16, [8], [True], 16),
        ("two_co_tiles", 1, 4, 8, 32, [16, 20], [False, True], 112),
        ("w_tiles_w200", 1, 4, 8, 200, [96, 96, 48], [True, False, False],
         96),
    ]
    with torch.inference_mode():
        results = [kernel_case(*c, gen=gen, reps=5) for c in cases]
    max_abs_err = max(r["y_max_abs"] for r in results)
    headline = next(r for r in results if r["name"] == "l0_48+48_to48")

    # ---- 4. slice
    model = ShiftUNetPlusPlus(
        input_channels=1, num_classes=NUM_CLASSES,
        pool_op_kernel_sizes=((2, 2, 2),) * 5, base_num_features=48,
        compute_dtype=torch.bfloat16, device="cuda")
    model.reset_parameters(seed=0)
    model.eval()
    per_pass = fused_launches_per_forward(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[slice] ShiftUNet++ {n_params / 1e6:.2f}M params, "
          f"{per_pass} fused-block launches per forward", flush=True)
    apply_fn = lambda x: model(x, do_ds=False)  # noqa: E731
    vols = [np.random.RandomState(s).randn(1, *VOLUME).astype(np.float32)
            for s in (1, 2, 3)]

    def predict(vol):
        return predict_volume_tiled(apply_fn, vol, PATCH, NUM_CLASSES,
                                    device="cuda", step_size=0.5,
                                    mirror_axes=(0, 1, 2),
                                    accum_dtype=torch.float16)

    def timed(vol):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        probs = predict(vol)
        end.record()
        torch.cuda.synchronize()
        return probs, start.elapsed_time(end)

    with torch.inference_mode():
        t0 = time.time()
        predict(vols[0])                               # warm-up volume
        print(f"[slice] warm-up volume {time.time() - t0:.1f} s", flush=True)
        fb.fused_shift_conv_block.launches = 0
        outs = [timed(v) for v in vols[1:]]
        launches = fb.fused_shift_conv_block.launches
        w16, n_tiles = f16_weights()
        # weights >= 2^-10: a class share of 1/16 or more is still a normal
        # float16, so the sum over classes is good to ~1e-3
        normal, zero = w16 >= 2.0 ** -10, w16 == 0
        want = len(outs) * n_tiles * TTA * per_pass
        print(f"[slice] fused-block launches {launches} over {len(outs)} "
              f"volumes (expected {want} = {len(outs)} x {n_tiles} tiles x "
              f"{TTA} passes x {per_pass})", flush=True)
        check(launches == want, f"launch count {launches} != {want}")
        for k, (probs, ms) in enumerate(outs):
            p = np.asarray(probs, dtype=np.float32)
            check(p.shape == (NUM_CLASSES, *VOLUME), f"shape {p.shape}")
            check(bool(np.isfinite(p).all()), "non-finite probabilities")
            s = p.sum(0)
            dev = float(np.abs(s[normal] - 1.0).max())
            tail = ~normal & ~zero
            print(f"[slice] volume {k + 1}: {ms:.1f} ms, "
                  f"{n_tiles * TTA / (ms / 1e3):.2f} patches/s, probs "
                  f"{probs.dtype}; max |sum_k p - 1| {dev:.2e} over the "
                  f"{int(normal.sum())} voxels of weight >= 2^-10; "
                  f"{int(tail.sum())} voxels of smaller weight reach "
                  f"{float(np.abs(s[tail] - 1.0).max()):.2e}; "
                  f"{int(zero.sum())} voxels of zero weight hold p = 0",
                  flush=True)
            check(dev <= PROB_SUM_ATOL, f"probs sum off by {dev}")
            check(bool((s[zero] == 0).all()),
                  "zero-weight voxels hold probabilities")
        ms_kernel = float(np.mean([ms for _, ms in outs]))

        # one patch: kernel path, plain path, float32 plain model. The plain
        # path swaps the plain version in for the fused op at its call site.
        x = torch.from_numpy(vols[1][0, :128, :128, :128, None]).cuda()[None]
        logits_k = apply_fn(x).float()
        launches_before_plain = fb.fused_shift_conv_block.launches
        model32 = ShiftUNetPlusPlus(
            input_channels=1, num_classes=NUM_CLASSES,
            pool_op_kernel_sizes=((2, 2, 2),) * 5, base_num_features=48,
            compute_dtype=torch.float32, device="cuda")
        model32.load_state_dict(model.state_dict())
        blocks.fused_shift_conv_block = fb.fused_shift_conv_block_ref
        try:
            logits_p = apply_fn(x).float()
            _, ms_plain = timed(vols[1])
            logits_32 = model32(x, do_ds=False)
        finally:
            blocks.fused_shift_conv_block = fb.fused_shift_conv_block
        del model32
        check(fb.fused_shift_conv_block.launches == launches_before_plain,
              "the plain path launched the kernel")
        check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
        d = (logits_k - logits_p).abs()
        agree = float((logits_k.argmax(-1) == logits_p.argmax(-1))
                      .float().mean())
        print(f"[slice] one 128^3 patch, kernel vs plain path: max "
              f"|dlogit| {float(d.max()):.4e} (mean {float(d.mean()):.3e}, "
              f"max |logit| {float(logits_p.abs().max()):.3f}), argmax "
              f"agreement {agree:.6f}", flush=True)
        errs = {}
        for name, lg in (("kernel", logits_k), ("plain", logits_p)):
            e = (lg - logits_32).abs()
            a32 = float((lg.argmax(-1) == logits_32.argmax(-1))
                        .float().mean())
            errs[name] = (float(e.mean()), a32)
            print(f"[slice]   {name} path vs float32 model: max |dlogit| "
                  f"{float(e.max()):.4e}, mean {float(e.mean()):.4e}, argmax "
                  f"agreement {a32:.6f}", flush=True)
        check(errs["kernel"][0] <= ERR_RATIO * errs["plain"][0],
              "kernel path further from the float32 model than the plain "
              "path")
        check(errs["kernel"][1] >= errs["plain"][1] - AGREE_SLACK,
              "kernel path argmax agreement with float32 below the plain "
              "path's")
    print(f"[slice] ms/volume: kernel path {ms_kernel:.1f} "
          f"({n_tiles * TTA / (ms_kernel / 1e3):.2f} patches/s), plain path "
          f"{ms_plain:.1f} ({n_tiles * TTA / (ms_plain / 1e3):.2f} "
          f"patches/s)  [{smi}]", flush=True)
    print(f"[report] kernel ms/plain_ms are per call at the l0_48+48_to48 "
          f"shape", flush=True)

    # ---- 5. report
    print(json.dumps({"kernels": [{
        "name": "fused_shift_conv_block", "route": "cuda",
        "source": "e2enet_tpu_torch/csrc/fused_block.cu",
        "replaces": "e2enet_tpu/ops/fused_block.py:85",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": headline["ms"], "plain_ms": headline["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
