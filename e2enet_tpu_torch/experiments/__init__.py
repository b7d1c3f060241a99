"""The port's counterparts of the repository's top-level `experiments/`
scripts that reach a TPU kernel: each module holds the library functions of
one experiment, a hand-written CUDA kernel behind each (csrc/, bound in
ops/_native.py) with its plain torch version beside it, and `main(argv)`,
which repeats the experiment on the card:

    python -m e2enet_tpu_torch.experiments.shift_conv        # #11
    python -m e2enet_tpu_torch.experiments.ring_phases       # #11's phases
    python -m e2enet_tpu_torch.experiments.exp_cf_fused [--v2]  # #12
    python -m e2enet_tpu_torch.experiments.exp_pipeline_fwd  # #13
    python -m e2enet_tpu_torch.experiments.exp_int8_mma      # #14

A `main` runs on the card only: without CUDA it raises SystemExit. The
library functions take the plain version for CPU tensors, as every wrapper
of the port does. None of these kernels is on the serving or training path.
"""
import subprocess
from typing import Callable

import torch


def require_cuda(prog: str) -> torch.device:
    """The card, or SystemExit: an experiment measures the card and never
    falls back to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device; this experiment runs on "
                         f"the card only")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them (or the
    name alone where nvidia-smi is missing)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[0]
    except OSError:
        pass
    return torch.cuda.get_device_name(0)


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean ms of fn over `reps` back-to-back calls on the current stream
    between two CUDA events, after one warm-up call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
