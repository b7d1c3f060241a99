"""Global configuration constants.

Parity: reference e2enet/configuration.py:3-5.

The port's own copy of e2enet_tpu/configuration.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
import os

# number of host worker threads/processes used by preprocessing & evaluation
default_num_threads = int(os.environ.get("E2ENET_TPU_NUM_THREADS",
                                         os.environ.get("nnUNet_def_n_proc", 4)))

# if the ratio of max(spacing)/min(spacing) exceeds this, resampling happens
# separately in-plane (spline) and along the low-res axis (nearest)
RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD = 3
