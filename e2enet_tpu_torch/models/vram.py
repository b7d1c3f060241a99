"""Activation-memory proxy used by the experiment planner.

Parity: Generic_UNet.compute_approx_vram_consumption
(e2enet/network_architecture/generic_UNet.py:~216, identical math in
unetpp_d.py:552-591) plus the class constants the planner reads
(generic_UNet.py:202-216).

The port's own copy of e2enet_tpu/models/vram.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
import numpy as np

DEFAULT_BATCH_SIZE_3D = 2
BASE_NUM_FEATURES_3D = 30
MAX_NUM_FILTERS_3D = 320
MAX_NUMPOOL_3D = 999
use_this_for_batch_size_computation_3D = 520000000  # VRAM reference budget


def compute_approx_vram_consumption(patch_size, num_pool_per_axis,
                                    base_num_features, max_num_features,
                                    num_modalities, num_classes,
                                    pool_op_kernel_sizes,
                                    deep_supervision=False, conv_per_stage=2):
    if not isinstance(num_pool_per_axis, np.ndarray):
        num_pool_per_axis = np.array(num_pool_per_axis)

    npool = len(pool_op_kernel_sizes)
    map_size = np.array(patch_size)
    tmp = np.int64((conv_per_stage * 2 + 1) * np.prod(map_size, dtype=np.int64)
                   * base_num_features
                   + num_modalities * np.prod(map_size, dtype=np.int64)
                   + num_classes * np.prod(map_size, dtype=np.int64))

    num_feat = base_num_features
    for p in range(npool):
        for pi in range(len(num_pool_per_axis)):
            map_size[pi] /= pool_op_kernel_sizes[p][pi]
        num_feat = min(num_feat * 2, max_num_features)
        # conv_per_stage both in encoder and decoder + 1 transposed conv,
        # except the bottleneck level
        num_blocks = (conv_per_stage * 2 + 1) if p < (npool - 1) else conv_per_stage
        tmp += num_blocks * np.prod(map_size, dtype=np.int64) * num_feat
        if deep_supervision and p < (npool - 2):
            tmp += np.prod(map_size, dtype=np.int64) * num_classes
    return tmp
