"""Pool/conv network-topology solver.

Decides, per downsampling stage, which axes get pooled (stride-2) and which
conv kernels shrink to 1 on out-of-spacing-range axes (pseudo-2D convs for
anisotropic data), plus the padded patch size and divisibility constraint.

Parity: reference e2enet/experiment_planning/common_utils.py:89-154
(`get_pool_and_conv_props`, the solver used by ExperimentPlanner3D_v21),
plus get_shape_must_be_divisible_by / pad_shape / get_network_numpool
(common_utils.py:232-267).

The port's own copy of e2enet_tpu/planning/topology.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
from copy import deepcopy
from typing import List, Sequence, Tuple

import numpy as np


def get_pool_and_conv_props(spacing: Sequence[float],
                            patch_size: Sequence[int],
                            min_feature_map_size: int,
                            max_numpool: int,
                            ) -> Tuple[List[int], List[List[int]],
                                       List[List[int]], np.ndarray,
                                       np.ndarray]:
    """Greedy spacing-aware pooling plan.

    Per iteration: pool (stride 2) every axis whose current spacing is within
    2x of the finest axis AND whose current size still allows halving without
    dropping under 2*min_feature_map_size; conv kernels are 3 on the largest
    set of axes with mutually-within-2x spacings, 1 elsewhere.

    Returns (num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes,
             padded_patch_size, must_be_divisible_by).
    """
    dim = len(spacing)
    current_spacing = deepcopy(list(spacing))
    current_size = deepcopy(list(patch_size))

    pool_op_kernel_sizes = []
    conv_kernel_sizes = []
    num_pool_per_axis = [0] * dim

    while True:
        min_spacing = min(current_spacing)
        valid_axes_for_pool = [i for i in range(dim)
                               if current_spacing[i] / min_spacing < 2]
        # conv kernel: 3 on the largest clique of axes with spacings mutually
        # within a factor of 2, 1 on the rest
        axes = []
        for a in range(dim):
            my_spacing = current_spacing[a]
            partners = [i for i in range(dim)
                        if current_spacing[i] / my_spacing < 2
                        and my_spacing / current_spacing[i] < 2]
            if len(partners) > len(axes):
                axes = partners
        conv_kernel_size = [3 if i in axes else 1 for i in range(dim)]

        valid_axes_for_pool = [i for i in valid_axes_for_pool
                               if current_size[i] >= 2 * min_feature_map_size]
        valid_axes_for_pool = [i for i in valid_axes_for_pool
                               if num_pool_per_axis[i] < max_numpool]
        if len(valid_axes_for_pool) == 0:
            break

        other_axes = [i for i in range(dim) if i not in valid_axes_for_pool]
        pool_kernel_sizes = [0] * dim
        for v in valid_axes_for_pool:
            pool_kernel_sizes[v] = 2
            num_pool_per_axis[v] += 1
            current_spacing[v] *= 2
            current_size[v] = np.ceil(current_size[v] / 2)
        for nv in other_axes:
            pool_kernel_sizes[nv] = 1

        pool_op_kernel_sizes.append(pool_kernel_sizes)
        conv_kernel_sizes.append(conv_kernel_size)

    must_be_divisible_by = get_shape_must_be_divisible_by(num_pool_per_axis)
    patch_size = pad_shape(patch_size, must_be_divisible_by)

    # one more conv kernel for the bottleneck (always full 3s)
    conv_kernel_sizes.append([3] * dim)
    return (num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes,
            patch_size, must_be_divisible_by)


def get_shape_must_be_divisible_by(net_numpool_per_axis):
    return 2 ** np.array(net_numpool_per_axis)


def pad_shape(shape, must_be_divisible_by):
    """Round every axis UP to the next multiple of must_be_divisible_by
    (axes already divisible stay unchanged)."""
    if not isinstance(must_be_divisible_by, (tuple, list, np.ndarray)):
        must_be_divisible_by = [must_be_divisible_by] * len(shape)
    else:
        assert len(must_be_divisible_by) == len(shape)
    new_shp = [shape[i] + must_be_divisible_by[i]
               - shape[i] % must_be_divisible_by[i] for i in range(len(shape))]
    for i in range(len(shape)):
        if shape[i] % must_be_divisible_by[i] == 0:
            new_shp[i] -= must_be_divisible_by[i]
    return np.array(new_shp).astype(int)


def get_network_numpool(patch_size, maxpool_cap=999, min_feature_map_size=4):
    network_numpool_per_axis = np.floor(
        [np.log(i / min_feature_map_size) / np.log(2)
         for i in patch_size]).astype(int)
    return [min(i, maxpool_cap) for i in network_numpool_per_axis]
