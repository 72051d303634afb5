"""Network topology math (reference:
`nnunetv2/experiment_planning/experiment_planners/network_topology.py:30-105`).

Greedy per-axis pooling: pool every axis whose current feature-map edge is >= 2x the
minimum edge length AND whose current spacing is within 2x of the finest axis; conv
kernels start at 1 on coarse axes and become 3 once the axis spacing is within 2x of
the finest. Emits padded patch size divisible by 2**num_pool per axis.

This package's copy of ``nnuzoo_tpu/planning/topology.py``; the port imports nothing of
the JAX package.
"""

from copy import deepcopy
from typing import List, Tuple

import numpy as np


def get_shape_must_be_divisible_by(net_numpool_per_axis) -> np.ndarray:
    return 2 ** np.array(net_numpool_per_axis)


def pad_shape(shape, must_be_divisible_by) -> np.ndarray:
    """Round shape up to the next multiple of must_be_divisible_by (per axis)."""
    if not isinstance(must_be_divisible_by, (tuple, list, np.ndarray)):
        must_be_divisible_by = [must_be_divisible_by] * len(shape)
    assert len(must_be_divisible_by) == len(shape)
    new_shp = [shape[i] + must_be_divisible_by[i] - shape[i] % must_be_divisible_by[i]
               for i in range(len(shape))]
    for i in range(len(shape)):
        if shape[i] % must_be_divisible_by[i] == 0:
            new_shp[i] -= must_be_divisible_by[i]
    return np.array(new_shp).astype(int)


def get_pool_and_conv_props(spacing, patch_size, min_feature_map_size: int,
                            max_numpool: int
                            ) -> Tuple[List[int], List[List[int]], List[List[int]],
                                       np.ndarray, np.ndarray]:
    """Returns (num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes,
    padded_patch_size, shape_must_be_divisible_by)."""
    dim = len(spacing)
    current_spacing = list(deepcopy(spacing))
    current_size = list(deepcopy(patch_size))

    pool_op_kernel_sizes = [[1] * dim]
    conv_kernel_sizes = []
    num_pool_per_axis = [0] * dim
    kernel_size = [1] * dim

    while True:
        valid = [i for i in range(dim) if current_size[i] >= 2 * min_feature_map_size]
        if len(valid) < 1:
            break
        min_spacing_of_valid = min(current_spacing[i] for i in valid)
        valid = [i for i in valid if current_spacing[i] / min_spacing_of_valid < 2]
        valid = [i for i in valid if num_pool_per_axis[i] < max_numpool]

        if len(valid) == 1:
            if current_size[valid[0]] < 3 * min_feature_map_size:
                break
        if len(valid) < 1:
            break

        # conv kernels: 1 -> 3 once axis spacing is within 2x of the finest; sticky at 3
        for d in range(dim):
            if kernel_size[d] != 3 and current_spacing[d] / min(current_spacing) < 2:
                kernel_size[d] = 3

        pool_kernel_sizes = [1] * dim
        for v in valid:
            pool_kernel_sizes[v] = 2
            num_pool_per_axis[v] += 1
            current_spacing[v] *= 2
            current_size[v] = int(np.ceil(current_size[v] / 2))

        pool_op_kernel_sizes.append(pool_kernel_sizes)
        conv_kernel_sizes.append(deepcopy(kernel_size))

    must_be_divisible_by = get_shape_must_be_divisible_by(num_pool_per_axis)
    patch_size = pad_shape(patch_size, must_be_divisible_by)
    conv_kernel_sizes.append([3] * dim)  # bottleneck conv
    return (num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes, patch_size,
            must_be_divisible_by)
