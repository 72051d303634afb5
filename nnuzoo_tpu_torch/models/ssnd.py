"""SSND: SS2D's cross scan generalised to N dimensions (port of
``nnuzoo_tpu/models/ssnd.py``).

Channels-last, 2d or 3d. The conv output is scanned in ``dim`` axis orders,
each forwards and backwards: K = 2*dim directions. 2d takes (h, w) and
(w, h), as SS2D does; 3d takes (z, h, w), (w, z, h) and (h, w, z). Each
direction is merged back with its own output, as the JAX package does (the
reference re-uses direction 1 for the third 3d order, an indexing slip).

The glues are SS2D's (:class:`ss2d.GluedScan`): "default" scans the K
directions in one :func:`selective_scan_blkd` call (K1/K2 on the card);
"fused" makes two :func:`cross_scan_fused` calls of G = dim streams, one
per traversal orientation (K3/K4 on the card), and raises where K3/K4 do
not take the widths (Dh = d_inner up to 256, dt rank up to 8).
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import CONV, conv_cl
from .ss2d import GluedScan

AXIS_ORDERS = {2: ((0, 1), (1, 0)), 3: ((0, 1, 2), (2, 0, 1), (1, 2, 0))}


class SSND(GluedScan):
    """x (B, *spatial, d_model) -> same shape; ``spatial_dims`` 2 or 3."""

    def __init__(self, d_model: int, spatial_dims: int = 3, d_state: int = 16,
                 d_conv: int = 3, expand: int = 2,
                 dt_rank: Optional[int] = None):
        if spatial_dims not in AXIS_ORDERS:
            raise ValueError(f"SSND takes spatial_dims 2 or 3, got {spatial_dims}")
        if d_conv % 2 == 0:
            raise ValueError("SSND takes an odd d_conv (symmetric SAME padding)")
        super().__init__(d_model, 2 * spatial_dims, d_state, expand, dt_rank)
        self.spatial_dims = spatial_dims
        d_inner = self.d_inner
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv = CONV[spatial_dims](d_inner, d_inner, d_conv,
                                       padding=d_conv // 2, groups=d_inner)
        self.add_scan_parameters()
        self.out_norm = nn.LayerNorm(d_inner, eps=1e-6)
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)
        self.read_glue()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dim, D = self.spatial_dims, self.d_inner
        B, spatial = x.shape[0], tuple(x.shape[1:-1])
        L = math.prod(spatial)
        xpart, z = self.in_proj(x).chunk(2, dim=-1)
        xc = F.silu(conv_cl(self.conv, xpart))
        orders = AXIS_ORDERS[dim]
        streams = [xc.permute((0,) + tuple(o + 1 for o in order) + (dim + 1,))
                   .reshape(B, L, D) for order in orders]
        # un-permute each axis order's output back to (z)hw and sum them
        y = 0
        for y_k, order in zip(self.scan_streams(streams), orders):
            inv = [order.index(i) for i in range(dim)]
            y_k = y_k.reshape(B, *(spatial[o] for o in order), D)
            y = y + y_k.permute((0,) + tuple(i + 1 for i in inv) + (dim + 1,))
        y = self.out_norm(y) * F.silu(z)
        return self.out_proj(y)
