"""The X²Net family's N-d patch operations (port of
``nnuzoo_tpu/models/x2net.py``; so far :class:`PatchMergingND`, which
SwinUNETR merges with). Channels-last."""

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn


class PatchMergingND(nn.Module):
    """Space-to-depth with a per-axis scale vector + LN + Linear (no bias).
    An extent that the scale does not divide is truncated first; the
    merged channels are ordered (scale offsets row-major, then channel)."""

    def __init__(self, input_dim: int, scales: Sequence[int],
                 output_features: Optional[int] = None):
        super().__init__()
        self.scales = tuple(int(s) for s in scales)
        merged = input_dim * math.prod(self.scales)
        self.norm = nn.LayerNorm(merged, eps=1e-6)
        self.reduction = nn.Linear(merged, output_features or 2 * input_dim,
                                   bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = len(self.scales)
        B, C = x.shape[0], x.shape[-1]
        new = [s // sc for s, sc in zip(x.shape[1:-1], self.scales)]
        x = x[(slice(None),) + tuple(slice(0, n * sc)
                                     for n, sc in zip(new, self.scales))]
        shape = [B]
        for n, sc in zip(new, self.scales):
            shape += [n, sc]
        perm = [0] + [1 + 2 * i for i in range(dims)] + \
            [2 + 2 * i for i in range(dims)] + [1 + 2 * dims]
        x = x.reshape(*shape, C).permute(perm).reshape(
            B, *new, C * math.prod(self.scales))
        return self.reduction(self.norm(x))
