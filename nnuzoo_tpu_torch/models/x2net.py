"""The X²Net family's N-d patch operations (port of
``nnuzoo_tpu/models/x2net.py``; so far :class:`PatchMergingND`, which
SwinUNETR and LM2Net merge with, and :class:`PatchExpandND`, LM2Net's
decoder step). Channels-last."""

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


class PatchExpandND(nn.Module):
    """Depth-to-space with a per-axis scale vector. Without ``output_dim`` a
    Linear (no bias) first widens ``input_dim`` to 2*input_dim, which the
    depth-to-space splits into 2*input_dim / prod(scales) channels; with it
    the depth-to-space splits the input's channels and a Linear (no bias)
    then makes ``output_dim``. A LayerNorm ends both. The split channels are
    ordered (scale offsets row-major, then channel), as PatchMergingND
    merges them."""

    def __init__(self, input_dim: int, scales: Sequence[int],
                 output_dim: Optional[int] = None):
        super().__init__()
        self.scales = tuple(int(s) for s in scales)
        prod = math.prod(self.scales)
        self.output_dim = output_dim
        wide = input_dim if output_dim is not None else 2 * input_dim
        if wide % prod:
            raise ValueError(f"PatchExpandND: channels {wide} must be divisible "
                             f"by the scale product {prod} (scales {self.scales})")
        self.c_out = wide // prod
        if output_dim is None:
            self.expand = nn.Linear(input_dim, wide, bias=False)
            self.norm = nn.LayerNorm(self.c_out, eps=1e-6)
        else:
            self.expand = nn.Linear(self.c_out, output_dim, bias=False)
            self.norm = nn.LayerNorm(output_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = len(self.scales)
        B, spatial = x.shape[0], x.shape[1:-1]
        if self.output_dim is None:
            x = self.expand(x)
        x = x.reshape(B, *spatial, *self.scales, self.c_out)
        # (B, s0.., sc0.., c) -> (B, s0, sc0, s1, sc1, .., c)
        perm = [0]
        for i in range(dims):
            perm += [1 + i, 1 + dims + i]
        x = x.permute(perm + [1 + 2 * dims]).reshape(
            B, *(s * sc for s, sc in zip(spatial, self.scales)), self.c_out)
        if self.output_dim is not None:
            x = self.expand(x)
        return self.norm(x)
