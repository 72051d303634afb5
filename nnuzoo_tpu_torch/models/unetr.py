"""UNETR's residual conv blocks (port of the blocks of
``nnuzoo_tpu/models/unetr.py`` that SegMamba and SwinUMamba decode with).
Channels-last, 2d and 3d. ``UnetrPrUpBlock`` and ``UNETR`` itself come with
the attention models."""

import torch
import torch.nn as nn

from .layers import ConvNormAct, TransposedConvUp


class UnetrBasicBlock(nn.Module):
    """Two 3x3 ConvNormAct plus the input (through a 1x1 ConvNormAct where the
    width changes)."""

    def __init__(self, in_ch: int, features: int, dim: int):
        super().__init__()
        self.conv1 = ConvNormAct(in_ch, features, 3, 1, dim)
        self.conv2 = ConvNormAct(features, features, 3, 1, dim)
        self.skip = ConvNormAct(in_ch, features, 1, 1, dim) \
            if in_ch != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.conv1(x))
        return h + (self.skip(x) if self.skip is not None else x)


class UnetrUpBlock(nn.Module):
    """A stride-2 transposed conv, the skip concatenated, then a
    :class:`UnetrBasicBlock`."""

    def __init__(self, in_ch: int, skip_ch: int, features: int, dim: int):
        super().__init__()
        self.up = TransposedConvUp(in_ch, features, 2, dim)
        self.block = UnetrBasicBlock(features + skip_ch, features, dim)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.block(torch.cat([self.up(x), skip], dim=-1))
