"""UNETR (port of ``nnuzoo_tpu/models/unetr.py``): a ViT-B encoder whose
hidden states, tapped at evenly spaced layers, feed a residual conv decoder
(UNETR, Hatamizadeh et al.). Its residual conv blocks are also what SegMamba,
SwinUMamba and SwinUNETR decode with. Channels-last, 2d and 3d.
"""

import functools
from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

from .._device import resolve_device
from .attention import ViTBlock, trunc_normal_02_
from .layers import CONV, ConvNormAct, TransposedConvUp, build_seeded, conv_cl, \
    conv_same
from .registry import register_model


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


class UnetrPrUpBlock(nn.Module):
    """``num_upsamples`` times: a stride-2 transposed conv, then a 3x3
    ConvNormAct (a ViT feature map brought up progressively)."""

    def __init__(self, in_ch: int, features: int, num_upsamples: int, dim: int):
        super().__init__()
        self.num_upsamples = num_upsamples
        for i in range(num_upsamples):
            self.add_module(f"up{i}", TransposedConvUp(
                in_ch if i == 0 else features, features, 2, dim))
            self.add_module(f"conv{i}", ConvNormAct(features, features, 3, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_upsamples):
            x = getattr(self, f"conv{i}")(getattr(self, f"up{i}")(x))
        return x


class UNETR(nn.Module):
    """x (B, *patch_size, C) -> [logits], channels-last, no deep
    supervision. The learned position embedding has one row per patch
    token, so the model is built for ``patch_size`` (each extent a
    multiple of ``patch``)."""

    def __init__(self, in_ch: int, num_classes: int, patch_size: Sequence[int],
                 feature_size: int = 16, hidden_size: int = 768,
                 mlp_dim: int = 3072, num_heads: int = 12, num_layers: int = 12,
                 patch: int = 16):
        super().__init__()
        dim = len(patch_size)
        self.feat_size = tuple(s // patch for s in patch_size)
        self.hidden_size = hidden_size
        self.patch_embed = CONV[dim](in_ch, hidden_size, patch, stride=patch)
        self.pos_embed = nn.Parameter(torch.empty(
            1, int(np.prod(self.feat_size)), hidden_size))
        self.taps = [int(i) for i in np.linspace(num_layers // 4, num_layers - 1, 3)]
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"vit{i}", ViTBlock(hidden_size, num_heads,
                                                mlp_ratio=mlp_dim / hidden_size))
        f = feature_size
        self.encoder1 = UnetrBasicBlock(in_ch, f, dim)
        self.encoder2 = UnetrPrUpBlock(hidden_size, 2 * f, 3, dim)
        self.encoder3 = UnetrPrUpBlock(hidden_size, 4 * f, 2, dim)
        self.encoder4 = UnetrPrUpBlock(hidden_size, 8 * f, 1, dim)
        self.decoder5 = UnetrUpBlock(hidden_size, 8 * f, 8 * f, dim)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f, 4 * f, dim)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f, 2 * f, dim)
        self.decoder2 = UnetrUpBlock(2 * f, f, f, dim)
        self.out = CONV[dim](f, num_classes, 1)

    def reset_parameters(self, generator=None) -> None:
        trunc_normal_02_(self.pos_embed, generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        B = x.shape[0]
        tokens = conv_same(self.patch_embed, x).reshape(B, -1, self.hidden_size)
        tokens = tokens + self.pos_embed
        hidden = {}
        for i in range(self.num_layers):
            tokens = getattr(self, f"vit{i}")(tokens)
            if i in self.taps:
                hidden[i] = tokens

        def to_map(t):
            return t.reshape(B, *self.feat_size, self.hidden_size)

        enc1 = self.encoder1(x)
        enc2 = self.encoder2(to_map(hidden[self.taps[0]]))
        enc3 = self.encoder3(to_map(hidden[self.taps[1]]))
        enc4 = self.encoder4(to_map(hidden[self.taps[2]]))
        dec3 = self.decoder5(to_map(tokens), enc4)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        return [conv_cl(self.out, self.decoder2(dec1, enc1))]


def get_unetr_from_plans(plans_manager, dataset_json, configuration_manager,
                         num_input_channels, deep_supervision=False,
                         device="cuda", seed: int = 0, **kwargs):
    """UNETR (ViT-B, patch 16, feature size 16) for the configuration's
    patch, 2d or 3d, fp32, with weights drawn from ``seed`` on the CPU and
    moved to ``device``. ``deep_supervision`` is ignored (one output);
    ``kwargs`` (``hidden_size``, ``mlp_dim``, ``num_heads``, ``num_layers``,
    ``feature_size``) shrink it."""
    dev = resolve_device(device)
    label_manager = plans_manager.get_label_manager(dataset_json)
    return build_seeded(functools.partial(
        UNETR, num_input_channels, label_manager.num_segmentation_heads,
        tuple(configuration_manager.patch_size), **kwargs), dev, seed)


register_model("nnUNetTrainerUNETR", get_unetr_from_plans)
