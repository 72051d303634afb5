"""SegMamba (port of ``nnuzoo_tpu/models/seg_mamba.py``).

A conv-stem 4-stage encoder (stride-2 stem, stride-2 downsamples); each
stage is a GSC gated conv, then trimodal MambaLayers (forward, backward and
slice-major scans over the flattened tokens), then a channel MLP; a
UNETR-style residual conv decoder. 2d and 3d, channels-last.
"""

import functools
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from .layers import CONV, build_seeded, conv_cl, conv_same, instance_norm_cl
from .light_munet import GSC, _instance_norm
from .mamba import MambaBlock
from .registry import register_model
from .unetr import UnetrBasicBlock, UnetrUpBlock

NUM_SLICES = (64, 32, 16, 8)


class MambaLayer3Way(nn.Module):
    """LN -> trimodal Mamba over the flattened tokens -> residual. The
    slice-major branch groups the tokens in ``num_slices`` slices, halved
    until they divide the length."""

    def __init__(self, c: int, num_slices: int):
        super().__init__()
        self.num_slices = num_slices
        self.norm = nn.LayerNorm(c, eps=1e-6)
        self.mamba = MambaBlock(d_model=c, bimamba_type="v3", nslices=num_slices)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        flat = x.reshape(B, -1, C)
        L, ns = flat.shape[1], self.num_slices
        while L % ns != 0 and ns > 1:
            ns //= 2
        h = self.mamba(self.norm(flat), nslices=ns)
        return (flat + h).reshape(x.shape)


class MlpChannel(nn.Module):
    """1x1 conv -> exact GELU -> 1x1 conv."""

    def __init__(self, c: int, hidden: int, dim: int):
        super().__init__()
        self.fc1 = CONV[dim](c, hidden, 1)
        self.fc2 = CONV[dim](hidden, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_cl(self.fc2, F.gelu(conv_cl(self.fc1, x)))


class MambaEncoder(nn.Module):
    def __init__(self, in_ch: int, dim: int, depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (48, 96, 192, 384)):
        super().__init__()
        self.depths = tuple(depths)
        self.stem = CONV[dim](in_ch, dims[0], 7, stride=2)
        for i in range(4):
            if i > 0:
                self.add_module(f"down_norm{i}", _instance_norm(dims[i - 1]))
                self.add_module(f"down{i}", CONV[dim](dims[i - 1], dims[i], 2,
                                                      stride=2))
            self.add_module(f"gsc{i}", GSC(dims[i], dim))
            for d in range(depths[i]):
                self.add_module(f"stage{i}_block{d}",
                                MambaLayer3Way(dims[i], NUM_SLICES[i]))
            self.add_module(f"out_norm{i}", _instance_norm(dims[i]))
            self.add_module(f"mlp{i}", MlpChannel(dims[i], 2 * dims[i], dim))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i in range(4):
            if i == 0:
                x = conv_same(self.stem, x)
            else:
                x = instance_norm_cl(getattr(self, f"down_norm{i}"), x)
                x = conv_same(getattr(self, f"down{i}"), x)
            x = getattr(self, f"gsc{i}")(x)
            for d in range(self.depths[i]):
                x = getattr(self, f"stage{i}_block{d}")(x)
            out = instance_norm_cl(getattr(self, f"out_norm{i}"), x)
            outs.append(getattr(self, f"mlp{i}")(out))
        return outs


class SegMamba(nn.Module):
    """x (B, *patch, C) -> [logits], channels-last, no deep supervision."""

    def __init__(self, in_ch: int, num_classes: int, dim: int = 2,
                 feat_size: Sequence[int] = (48, 96, 192, 384),
                 hidden_size: int = 768):
        super().__init__()
        f = tuple(feat_size)
        self.vit = MambaEncoder(in_ch, dim, dims=f)
        self.encoder1 = UnetrBasicBlock(in_ch, f[0], dim)
        self.encoder2 = UnetrBasicBlock(f[0], f[1], dim)
        self.encoder3 = UnetrBasicBlock(f[1], f[2], dim)
        self.encoder4 = UnetrBasicBlock(f[2], f[3], dim)
        self.encoder5 = UnetrBasicBlock(f[3], hidden_size, dim)
        self.decoder5 = UnetrUpBlock(hidden_size, f[3], f[3], dim)
        self.decoder4 = UnetrUpBlock(f[3], f[2], f[2], dim)
        self.decoder3 = UnetrUpBlock(f[2], f[1], f[1], dim)
        self.decoder2 = UnetrUpBlock(f[1], f[0], f[0], dim)
        self.decoder1 = UnetrBasicBlock(f[0], f[0], dim)
        self.out = CONV[dim](f[0], num_classes, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = self.vit(x)
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(feats[0])
        enc3 = self.encoder3(feats[1])
        enc4 = self.encoder4(feats[2])
        enc_hidden = self.encoder5(feats[3])
        d3 = self.decoder5(enc_hidden, enc4)
        d2 = self.decoder4(d3, enc3)
        d1 = self.decoder3(d2, enc2)
        d0 = self.decoder2(d1, enc1)
        return [conv_cl(self.out, self.decoder1(d0))]


def get_segmamba_from_plans(plans_manager, dataset_json, configuration_manager,
                            num_input_channels, deep_supervision=False,
                            device="cuda", seed: int = 0, **kwargs):
    """SegMamba for the configuration's patch dimension, fp32, with weights
    drawn from ``seed`` on the CPU and moved to ``device``.
    ``deep_supervision`` is ignored (one output); ``kwargs`` (``feat_size``,
    ``hidden_size``) shrink it."""
    dev = resolve_device(device)
    label_manager = plans_manager.get_label_manager(dataset_json)
    dim = len(configuration_manager.patch_size)
    return build_seeded(functools.partial(
        SegMamba, num_input_channels, label_manager.num_segmentation_heads, dim,
        **kwargs), dev, seed)


register_model("nnUNetTrainerSegMamba", get_segmamba_from_plans)
