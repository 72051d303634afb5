"""Swin-Transformer U-Nets (port of ``nnuzoo_tpu/models/swt.py``).

- :class:`SwinTransformerUnet` ("SwT", Swin-Unet, 2d): patch embed 4,
  [SwinBlock x depth -> PatchMerging] encoder, a mirrored decoder of
  PatchExpand and skip concatenation, a channel-keeping 4x expand and a 1x1
  head without bias.
- :class:`SwinUNETR` (monai's SwinUNETR at feature size 48, 2d and 3d): a
  stride-2 conv patch embed, Swin stages with N-d windows and N-d patch
  merging, feeding a UNETR-style residual conv decoder.

Channels-last. The window blocks are built for the map each stage sees, so
both models are built for the plan's patch size.
"""

import functools
from typing import List, Sequence

import torch
import torch.nn as nn

from .._device import resolve_device
from .attention import SwinBlock, SwinBlockND
from .layers import CONV, build_seeded, conv_cl, conv_same, pad_to_match, \
    set_drop_path_generator
from .registry import register_model
from .unetr import UnetrBasicBlock, UnetrUpBlock
from .vssm import PatchEmbed2D, PatchExpand, PatchMerging2D, _depth_to_space
from .x2net import PatchMergingND


class SwinStage(nn.Module):
    """``depth`` :class:`SwinBlock` (``block0``..), every odd one shifted by
    half a window; ``drop_path`` holds each block's rate (0 past its end)."""

    block = SwinBlock

    def __init__(self, dim: int, depth: int, num_heads: int,
                 spatial: Sequence[int], window: int = 7,
                 drop_path: Sequence[float] = ()):
        super().__init__()
        for i in range(depth):
            self.add_module(f"block{i}", self.block(
                dim, num_heads, spatial, window,
                shift=0 if i % 2 == 0 else window // 2,
                drop_path=drop_path[i] if i < len(drop_path) else 0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class SwinStageND(SwinStage):
    """:class:`SwinStage` of :class:`SwinBlockND` (2d or 3d)."""

    block = SwinBlockND


class FinalPatchExpanding(nn.Module):
    """Linear(dim -> patch² · dim, no bias), depth-to-space, LN: keeps the
    channel count across the last upsample."""

    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.patch = patch
        self.expand = nn.Linear(dim, patch * patch * dim, bias=False)
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(_depth_to_space(self.expand(x), self.patch))


class SwinTransformerUnet(nn.Module):
    """Swin-Unet, x (B, H, W, C) -> [logits]. The skip of each decoder
    stage is the encoder stage's input; the upsampled map is cropped to the
    skip, then zero-padded where patch merging floored an odd extent; the
    expands come after each decoder stage. Drop path rises linearly over
    the encoder's blocks to ``drop_path_rate``; each decoder stage reuses
    its encoder stage's rates."""

    def __init__(self, in_ch: int, num_classes: int, patch_size: Sequence[int],
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 patch: int = 4, drop_path_rate: float = 0.1):
        super().__init__()
        self.n = n = len(depths)
        dims = [embed_dim * 2 ** i for i in range(n)]
        self.patch_embed = PatchEmbed2D(in_ch, patch, embed_dim)
        total = sum(depths)
        dpr = [drop_path_rate * j / max(1, total - 1) for j in range(total)]

        def stage_dpr(i):
            lo = sum(depths[:i])
            return tuple(dpr[lo:lo + depths[i]])

        spatial = [tuple(s // patch for s in patch_size)]
        for i in range(n - 1):
            spatial.append(tuple(s // 2 for s in spatial[-1]))
        for i, depth in enumerate(depths):
            self.add_module(f"enc{i}", SwinStage(dims[i], depth, num_heads[i],
                                                 spatial[i], window, stage_dpr(i)))
            if i < n - 1:
                self.add_module(f"down{i}", PatchMerging2D(dims[i], 2))
        self.first_expand = PatchExpand(dims[-1], 2)
        for i in range(n - 1):
            idx = n - 2 - i
            self.add_module(f"concat_back{i}", nn.Linear(2 * dims[idx], dims[idx]))
            self.add_module(f"dec{i}", SwinStage(dims[idx], depths[idx],
                                                 num_heads[idx], spatial[idx],
                                                 window, stage_dpr(idx)))
            if i < n - 2:
                self.add_module(f"expand{i}", PatchExpand(dims[idx], 2))
        self.norm_up = nn.LayerNorm(embed_dim, eps=1e-6)
        self.final_expand = FinalPatchExpanding(embed_dim, patch)
        self.head = nn.Conv2d(embed_dim, num_classes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        n = self.n
        h = self.patch_embed(x)
        skips = []
        for i in range(n):
            skips.append(h)
            h = getattr(self, f"enc{i}")(h)
            if i < n - 1:
                h = getattr(self, f"down{i}")(h)
        h = self.first_expand(h)
        for i in range(n - 1):
            skip = skips[n - 2 - i]
            h = pad_to_match(h[:, :skip.shape[1], :skip.shape[2]], skip.shape[1:-1])
            h = getattr(self, f"concat_back{i}")(torch.cat([h, skip], -1))
            h = getattr(self, f"dec{i}")(h)
            if i < n - 2:
                h = getattr(self, f"expand{i}")(h)
        h = self.final_expand(self.norm_up(h))
        return [conv_cl(self.head, h[:, :x.shape[1], :x.shape[2]])]


class SwinUNETR(nn.Module):
    """SwinUNETR, x (B, *patch_size, C) -> [logits], 2d or 3d: window 7 (7³
    at 3d) attention in the Swin stages, N-d patch merging between them,
    and residual conv blocks on the input and on each stage's output."""

    def __init__(self, in_ch: int, num_classes: int, patch_size: Sequence[int],
                 feature_size: int = 48, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7):
        super().__init__()
        sd = len(patch_size)
        self.n = n = len(depths)
        f = feature_size
        dims = [f * 2 ** i for i in range(4)]
        self.patch_embed_conv = CONV[sd](in_ch, f, 2, stride=2)
        self.patch_embed_norm = nn.LayerNorm(f, eps=1e-6)
        spatial = tuple(-(-s // 2) for s in patch_size)      # "SAME", stride 2
        for i, depth in enumerate(depths):
            self.add_module(f"swin{i}", SwinStageND(dims[i], depth, num_heads[i],
                                                    spatial, window))
            if i < n - 1:
                self.add_module(f"down{i}", PatchMergingND(dims[i], (2,) * sd,
                                                           dims[i + 1]))
                spatial = tuple(s // 2 for s in spatial)
        self.encoder0 = UnetrBasicBlock(in_ch, f, sd)
        self.encoder1 = UnetrBasicBlock(f, f, sd)
        self.encoder2 = UnetrBasicBlock(2 * f, 2 * f, sd)
        self.encoder3 = UnetrBasicBlock(4 * f, 4 * f, sd)
        self.encoder4 = UnetrBasicBlock(8 * f, 8 * f, sd)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f, 4 * f, sd)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f, 2 * f, sd)
        self.decoder2 = UnetrUpBlock(2 * f, f, f, sd)
        self.decoder1 = UnetrUpBlock(f, f, f, sd)
        self.out = CONV[sd](f, num_classes, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.patch_embed_norm(conv_same(self.patch_embed_conv, x))
        feats = []
        for i in range(self.n):
            h = getattr(self, f"swin{i}")(h)
            feats.append(h)
            if i < self.n - 1:
                h = getattr(self, f"down{i}")(h)
        enc0 = self.encoder0(x)
        enc1 = self.encoder1(feats[0])
        enc2 = self.encoder2(feats[1])
        enc3 = self.encoder3(feats[2])
        d = self.decoder4(self.encoder4(feats[3]), enc3)
        d = self.decoder3(d, enc2)
        d = self.decoder2(d, enc1)
        d = self.decoder1(d, enc0)
        return [conv_cl(self.out, d)]


def get_swt_from_plans(plans_manager, dataset_json, configuration_manager,
                       num_input_channels, deep_supervision=False,
                       device="cuda", seed: int = 0, **kwargs):
    """SwinTransformerUnet at the production setting (depths (2, 2, 9, 2),
    embed 96, heads (3, 6, 12, 24), window 7, patch 4) for a 2d
    configuration, fp32, with weights drawn from ``seed`` on the CPU and
    moved to ``device``; the DropPath modules share one generator on
    ``device``, seeded from ``seed``. ``deep_supervision`` is ignored (one
    output); ``kwargs`` override the settings."""
    dev = resolve_device(device)
    label_manager = plans_manager.get_label_manager(dataset_json)
    if len(configuration_manager.patch_size) != 2:
        raise ValueError("SwT is 2D-only")
    model = build_seeded(functools.partial(
        SwinTransformerUnet, num_input_channels,
        label_manager.num_segmentation_heads,
        tuple(configuration_manager.patch_size),
        **{"depths": (2, 2, 9, 2), **kwargs}), dev, seed)
    set_drop_path_generator(model, torch.Generator(device=dev).manual_seed(seed))
    return model


def get_swin_unetr_from_plans(plans_manager, dataset_json, configuration_manager,
                              num_input_channels, deep_supervision=False,
                              device="cuda", seed: int = 0, **kwargs):
    """SwinUNETR (feature size 48) for the configuration's patch, 2d or 3d,
    fp32, with weights drawn from ``seed`` on the CPU and moved to
    ``device``. ``deep_supervision`` is ignored (one output); ``kwargs``
    (``feature_size``, ``depths``, ``num_heads``) shrink it."""
    dev = resolve_device(device)
    label_manager = plans_manager.get_label_manager(dataset_json)
    return build_seeded(functools.partial(
        SwinUNETR, num_input_channels, label_manager.num_segmentation_heads,
        tuple(configuration_manager.patch_size), **kwargs), dev, seed)


register_model("nnUNetTrainerSwinTransformerUnet", get_swt_from_plans)
register_model("nnUNetTrainerSwUNETR", get_swin_unetr_from_plans)
