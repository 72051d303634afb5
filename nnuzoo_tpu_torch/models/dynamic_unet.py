"""Plans-driven dynamic U-Nets (port of ``nnuzoo_tpu/models/dynamic_unet.py``):
PlainConvUNet and ResidualEncoderUNet, the networks that the planner writes
into every plan (``architecture.arch_kwargs``: n_stages, features_per_stage,
kernel_sizes, strides, n_conv_per_stage(_decoder), n_blocks_per_stage), for
2d and 3d patches.

Channels-last in and out. The forward returns the deep-supervision logits,
highest resolution first, at the encoder's skip resolutions (only the
full-resolution head without deep supervision, see ``UNetDecoder``).
Submodule names are the
flax names (``encoder.stage{s}.conv{i}``, ``encoder.stage{s}_block{b}``,
``decoder.up{i}.transpconv``, ``decoder.dec{i}``, ``decoder.seg{i}``), so
``convert.py`` maps the JAX package's parameters by name.

The JAX package's ``remat`` option (set only by a benchmark script) is not
ported.
"""

from typing import Any, Dict, List, Sequence

import torch
import torch.nn as nn

from .layers import CONV, ResidualBlock, StackedConvBlocks, TransposedConvUp, \
    conv_cl


def arch_dim(arch_kwargs: Dict[str, Any]) -> int:
    """The spatial dimension of a plan's architecture."""
    first = arch_kwargs["strides"][0]
    return len(first) if isinstance(first, (list, tuple)) \
        else len(arch_kwargs["kernel_sizes"][0])


class PlainConvEncoder(nn.Module):
    def __init__(self, in_ch: int, n_stages: int, features_per_stage: Sequence[int],
                 kernel_sizes, strides, n_conv_per_stage: Sequence[int], dim: int):
        super().__init__()
        for s in range(n_stages):
            self.add_module(f"stage{s}", StackedConvBlocks(
                n_conv_per_stage[s], in_ch, features_per_stage[s], kernel_sizes[s],
                strides[s], dim))
            in_ch = features_per_stage[s]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        skips = []
        for stage in self.children():
            x = stage(x)
            skips.append(x)
        return skips


class ResidualEncoder(nn.Module):
    def __init__(self, in_ch: int, n_stages: int, features_per_stage: Sequence[int],
                 kernel_sizes, strides, n_blocks_per_stage: Sequence[int], dim: int):
        super().__init__()
        self.n_blocks_per_stage = list(n_blocks_per_stage[:n_stages])
        for s in range(n_stages):
            for b in range(n_blocks_per_stage[s]):
                self.add_module(f"stage{s}_block{b}", ResidualBlock(
                    in_ch, features_per_stage[s], kernel_sizes[s],
                    strides[s] if b == 0 else 1, dim))
                in_ch = features_per_stage[s]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        blocks = iter(self.children())
        skips = []
        for n in self.n_blocks_per_stage:
            for _ in range(n):
                x = next(blocks)(x)
            skips.append(x)
        return skips


class UNetDecoder(nn.Module):
    """Up by a transposed conv, concatenate the skip, a stack of convs, and a
    1x1 head at every level. Without deep supervision only the last head
    runs; the others are kept, as the original's decoder keeps them, so that
    a model built for inference loads the weights trained with deep
    supervision (the JAX package's module leaves them out, and flax ignores
    the extra parameters)."""

    def __init__(self, features_per_stage: Sequence[int], kernel_sizes, strides,
                 n_conv_per_stage_decoder: Sequence[int], num_classes: int,
                 dim: int, deep_supervision: bool = True):
        super().__init__()
        n_stages = len(features_per_stage)
        self.deep_supervision = deep_supervision
        self.levels = n_stages - 1
        for i, s in enumerate(range(n_stages - 2, -1, -1)):
            self.add_module(f"up{i}", TransposedConvUp(
                features_per_stage[s + 1], features_per_stage[s], strides[s + 1],
                dim))
            self.add_module(f"dec{i}", StackedConvBlocks(
                n_conv_per_stage_decoder[i], 2 * features_per_stage[s],
                features_per_stage[s], kernel_sizes[s], 1, dim))
            self.add_module(f"seg{i}", CONV[dim](features_per_stage[s],
                                                 num_classes, 1))

    def forward(self, skips: List[torch.Tensor]) -> List[torch.Tensor]:
        x = skips[-1]
        seg_outputs = []
        for i in range(self.levels):
            x = getattr(self, f"up{i}")(x)
            x = getattr(self, f"dec{i}")(torch.cat([x, skips[-2 - i]], -1))
            if self.deep_supervision or i == self.levels - 1:
                seg_outputs.append(conv_cl(getattr(self, f"seg{i}"), x))
        return seg_outputs[::-1]        # highest resolution first


class PlainConvUNet(nn.Module):
    """x (B, *patch, C) -> deep-supervision logits, channels-last."""

    def __init__(self, in_ch: int, arch_kwargs: Dict[str, Any], num_classes: int,
                 deep_supervision: bool = True):
        super().__init__()
        kw = arch_kwargs
        dim = arch_dim(kw)
        self.encoder = PlainConvEncoder(
            in_ch, kw["n_stages"], kw["features_per_stage"], kw["kernel_sizes"],
            kw["strides"], kw["n_conv_per_stage"], dim)
        self.decoder = UNetDecoder(
            kw["features_per_stage"], kw["kernel_sizes"], kw["strides"],
            kw["n_conv_per_stage_decoder"], num_classes, dim, deep_supervision)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.decoder(self.encoder(x))


class ResidualEncoderUNet(nn.Module):
    """PlainConvUNet with residual blocks in the encoder
    (``n_blocks_per_stage``, else ``n_conv_per_stage``, blocks a stage)."""

    def __init__(self, in_ch: int, arch_kwargs: Dict[str, Any], num_classes: int,
                 deep_supervision: bool = True):
        super().__init__()
        kw = arch_kwargs
        dim = arch_dim(kw)
        self.encoder = ResidualEncoder(
            in_ch, kw["n_stages"], kw["features_per_stage"], kw["kernel_sizes"],
            kw["strides"], kw.get("n_blocks_per_stage", kw.get("n_conv_per_stage")),
            dim)
        self.decoder = UNetDecoder(
            kw["features_per_stage"], kw["kernel_sizes"], kw["strides"],
            kw["n_conv_per_stage_decoder"], num_classes, dim, deep_supervision)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.decoder(self.encoder(x))
