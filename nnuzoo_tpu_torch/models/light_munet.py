"""LightMUNet / LightUMamba and LightSS2DMambaUNet (port of
``nnuzoo_tpu/models/light_munet.py``).

SegResNet-style encoder/decoder whose residual blocks run a Mamba over the
flattened spatial tokens (the axis order cycling from stage to stage) after
a GSC gated spatial conv; depthwise-separable convs throughout. The SS2D
variant swaps the token Mamba for SS2D's 4-direction cross-scan (2d only).

Channels-last (B, *spatial, C); 2d and 3d.
"""

import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from .layers import CONV, build_seeded, conv_cl, instance_norm_cl, max_pool, \
    resize_linear
from .mamba import Mamba2Block, MambaBlock
from .registry import register_model
from .ss2d import SS2D

_ORDERS_3D = ((0, 1, 2), (0, 2, 1), (2, 1, 0))
_ORDERS_2D = ((0, 1), (1, 0))


class DWConv(nn.Module):
    """Depthwise conv ("SAME", odd kernel) then a pointwise conv."""

    def __init__(self, in_ch: int, features: int, dim: int, kernel: int = 3,
                 use_bias: bool = False):
        super().__init__()
        self.depth = CONV[dim](in_ch, in_ch, kernel, padding=kernel // 2,
                               groups=in_ch, bias=use_bias)
        self.point = CONV[dim](in_ch, features, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_cl(self.point, conv_cl(self.depth, x))


def _instance_norm(c: int) -> nn.GroupNorm:
    """Per-channel GroupNorm without scale or bias (eps 1e-5)."""
    return nn.GroupNorm(c, c, eps=1e-5, affine=False)


def _group_norm(c: int) -> nn.GroupNorm:
    """flax's ``GroupNorm(num_groups=min(8, c))`` (eps 1e-6)."""
    return nn.GroupNorm(min(8, c), c, eps=1e-6)


def norm_cl(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """A GroupNorm over a channels-last tensor."""
    return norm(x.movedim(-1, 1)).movedim(1, -1)


class GSC(nn.Module):
    """Gated spatial conv."""

    def __init__(self, c: int, dim: int):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (_instance_norm(c) for _ in range(3))
        self.proj = DWConv(c, c, dim, 3, use_bias=True)
        self.proj2 = CONV[dim](c, c, 1)
        self.proj3 = DWConv(c, c, dim, 3, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = F.relu(self.proj(instance_norm_cl(self.norm1, x)))
        x2 = F.relu(conv_cl(self.proj2, instance_norm_cl(self.norm2, x)))
        x3 = F.relu(self.proj3(instance_norm_cl(self.norm3, x1 + x2)))
        return x3 + x


def mamba2_headdim(d_model: int, expand: int = 2) -> int:
    """The largest i < d_model*expand/8 with (d_model*expand / i) % 8 == 0
    (1 if there is none): Mamba2's head width in light_mamba2net."""
    nheaddim = 1
    for i in range(1, int(d_model * expand / 8)):
        if (d_model * expand / i) % 8 == 0:
            nheaddim = i
    return nheaddim


def _permutation(order: Optional[Sequence[int]], dim: int):
    """The permutation of a (B, *spatial, C) tensor that puts its spatial
    axes in ``order``, and its inverse; None for the identity."""
    if order is None or tuple(order) == tuple(range(dim)):
        return None
    inv = [0] * dim
    for i, o in enumerate(order):
        inv[o] = i
    return ((0,) + tuple(o + 1 for o in order) + (dim + 1,),
            (0,) + tuple(i + 1 for i in inv) + (dim + 1,))


class MambaLayer(nn.Module):
    """LN -> Mamba over the flattened tokens -> skip-scaled residual -> the
    same LN again -> Linear, the spatial axes taken in ``order``. With
    ``use_ss2d`` the mixer is an SS2D over the 2d map instead; with
    ``use_mamba2`` a Mamba2Block (d_state 16, :func:`mamba2_headdim`)."""

    def __init__(self, input_dim: int, output_dim: int, use_ss2d: bool = False,
                 use_mamba2: bool = False):
        super().__init__()
        self.use_ss2d = use_ss2d
        self.norm = nn.LayerNorm(input_dim, eps=1e-6)
        if use_ss2d:
            self.ss2d = SS2D(d_model=input_dim)
        elif use_mamba2:
            self.mamba = Mamba2Block(d_model=input_dim, d_state=16,
                                     headdim=mamba2_headdim(input_dim))
        else:
            self.mamba = MambaBlock(d_model=input_dim)
        self.skip_scale = nn.Parameter(torch.ones(1))
        self.proj = nn.Linear(input_dim, output_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.skip_scale.fill_(1.0)

    def forward(self, x: torch.Tensor,
                order: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        dim = x.dim() - 2
        perm = _permutation(order, dim)
        xp = x.permute(perm[0]) if perm is not None else x
        B, C, spatial = xp.shape[0], xp.shape[-1], xp.shape[1:-1]
        flat = xp.reshape(B, -1, C)
        normed = self.norm(flat)
        if self.use_ss2d:
            if dim != 2 or perm is not None:
                raise ValueError("the SS2D mixer takes a 2d map in its own order")
            mix = self.ss2d(normed.reshape(B, *spatial, C)).reshape(B, -1, C)
        else:
            mix = self.mamba(normed)
        out = self.proj(self.norm(mix + self.skip_scale * flat))
        out = out.reshape(B, *spatial, out.shape[-1])
        return out.permute(perm[1]) if perm is not None else out


class ResMambaBlock(nn.Module):
    def __init__(self, c: int, dim: int, order: Tuple[int, ...],
                 use_ss2d: bool = False, use_mamba2: bool = False):
        super().__init__()
        self.order = None if use_ss2d else tuple(order)
        self.gsc = GSC(c, dim)
        self.norm1, self.norm2 = _group_norm(c), _group_norm(c)
        self.mamba1 = MambaLayer(c, c, use_ss2d, use_mamba2)
        self.mamba2 = MambaLayer(c, c, use_ss2d, use_mamba2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.gsc(x)
        h = self.mamba1(F.relu(norm_cl(self.norm1, x)), self.order)
        h = self.mamba2(F.relu(norm_cl(self.norm2, h)), self.order)
        return h + x


class ResUpBlock(nn.Module):
    def __init__(self, c: int, dim: int):
        super().__init__()
        self.norm1, self.norm2 = _group_norm(c), _group_norm(c)
        self.conv = DWConv(c, c, dim, 3)
        self.skip_scale = nn.Parameter(torch.ones(1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.skip_scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(F.relu(norm_cl(self.norm1, x)))
        return F.relu(norm_cl(self.norm2, h + self.skip_scale * x))


class LightMUNet(nn.Module):
    """x (B, *patch, C) -> [logits], channels-last; no deep supervision (the
    reference trainer runs LightMUNet without it)."""

    def __init__(self, in_ch: int, num_classes: int, dim: int = 2,
                 init_filters: int = 32, blocks_down: Sequence[int] = (1, 2, 2, 4),
                 blocks_up: Sequence[int] = (1, 1, 1), use_ss2d: bool = False):
        super().__init__()
        if use_ss2d and dim != 2:
            raise ValueError("LightSS2DMambaUNet is 2D-only")
        self.dim, self.use_ss2d = dim, use_ss2d
        self.blocks_down, self.blocks_up = tuple(blocks_down), tuple(blocks_up)
        orders = _ORDERS_3D if dim == 3 else _ORDERS_2D
        self.orders = [orders[i % len(orders)] for i in range(len(blocks_down))]
        f = init_filters
        self.convInit = DWConv(in_ch, f, dim, 3)
        for i, n_blocks in enumerate(blocks_down):
            ch = f * 2 ** i
            if i > 0:
                self.add_module(f"down_mamba{i}",
                                MambaLayer(ch // 2, ch, use_ss2d))
            for b in range(n_blocks):
                self.add_module(f"down{i}_block{b}",
                                ResMambaBlock(ch, dim, self.orders[i], use_ss2d))
        ch = f * 2 ** (len(blocks_down) - 1)
        for i, n_blocks in enumerate(blocks_up):
            self.add_module(f"up_conv{i}", CONV[dim](ch, ch // 2, 1))
            ch //= 2
            for b in range(n_blocks):
                self.add_module(f"up{i}_block{b}", ResUpBlock(ch, dim))
        self.final_norm = _group_norm(ch)
        self.conv_final = DWConv(ch, num_classes, dim, 1, use_bias=True)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.convInit(x)
        skips = []
        for i, n_blocks in enumerate(self.blocks_down):
            if i > 0:
                x = getattr(self, f"down_mamba{i}")(
                    x, None if self.use_ss2d else self.orders[i])
                x = max_pool(x, 2, self.dim)
            for b in range(n_blocks):
                x = getattr(self, f"down{i}_block{b}")(x)
            skips.append(x)
        skips = skips[::-1]
        for i, n_blocks in enumerate(self.blocks_up):
            x = conv_cl(getattr(self, f"up_conv{i}"), x)
            x = resize_linear(x, skips[i + 1].shape[1:-1], self.dim) + skips[i + 1]
            for b in range(n_blocks):
                x = getattr(self, f"up{i}_block{b}")(x)
        x = F.relu(norm_cl(self.final_norm, x))
        return [self.conv_final(x)]


def get_light_munet_from_plans(plans_manager, dataset_json, configuration_manager,
                               num_input_channels, deep_supervision=False,
                               device="cuda", seed: int = 0,
                               use_ss2d: bool = False, **kwargs):
    """LightMUNet (LightSS2DMambaUNet with ``use_ss2d``, 2d only) for the
    configuration's patch dimension, fp32, with weights drawn from ``seed``
    on the CPU and moved to ``device``. ``deep_supervision`` is ignored (the
    model has one output); ``kwargs`` (``init_filters``, ``blocks_down``,
    ``blocks_up``) shrink it."""
    dev = resolve_device(device)
    label_manager = plans_manager.get_label_manager(dataset_json)
    dim = len(configuration_manager.patch_size)
    return build_seeded(functools.partial(
        LightMUNet, num_input_channels, label_manager.num_segmentation_heads,
        dim, use_ss2d=use_ss2d, **kwargs), dev, seed)


register_model("nnUNetTrainerLightMUNet", get_light_munet_from_plans)
register_model("nnUNetTrainerLightSS2DMambaUNet",
               functools.partial(get_light_munet_from_plans, use_ss2d=True))
