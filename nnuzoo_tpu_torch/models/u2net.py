"""U²-Net family (port of ``nnuzoo_tpu/models/u2net.py``): REBNCONV, the
RSU blocks (RSU7..RSU4 and the dilated RSU4F that M2Net and M2NetP use at
their two coarsest stages) and U2Net / U2NetP behind ``nnUNetTrainerU2Net``
and ``nnUNetTrainerU2NetP``.

The blocks work channels-first inside and take and return channels-last
tensors, as the rest of the port does. ``dim`` (2 or 3) is the patch's, as
in the JAX package."""

import functools
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from .layers import CONV, build_seeded, instance_norm_cf, resize_linear
from .registry import register_model


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def _cf(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _pool_cf(x: torch.Tensor) -> torch.Tensor:
    """2-window stride-2 max pool of (B, C, *spatial), flooring odd sizes."""
    return (F.max_pool1d, F.max_pool2d, F.max_pool3d)[x.dim() - 3](x, 2, 2)


def _up_cf(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Linear upsampling of (B, C, *spatial) to ``like``'s spatial size."""
    return _cf(resize_linear(_cl(x), like.shape[2:], x.dim() - 2))


class REBNCONV(nn.Module):
    """conv 3 (dilated, "SAME" padding) -> per-channel GroupNorm -> ReLU.

    The JAX package uses GroupNorm with group_size=1 and eps=1e-5 where the
    original used BatchNorm; that is GroupNorm with one group per channel."""

    def __init__(self, in_ch: int, features: int, dirate: int = 1, dim: int = 2):
        super().__init__()
        self.conv = CONV[dim](in_ch, features, 3, padding=dirate, dilation=dirate)
        self.norm = nn.GroupNorm(features, features, eps=1e-5)

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-first (B, C, *spatial) in and out."""
        return F.relu(instance_norm_cf(self.norm, self.conv(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-last (B, *spatial, C) in and out."""
        return _cl(self.forward_cf(_cf(x)))


class RSU(nn.Module):
    """RSU-L (L = ``levels``, 7 for RSU7 .. 4 for RSU4): an input conv to
    ``out_ch``, then an L-level U on ``mid_ch`` (max pools down, a dilated
    conv at the bottom, linear upsampling back), added to the input conv."""

    def __init__(self, in_ch: int, levels: int, mid_ch: int, out_ch: int,
                 dim: int = 2):
        super().__init__()
        self.levels = levels
        self.rebnconvin = REBNCONV(in_ch, out_ch, 1, dim)
        for i in range(levels - 1):
            self.add_module(f"enc{i + 1}",
                            REBNCONV(out_ch if i == 0 else mid_ch, mid_ch, 1, dim))
        self.bottom = REBNCONV(mid_ch, mid_ch, 2, dim)
        # every decoder conv stays at mid_ch but the last
        for i in range(levels - 2, 0, -1):
            self.add_module(f"dec{i}", REBNCONV(2 * mid_ch, mid_ch, 1, dim))
        self.dec0 = REBNCONV(2 * mid_ch, out_ch, 1, dim)

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin.forward_cf(x)
        enc = []
        hx = hxin
        for i in range(self.levels - 1):
            hx = getattr(self, f"enc{i + 1}").forward_cf(hx)
            enc.append(hx)
            if i < self.levels - 2:
                hx = _pool_cf(hx)
        hx = self.bottom.forward_cf(hx)
        for i in range(self.levels - 2, 0, -1):
            hx = getattr(self, f"dec{i}").forward_cf(torch.cat([hx, enc[i]], 1))
            hx = _up_cf(hx, enc[i - 1])
        return self.dec0.forward_cf(torch.cat([hx, enc[0]], 1)) + hxin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-last (B, *spatial, C) in and out."""
        return _cl(self.forward_cf(_cf(x)))


class RSU4F(nn.Module):
    """Dilated RSU without pooling: dilations 1, 2, 4, 8 down, 4, 2, 1 up."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int, dim: int = 2):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch, 1, dim)
        self.conv1 = REBNCONV(out_ch, mid_ch, 1, dim)
        self.conv2 = REBNCONV(mid_ch, mid_ch, 2, dim)
        self.conv3 = REBNCONV(mid_ch, mid_ch, 4, dim)
        self.conv4 = REBNCONV(mid_ch, mid_ch, 8, dim)
        self.conv3d = REBNCONV(2 * mid_ch, mid_ch, 4, dim)
        self.conv2d = REBNCONV(2 * mid_ch, mid_ch, 2, dim)
        self.conv1d = REBNCONV(2 * mid_ch, out_ch, 1, dim)

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin.forward_cf(x)
        hx1 = self.conv1.forward_cf(hxin)
        hx2 = self.conv2.forward_cf(hx1)
        hx3 = self.conv3.forward_cf(hx2)
        hx4 = self.conv4.forward_cf(hx3)
        hx3d = self.conv3d.forward_cf(torch.cat([hx4, hx3], 1))
        hx2d = self.conv2d.forward_cf(torch.cat([hx3d, hx2], 1))
        hx1d = self.conv1d.forward_cf(torch.cat([hx2d, hx1], 1))
        return hx1d + hxin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-last (B, *spatial, C) in and out."""
        return _cl(self.forward_cf(_cf(x)))


class U2Net(nn.Module):
    """x (B, *spatial, C) -> [d0, d1, ..., d6] (only [d0] without deep
    supervision), each (B, *spatial, num_classes) at full resolution: six
    RSU stages down (the last two RSU4F), five up, six side heads upsampled
    to full resolution and the fused d0. ``small`` is U2NetP (every stage
    64 wide, 16 inside); otherwise the stages widen from 64 to 512."""

    def __init__(self, in_ch: int, num_classes: int, small: bool = False,
                 deep_supervision: bool = True, dim: int = 2):
        super().__init__()
        if small:
            enc = [(7, 16, 64), (6, 16, 64), (5, 16, 64), (4, 16, 64)]
            f4, m4f = 64, 16
            dec = [(4, 16, 64), (5, 16, 64), (6, 16, 64), (7, 16, 64)]
        else:
            enc = [(7, 32, 64), (6, 32, 128), (5, 64, 256), (4, 128, 512)]
            f4, m4f = 512, 256
            dec = [(4, 128, 256), (5, 64, 128), (6, 32, 64), (7, 16, 64)]
        self.deep_supervision = deep_supervision
        ch = in_ch
        skips = []
        for i, (levels, mid, out) in enumerate(enc):
            self.add_module(f"stage{i + 1}", RSU(ch, levels, mid, out, dim))
            skips.append(out)
            ch = out
        self.stage5 = RSU4F(ch, m4f, f4, dim)
        self.stage6 = RSU4F(f4, m4f, f4, dim)
        self.stage5d = RSU4F(2 * f4, m4f, f4, dim)
        ch = f4
        side_ch = [f4]
        for i, (levels, mid, out) in enumerate(dec):
            self.add_module(f"stage{4 - i}d",
                            RSU(ch + skips[3 - i], levels, mid, out, dim))
            ch = out
            side_ch.append(out)
        # side heads d1 (finest) .. d6 on stage1d .. stage4d, stage5d, stage6
        for i, c in enumerate(side_ch[:0:-1] + [f4, f4]):
            self.add_module(f"side{i + 1}",
                            CONV[dim](c, num_classes, 3, padding=1))
        self.outconv = CONV[dim](6 * num_classes, num_classes, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = _cf(x)
        skips = []
        hx = x
        for i in range(4):
            hx = getattr(self, f"stage{i + 1}").forward_cf(hx)
            skips.append(hx)
            hx = _pool_cf(hx)
        hx5 = self.stage5.forward_cf(hx)
        hx6 = self.stage6.forward_cf(_pool_cf(hx5))
        hx = self.stage5d.forward_cf(torch.cat([_up_cf(hx6, hx5), hx5], 1))
        dec = [hx]
        for i in range(4):
            hx = _up_cf(hx, skips[3 - i])
            hx = getattr(self, f"stage{4 - i}d").forward_cf(
                torch.cat([hx, skips[3 - i]], 1))
            dec.append(hx)
        sides = []
        for i, f in enumerate([dec[4], dec[3], dec[2], dec[1], dec[0], hx6]):
            d = getattr(self, f"side{i + 1}")(f)
            sides.append(d if d.shape[2:] == x.shape[2:] else _up_cf(d, x))
        d0 = self.outconv(torch.cat(sides, 1))
        outs = [d0] + sides if self.deep_supervision else [d0]
        return [_cl(o) for o in outs]


def get_u2net_from_plans(plans_manager, dataset_json, configuration_manager,
                         num_input_channels, deep_supervision=True,
                         device="cuda", seed: int = 0, small: bool = False):
    """U2Net (U2NetP with ``small``) for the configuration's patch dimension,
    fp32, with weights drawn from ``seed`` (the JAX package's initialisers)
    on the CPU and moved to ``device``."""
    dev = resolve_device(device)
    label_manager = plans_manager.get_label_manager(dataset_json)
    return build_seeded(functools.partial(
        U2Net, num_input_channels, label_manager.num_segmentation_heads,
        small=small, deep_supervision=deep_supervision,
        dim=len(configuration_manager.patch_size)), dev, seed)


register_model("nnUNetTrainerU2Net", get_u2net_from_plans)
register_model("nnUNetTrainerU2NetP",
               functools.partial(get_u2net_from_plans, small=True))
