"""LM2Net (AltM²Net) and LightMamba2Net, the X²Net hybrids on mini
LightMUNets (port of ``nnuzoo_tpu/models/lm2net.py``).

The outer network is U²Net's U of six stages: PatchMergingND between the
encoder stages, PatchExpandND and a concatenation in the decoder, a side
head at each stage's resolution and the fused d0 head. Each stage is a mini
LightMUNet (:class:`MiniLightMUNet`): a depthwise-separable convInit, one
ResMambaBlock a level (its token Mamba in the level's axis order: the "Alt"
direction alternation), conv-only ResUpBlocks, nearest upsampling with
additive skips and a GroupNorm + ReLU + dwconv head. LM2Net's minis mix
with Mamba (K1/K2 on the card) and its bottleneck stages are
depthwise-separable RSU4Fs (:class:`DWRSU4F`) around a fixed 2x ceil pool;
LightMamba2Net's mix with Mamba2 (``models/mamba.py:Mamba2Block``), take
two blocks a level below the first and use minis for the bottleneck too,
with a PatchMergingND / PatchExpandND at ``scales[4]``.

The stage scale plans (:func:`ref_get_scales`, :func:`ref_scale_value`) are
the reference's, floats included; they gate the minis' pooling. LM2NetP's
decoder stages 2d and 1d get stage 3's plan (the reference passes the wrong
resolution), which changes where those minis pool. A mini whose map does
not fit its plan pools odd extents down and meets its skips again through
the nearest resize at a non-integer ratio (:func:`layers.resize_nearest`,
JAX's rule).

Channels-last (B, *spatial, C); 2d and 3d.
"""

import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from .layers import (CONV, build_seeded, conv_cl, instance_norm_cl, max_pool,
                     max_pool_ceil, pad_to_match, resize_linear, resize_nearest)
from .light_munet import (DWConv, ResMambaBlock, ResUpBlock, _ORDERS_2D,
                          _ORDERS_3D, _group_norm, norm_cl)
from .m2net import _DistributedOutConv
from .registry import register_model
from .x2net import PatchExpandND, PatchMergingND


# ------------------------------------------------------------------ scale plans
def _get_scale(v):
    """An odd extent is not downsampled."""
    if v % 2 == 1:
        return 1, v
    return 2, v // 2


def ref_get_scales(sizes: Sequence[float], n_steps: int,
                   min_size: int = 1) -> list:
    """The reference's ``get_scales``: per-axis halving, but not of an odd
    extent nor below ``min_size``; the sizes may become floats (the
    reference divides without rounding)."""
    sizes = [float(s) for s in sizes]
    out = []
    for _ in range(n_steps):
        step = []
        for ax in range(len(sizes)):
            sc, nv = _get_scale(sizes[ax])
            if sc != 1 and nv >= min_size:
                sizes[ax] = nv
                step.append(sc)
            else:
                step.append(1)
        out.append(tuple(step))
    return out


def ref_scale_value(sizes: Sequence[float], scales) -> Tuple[float, ...]:
    """The reference's ``get_scale_value``: the sizes divided by each step's
    scales."""
    sizes = [float(s) for s in sizes]
    for sc in scales:
        sizes = [s / f for s, f in zip(sizes, sc)]
    return tuple(sizes)


# ------------------------------------------------------------ dw-sep RSU4F
class DWREBNCONV(nn.Module):
    """Depthwise-separable 3^d conv (no bias; the reference drops
    REBNCONV's dilation here) -> per-channel GroupNorm (eps 1e-5, scale and
    bias) -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dim: int = 2):
        super().__init__()
        self.conv = DWConv(in_ch, out_ch, dim, 3)
        self.norm = nn.GroupNorm(out_ch, out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(instance_norm_cl(self.norm, self.conv(x)))


class DWRSU4F(nn.Module):
    """RSU4F on :class:`DWREBNCONV`: LM2Net's bottleneck stages. Every
    layer keeps the map's size (the dilation ladder is dropped)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int, dim: int = 2):
        super().__init__()
        self.rebnconvin = DWREBNCONV(in_ch, out_ch, dim)
        self.rebnconv1 = DWREBNCONV(out_ch, mid_ch, dim)
        self.rebnconv2 = DWREBNCONV(mid_ch, mid_ch, dim)
        self.rebnconv3 = DWREBNCONV(mid_ch, mid_ch, dim)
        self.rebnconv4 = DWREBNCONV(mid_ch, mid_ch, dim)
        self.rebnconv3d = DWREBNCONV(2 * mid_ch, mid_ch, dim)
        self.rebnconv2d = DWREBNCONV(2 * mid_ch, mid_ch, dim)
        self.rebnconv1d = DWREBNCONV(2 * mid_ch, out_ch, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        hx1 = self.rebnconv1(hxin)
        hx2 = self.rebnconv2(hx1)
        hx3 = self.rebnconv3(hx2)
        hx4 = self.rebnconv4(hx3)
        hx3d = self.rebnconv3d(torch.cat([hx4, hx3], -1))
        hx2d = self.rebnconv2d(torch.cat([hx3d, hx2], -1))
        hx1d = self.rebnconv1d(torch.cat([hx2d, hx1], -1))
        return hx1d + hxin


# ------------------------------------------------------------------ mini U-Net
class MiniLightMUNet(nn.Module):
    """A stage's mini LightMUNet of ``n_layers`` levels at ``mid_ch``
    channels: level i pools by the i-th step of the plan of
    ``input_patch_size`` (the input's own size when None; min size 4), then
    runs its ResMambaBlocks (``down{i}``, then ``down{i}_{b}``). With
    ``use_mamba2`` the blocks mix with Mamba2, a level below the first has
    two, and there is no ``add_last`` residual (``rebnconvin``)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int, n_layers: int,
                 dim: int = 2, input_patch_size: Optional[Sequence[float]] = None,
                 add_last: bool = False, use_mamba2: bool = False,
                 min_size: int = 4):
        super().__init__()
        self.dim, self.n_layers, self.min_size = dim, n_layers, min_size
        self.input_patch_size = None if input_patch_size is None \
            else tuple(input_patch_size)
        self.add_last = add_last and not use_mamba2
        orders = _ORDERS_3D if dim == 3 else _ORDERS_2D
        self.blocks_down = [1] + [2 if use_mamba2 else 1] * (n_layers - 1)
        if self.add_last:
            self.rebnconvin = DWConv(in_ch, out_ch, dim, 3)
        self.convInit = DWConv(in_ch, mid_ch, dim, 3)
        for i, n_blocks in enumerate(self.blocks_down):
            for b in range(n_blocks):
                self.add_module(f"down{i}" if b == 0 else f"down{i}_{b}",
                                ResMambaBlock(mid_ch, dim, orders[i % len(orders)],
                                              use_mamba2=use_mamba2))
        for i in range(n_layers - 1):
            self.add_module(f"up_conv{i}", CONV[dim](mid_ch, mid_ch, 1, bias=False))
            self.add_module(f"up{i}", ResUpBlock(mid_ch, dim))
        self.final_norm = _group_norm(mid_ch)
        self.conv_final = DWConv(mid_ch, out_ch, dim, 1, use_bias=True)

    def scales(self, spatial: Sequence[int]) -> List[Tuple[int, ...]]:
        """Each level's pooling window for an input of ``spatial``."""
        ips = self.input_patch_size or tuple(spatial)
        return [(1,) * self.dim] + ref_get_scales(ips, self.n_layers - 1,
                                                  self.min_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scales = self.scales(x.shape[1:-1])
        h = self.convInit(x)
        down = []
        for i, n_blocks in enumerate(self.blocks_down):
            if math.prod(scales[i]) != 1:
                h = max_pool(h, scales[i], self.dim)
            for b in range(n_blocks):
                h = getattr(self, f"down{i}" if b == 0 else f"down{i}_{b}")(h)
            down.append(h)
        down = down[::-1]
        h = down[0]
        for i in range(self.n_layers - 1):
            h = conv_cl(getattr(self, f"up_conv{i}"), h)
            skip = down[i + 1]
            if h.shape[1:-1] != skip.shape[1:-1]:
                h = resize_nearest(h, skip.shape[1:-1])
            h = getattr(self, f"up{i}")(h + skip)
        out = self.conv_final(F.relu(norm_cl(self.final_norm, h)))
        if self.add_last:
            out = out + self.rebnconvin(x)
        return out


# ------------------------------------------------------------------ outer nets
_N_LAYERS = (7, 6, 5, 4)


class LM2NetBase(nn.Module):
    """The outer network: ``small`` picks the P table, ``use_mamba2``
    LightMamba2Net (Mamba2 minis, mini bottleneck stages) over LM2Net (Mamba
    minis, DWRSU4F bottleneck). The stage plans come from ``patch_size``,
    which the model's input must have (the plans and channel counts are
    fixed when it is built). x (B, *patch, in_ch) -> 7 outputs (d0 and the
    six sides) with ``deep_supervision``, else [d0]."""

    def __init__(self, in_ch: int, num_classes: int, patch_size: Sequence[int],
                 deep_supervision: bool = True, small: bool = False,
                 use_mamba2: bool = False, side_kernel: int = 1):
        super().__init__()
        dim = self.dim = len(patch_size)
        self.deep_supervision, self.use_mamba2 = deep_supervision, use_mamba2
        self.small = small
        m2 = use_mamba2
        ips = tuple(int(p) for p in patch_size)
        scales = ref_get_scales(ips, 5, min_size=8)
        if small:
            enc = [(32, 64)] * 4
            merge_out = [64] * 4
            dec = [(32, 128)] * 4
            expand_out = [64] * 4
            concat_back = [None] * 4
            bneck_mid, bneck_out = 32, 64
            bneck5d_mid, bneck5d_out = (32, 128) if m2 else (64, 128)
        else:
            enc = [(16 if m2 else 32, 32), (32, 64), (64, 128), (128, 256)]
            merge_out = [64, 128, 256, 512]
            dec = [(16, 32), (32, 64), (64, 128), (128, 256)]
            expand_out = [32, 64, 128, 256]
            concat_back = [32, 64, 128, 256]
            bneck_mid, bneck_out, bneck5d_mid, bneck5d_out = 256, 512, 256, 512

        def mini(c_in, mid, out, n, ipsize, add_last=True):
            return MiniLightMUNet(c_in, mid, out, n, dim, tuple(ipsize),
                                  add_last=add_last, use_mamba2=m2)

        stage_ips = [ref_scale_value(ips, scales[:i]) for i in range(5)]
        c = in_ch
        for i in range(4):
            self.add_module(f"stage{i + 1}", mini(c, *enc[i], _N_LAYERS[i],
                                                  stage_ips[i]))
            self.add_module(f"patch_merging{i + 1}", PatchMergingND(
                enc[i][1], scales[i], merge_out[i]))
            c = merge_out[i]
        if m2:
            self.stage5 = mini(c, bneck_mid, bneck_out, 4, stage_ips[4])
            self.patch_merging5 = PatchMergingND(bneck_out, scales[4], bneck_out)
            self.stage6 = mini(bneck_out, bneck_mid, bneck_out, 4,
                               ref_scale_value(ips, scales), add_last=False)
            self.patch_expand5d = PatchExpandND(bneck_out, scales[4],
                                                output_dim=bneck_out)
            self.stage5d = mini(2 * bneck_out, bneck5d_mid, bneck5d_out, 4,
                                stage_ips[4])
        else:
            self.stage5 = DWRSU4F(c, bneck_mid, bneck_out, dim)
            self.stage6 = DWRSU4F(bneck_out, bneck_mid, bneck_out, dim)
            self.stage5d = DWRSU4F(2 * bneck_out, bneck5d_mid, bneck5d_out, dim)

        # the decoder stages' plans: LM2NetP's stage2d and stage1d take stage
        # 3's (the reference's quirk); LightMamba2NetP's do not
        if small and not m2:
            dec_ips = [stage_ips[3], stage_ips[2], stage_ips[2], stage_ips[2]]
        else:
            dec_ips = [stage_ips[3], stage_ips[2], stage_ips[1], stage_ips[0]]
        c = bneck5d_out
        for j, i in enumerate(range(3, -1, -1)):
            self.add_module(f"patch_expand{i + 1}d", PatchExpandND(
                c, scales[i], output_dim=expand_out[i]))
            c = expand_out[i] + enc[i][1]
            if concat_back[i] is not None:
                self.add_module(f"concat_back_dim{i + 1}d",
                                nn.Linear(c, concat_back[i]))
                c = concat_back[i]
            self.add_module(f"stage{i + 1}d", mini(c, *dec[i], _N_LAYERS[i],
                                                   dec_ips[j]))
            c = dec[i][1]
        self.concat_back = concat_back

        side_in = [dec[0][1], dec[1][1], dec[2][1], dec[3][1], bneck5d_out,
                   bneck_out]
        for i, ch in enumerate(side_in):
            self.add_module(f"side{i + 1}", CONV[dim](
                ch, num_classes, side_kernel, padding=side_kernel // 2))
        self.outconv = _DistributedOutConv(num_classes, dim=dim)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        full_res = x.shape[1:-1]
        skips = []
        h = x
        for i in range(4):
            h = getattr(self, f"stage{i + 1}")(h)
            skips.append(h)
            h = getattr(self, f"patch_merging{i + 1}")(h)
        hx5 = self.stage5(h)
        if self.use_mamba2:
            hx6 = self.stage6(self.patch_merging5(hx5))
            hx6up = pad_to_match(self.patch_expand5d(hx6), hx5.shape[1:-1])
        else:
            hx6 = self.stage6(max_pool_ceil(hx5, 2, self.dim))
            hx6up = resize_linear(hx6, hx5.shape[1:-1], self.dim)
        hx5d = self.stage5d(torch.cat([hx6up, hx5], -1))

        h = hx5d
        dec = []
        for i in range(3, -1, -1):
            h = getattr(self, f"patch_expand{i + 1}d")(h)
            h = torch.cat([pad_to_match(h, skips[i].shape[1:-1]), skips[i]], -1)
            if self.concat_back[i] is not None:
                h = getattr(self, f"concat_back_dim{i + 1}d")(h)
            h = getattr(self, f"stage{i + 1}d")(h)
            dec.append(h)
        hx4d, hx3d, hx2d, hx1d = dec

        sides = [conv_cl(getattr(self, f"side{i + 1}"), f) for i, f in
                 enumerate((hx1d, hx2d, hx3d, hx4d, hx5d, hx6))]
        d0 = self.outconv(sides, full_res)
        outs = [d0] + sides
        return outs if self.deep_supervision else [d0]


def _make_builder(use_mamba2: bool, small: bool = False):
    def builder(plans_manager, dataset_json, configuration_manager,
                num_input_channels, deep_supervision=True, device="cuda",
                seed: int = 0, **kwargs):
        """The configuration's LM2Net-family model for its patch (2d or 3d),
        fp32, with weights drawn from ``seed`` on the CPU and moved to
        ``device``; side heads 1x1, but 3x3 for LightMamba2NetP."""
        dev = resolve_device(device)
        label_manager = plans_manager.get_label_manager(dataset_json)
        patch = tuple(configuration_manager.patch_size)
        if len(patch) not in (2, 3):
            raise ValueError(f"LM2Net takes a 2d or 3d patch, got {patch}")
        return build_seeded(functools.partial(
            LM2NetBase, num_input_channels,
            label_manager.num_segmentation_heads, patch,
            deep_supervision=deep_supervision, small=small,
            use_mamba2=use_mamba2, side_kernel=3 if (use_mamba2 and small) else 1,
            **kwargs), dev, seed)
    return builder


register_model("nnUNetTrainerLM2Net", _make_builder(False))
register_model("nnUNetTrainerLM2NetP", _make_builder(False, small=True))
register_model("nnUNetTrainerLightMamba2Net", _make_builder(True))
register_model("nnUNetTrainerLightMamba2NetP", _make_builder(True, small=True))
