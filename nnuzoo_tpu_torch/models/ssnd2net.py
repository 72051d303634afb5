"""SSND2Net and SSND2NetP, the X²Net hybrid on mini N-d cross-scan U-Nets
(port of ``nnuzoo_tpu/models/ssnd2net.py``).

The outer network is U²Net's U of six stages, each a :class:`MUSSND`: a
mini U-Net whose levels mix with SSND (``mixers.MixerLayer``, "ssnd"),
two blocks a level in the encoder and one in the decoder, stochastic depth
falling from 0.2 to 0 across the decoder. A mini pools by the reference's
odd-axis-gated plan of its own input patch (:func:`lm2net.ref_get_scales`
with min size 1, identity scales dropped from the downsampling list); the
bottleneck minis (stages 5, 6 and 5d) get no patch and do not pool.
PatchMergingND and PatchExpandND move between the stages (stage 5 to 6 by
``scales[4]``), the decoder concatenates each skip and maps it back with a
Linear, the six side heads are 3x3 and the fused head is d0.

``remat`` reruns each mini whole in the backward pass (the JAX package's
``nn.remat`` of the mini, which keeps no scan output); it is off unless
asked for.

Channels-last (B, *spatial, C); 2d and 3d.
"""

import functools
import math
import os
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from .._device import resolve_device
from .layers import CONV, build_seeded, conv_cl, pad_to_match, \
    set_drop_path_generator
from .light_munet import DWConv
from .lm2net import ref_get_scales, ref_scale_value
from .m2net import _DistributedOutConv, remat_stage
from .mixers import MixerLayer
from .registry import register_model
from .x2net import PatchExpandND, PatchMergingND


class MUSSND(nn.Module):
    """A mini SSND U-Net of ``n_layers`` levels at ``mid_ch`` channels:
    (with ``add_last``) a depthwise-separable ``rebnconvin`` to ``out_ch``
    whose output is both the mini's input and its residual; a 1^d
    ``patch_embed`` and LayerNorm ``patch_norm``; two SSND blocks a level
    (``layer{i}``), then a PatchMergingND by the next non-identity scale of
    the plan of ``input_patch_size`` (``down{i}``); the decoder expands by
    the plan's scales from the end (``expand{s}``) where they are not the
    identity, concatenates the skip, maps it back (``concat_back_dim{s}``)
    and mixes with one SSND block (``stage{s}``); a 1^d ``seg`` head."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int, n_layers: int,
                 dim: int = 2, input_patch_size: Optional[Sequence[float]] = None,
                 add_last: bool = False, d_state: int = 16,
                 drop_path_rate: float = 0.2):
        super().__init__()
        n, mid = n_layers, mid_ch
        self.n_layers, self.add_last = n, add_last
        self.scales = ref_get_scales(input_patch_size, n - 1, 1) \
            if input_patch_size is not None else []
        # the reference compacts identity scales out of the downsampling
        # list and indexes it by level
        self.downs = [s for s in self.scales if math.prod(s) != 1]
        if add_last:
            self.rebnconvin = DWConv(in_ch, out_ch, dim, 3)
            in_ch = out_ch
        self.patch_embed = CONV[dim](in_ch, mid, 1)
        self.patch_norm = nn.LayerNorm(mid, eps=1e-6)
        total = 2 * n
        dpr = [drop_path_rate * j / max(1, total - 1) for j in range(total)]
        for i in range(n):
            self.add_module(f"layer{i}", MixerLayer(
                mid, 2, "ssnd", d_state, dim, tuple(dpr[2 * i:2 * i + 2])))
            if i < len(self.downs):
                self.add_module(f"down{i}", PatchMergingND(mid, self.downs[i], mid))
        dprd = [drop_path_rate * (2 * (n - 1) - 1 - j) / max(1, 2 * (n - 1) - 1)
                for j in range(2 * (n - 1))]
        for s in range(1, n):
            scale = self.scales[-s] if self.scales else None
            if scale is not None and math.prod(scale) != 1:
                self.add_module(f"expand{s - 1}",
                                PatchExpandND(mid, scale, output_dim=mid))
            self.add_module(f"concat_back_dim{s - 1}", nn.Linear(2 * mid, mid))
            self.add_module(f"stage{s - 1}", MixerLayer(
                mid, 1, "ssnd", d_state, dim, dprd[2 * (s - 1)]))
        # patch size 1: no final expand
        self.seg = CONV[dim](mid, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.add_last:
            # the reference embeds rebnconvin's output, not the raw input
            x = last_add = self.rebnconvin(x)
        h = self.patch_norm(conv_cl(self.patch_embed, x))
        skips = []
        for i in range(self.n_layers):
            h = getattr(self, f"layer{i}")(h)
            skips.append(h)
            if i < len(self.downs):
                h = getattr(self, f"down{i}")(h)
        h = skips[-1]
        for s in range(1, self.n_layers):
            if hasattr(self, f"expand{s - 1}"):
                h = getattr(self, f"expand{s - 1}")(h)
            skip = skips[-(s + 1)]
            h = torch.cat([pad_to_match(h, skip.shape[1:-1]), skip], -1)
            h = getattr(self, f"concat_back_dim{s - 1}")(h)
            h = getattr(self, f"stage{s - 1}")(h)
        out = conv_cl(self.seg, h)
        return out + last_add if self.add_last else out


_N_LAYERS = (7, 6, 5, 4)


class SSND2Net(nn.Module):
    """The outer network; ``small`` picks the P table. The stage plans come
    from ``patch_size``, which the model's input must have. x (B, *patch,
    in_ch) -> 7 outputs (d0 and the six sides) with ``deep_supervision``,
    else [d0]."""

    def __init__(self, in_ch: int, num_classes: int, patch_size: Sequence[int],
                 deep_supervision: bool = True, small: bool = False,
                 remat: bool = False):
        super().__init__()
        dim = len(patch_size)
        self.deep_supervision, self.remat = deep_supervision, remat
        ips = tuple(int(p) for p in patch_size)
        scales = ref_get_scales(ips, 5, 1)
        if small:
            enc = [(16, 64)] * 4
            merge_out = [64] * 4
            dec = [(16, 128)] * 4
            expand_out = [64] * 4
            concat_back = [128] * 4
            b_mid, b_out, b5d_mid, b5d_out = 16, 64, 16, 128
        else:
            enc = [(16, 32), (32, 64), (64, 128), (128, 256)]
            merge_out = [64, 128, 256, 512]
            dec = [(16, 32), (32, 64), (64, 128), (128, 256)]
            expand_out = [32, 64, 128, 256]
            concat_back = [32, 64, 128, 256]
            b_mid, b_out, b5d_mid, b5d_out = 256, 512, 256, 512
        stage_ips = [ref_scale_value(ips, scales[:i]) for i in range(4)]

        def mini(c_in, mid, out, n, ipsize):
            return MUSSND(c_in, mid, out, n, dim, ipsize, add_last=True)

        c = in_ch
        for i in range(4):
            self.add_module(f"stage{i + 1}", mini(c, *enc[i], _N_LAYERS[i],
                                                  stage_ips[i]))
            self.add_module(f"patch_merging{i + 1}", PatchMergingND(
                enc[i][1], scales[i], merge_out[i]))
            c = merge_out[i]
        # the bottleneck minis get no patch: they do not pool
        self.stage5 = mini(c, b_mid, b_out, 4, None)
        self.patch_merging5 = PatchMergingND(b_out, scales[4], b_out)
        self.stage6 = mini(b_out, b_mid, b_out, 4, None)
        self.patch_expand5d = PatchExpandND(b_out, scales[4], output_dim=b_out)
        self.stage5d = mini(2 * b_out, b5d_mid, b5d_out, 4, None)
        dec_ips = [stage_ips[3], stage_ips[2], stage_ips[1], stage_ips[0]]
        c = b5d_out
        for j, i in enumerate(range(3, -1, -1)):
            self.add_module(f"patch_expand{i + 1}d", PatchExpandND(
                c, scales[i], output_dim=expand_out[i]))
            self.add_module(f"concat_back_dim{i + 1}d", nn.Linear(
                expand_out[i] + enc[i][1], concat_back[i]))
            self.add_module(f"stage{i + 1}d", mini(concat_back[i], *dec[i],
                                                   _N_LAYERS[i], dec_ips[j]))
            c = dec[i][1]
        side_in = [dec[0][1], dec[1][1], dec[2][1], dec[3][1], b5d_out, b_out]
        for i, ch in enumerate(side_in):
            self.add_module(f"side{i + 1}", CONV[dim](ch, num_classes, 3,
                                                      padding=1))
        self.outconv = _DistributedOutConv(num_classes, dim=dim)

    def _stage(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Run a mini, rerun whole in the backward pass where ``remat`` asks
        for it."""
        stage = getattr(self, name)
        if self.remat and self.training and torch.is_grad_enabled():
            return remat_stage(stage, x, keep_scans=False)
        return stage(x)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        full_res = x.shape[1:-1]
        skips = []
        h = x
        for i in range(4):
            h = self._stage(f"stage{i + 1}", h)
            skips.append(h)
            h = getattr(self, f"patch_merging{i + 1}")(h)
        hx5 = self._stage("stage5", h)
        hx6 = self._stage("stage6", self.patch_merging5(hx5))
        hx6up = pad_to_match(self.patch_expand5d(hx6), hx5.shape[1:-1])
        h = self._stage("stage5d", torch.cat([hx6up, hx5], -1))
        hx5d = h
        dec = []
        for i in range(3, -1, -1):
            h = getattr(self, f"patch_expand{i + 1}d")(h)
            h = torch.cat([pad_to_match(h, skips[i].shape[1:-1]), skips[i]], -1)
            h = getattr(self, f"concat_back_dim{i + 1}d")(h)
            h = self._stage(f"stage{i + 1}d", h)
            dec.append(h)
        hx4d, hx3d, hx2d, hx1d = dec
        sides = [conv_cl(getattr(self, f"side{i + 1}"), f) for i, f in
                 enumerate((hx1d, hx2d, hx3d, hx4d, hx5d, hx6))]
        d0 = self.outconv(sides, full_res)
        return [d0] + sides if self.deep_supervision else [d0]


def get_ssnd2net_from_plans(plans_manager, dataset_json, configuration_manager,
                            num_input_channels, deep_supervision=True,
                            device="cuda", seed: int = 0, small: bool = False,
                            remat: Optional[bool] = None):
    """SSND2Net, or SSND2NetP with ``small``, for the configuration's patch
    (2d or 3d), fp32, with weights drawn from ``seed`` on the CPU and moved
    to ``device``; the DropPath modules share one generator on ``device``
    (but the meta device), seeded from ``seed``. ``remat`` None reads
    ``NNUZOO_REMAT`` ("1" turns it on) and is off otherwise."""
    dev = resolve_device(device)
    if remat is None:
        remat = os.environ.get("NNUZOO_REMAT", "0") == "1"
    label_manager = plans_manager.get_label_manager(dataset_json)
    patch = tuple(configuration_manager.patch_size)
    if len(patch) not in (2, 3):
        raise ValueError(f"SSND2Net takes a 2d or 3d patch, got {patch}")
    model = build_seeded(functools.partial(
        SSND2Net, num_input_channels, label_manager.num_segmentation_heads,
        patch, deep_supervision=deep_supervision, small=small, remat=remat),
        dev, seed)
    if dev.type != "meta":
        set_drop_path_generator(model,
                                torch.Generator(device=dev).manual_seed(seed))
    return model


register_model("nnUNetTrainerSSND2Net", get_ssnd2net_from_plans)
register_model("nnUNetTrainerSSND2NetP",
               functools.partial(get_ssnd2net_from_plans, small=True))
