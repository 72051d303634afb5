"""SwinUMamba / SwinUMambaD (port of ``nnuzoo_tpu/models/swin_umamba.py``).

Conv stem (7x7 stride 2) -> VSSM encoder (patch 2, depths 2/2/9/2, dims
96/192/384/768 of SS2D blocks with PatchMerging) -> a UNETR-style residual
conv decoder (SwinUMamba) or a decoder of VSS blocks (SwinUMambaD). Deep
supervision heads at /1, /2, /4, /8. 2d, channels-last.

The heads past the first are built whether or not ``deep_supervision`` asks
for their outputs, so a model for inference loads a trained state_dict.
"""

import functools
from typing import List, Sequence

import torch
import torch.nn as nn

from .._device import resolve_device
from .layers import build_seeded, conv_cl, conv_same, instance_norm_cl, \
    set_drop_path_generator
from .registry import register_model
from .ss2d import VSSLayer
from .unetr import UnetrBasicBlock, UnetrUpBlock
from .vssm import PatchEmbed2D, PatchExpand, PatchMerging2D



class _VSSMBackbone(nn.Module):
    """PatchEmbed -> [VSSLayer -> PatchMerging] x 4; returns the input and
    each layer's output. Drop path rises linearly over the blocks to
    ``drop_path_rate``."""

    def __init__(self, in_ch: int, depths: Sequence[int] = (2, 2, 9, 2),
                 dims: Sequence[int] = (96, 192, 384, 768), patch_size: int = 2,
                 drop_path_rate: float = 0.2):
        super().__init__()
        self.n, self.dims = len(depths), tuple(dims)
        self.patch_embed = PatchEmbed2D(in_ch, patch_size, dims[0])
        total = sum(depths)
        dpr = [drop_path_rate * j / max(1, total - 1) for j in range(total)]
        for i, depth in enumerate(depths):
            lo = sum(depths[:i])
            self.add_module(f"layer{i}", VSSLayer(dims[i], depth,
                                                  drop_path=tuple(dpr[lo:lo + depth])))
            if i < self.n - 1:
                self.add_module(f"down{i}", PatchMerging2D(dims[i], 2, dims[i + 1]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = [x]
        h = self.patch_embed(x)
        for i in range(self.n):
            h = getattr(self, f"layer{i}")(h)
            outs.append(h)
            if i < self.n - 1:
                h = getattr(self, f"down{i}")(h)
        return outs


class SwinUMamba(nn.Module):
    """x (B, H, W, C) -> logits at /1 (and /2, /4, /8 with deep
    supervision), channels-last."""

    def __init__(self, in_ch: int, num_classes: int,
                 feat_size: Sequence[int] = (48, 96, 192, 384, 768),
                 deep_supervision: bool = True):
        super().__init__()
        f = tuple(feat_size)
        self.deep_supervision = deep_supervision
        self.stem_conv = nn.Conv2d(in_ch, f[0], 7, stride=2)
        self.stem_norm = nn.GroupNorm(f[0], f[0], eps=1e-5)
        self.vssm_encoder = _VSSMBackbone(f[0])
        d = self.vssm_encoder.dims
        self.encoder1 = UnetrBasicBlock(in_ch, f[0], 2)
        self.encoder2 = UnetrBasicBlock(f[0], f[1], 2)
        self.encoder3 = UnetrBasicBlock(d[0], f[2], 2)
        self.encoder4 = UnetrBasicBlock(d[1], f[3], 2)
        self.encoder5 = UnetrBasicBlock(d[2], f[4], 2)
        self.decoder6 = UnetrUpBlock(d[3], f[4], f[4], 2)
        self.decoder5 = UnetrUpBlock(f[4], f[3], f[3], 2)
        self.decoder4 = UnetrUpBlock(f[3], f[2], f[2], 2)
        self.decoder3 = UnetrUpBlock(f[2], f[1], f[1], 2)
        self.decoder2 = UnetrUpBlock(f[1], f[0], f[0], 2)
        self.decoder1 = UnetrBasicBlock(f[0], f[0], 2)
        for i in range(4):
            self.add_module(f"out{i}", nn.Conv2d(f[i], num_classes, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        stem = instance_norm_cl(self.stem_norm, conv_same(self.stem_conv, x))
        vss = self.vssm_encoder(stem)
        enc1 = self.encoder1(x)                              # /1
        enc2 = self.encoder2(vss[0])                         # /2
        enc3 = self.encoder3(vss[1])                         # /4
        enc4 = self.encoder4(vss[2])                         # /8
        enc5 = self.encoder5(vss[3])                         # /16
        dec4 = self.decoder6(vss[4], enc5)                   # /32 -> /16
        dec3 = self.decoder5(dec4, enc4)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec_out = self.decoder1(self.decoder2(dec1, enc1))
        feats = (dec_out, dec1, dec2, dec3)
        n = 4 if self.deep_supervision else 1
        return [conv_cl(getattr(self, f"out{i}"), feats[i]) for i in range(n)]


class SwinUMambaD(nn.Module):
    """The same encoder; a decoder of PatchExpand, the skip concatenated, a
    Linear back to the skip's width and one VSS block per stage, then a
    final PatchExpand to the input's resolution."""

    def __init__(self, in_ch: int, num_classes: int,
                 feat_size: Sequence[int] = (48, 96, 192, 384, 768),
                 deep_supervision: bool = True):
        super().__init__()
        f = tuple(feat_size)
        self.deep_supervision = deep_supervision
        self.stem_conv = nn.Conv2d(in_ch, f[0], 7, stride=2)
        self.stem_norm = nn.GroupNorm(f[0], f[0], eps=1e-5)
        self.vssm_encoder = _VSSMBackbone(f[0])
        d = self.vssm_encoder.dims
        skips = (f[0],) + d[:3]                     # /2 /4 /8 /16
        below = d[3]
        for i in range(3, -1, -1):
            self.add_module(f"expand{i}", PatchExpand(below, 2, skips[i]))
            self.add_module(f"concat_back{i}", nn.Linear(2 * skips[i], skips[i]))
            self.add_module(f"dec_vss{i}", VSSLayer(skips[i], 1))
            below = skips[i]
        self.final_expand = PatchExpand(below, 2, f[0])
        heads = (f[0],) + tuple(skips)              # /1 /2 /4 /8
        for i in range(4):
            self.add_module(f"out{i}", nn.Conv2d(heads[i], num_classes, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        stem = instance_norm_cl(self.stem_norm, conv_same(self.stem_conv, x))
        vss = self.vssm_encoder(stem)
        skips = [stem, vss[1], vss[2], vss[3]]      # /2 /4 /8 /16
        h = vss[4]                                  # /32
        dec = []
        for i in range(3, -1, -1):
            h = getattr(self, f"expand{i}")(h)
            h = getattr(self, f"concat_back{i}")(torch.cat([h, skips[i]], -1))
            h = getattr(self, f"dec_vss{i}")(h)
            dec.append(h)
        feats = (self.final_expand(h), dec[-1], dec[-2], dec[-3])
        n = 4 if self.deep_supervision else 1
        return [conv_cl(getattr(self, f"out{i}"), feats[i]) for i in range(n)]


def get_swin_umamba_from_plans(plans_manager, dataset_json, configuration_manager,
                               num_input_channels, deep_supervision=True,
                               device="cuda", seed: int = 0,
                               mamba_decoder: bool = False, **kwargs):
    """SwinUMamba (SwinUMambaD with ``mamba_decoder``) for a 2d
    configuration, fp32, with weights drawn from ``seed`` on the CPU and
    moved to ``device``; the DropPath modules share one generator on
    ``device``, seeded from ``seed``. ``kwargs`` (``feat_size``) narrow the
    decoder."""
    dev = resolve_device(device)
    label_manager = plans_manager.get_label_manager(dataset_json)
    if len(configuration_manager.patch_size) != 2:
        raise ValueError("SwinUMamba is 2D-only")
    cls = SwinUMambaD if mamba_decoder else SwinUMamba
    model = build_seeded(functools.partial(
        cls, num_input_channels, label_manager.num_segmentation_heads,
        deep_supervision=deep_supervision, **kwargs), dev, seed)
    set_drop_path_generator(model, torch.Generator(device=dev).manual_seed(seed))
    return model


register_model("nnUNetTrainerSwinUMamba", get_swin_umamba_from_plans)
register_model("nnUNetTrainerSwinUMambaD",
               functools.partial(get_swin_umamba_from_plans, mamba_decoder=True))


def load_vmamba_pretrained(model: nn.Module, state_dict: dict,
                           verbose: bool = True) -> int:
    """Copy ImageNet-pretrained VMamba weights into a SwinUMamba(D)'s
    ``vssm_encoder`` (the JAX package's function of the same name, on the
    port's layouts, which are VMamba's own torch layouts: nothing is
    transposed). ``state_dict`` is VMamba's (``{"model": ...}`` or the inner
    dict): ``layers.{i}.blocks.{j}.*`` go to ``layer{i}.block{j}.*`` and
    ``layers.{i}.downsample.*`` to ``down{i}.*``; patch_embed, the final norm
    and the head are skipped, as the reference does, and so is a key with no
    counterpart. A shape that disagrees raises. Returns the number of
    tensors copied."""
    sd = state_dict.get("model", state_dict)
    target = dict(model.vssm_encoder.state_dict(keep_vars=True))
    n_loaded = 0
    with torch.no_grad():
        for key, value in sd.items():
            if key.startswith(("patch_embed.", "norm.", "head.")):
                continue
            parts = key.split(".")
            name = None
            if parts[0] == "layers" and len(parts) > 3:
                if parts[2] == "downsample":
                    name = ".".join([f"down{parts[1]}"] + parts[3:])
                elif parts[2] == "blocks":
                    name = ".".join([f"layer{parts[1]}", f"block{parts[3]}"]
                                    + parts[4:])
            if name not in target:
                if verbose:
                    print(f"passing: {key}")
                continue
            if tuple(target[name].shape) != tuple(value.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} against "
                                 f"{tuple(target[name].shape)} of {name}")
            target[name].copy_(value)
            n_loaded += 1
    return n_loaded
