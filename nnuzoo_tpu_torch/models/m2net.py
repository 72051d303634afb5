"""M2NetP, the lightweight X2Net hybrid (port of
``nnuzoo_tpu/models/m2net.py``).

U2Net macro-topology: stages 1-4 (encoder and decoder) are mini VSSM U-Nets
("MU") running 4-direction selective scans, stages 5/6 are dilated RSU4F conv
blocks; PatchMerging2D downsamples between encoder stages, PatchExpand
upsamples in the decoder, whose MUs take the skip concatenated directly. Six
side heads at their native resolutions plus the fused d0.
"""

import os
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from .layers import DropPath, conv_cl, init_parameters, lecun_normal_, \
    pad_to_match, resize_linear, set_drop_path_generator
from .registry import register_model
from .u2net import RSU4F
from .vssm import MU, PatchExpand, PatchMerging2D


def _maxpool2_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool with ceil mode (odd edges pool what is there)."""
    y = nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1)


class _DistributedOutConv(nn.Module):
    """The fused d0 head: ``outconv(cat(d1, upsample(d2..d6)))`` computed as
    ``sum_i upsample(d_i @ W_i) + b``; the 1x1 conv and the bilinear resize
    commute, so each slice W_i is applied at its side's native resolution.
    The weight keeps the layout of the 1x1 conv it replaces,
    (nc, n_sides*nc, 1, 1)."""

    def __init__(self, num_classes: int, n_sides: int = 6):
        super().__init__()
        self.num_classes = num_classes
        self.weight = nn.Parameter(torch.empty(num_classes, n_sides * num_classes,
                                               1, 1))
        self.bias = nn.Parameter(torch.empty(num_classes))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, sides: Sequence[torch.Tensor],
                full_res: Sequence[int]) -> torch.Tensor:
        nc = self.num_classes
        out = None
        for i, d in enumerate(sides):
            e = nn.functional.linear(d, self.weight[:, i * nc:(i + 1) * nc, 0, 0])
            e = resize_linear(e, full_res, 2)
            out = e if out is None else out + e
        return out + self.bias


class M2NetP(nn.Module):
    """x (B, H, W, C) -> [d0, d1, ..., d6] (only [d0] without deep
    supervision), each (B, h, w, num_classes) at its native resolution, in
    the parameters' dtype.

    ``remat`` trades recompute for memory in training: the memory-dominant
    full- and half-resolution stages (1, 2, 2d, 1d) keep only their inputs
    and run again in the backward pass; ``remat_deep_stages`` extends that
    to the other stages. A stage that runs again draws the DropPath masks of
    its first run (see :meth:`_stage`)."""

    def __init__(self, in_ch: int, num_classes: int, deep_supervision: bool = True,
                 remat: bool = False, remat_deep_stages: bool = False,
                 stage_layers: Sequence[int] = (7, 6, 5, 4)):
        super().__init__()
        sl = tuple(stage_layers)
        self.deep_supervision = deep_supervision
        self.remat = remat
        self.remat_deep_stages = remat_deep_stages
        self.stage1 = MU(in_ch, 16, 64, sl[0])
        self.patch_merging1 = PatchMerging2D(64, 2, output_features=64)
        self.stage2 = MU(64, 16, 64, sl[1])
        self.patch_merging2 = PatchMerging2D(64, 2, output_features=64)
        self.stage3 = MU(64, 16, 64, sl[2])
        self.patch_merging3 = PatchMerging2D(64, 2, output_features=64)
        self.stage4 = MU(64, 16, 64, sl[3])
        self.patch_merging4 = PatchMerging2D(64, 2, output_features=64)
        self.stage5 = RSU4F(64, 16, 64)
        self.stage6 = RSU4F(64, 16, 64)
        self.stage5d = RSU4F(128, 16, 128)
        self.patch_expand4d = PatchExpand(128, 2)
        self.stage4d = MU(128, 16, 128, sl[3])
        self.patch_expand3d = PatchExpand(128, 2)
        self.stage3d = MU(128, 16, 128, sl[2])
        self.patch_expand2d = PatchExpand(128, 2)
        self.stage2d = MU(128, 16, 128, sl[1])
        self.patch_expand1d = PatchExpand(128, 2)
        self.stage1d = MU(128, 16, 128, sl[0])
        for i, ch in enumerate((128, 128, 128, 128, 128, 64)):
            self.add_module(f"side{i + 1}", nn.Conv2d(ch, num_classes, 3, padding=1))
        self.outconv = _DistributedOutConv(num_classes)

    def _stage(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Run a stage, under ``torch.utils.checkpoint`` where ``remat`` asks
        for it. ``checkpoint`` restores only the global random state when it
        runs the stage again, so the states of the DropPath modules' own
        generators are kept here and set for the second run, which then
        draws the same masks; the generators go on from where the forward
        pass left them."""
        stage = getattr(self, name)
        deep = name not in ("stage1", "stage2", "stage2d", "stage1d")
        if not (self.remat and (self.remat_deep_stages or not deep)
                and self.training and torch.is_grad_enabled()):
            return stage(x)
        generators = []
        for m in stage.modules():
            if isinstance(m, DropPath) and m.generator is not None and \
                    not any(m.generator is g for g in generators):
                generators.append(m.generator)
        entry = [g.get_state() for g in generators]
        runs = []

        def run(inp):
            if not runs:
                runs.append(1)
                return stage(inp)
            after = [g.get_state() for g in generators]
            for g, state in zip(generators, entry):
                g.set_state(state)
            try:
                # checkpoint stops this run with an exception of its own as
                # soon as it has every tensor that the backward pass needs
                return stage(inp)
            finally:
                for g, state in zip(generators, after):
                    g.set_state(state)

        return checkpoint(run, x, use_reentrant=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        full_res = x.shape[1:3]
        hx1 = self._stage("stage1", x)
        hx2 = self._stage("stage2", self.patch_merging1(hx1))
        hx3 = self._stage("stage3", self.patch_merging2(hx2))
        hx4 = self._stage("stage4", self.patch_merging3(hx3))
        hx5 = self._stage("stage5", self.patch_merging4(hx4))
        hx6 = self._stage("stage6", _maxpool2_ceil(hx5))
        hx6up = resize_linear(hx6, hx5.shape[1:3], 2)

        def cat_skip(up, skip):
            return torch.cat([pad_to_match(up, skip.shape[1:-1]), skip], dim=-1)

        hx5d = self._stage("stage5d", torch.cat([hx6up, hx5], dim=-1))
        hx4d = self._stage("stage4d", cat_skip(self.patch_expand4d(hx5d), hx4))
        hx3d = self._stage("stage3d", cat_skip(self.patch_expand3d(hx4d), hx3))
        hx2d = self._stage("stage2d", cat_skip(self.patch_expand2d(hx3d), hx2))
        hx1d = self._stage("stage1d", cat_skip(self.patch_expand1d(hx2d), hx1))

        feats = (hx1d, hx2d, hx3d, hx4d, hx5d, hx6)
        sides = [conv_cl(getattr(self, f"side{i + 1}"), f)
                 for i, f in enumerate(feats)]
        d0 = self.outconv(sides, full_res)
        return [d0] + sides if self.deep_supervision else [d0]


def get_m2net_from_plans(plans_manager, dataset_json, configuration_manager,
                         num_input_channels, deep_supervision=True, remat=None,
                         device="cuda", seed: int = 0,
                         stage_layers: Sequence[int] = (7, 6, 5, 4)):
    """Build M2NetP (fp32) for a 2d configuration, with weights drawn from
    ``seed`` (the JAX package's initialisers) on the CPU and moved to
    ``device``. ``remat`` None reads ``NNUZOO_REMAT`` ("1" turns it on) and is
    off otherwise: the plan's batch of 12 patches of 256x224 fits an 80 GB
    card without it. The DropPath modules share one generator on ``device``,
    seeded from ``seed``."""
    dev = resolve_device(device)
    if remat is None:
        remat = os.environ.get("NNUZOO_REMAT", "0") == "1"
    label_manager = plans_manager.get_label_manager(dataset_json)
    if len(configuration_manager.patch_size) != 2:
        raise ValueError("M2Net is 2D-only")
    with torch.device("meta"):
        model = M2NetP(num_input_channels, label_manager.num_segmentation_heads,
                       deep_supervision=deep_supervision, remat=remat,
                       stage_layers=stage_layers)
    model = model.to_empty(device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(dev)
    set_drop_path_generator(model, torch.Generator(device=dev).manual_seed(seed))
    return model


register_model("nnUNetTrainerM2NetP", get_m2net_from_plans)
