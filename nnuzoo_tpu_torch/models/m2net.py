"""M2Net (SS2D2Net) and its lightweight M2NetP, the X2Net hybrids (port of
``nnuzoo_tpu/models/m2net.py``).

U2Net macro-topology: stages 1-4 (encoder and decoder) are mini VSSM U-Nets
("MU") running 4-direction selective scans, stages 5/6 are dilated RSU4F conv
blocks; PatchMerging2D downsamples between encoder stages, PatchExpand
upsamples in the decoder. M2Net's decoder concatenates the skip and maps it
back with a Linear (``concat_back_dim``) before each MU; M2NetP's MUs take
the skip concatenated directly. Six side heads at their native resolutions
plus the fused d0.
"""

import functools
import os
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device
from ..ops.cross_scan import cross_scan_fwd_op
from ..ops.selective_scan import scan_core_fwd_op
from .layers import DropPath, build_seeded, conv_cl, lecun_normal_, \
    max_pool_ceil, pad_to_match, resize_linear, set_drop_path_generator
from .registry import register_model
from .u2net import RSU4F
from .vssm import MU, PatchExpand, PatchMerging2D

# the scan forwards whose outputs a rematted stage keeps (the JAX package's
# "scan_y" and "scan_carries")
_KEPT_OPS = (scan_core_fwd_op._opoverload, cross_scan_fwd_op._opoverload)


def _keep_scan_outputs(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _KEPT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_stage(stage: nn.Module, x: torch.Tensor,
                keep_scans: bool = True) -> torch.Tensor:
    """``stage(x)`` under a selective ``torch.utils.checkpoint``: the scan
    forwards' outputs (y and the chunk carries the backward kernels start
    from) are kept, everything else in the stage runs again in the backward
    pass, as the JAX package's remat policy does (``_stage_blocks``).
    Without ``keep_scans`` nothing is kept and the scans run again too.
    ``checkpoint`` restores only the global random state when it runs the
    stage again, so the states of the DropPath modules' own generators are
    kept here and set for the second run, which then draws the same masks;
    the generators go on from where the forward pass left them."""
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
            # checkpoint stops this run with an exception of its own as soon
            # as it has every tensor that the backward pass needs
            return stage(inp)
        finally:
            for g, state in zip(generators, after):
                g.set_state(state)

    if not keep_scans:
        return checkpoint(run, x, use_reentrant=False)
    return checkpoint(run, x, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, _keep_scan_outputs))


def _maxpool2_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool with ceil mode (odd edges pool what is there)."""
    return max_pool_ceil(x, 2, 2)


class _DistributedOutConv(nn.Module):
    """The fused d0 head: ``outconv(cat(d1, upsample(d2..d6)))`` computed as
    ``sum_i upsample(d_i @ W_i) + b``; the 1x1 conv and the bilinear resize
    commute, so each slice W_i is applied at its side's native resolution.
    The weight keeps the layout of the 1x1 conv it replaces,
    (nc, n_sides*nc, 1, 1) at 2d and (nc, n_sides*nc, 1, 1, 1) at 3d."""

    def __init__(self, num_classes: int, n_sides: int = 6, dim: int = 2):
        super().__init__()
        self.num_classes, self.dim = num_classes, dim
        self.weight = nn.Parameter(torch.empty(num_classes, n_sides * num_classes,
                                               *(1,) * dim))
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
            e = nn.functional.linear(
                d, self.weight[:, i * nc:(i + 1) * nc].reshape(nc, nc))
            e = resize_linear(e, full_res, self.dim)
            out = e if out is None else out + e
        return out + self.bias


def _cat_skip(up: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    return torch.cat([pad_to_match(up, skip.shape[1:-1]), skip], dim=-1)


class M2Net(nn.Module):
    """x (B, H, W, C) -> [d0, d1, ..., d6] (only [d0] without deep
    supervision), each (B, h, w, num_classes) at its native resolution, in
    the parameters' dtype.

    Encoder MUs of mid/out widths 16/32, 32/64, 64/128 and 128/256 at /1 to
    /8, each followed by a PatchMerging2D to twice its width; RSU4F(256 ->
    512) at /16 and /32 and for stage 5d; each decoder stage a PatchExpand
    to half the width, the skip concatenated and mapped back by a Linear
    (``concat_back_dim{4,3,2,1}d``), then its MU. ``remat`` reruns every
    stage in the backward pass, keeping only its input and its scans'
    outputs (:func:`remat_stage`)."""

    def __init__(self, in_ch: int, num_classes: int, deep_supervision: bool = True,
                 remat: bool = False):
        super().__init__()
        self.deep_supervision = deep_supervision
        self.remat = remat
        self.stage1 = MU(in_ch, 16, 32, 7)
        self.patch_merging1 = PatchMerging2D(32, 2)
        self.stage2 = MU(64, 32, 64, 6)
        self.patch_merging2 = PatchMerging2D(64, 2)
        self.stage3 = MU(128, 64, 128, 5)
        self.patch_merging3 = PatchMerging2D(128, 2)
        self.stage4 = MU(256, 128, 256, 4)
        self.patch_merging4 = PatchMerging2D(256, 2)
        self.stage5 = RSU4F(512, 256, 512)
        self.stage6 = RSU4F(512, 256, 512)
        self.stage5d = RSU4F(1024, 256, 512)
        for i, (dim, n_layers) in zip((4, 3, 2, 1), ((512, 4), (256, 5), (128, 6),
                                                     (64, 7))):
            half = dim // 2
            self.add_module(f"patch_expand{i}d", PatchExpand(dim, 2))
            self.add_module(f"concat_back_dim{i}d", nn.Linear(2 * half, half))
            self.add_module(f"stage{i}d", MU(half, half // 2, half, n_layers))
        for i, ch in enumerate((32, 64, 128, 256, 512, 512)):
            self.add_module(f"side{i + 1}", nn.Conv2d(ch, num_classes, 3, padding=1))
        self.outconv = _DistributedOutConv(num_classes)

    def _stage(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Run a stage, under :func:`remat_stage` where ``remat`` asks for it."""
        stage = getattr(self, name)
        if self.remat and self.training and torch.is_grad_enabled():
            return remat_stage(stage, x)
        return stage(x)

    def _decoder_stage(self, i: int, x: torch.Tensor,
                       skip: torch.Tensor) -> torch.Tensor:
        up = getattr(self, f"patch_expand{i}d")(x)
        up = getattr(self, f"concat_back_dim{i}d")(_cat_skip(up, skip))
        return self._stage(f"stage{i}d", up)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        full_res = x.shape[1:3]
        hx1 = self._stage("stage1", x)
        hx2 = self._stage("stage2", self.patch_merging1(hx1))
        hx3 = self._stage("stage3", self.patch_merging2(hx2))
        hx4 = self._stage("stage4", self.patch_merging3(hx3))
        hx5 = self._stage("stage5", self.patch_merging4(hx4))
        hx6 = self._stage("stage6", _maxpool2_ceil(hx5))
        hx6up = resize_linear(hx6, hx5.shape[1:3], 2)

        hx5d = self._stage("stage5d", torch.cat([hx6up, hx5], dim=-1))
        hx4d = self._decoder_stage(4, hx5d, hx4)
        hx3d = self._decoder_stage(3, hx4d, hx3)
        hx2d = self._decoder_stage(2, hx3d, hx2)
        hx1d = self._decoder_stage(1, hx2d, hx1)

        feats = (hx1d, hx2d, hx3d, hx4d, hx5d, hx6)
        sides = [conv_cl(getattr(self, f"side{i + 1}"), f)
                 for i, f in enumerate(feats)]
        d0 = self.outconv(sides, full_res)
        return [d0] + sides if self.deep_supervision else [d0]


class M2NetP(nn.Module):
    """x (B, H, W, C) -> [d0, d1, ..., d6] (only [d0] without deep
    supervision), each (B, h, w, num_classes) at its native resolution, in
    the parameters' dtype.

    ``remat`` trades recompute for memory in training: the memory-dominant
    full- and half-resolution stages (1, 2, 2d, 1d) keep only their inputs
    and their scans' outputs and run again in the backward pass
    (:func:`remat_stage`); ``remat_deep_stages`` extends that to the other
    stages."""

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
        """Run a stage, under :func:`remat_stage` where ``remat`` asks for it."""
        stage = getattr(self, name)
        deep = name not in ("stage1", "stage2", "stage2d", "stage1d")
        if self.remat and (self.remat_deep_stages or not deep) and \
                self.training and torch.is_grad_enabled():
            return remat_stage(stage, x)
        return stage(x)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        full_res = x.shape[1:3]
        hx1 = self._stage("stage1", x)
        hx2 = self._stage("stage2", self.patch_merging1(hx1))
        hx3 = self._stage("stage3", self.patch_merging2(hx2))
        hx4 = self._stage("stage4", self.patch_merging3(hx3))
        hx5 = self._stage("stage5", self.patch_merging4(hx4))
        hx6 = self._stage("stage6", _maxpool2_ceil(hx5))
        hx6up = resize_linear(hx6, hx5.shape[1:3], 2)

        hx5d = self._stage("stage5d", torch.cat([hx6up, hx5], dim=-1))
        hx4d = self._stage("stage4d", _cat_skip(self.patch_expand4d(hx5d), hx4))
        hx3d = self._stage("stage3d", _cat_skip(self.patch_expand3d(hx4d), hx3))
        hx2d = self._stage("stage2d", _cat_skip(self.patch_expand2d(hx3d), hx2))
        hx1d = self._stage("stage1d", _cat_skip(self.patch_expand1d(hx2d), hx1))

        feats = (hx1d, hx2d, hx3d, hx4d, hx5d, hx6)
        sides = [conv_cl(getattr(self, f"side{i + 1}"), f)
                 for i, f in enumerate(feats)]
        d0 = self.outconv(sides, full_res)
        return [d0] + sides if self.deep_supervision else [d0]


def get_m2net_from_plans(plans_manager, dataset_json, configuration_manager,
                         num_input_channels, deep_supervision=True, remat=None,
                         device="cuda", seed: int = 0, small: bool = False,
                         stage_layers: Optional[Sequence[int]] = None):
    """Build M2Net, or M2NetP with ``small`` (fp32), for a 2d configuration,
    with weights drawn from ``seed`` (the JAX package's initialisers) on the
    CPU and moved to ``device``. ``remat`` None reads ``NNUZOO_REMAT`` ("1"
    turns it on) and is off otherwise: the plan's batch of 12 patches of
    256x224 fits an 80 GB card without it. The DropPath modules share one
    generator on ``device``, seeded from ``seed``. ``stage_layers`` (M2NetP
    only; its default (7, 6, 5, 4)) cuts the MUs' depths."""
    dev = resolve_device(device)
    if remat is None:
        remat = os.environ.get("NNUZOO_REMAT", "0") == "1"
    label_manager = plans_manager.get_label_manager(dataset_json)
    if len(configuration_manager.patch_size) != 2:
        raise ValueError("M2Net is 2D-only")
    args = (num_input_channels, label_manager.num_segmentation_heads)
    if small:
        factory = functools.partial(M2NetP, *args, deep_supervision=deep_supervision,
                                    remat=remat,
                                    stage_layers=stage_layers or (7, 6, 5, 4))
    elif stage_layers is not None:
        raise ValueError("M2Net takes no stage_layers (M2NetP does)")
    else:
        factory = functools.partial(M2Net, *args, deep_supervision=deep_supervision,
                                    remat=remat)
    model = build_seeded(factory, dev, seed)
    set_drop_path_generator(model, torch.Generator(device=dev).manual_seed(seed))
    return model


register_model(["nnUNetTrainerM2Net", "nnUNetTrainerFineTuneDecoderWarmUp"],
               get_m2net_from_plans)
register_model("nnUNetTrainerM2NetP",
               functools.partial(get_m2net_from_plans, small=True))
