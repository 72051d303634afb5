"""Common building blocks (port of ``nnuzoo_tpu/models/layers.py``).

Activations are channels-last, (B, *spatial, C), as in the JAX package, so
module outputs compare like with like. Convolutions run on a channels-first
view of the same memory (:func:`conv_cl`).
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv_cl(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a channels-first conv module to a channels-last (B, H, W, C)
    tensor; the permutes are views."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def resize_linear(x: torch.Tensor, new_spatial: Sequence[int],
                  dim: int = 2) -> torch.Tensor:
    """Bilinear/trilinear resize of (B, *spatial, C), align_corners=False.

    Matches ``jax.image.resize(..., "linear")`` when no axis shrinks; that
    function antialiases when it downsamples and ``F.interpolate`` does not,
    so shrinking raises."""
    spatial = tuple(x.shape[1:-1])
    new_spatial = tuple(int(s) for s in new_spatial)
    if spatial == new_spatial:
        return x
    if any(n < s for s, n in zip(spatial, new_spatial)):
        raise ValueError(f"resize_linear only upsamples: {spatial} -> {new_spatial}")
    mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[dim]
    y = F.interpolate(x.movedim(-1, 1), size=new_spatial, mode=mode,
                      align_corners=False)
    return y.movedim(1, -1)


def max_pool(x: torch.Tensor, window: int, dim: int = 2) -> torch.Tensor:
    """Non-overlapping max pool of (B, *spatial, C) (floor at odd edges)."""
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[dim]
    return pool(x.movedim(-1, 1), window, window).movedim(1, -1)


def pad_to_match(x: torch.Tensor, target_spatial: Sequence[int]) -> torch.Tensor:
    """Zero-pad (B, *spatial, C) at the bottom/right so the spatial dims equal
    ``target_spatial`` (a decoder's re-expanded map can be smaller than its
    skip after patch merging floored an odd dim)."""
    spatial = tuple(x.shape[1:-1])
    if spatial == tuple(target_spatial):
        return x
    pads = [t - s for s, t in zip(spatial, target_spatial)]
    if any(p < 0 for p in pads):
        raise ValueError(f"cannot pad {spatial} to {tuple(target_spatial)}")
    flat = [0, 0]                      # channels
    for p in reversed(pads):
        flat += [0, p]
    return F.pad(x, flat)


class DropPath(nn.Module):
    """Stochastic depth: drops the whole residual branch per sample, in
    training mode only; the identity in eval mode. The masks come from
    ``generator``, which must live on the input's device (None: the device's
    global generator); :func:`set_drop_path_generator` sets one for a model."""

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator

    def __deepcopy__(self, memo):
        # a copy of a model goes on drawing from the same generator
        twin = DropPath(self.rate, self.generator)
        twin.training = self.training
        return twin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep_shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        keep = torch.empty(keep_shape, device=x.device).bernoulli_(
            1.0 - self.rate, generator=self.generator)
        return torch.where(keep.bool(), x / (1.0 - self.rate), 0.0)


def set_drop_path_generator(model: nn.Module,
                            generator: Optional[torch.Generator]) -> None:
    """Make every DropPath of ``model`` draw from ``generator``."""
    for module in model.modules():
        if isinstance(module, DropPath):
            module.generator = generator


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """N(0, 1/fan_in), the scale of flax's default ``lecun_normal`` (without
    its truncation)."""
    with torch.no_grad():
        weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


def init_parameters(model: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """Initialise every parameter of ``model`` as the JAX package's flax
    modules do: Linear/Conv weights lecun normal with zero biases, norms one
    and zero, and modules with parameters of their own through their
    ``reset_parameters(generator)``."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif next(module.parameters(recurse=False), None) is not None:
                module.reset_parameters(generator)
