"""Common building blocks (port of ``nnuzoo_tpu/models/layers.py``).

Activations are channels-last, (B, *spatial, C), as in the JAX package, so
module outputs compare like with like. Convolutions run on a channels-first
view of the same memory (:func:`conv_cl`; for a 3d map that view is
``channels_last_3d`` memory).

The nnU-Net units (:class:`ConvNormAct`, :class:`StackedConvBlocks`,
:class:`ResidualBlock`, :class:`TransposedConvUp`) follow flax's
conventions, which differ from torch's in two places: a "SAME" convolution
with stride 2 on an even size pads one more voxel at the high end than at
the low one (:func:`conv_same`), and a ``ConvTranspose`` kernel is the
spatial flip of torch's (``convert.py`` flips it).
"""

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


CONV = {2: nn.Conv2d, 3: nn.Conv3d}
CONV_TRANSPOSE = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def tup(x, dim: int) -> Tuple[int, ...]:
    """An int or a sequence of ``dim`` ints as a tuple of ``dim`` ints."""
    if isinstance(x, (tuple, list)):
        if len(x) != dim:
            raise ValueError(f"{x} has not {dim} entries")
        return tuple(int(i) for i in x)
    return (int(x),) * dim


def conv_cl(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a channels-first conv module to a channels-last (B, *spatial, C)
    tensor; the moves of the channel axis are views."""
    return conv(x.movedim(-1, 1)).movedim(1, -1)


def same_pads(sizes: Sequence[int], kernel: Sequence[int], strides: Sequence[int],
              dilation: Sequence[int]):
    """The (low, high) padding of each spatial axis under flax's (XLA's)
    "SAME": ceil(n / s) outputs, and where the total padding is odd the
    extra voxel goes to the high end (a k=3, s=2 conv on an even size takes
    its first tap at x[0]; torch's ``padding=1`` takes it at x[-1])."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def conv_same(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (an ``nn.ConvNd`` whose own padding is not used) on the
    channels-last ``x`` with flax's "SAME" padding: symmetric padding goes to
    the convolution, the extra high-end voxel of an odd total to ``F.pad``."""
    pads = same_pads(x.shape[1:-1], conv.kernel_size, conv.stride, conv.dilation)
    extra = [0, 0]                     # channels
    for lo, hi in reversed(pads):
        extra += [0, hi - lo]
    if any(extra):
        x = F.pad(x, extra)
    y = _CONV_FN[len(pads)](x.movedim(-1, 1), conv.weight, conv.bias, conv.stride,
                            [lo for lo, _ in pads], conv.dilation)
    return y.movedim(1, -1)


def instance_norm_cf(norm: nn.GroupNorm, y: torch.Tensor) -> torch.Tensor:
    """Per-channel GroupNorm (flax's ``GroupNorm(group_size=1)``) of a
    channels-first (B, C, *spatial) tensor. A map of one voxel normalises to
    zero (torch's ``group_norm`` refuses that input), leaving the bias (if
    the norm has one)."""
    if y[0, 0].numel() > 1:
        return norm(y)
    if norm.bias is None:
        return torch.zeros_like(y)
    return torch.zeros_like(y) + norm.bias.reshape((1, -1) + (1,) * (y.dim() - 2))


def instance_norm_cl(norm: nn.GroupNorm, y: torch.Tensor) -> torch.Tensor:
    """:func:`instance_norm_cf` of a channels-last tensor."""
    return instance_norm_cf(norm, y.movedim(-1, 1)).movedim(1, -1)


def _norm(features: int) -> nn.GroupNorm:
    return nn.GroupNorm(features, features, eps=1e-5)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


class ConvNormAct(nn.Module):
    """conv ("SAME") -> per-channel GroupNorm (eps 1e-5) -> LeakyReLU(0.01),
    the nnU-Net unit; channels-last in and out."""

    def __init__(self, in_ch: int, features: int, kernel_size, strides=1,
                 dim: int = 2):
        super().__init__()
        self.conv = CONV[dim](in_ch, features, tup(kernel_size, dim),
                              stride=tup(strides, dim))
        self.norm = _norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _leaky(instance_norm_cl(self.norm, conv_same(self.conv, x)))


class StackedConvBlocks(nn.Module):
    """``num_convs`` :class:`ConvNormAct` (``conv0``..); the first carries the
    stage's stride."""

    def __init__(self, num_convs: int, in_ch: int, features: int, kernel_size,
                 first_stride=1, dim: int = 2):
        super().__init__()
        for i in range(num_convs):
            self.add_module(f"conv{i}", ConvNormAct(
                in_ch if i == 0 else features, features, kernel_size,
                first_stride if i == 0 else 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class ResidualBlock(nn.Module):
    """The basic residual block (dynamic_network_architectures BasicBlockD):
    conv-norm-act, conv-norm, plus the input (through a 1x1 conv and a norm
    where the stride or the width changes), then the activation."""

    def __init__(self, in_ch: int, features: int, kernel_size, first_stride=1,
                 dim: int = 2):
        super().__init__()
        k, s = tup(kernel_size, dim), tup(first_stride, dim)
        self.conv1 = CONV[dim](in_ch, features, k, stride=s)
        self.norm1 = _norm(features)
        self.conv2 = CONV[dim](features, features, k)
        self.norm2 = _norm(features)
        if any(si != 1 for si in s) or in_ch != features:
            # a 1x1 "SAME" conv pads nothing, at any stride
            self.skip = CONV[dim](in_ch, features, 1, stride=s)
            self.skip_norm = _norm(features)
        else:
            self.skip = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _leaky(instance_norm_cl(self.norm1, conv_same(self.conv1, x)))
        y = instance_norm_cl(self.norm2, conv_same(self.conv2, y))
        if self.skip is not None:
            x = instance_norm_cl(self.skip_norm, conv_cl(self.skip, x))
        return _leaky(y + x)


class TransposedConvUp(nn.Module):
    """A transposed conv whose kernel is its stride (no overlap), as flax's
    ``ConvTranspose`` under the name ``transpconv``; channels-last."""

    def __init__(self, in_ch: int, features: int, strides, dim: int = 2):
        super().__init__()
        s = tup(strides, dim)
        self.transpconv = CONV_TRANSPOSE[dim](in_ch, features, s, stride=s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_cl(self.transpconv, x)


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


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def max_pool(x: torch.Tensor, window, dim: int = 2) -> torch.Tensor:
    """Non-overlapping max pool of (B, *spatial, C) (floor at odd edges);
    ``window`` an int or one per spatial axis."""
    w = tup(window, dim)
    return _MAX_POOL[dim](x.movedim(-1, 1), w, w).movedim(1, -1)


def max_pool_ceil(x: torch.Tensor, window, dim: int = 2) -> torch.Tensor:
    """:func:`max_pool` with ceil mode: an edge the window does not divide
    pools what is there (the JAX package pads it with -inf first)."""
    w = tup(window, dim)
    return _MAX_POOL[dim](x.movedim(-1, 1), w, w, ceil_mode=True).movedim(1, -1)


def resize_nearest(x: torch.Tensor, new_spatial: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "nearest")`` of (B, *spatial, C): output
    index i of an axis of n reads input floor((i + 1/2) n / m), computed
    exactly. (``F.interpolate``'s "nearest" reads floor(i n / m): 7 -> 4
    reads [0, 1, 3, 5] where JAX reads [0, 2, 4, 6].)"""
    for axis, (n, m) in enumerate(zip(x.shape[1:-1], new_spatial)):
        if n != m:
            idx = torch.tensor([(2 * i + 1) * n // (2 * m) for i in range(m)],
                               device=x.device)
            x = x.index_select(axis + 1, idx)
    return x


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
    modules do: Linear/Conv weights lecun normal with zero biases (a
    transposed conv's fan-in is its input channels times its kernel's
    size), norms one and zero, and modules with parameters of their own
    through their ``reset_parameters(generator)``."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d, nn.Conv3d,
                                   nn.ConvTranspose2d, nn.ConvTranspose3d)):
                w = module.weight
                fan_in = w.shape[0] * w[0, 0].numel() \
                    if getattr(module, "transposed", False) else w[0].numel()
                lecun_normal_(w, fan_in, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
                if module.weight is not None:
                    module.weight.fill_(1.0)
                    module.bias.zero_()
            elif next(module.parameters(recurse=False), None) is not None:
                module.reset_parameters(generator)


def build_seeded(factory, device, seed: int) -> nn.Module:
    """``factory()`` built on the meta device, its parameters drawn from
    ``seed`` on the CPU (:func:`init_parameters`), then moved to ``device``."""
    with torch.device("meta"):
        model = factory()
    model = model.to_empty(device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
