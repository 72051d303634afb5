"""Transformer blocks: ViT blocks and (shifted-)window Swin attention (port of
``nnuzoo_tpu/models/attention.py``). Channels-last, 2d and 3d.

Attention is written out as the JAX package writes it, in the input's
dtype: q·kᵀ times ``head_dim ** -0.5``, plus the relative-position bias and
the shift mask, softmax, then ·v. Every LayerNorm has flax's eps 1e-6 and
every GELU is exact (erf).

Torch builds parameters before it sees an input, and a Swin block's window
(so its bias table) is clamped to the map it attends over: the window
blocks take that map's ``spatial`` extent when they are built, and raise
if a forward's input would clamp the window otherwise. The shift mask and
the relative-position index are built per shape and device (cached, never
in the ``state_dict``); the mask is -100, not -inf, over the padded
extent, and the padded tokens are attended to without a mask, as in the
JAX package.
"""

import functools
import itertools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import DropPath


def _layer_norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=1e-6)


def trunc_normal_02_(param: torch.Tensor,
                     generator: Optional[torch.Generator]) -> None:
    """flax's ``truncated_normal(0.02)``: 0.02 times a normal cut at ±2."""
    with torch.no_grad():
        nn.init.trunc_normal_(param, 0.0, 0.02, -0.04, 0.04, generator=generator)


class MLP(nn.Module):
    """Linear -> exact GELU -> Linear."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def multi_head_attention(x: torch.Tensor, qkv: nn.Linear, proj: nn.Linear,
                         num_heads: int, bias: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """proj(softmax(q·kᵀ·hd^-0.5 + bias + mask)·v) of (Bn, L, C) tokens.
    ``bias`` (heads, L, L) is added to every row; ``mask`` (nW, L, L) to the
    nW windows of each sample (Bn = batch * nW, windows of a sample
    adjacent)."""
    Bn, L, C = x.shape
    hd = C // num_heads
    q, k, v = qkv(x).reshape(Bn, L, 3, num_heads, hd).permute(2, 0, 3, 1, 4) \
        .unbind(0)
    attn = (q @ k.transpose(-2, -1)) * hd ** -0.5
    if bias is not None:
        attn = attn + bias
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.reshape(Bn // nW, nW, num_heads, L, L)
                + mask[None, :, None]).reshape(Bn, num_heads, L, L)
    out = attn.softmax(-1) @ v
    return proj(out.transpose(1, 2).reshape(Bn, L, C))


class Attention(nn.Module):
    """Multi-head self-attention over all tokens (ViT)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return multi_head_attention(x, self.qkv, self.proj, self.num_heads)


class ViTBlock(nn.Module):
    """Pre-LN transformer block; one DropPath serves both residual
    branches."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = _layer_norm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.drop_path = DropPath(drop_path)
        self.norm2 = _layer_norm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


# ------------------------------------------------------------------ windows
def _window_perm(dims: int):
    # (B, n0, w0, n1, w1, ..., C) -> (B, n0, n1, ..., w0, w1, ..., C)
    return [0] + [1 + 2 * i for i in range(dims)] + \
        [2 + 2 * i for i in range(dims)] + [1 + 2 * dims]


def window_partition_nd(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, *spatial, C) -> (B*nW, prod(window), C), windows of a sample
    adjacent, row-major."""
    B, C = x.shape[0], x.shape[-1]
    shape = [B]
    for s, w in zip(x.shape[1:-1], window):
        shape += [s // w, w]
    x = x.reshape(*shape, C).permute(_window_perm(len(window)))
    return x.reshape(-1, math.prod(window), C)


def window_reverse_nd(wins: torch.Tensor, window: Sequence[int],
                      spatial: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`window_partition_nd` for a map of ``spatial``."""
    dims = len(spatial)
    nw = [s // w for s, w in zip(spatial, window)]
    B = wins.shape[0] // math.prod(nw)
    x = wins.reshape(B, *nw, *window, -1)
    perm = [0]
    for i in range(dims):
        perm += [1 + i, 1 + dims + i]
    x = x.permute(perm + [1 + 2 * dims])
    return x.reshape(B, *spatial, x.shape[-1])


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window*window, C)."""
    return window_partition_nd(x, (window, window))


def window_reverse(wins: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    return window_reverse_nd(wins, (window, window), (H, W))


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def _shift_regions(spatial: Tuple[int, ...], window: Tuple[int, ...],
                   shift: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """(nW, prod(window)): the region of each windowed position. Each
    shifted axis falls into (body, window-shift, shift) bands. (The cache
    outlives a serving call's inference mode, so its tensors are made
    outside it: a training step may use them next.)"""
    img = torch.zeros((1, *spatial, 1), device=device)
    bands = [(slice(0, -w), slice(-w, -s), slice(-s, None)) if s > 0
             else (slice(None),) for w, s in zip(window, shift)]
    for cnt, region in enumerate(itertools.product(*bands)):
        img[(slice(None), *region, slice(None))] = cnt
    return window_partition_nd(img, window)[..., 0]


def shift_attn_mask_nd(spatial: Sequence[int], window: Sequence[int],
                       shift: Sequence[int], device=None,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(nW, L, L) additive mask of the shifted windows over the (padded)
    map ``spatial``: -100 between positions of different regions, else 0."""
    m = _shift_regions(tuple(spatial), tuple(window), tuple(shift),
                       torch.device(device or "cpu"))
    return torch.where(m[:, None, :] != m[:, :, None], -100.0, 0.0).to(dtype)


def shift_attn_mask(H: int, W: int, window: int, shift: int, device=None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return shift_attn_mask_nd((H, W), (window, window), (shift, shift), device,
                              dtype)


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def relative_position_index(window: Tuple[int, ...],
                            device: torch.device) -> torch.Tensor:
    """The (L, L) index, flattened, into a (prod(2w-1), heads) bias table:
    the offset of the key from the query, each axis shifted to be
    non-negative, row-major with the last axis fastest."""
    dims = len(window)
    coords = np.stack(np.meshgrid(*[np.arange(w) for w in window],
                                  indexing="ij")).reshape(dims, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    index = np.zeros(rel.shape[:2], dtype=np.int64)
    stride = 1
    for i in range(dims - 1, -1, -1):
        index += (rel[..., i] + window[i] - 1) * stride
        stride *= 2 * window[i] - 1
    return torch.from_numpy(index.reshape(-1)).to(device)


class WindowAttentionND(nn.Module):
    """Windowed multi-head self-attention with an N-d relative-position
    bias (a learned (prod(2w-1), heads) table)."""

    def __init__(self, dim: int, window: Sequence[int], num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.window = tuple(int(w) for w in window)
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            math.prod(2 * w - 1 for w in self.window), num_heads))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        trunc_normal_02_(self.relative_position_bias_table, generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        L = x.shape[1]
        index = relative_position_index(self.window, x.device)
        bias = self.relative_position_bias_table[index].reshape(
            L, L, self.num_heads).permute(2, 0, 1)
        return multi_head_attention(x, self.qkv, self.proj, self.num_heads,
                                    bias, mask)


class WindowAttention(WindowAttentionND):
    """2d windows of ``window`` x ``window``."""

    def __init__(self, dim: int, window: int, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__(dim, (window, window), num_heads, qkv_bias)


class _WindowBlock(nn.Module):
    """norm1 -> zero-pad to window multiples -> roll -> windowed attention
    (shift mask) -> roll back -> crop -> residual; norm2 -> MLP ->
    residual. Subclasses say which window and shift a map gets."""

    def __init__(self, dim: int, num_heads: int, window: Tuple[int, ...],
                 mlp_ratio: float, drop_path: float):
        super().__init__()
        self.norm1 = _layer_norm(dim)
        self.attn = WindowAttentionND(dim, window, num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = _layer_norm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim)

    def window_and_shift(self, spatial):
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = tuple(x.shape[1:-1])
        window, shift = self.window_and_shift(spatial)
        if window != self.attn.window:
            raise ValueError(f"a {spatial} map takes windows {window}; this "
                             f"block was built for {self.attn.window}")
        dims = len(spatial)
        axes = tuple(range(1, dims + 1))
        pads = [(-s) % w for s, w in zip(spatial, window)]
        h = self.norm1(x)
        if any(pads):
            flat = [0, 0]
            for p in reversed(pads):
                flat += [0, p]
            h = F.pad(h, flat)
        padded = tuple(s + p for s, p in zip(spatial, pads))
        mask = None
        if any(shift):
            h = torch.roll(h, tuple(-s for s in shift), axes)
            mask = shift_attn_mask_nd(padded, window, shift, h.device, h.dtype)
        h = window_reverse_nd(self.attn(window_partition_nd(h, window), mask),
                              window, padded)
        if any(shift):
            h = torch.roll(h, shift, axes)
        if any(pads):
            h = h[(slice(None),) + tuple(slice(0, s) for s in spatial)]
        x = x + self.drop_path(h)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class SwinBlock(_WindowBlock):
    """2d (shifted-)window block. The window is clamped to the map; the
    shift is kept whenever the window was not clamped, even when it spans
    the whole map, and dropped when it was."""

    def __init__(self, dim: int, num_heads: int, spatial: Sequence[int],
                 window: int = 7, shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        self.nominal_window, self.shift = window, shift
        w = min(window, *spatial)
        super().__init__(dim, num_heads, (w, w), mlp_ratio, drop_path)

    def window_and_shift(self, spatial):
        H, W = spatial
        w = min(self.nominal_window, H, W)
        s = self.shift if w == self.nominal_window else 0
        return (w, w), (s, s)


class SwinBlockND(_WindowBlock):
    """The N-d (shifted-)window block. At 3d one window per axis,
    min(window, s), and no shift on an axis that the window covers; at 2d
    a :class:`SwinBlock` under the name ``block2d``."""

    def __init__(self, dim: int, num_heads: int, spatial: Sequence[int],
                 window: int = 7, shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        self.nominal_window, self.shift = window, shift
        if len(spatial) == 2:
            nn.Module.__init__(self)
            self.block2d = SwinBlock(dim, num_heads, spatial, window, shift,
                                     mlp_ratio, drop_path)
        else:
            super().__init__(dim, num_heads,
                             tuple(min(window, s) for s in spatial),
                             mlp_ratio, drop_path)
            self.block2d = None

    def window_and_shift(self, spatial):
        window = tuple(min(self.nominal_window, s) for s in spatial)
        return window, tuple(self.shift if w < s else 0
                             for w, s in zip(window, spatial))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.block2d is not None:
            return self.block2d(x)
        return super().forward(x)
