"""The X²Net family's stage mixers (port of ``nnuzoo_tpu/models/mixers.py``).

:class:`MixerLayer` stacks ``depth`` blocks of one token mixer on a
channels-last map:

- "ss2d": VSSBlock (4-direction selective scan, M2Net);
- "ssnd": GSC, then LN (eps 1e-6), SSND and DropPath around a residual
  (SSND2Net);
- "swin": shifted-window attention, the shift on every odd block (2d only;
  the map's size is given when the layer is built, since the window is
  clamped to it);
- "vit": a pre-LN transformer block over the flattened tokens;
- "mamba_alt": LN, a Mamba over the tokens (reversed on every odd block),
  DropPath, residual;
- "mamba2": LN, a Mamba2Block (head width min(64, C)), DropPath, residual;
- "mamba_nd": "mamba_alt" with an RMSNorm.

``drop_path`` is one stochastic-depth rate for every block or one per
block.
"""

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from .attention import SwinBlock, ViTBlock
from .layers import DropPath
from .light_munet import GSC
from .mamba import Mamba2Block, MambaBlock, RMSNorm
from .ss2d import VSSBlock
from .ssnd import SSND

MIXERS = ("ss2d", "ssnd", "swin", "vit", "mamba_alt", "mamba2", "mamba_nd")


class _TokenBlock(nn.Module):
    """A mixer over the flattened tokens ("vit", "mamba_alt", "mamba2",
    "mamba_nd"): norm, mixer, DropPath, residual (the ViTBlock has its
    own)."""

    def __init__(self, mixer: str, dim: int, block_index: int = 0,
                 drop_path: float = 0.0):
        super().__init__()
        self.mixer = mixer
        self.reverse = block_index % 2 == 1 and mixer in ("mamba_alt", "mamba_nd")
        if mixer == "vit":
            self.vit = ViTBlock(dim, max(1, dim // 32), drop_path=drop_path)
            return
        if mixer == "mamba2":
            self.norm = nn.LayerNorm(dim, eps=1e-6)
            self.mamba2 = Mamba2Block(dim, headdim=min(64, dim))
        elif mixer in ("mamba_alt", "mamba_nd"):
            self.norm = nn.LayerNorm(dim, eps=1e-6) if mixer == "mamba_alt" \
                else RMSNorm(dim)
            self.mamba = MambaBlock(dim)
        else:
            raise ValueError(f"unknown token mixer {mixer!r}")
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, spatial, C = x.shape[0], x.shape[1:-1], x.shape[-1]
        flat = x.reshape(B, -1, C)
        if self.mixer == "vit":
            return self.vit(flat).reshape(x.shape)
        h = self.norm(flat)
        if self.mixer == "mamba2":
            h = self.mamba2(h)
        else:
            h = self.mamba(h.flip(1)).flip(1) if self.reverse else self.mamba(h)
        return (flat + self.drop_path(h)).reshape(B, *spatial, C)


class MixerLayer(nn.Module):
    """``depth`` blocks of ``mixer`` (one of :data:`MIXERS`) at ``dim``
    channels on a channels-last (B, *spatial, dim) map. ``spatial`` (the
    map's size) is needed by "swin" only."""

    def __init__(self, dim: int, depth: int, mixer: str = "ss2d",
                 d_state: int = 16, spatial_dims: int = 2,
                 drop_path: Union[float, Sequence[float]] = 0.0,
                 spatial: Optional[Sequence[int]] = None):
        super().__init__()
        if mixer not in MIXERS:
            raise ValueError(f"unknown token mixer {mixer!r}; one of {MIXERS}")
        if mixer == "swin" and (spatial is None or len(spatial) != 2):
            raise ValueError("the swin mixer takes a 2d map whose size is given")
        self.depth, self.mixer = depth, mixer
        for i in range(depth):
            # one rate for all blocks, or the reference's per-block slices
            dp = drop_path[i] if isinstance(drop_path, (tuple, list)) else drop_path
            if mixer == "ss2d":
                self.add_module(f"block{i}", VSSBlock(dim, d_state, dp))
            elif mixer == "ssnd":
                self.add_module(f"gsc{i}", GSC(dim, spatial_dims))
                self.add_module(f"ln{i}", nn.LayerNorm(dim, eps=1e-6))
                self.add_module(f"block{i}", SSND(dim, spatial_dims, d_state))
                self.add_module(f"drop_path{i}", DropPath(dp))
            elif mixer == "swin":
                window = 7
                self.add_module(f"block{i}", SwinBlock(
                    dim, max(1, dim // 32), spatial, window,
                    0 if i % 2 == 0 else window // 2, drop_path=dp))
            else:
                self.add_module(f"block{i}", _TokenBlock(mixer, dim, i, dp))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            if self.mixer == "ssnd":
                x = getattr(self, f"gsc{i}")(x)
                branch = getattr(self, f"block{i}")(getattr(self, f"ln{i}")(x))
                x = x + getattr(self, f"drop_path{i}")(branch)
            else:
                x = getattr(self, f"block{i}")(x)
        return x
