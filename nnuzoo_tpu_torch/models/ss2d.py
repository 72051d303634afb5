"""SS2D: 4-direction visual selective scan (port of
``nnuzoo_tpu/models/ss2d.py``).

Channels-last. The 4 scan directions are row-major, column-major and their
reverses. Two glues compute the same function:

- "default": the 4 directions become K=4 groups of one
  :func:`selective_scan_blkd` call (projections in PyTorch, the selective-scan
  kernels on the card);
- "fused": two :func:`cross_scan_fused` calls, one per traversal
  orientation, each running the projections and the scan of both axis orders
  in the fused cross-scan kernels; the reversed sequences are never built.

The glue is read from ``NNUZOO_SS2D_FUSED`` when the SS2D is built ("1":
fused; unset or "0": default), as the JAX package reads it, and can be set
afterwards with :func:`set_ss2d_glue`. The fused kernels take Dh = d_inner a
multiple of 32 up to 256 and a dt rank up to 8 (d_model 16..128 in steps of
16): a wider SS2D raises on the fused glue, whether built with it or set to
it, rather than quietly taking the default glue. The JAX package's
lane-packed glue (``NNUZOO_SS2D_PACKED``) is not ported yet.
"""

import math
import os
from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cross_scan import KERNEL_MAX_DH, KERNEL_MAX_RANK, cross_scan_fused
from ..ops.selective_scan import selective_scan_blkd
from .layers import DropPath, conv_cl

GLUES = ("default", "fused")


def fused_scan_mode() -> bool:
    """Whether ``NNUZOO_SS2D_FUSED`` selects the fused glue: "1" does, unset
    or "0" does not; anything else raises (the port has no interpret mode:
    on the CPU the fused glue runs its plain version)."""
    env = os.environ.get("NNUZOO_SS2D_FUSED") or "0"
    if env not in ("0", "1"):
        raise ValueError(f"NNUZOO_SS2D_FUSED must be 0 or 1, got {env!r}")
    return env == "1"


class GluedScan(nn.Module):
    """What SS2D and the N-d SSND share: the cross-scan parameters of K
    directions over ``d_inner`` channels (``x_proj_weight``,
    ``dt_projs_weight``, ``dt_projs_bias``, ``A_logs``, ``Ds``), their
    initialisation, the glue ("default" or "fused", read from
    ``NNUZOO_SS2D_FUSED`` when built) and the scan backend."""

    def __init__(self, d_model: int, n_dirs: int, d_state: int = 16,
                 expand: int = 2, dt_rank: Optional[int] = None):
        super().__init__()
        self.d_inner = int(expand * d_model)
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.d_state = d_state
        self.n_dirs = n_dirs
        self.scan_backend: Optional[str] = None
        self.glue = "default"

    def add_scan_parameters(self) -> None:
        """Register the K directions' scan parameters (a subclass calls this
        after its input projections, so that they keep the JAX module's
        order)."""
        K, D, R, N = self.n_dirs, self.d_inner, self.dt_rank, self.d_state
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, D))
        self.A_logs = nn.Parameter(torch.empty(K * D, N))
        self.Ds = nn.Parameter(torch.empty(K * D))

    def read_glue(self) -> None:
        """Take the fused glue where ``NNUZOO_SS2D_FUSED`` asks for it."""
        if fused_scan_mode():
            self.check_fused()
            self.glue = "fused"

    def check_fused(self) -> None:
        """Raise ``ValueError`` where the fused glue's kernels (K3/K4) cannot
        run this module's widths."""
        Dh, R = self.d_inner, self.dt_rank
        if Dh % 32 or not 32 <= Dh <= KERNEL_MAX_DH or R > KERNEL_MAX_RANK:
            raise ValueError(
                f"the fused glue's kernels (K3/K4) take Dh = d_inner a "
                f"multiple of 32 up to {KERNEL_MAX_DH} and dt rank R up to "
                f"{KERNEL_MAX_RANK}; this {type(self).__name__} has Dh={Dh}, "
                f"R={R}: use the default glue")

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         dt_min: float = 0.001, dt_max: float = 0.1,
                         dt_init_floor: float = 1e-4) -> None:
        """The reference's SS2D initialisation: S4D-real A = 1..N (stored as
        log), D = 1, x_proj N(0, 0.02), dt_proj weight U(+-rank^-0.5) and a
        bias that is the inverse softplus of dt ~ logU(dt_min, dt_max)."""
        with torch.no_grad():
            self.x_proj_weight.normal_(0.0, 0.02, generator=generator)
            scale = self.dt_rank ** -0.5
            self.dt_projs_weight.uniform_(-scale, scale, generator=generator)
            dt = torch.empty_like(self.dt_projs_bias).uniform_(generator=generator)
            dt = torch.exp(dt * (math.log(dt_max) - math.log(dt_min)) +
                           math.log(dt_min)).clamp(min=dt_init_floor)
            self.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            a = torch.arange(1, self.d_state + 1, dtype=torch.float32)
            self.A_logs.copy_(torch.log(a).expand_as(self.A_logs))
            self.Ds.fill_(1.0)

    def scan_streams(self, streams: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each of the G = K/2 streams (B, L, d_inner) scanned forwards and
        backwards, by this module's glue: the sum of the two directions of
        each stream, in its natural order."""
        G, D, R, N = len(streams), self.d_inner, self.dt_rank, self.d_state
        A = -torch.exp(self.A_logs)
        if self.glue == "fused":
            # directions 0..G-1 forwards, then G..2G-1 as the same streams
            # walked from the right; y comes back in natural order
            GD = G * D
            y_f = cross_scan_fused(
                streams, self.x_proj_weight[:G], self.dt_projs_weight[:G],
                self.dt_projs_bias[:G], A[:GD], self.Ds[:GD], reverse=False,
                backend=self.scan_backend)
            y_r = cross_scan_fused(
                streams, self.x_proj_weight[G:], self.dt_projs_weight[G:],
                self.dt_projs_bias[G:], A[GD:], self.Ds[GD:], reverse=True,
                backend=self.scan_backend)
            ys = y_f + y_r                                  # (B, L, G*D)
            return [ys[..., g * D:(g + 1) * D] for g in range(G)]
        fwd = torch.stack(list(streams), dim=2)             # (B, L, G, D)
        xs = torch.cat([fwd, fwd.flip(1)], dim=2)           # (B, L, K, D)
        x_dbl = torch.einsum("blkd,kcd->blkc", xs, self.x_proj_weight)
        dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
        dts = torch.einsum("blkr,kdr->blkd", dts, self.dt_projs_weight)
        out_y = selective_scan_blkd(
            xs, dts, A, Bs, Cs, D=self.Ds,
            delta_bias=self.dt_projs_bias.reshape(-1), delta_softplus=True,
            backend=self.scan_backend)                      # (B, L, K, D)
        return [out_y[:, :, g] + out_y[:, :, g + G].flip(1) for g in range(G)]


class SS2D(GluedScan):
    """x (B, H, W, d_model) -> same shape.

    ``glue`` is "default" or "fused" (see the module's docstring).
    ``scan_backend`` is passed to :func:`selective_scan_blkd` or
    :func:`cross_scan_fused`: None runs the kernel path, "plain" and
    "plain_pair" the plain PyTorch scan (used to compare the two on the card,
    see :func:`set_scan_backend`)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 3,
                 expand: int = 2, dt_rank: Optional[int] = None,
                 dropout: float = 0.0, conv_bias: bool = True,
                 bias: bool = False):
        super().__init__(d_model, 4, d_state, expand, dt_rank)
        if d_conv % 2 == 0:
            raise ValueError("SS2D takes an odd d_conv (symmetric SAME padding)")
        d_inner = self.d_inner
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=bias)
        self.conv2d = nn.Conv2d(d_inner, d_inner, d_conv, padding=d_conv // 2,
                                groups=d_inner, bias=conv_bias)
        self.add_scan_parameters()
        self.out_norm = nn.LayerNorm(d_inner, eps=1e-6)
        self.out_proj = nn.Linear(d_inner, d_model, bias=bias)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        self.read_glue()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        D = self.d_inner
        xpart, z = self.in_proj(x).chunk(2, dim=-1)
        xc = F.silu(conv_cl(self.conv2d, xpart))            # (B, H, W, D)
        # the 2 traversal orders; directions 2/3 are their reversals
        y_hw, y_wh = self.scan_streams(
            (xc.reshape(B, H * W, D), xc.transpose(1, 2).reshape(B, H * W, D)))
        # merge the directions back into row-major order
        y = y_hw.reshape(B, H, W, D) + y_wh.reshape(B, W, H, D).transpose(1, 2)
        y = self.out_norm(y) * F.silu(z)
        return self.dropout(self.out_proj(y))


class VSSBlock(nn.Module):
    """LN -> SS2D -> DropPath -> residual."""

    def __init__(self, hidden_dim: int, d_state: int = 16,
                 drop_path: float = 0.0):
        super().__init__()
        self.ln_1 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.self_attention = SS2D(d_model=hidden_dim, d_state=d_state)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.drop_path(self.self_attention(self.ln_1(x)))


class VSSLayer(nn.Module):
    """Stack of VSSBlocks ``block0..``; ``drop_path`` is one rate for all
    blocks or one per block."""

    def __init__(self, dim: int, depth: int, d_state: int = 16,
                 drop_path: Union[float, Sequence[float]] = 0.0):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            dp = drop_path[i] if isinstance(drop_path, (tuple, list)) else drop_path
            self.add_module(f"block{i}", VSSBlock(dim, d_state, dp))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return x


def set_scan_backend(model: nn.Module, backend: Optional[str]) -> None:
    """Point every scan of ``model`` at a scan backend (None: the kernel path;
    "plain": the plain PyTorch scan; "plain_pair": the plain scan with its
    plain backward): every module with a ``scan_backend``, each SS2D (either
    glue) and each MambaBlock's scan branch."""
    for module in model.modules():
        if hasattr(module, "scan_backend"):
            module.scan_backend = backend


def set_ss2d_glue(model: nn.Module, glue: str) -> None:
    """Set the glue of every SS2D and SSND in ``model``: "default" or
    "fused". The fused glue raises ``ValueError``, and changes nothing,
    where one is wider than its kernels take (:meth:`GluedScan.check_fused`)."""
    if glue not in GLUES:
        raise ValueError(f"glue must be one of {GLUES}, got {glue!r}")
    blocks = [m for m in model.modules() if isinstance(m, GluedScan)]
    if glue == "fused":
        for module in blocks:
            module.check_fused()
    for module in blocks:
        module.glue = glue
