"""Mamba sequence blocks on the selective-scan kernels (port of
``nnuzoo_tpu/models/mamba.py``).

in_proj -> depthwise causal conv1d + SiLU -> x_proj (dt, B, C) -> selective
scan -> gate * silu(z) -> out_proj. Each scan branch calls the
Mamba-convention :func:`selective_scan` with K=1 (all of ``d_inner`` in one
direction), so on the card its forward runs on K1 and its backward on K2.

``bimamba_type``:
- None: unidirectional.
- "v1"/"v2" (bidirectional): a second parameter set (``bwd``) scans the
  flipped sequence; the outputs are added.
- "v3" (SegMamba's trimodal): ``bwd`` and a third set (``spatial``) that
  scans the sequence reordered slice-major over ``nslices`` groups.

``Mamba2Block`` (light_mamba2net's Mamba2): per-head scalar decay, B and C
shared by all heads, gated RMSNorm. It has two routes, chosen when it is
built from ``NNUZOO_SCAN_BACKEND`` (:func:`mamba2_route`): the chunked SSD
of ``ops/ssd.py`` (matmuls; the default), or with "mamba1" the per-head A,
dt and D broadcast over each head's channels and the Mamba-convention
:func:`selective_scan`, on K1/K2 on the card.
"""

import math
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.selective_scan import selective_scan
from ..ops.ssd import ssd_chunked


def _causal_conv1d(x, kernel, bias=None):
    """x (B, L, D), depthwise causal conv along L with kernel (K, D):
    out_t = sum_k x_{t+k-K+1} kernel_k (+ bias), zeros before the start."""
    K, D = kernel.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))
    return F.conv1d(xp, kernel.t().unsqueeze(1), bias, groups=D).transpose(1, 2)


class _ScanBranch(nn.Module):
    """One directional scan parameter set: conv1d + x_proj + dt_proj + A/D.
    ``scan_backend`` is the scan's backend (None: the kernels; "plain" or
    "plain_pair": the plain scan, see ``ss2d.set_scan_backend``)."""

    def __init__(self, d_inner: int, d_state: int, dt_rank: int, d_conv: int):
        super().__init__()
        self.dt_rank, self.d_state = dt_rank, d_state
        self.conv1d_weight = nn.Parameter(torch.empty(d_conv, d_inner))
        self.conv1d_bias = nn.Parameter(torch.empty(d_inner))
        self.x_proj = nn.Linear(d_inner, dt_rank + 2 * d_state, bias=False)
        self.dt_proj_weight = nn.Parameter(torch.empty(d_inner, dt_rank))
        self.dt_proj_bias = nn.Parameter(torch.empty(d_inner))
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.empty(d_inner))
        self.scan_backend: Optional[str] = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         dt_min: float = 0.001, dt_max: float = 0.1,
                         dt_init_floor: float = 1e-4) -> None:
        """The JAX package's initialisers: the conv lecun normal over its
        taps, zero bias, dt_proj U(+-rank^-0.5) with the inverse softplus of
        dt ~ logU(dt_min, dt_max) as bias, S4D-real A = 1..N (as log), D = 1."""
        with torch.no_grad():
            self.conv1d_weight.normal_(
                0.0, 1.0 / math.sqrt(self.conv1d_weight.shape[0]),
                generator=generator)
            self.conv1d_bias.zero_()
            scale = self.dt_rank ** -0.5
            self.dt_proj_weight.uniform_(-scale, scale, generator=generator)
            dt = torch.empty_like(self.dt_proj_bias).uniform_(generator=generator)
            dt = torch.exp(dt * (math.log(dt_max) - math.log(dt_min)) +
                           math.log(dt_min)).clamp(min=dt_init_floor)
            self.dt_proj_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            a = torch.arange(1, self.d_state + 1, dtype=torch.float32)
            self.A_log.copy_(torch.log(a).expand_as(self.A_log))
            self.D.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, L, d_inner) -> scan output (B, L, d_inner), no gating."""
        x = F.silu(_causal_conv1d(x, self.conv1d_weight, self.conv1d_bias))
        dt, Bm, Cm = torch.split(self.x_proj(x),
                                 [self.dt_rank, self.d_state, self.d_state], -1)
        delta = dt @ self.dt_proj_weight.t()
        y = selective_scan(
            x.transpose(1, 2), delta.transpose(1, 2), -torch.exp(self.A_log),
            Bm.transpose(1, 2), Cm.transpose(1, 2), D=self.D,
            delta_bias=self.dt_proj_bias, delta_softplus=True,
            backend=self.scan_backend)
        return y.transpose(1, 2)


class MambaBlock(nn.Module):
    """Drop-in for mamba_ssm.Mamba: x (B, L, d_model) -> (B, L, d_model).
    ``nslices`` ("v3") can also be given to :meth:`forward`, which SegMamba
    does: its slice count follows the input's length."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: Optional[int] = None,
                 bimamba_type: Optional[str] = None,
                 nslices: Optional[int] = None):
        super().__init__()
        if bimamba_type not in (None, "v1", "v2", "v3"):
            raise ValueError(f"bimamba_type must be None, v1, v2 or v3, got "
                             f"{bimamba_type!r}")
        d_inner = int(expand * d_model)
        dt_rank = dt_rank or math.ceil(d_model / 16)
        self.bimamba_type, self.nslices = bimamba_type, nslices
        branch = (d_inner, d_state, dt_rank, d_conv)
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.fwd = _ScanBranch(*branch)
        if bimamba_type is not None:
            self.bwd = _ScanBranch(*branch)
        if bimamba_type == "v3":
            self.spatial = _ScanBranch(*branch)
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    def forward(self, x: torch.Tensor,
                nslices: Optional[int] = None) -> torch.Tensor:
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        y = self.fwd(xs)
        if self.bimamba_type is not None:
            y = y + self.bwd(xs.flip(1)).flip(1)
        if self.bimamba_type == "v3":
            ns = nslices or self.nslices
            if ns is None:
                raise ValueError("v3 (spatial) needs nslices")
            B_, L, D = xs.shape
            per = L // ns
            # slice-major reordering: (B, ns, per, D) -> (B, per, ns, D)
            xs_s = xs.reshape(B_, ns, per, D).transpose(1, 2).reshape(B_, L, D)
            y_s = self.spatial(xs_s)
            y = y + y_s.reshape(B_, per, ns, D).transpose(1, 2).reshape(B_, L, D)
        return self.out_proj(y * F.silu(z))


MAMBA2_ROUTES = ("ssd", "mamba1")
# the other values the JAX package takes for NNUZOO_SCAN_BACKEND: they pick
# among its scan implementations, which the port does not have, and leave
# Mamba2Block on SSD there as here
_OTHER_SCAN_BACKENDS = ("pallas", "xla", "ref")


def mamba2_route() -> str:
    """Mamba2Block's route from ``NNUZOO_SCAN_BACKEND``: "mamba1" takes the
    selective scan; unset, empty, "pallas", "xla" or "ref" the SSD; anything
    else raises."""
    env = os.environ.get("NNUZOO_SCAN_BACKEND") or ""
    if env == "mamba1":
        return "mamba1"
    if env in ("",) + _OTHER_SCAN_BACKENDS:
        return "ssd"
    raise ValueError(f"NNUZOO_SCAN_BACKEND must be unset, mamba1, "
                     f"{', '.join(_OTHER_SCAN_BACKENDS)}; got {env!r}")


class Mamba2Block(nn.Module):
    """Mamba2 / SSD: x (B, L, d_model) -> (B, L, d_model). in_proj makes z,
    x, B, C and dt together; x, B and C go through one causal depthwise
    conv and SiLU; nheads = d_inner // headdim heads of scalar decay
    A = -exp(A_log) read one B and C (one group); then y * silu(z), an
    RMSNorm (eps 1e-5) with ``norm_weight``, out_proj. ``route`` ("ssd" or
    "mamba1", see :func:`mamba2_route`) is read from the environment when
    None; ``scan_backend`` is the mamba1 route's (see ``_ScanBranch``)."""

    def __init__(self, d_model: int, d_state: int = 64, d_conv: int = 4,
                 expand: int = 2, headdim: int = 64,
                 route: Optional[str] = None):
        super().__init__()
        route = route or mamba2_route()
        if route not in MAMBA2_ROUTES:
            raise ValueError(f"route must be one of {MAMBA2_ROUTES}, got {route!r}")
        self.route = route
        self.d_inner = d_inner = int(expand * d_model)
        self.nheads = nheads = max(1, d_inner // headdim)
        self.headdim = d_inner // nheads
        self.d_state = N = d_state
        self.in_proj = nn.Linear(d_model, 2 * d_inner + 2 * N + nheads, bias=False)
        self.conv1d_weight = nn.Parameter(torch.empty(d_conv, d_inner + 2 * N))
        self.conv1d_bias = nn.Parameter(torch.empty(d_inner + 2 * N))
        self.A_log = nn.Parameter(torch.empty(nheads))
        self.dt_bias = nn.Parameter(torch.empty(nheads))
        self.D = nn.Parameter(torch.empty(nheads))
        self.norm_weight = nn.Parameter(torch.empty(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)
        self.scan_backend: Optional[str] = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         dt_min: float = 0.001, dt_max: float = 0.1,
                         dt_init_floor: float = 1e-4) -> None:
        """The JAX package's initialisers: the conv lecun normal over its
        taps, zero bias, A = -U(1, 16) (as log), dt_bias the inverse
        softplus of dt ~ logU(dt_min, dt_max), D and the norm's weight 1."""
        with torch.no_grad():
            self.conv1d_weight.normal_(
                0.0, 1.0 / math.sqrt(self.conv1d_weight.shape[0]),
                generator=generator)
            self.conv1d_bias.zero_()
            a = torch.empty_like(self.A_log).uniform_(1.0, 16.0, generator=generator)
            self.A_log.copy_(torch.log(a))
            dt = torch.empty_like(self.dt_bias).uniform_(generator=generator)
            dt = torch.exp(dt * (math.log(dt_max) - math.log(dt_min)) +
                           math.log(dt_min)).clamp(min=dt_init_floor)
            self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            self.D.fill_(1.0)
            self.norm_weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B_, L, _ = x.shape
        d_inner, N, H, P = self.d_inner, self.d_state, self.nheads, self.headdim
        z, xbc, dt = torch.split(self.in_proj(x), [d_inner, d_inner + 2 * N, H], -1)
        xbc = F.silu(_causal_conv1d(xbc, self.conv1d_weight, self.conv1d_bias))
        xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], -1)
        A = -torch.exp(self.A_log)
        if self.route == "mamba1":
            # the per-head scalars over each head's channels (and A over the
            # states): one direction of d_inner channels on the selective scan
            y = selective_scan(
                xs.transpose(1, 2), dt.repeat_interleave(P, -1).transpose(1, 2),
                A.repeat_interleave(P)[:, None].expand(d_inner, N),
                Bm.transpose(1, 2), Cm.transpose(1, 2),
                D=self.D.repeat_interleave(P),
                delta_bias=self.dt_bias.repeat_interleave(P), delta_softplus=True,
                backend=self.scan_backend).transpose(1, 2)
        else:
            y = ssd_chunked(xs.reshape(B_, L, H, P), dt, A, Bm[:, :, None],
                            Cm[:, :, None], D=self.D, dt_bias=self.dt_bias,
                            chunk_size=128).reshape(B_, L, d_inner)
        y = y * F.silu(z)
        y = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True) + 1e-5) * self.norm_weight
        return self.out_proj(y)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight over the last axis."""

    def __init__(self, dim: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.epsilon) \
            * self.weight
