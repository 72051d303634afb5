"""Mamba2's SSD (state-space duality): the chunked scan (port of
``nnuzoo_tpu/ops/ssd.py``).

Per-head scalar decay:

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t x_t ;  y_t = C_t . h_t (+ D x)

The sequence is cut into chunks of Q steps (Q = min(chunk_size, L), L padded
to a multiple of Q), and the scan becomes matmuls:

  intra-chunk   Y[i] += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
                -> one masked (Q, Q) product a chunk and head
  chunk states  S_c   = sum_j exp(cum_end - cum_j) B_j (dt_j x_j)^T
  state passing H_c   = sum_{k<c} exp(cum_end_{k+1} + .. + cum_end_{c-1}) S_k
                -> one masked (nc, nc) decay matrix a head, by a matmul
  inter-chunk   Y[i] += exp(cum_i) C_i . H_c

Every exponent is of a sum of non-positive numbers. The causal mask goes on
the exponent, never on the product: above the diagonal the exponent is
positive and its exp could overflow to inf, and 0*inf poisons the backward.
The state passing takes the segment sums by a masked cumulative sum (Mamba2's
``segsum``), so each exponent is a sum over its own segment and not the
difference of two long running sums.

The (Q, Q) blocks of the intra-chunk term are B*nc*H*Q*Q numbers a call
(5.6 GB in fp32 for one LightMamba2Net layer at batch 12 and 256x224), so
:class:`_IntraChunk` makes them one slice of (batch x chunks) at a time and
saves only its inputs; its backward makes them again. B and C are shared by
the heads of a group and are never repeated to heads. Math in fp32 (fp64
for fp64 inputs).
"""

from typing import Optional

import torch
import torch.nn.functional as F

# the bytes of one (Q, Q) block tensor of a slice of the intra-chunk term
_SLICE_BYTES = 1 << 27


def _slices(n: int, per_item_bytes: int):
    step = max(1, _SLICE_BYTES // max(per_item_bytes, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _tril(Q: int, device, diagonal: int = 0) -> torch.Tensor:
    return torch.ones(Q, Q, dtype=torch.bool, device=device).tril(diagonal)


def _intra_blocks(Cg, Bg, cum, mask):
    """scores (s, G, Q, Q) = C B^T of each group, and decay (s, H, Q, Q) =
    exp(cum_i - cum_j) on and below the diagonal, 0 above it."""
    scores = Cg @ Bg.transpose(-1, -2)
    diff = cum[..., :, None] - cum[..., None, :]
    return scores, torch.exp(diff.masked_fill(~mask, float("-inf")))


def _mix(scores, decay):
    """The (s, H, Q, Q) blocks scores * decay, head h in group h // (H/G)."""
    s, G, Q = scores.shape[0], scores.shape[1], scores.shape[-1]
    H = decay.shape[1]
    return (scores[:, :, None] * decay.view(s, G, H // G, Q, Q)).view(s, H, Q, Q)


def intra_chunk_plain(Cg, Bg, cum, x):
    """The intra-chunk term with autograd through it (every (Q, Q) block
    kept for the backward): Cg, Bg (BC, G, Q, N); cum (BC, H, Q); x (BC, H,
    Q, P) -> (BC, H, Q, P). :func:`intra_chunk` computes the same."""
    scores, decay = _intra_blocks(Cg, Bg, cum, _tril(cum.shape[-1], cum.device))
    return _mix(scores, decay) @ x


class _IntraChunk(torch.autograd.Function):
    """:func:`intra_chunk_plain` one slice of chunks at a time, saving only
    its inputs; the backward rebuilds each slice's blocks."""

    @staticmethod
    def forward(ctx, Cg, Bg, cum, x):
        ctx.save_for_backward(Cg, Bg, cum, x)
        BC, H, Q, _ = x.shape
        mask = _tril(Q, x.device)
        y = torch.empty_like(x)
        for sl in _slices(BC, H * Q * Q * x.element_size()):
            scores, decay = _intra_blocks(Cg[sl], Bg[sl], cum[sl], mask)
            torch.matmul(_mix(scores, decay), x[sl], out=y[sl])
        return y

    @staticmethod
    def backward(ctx, dy):
        Cg, Bg, cum, x = ctx.saved_tensors
        BC, H, Q, _ = x.shape
        G = Cg.shape[1]
        mask = _tril(Q, x.device)
        dCg, dBg = torch.empty_like(Cg), torch.empty_like(Bg)
        dcum, dx = torch.empty_like(cum), torch.empty_like(x)
        for sl in _slices(BC, H * Q * Q * x.element_size()):
            scores, decay = _intra_blocks(Cg[sl], Bg[sl], cum[sl], mask)
            s = scores.shape[0]
            torch.matmul(_mix(scores, decay).transpose(-1, -2), dy[sl], out=dx[sl])
            dM = (dy[sl] @ x[sl].transpose(-1, -2)).view(s, G, H // G, Q, Q)
            dscores = (dM * decay.view(s, G, H // G, Q, Q)).sum(2)
            # d/d cum_i of exp(cum_i - cum_j) is +decay, d/d cum_j is -decay
            ddiff = (dM * scores[:, :, None]).view(s, H, Q, Q) * decay
            torch.sub(ddiff.sum(-1), ddiff.sum(-2), out=dcum[sl])
            torch.matmul(dscores, Bg[sl], out=dCg[sl])
            torch.matmul(dscores.transpose(-1, -2), Cg[sl], out=dBg[sl])
        return dCg, dBg, dcum, dx


def intra_chunk(Cg, Bg, cum, x):
    """The intra-chunk term, y[i] = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j)
    x_j for each chunk and head: Cg, Bg (BC, G, Q, N); cum (BC, H, Q); x
    (BC, H, Q, P) -> (BC, H, Q, P). No (Q, Q) block is kept for the
    backward."""
    return _IntraChunk.apply(Cg, Bg, cum, x)


def chunk_decay(cl: torch.Tensor) -> torch.Tensor:
    """(..., nc) log-decays of whole chunks -> (..., nc, nc) T with T[i, j] =
    exp(cl_{j+1} + .. + cl_i) for j <= i (1 on the diagonal) and 0 above:
    the state leaving chunk i is sum_j T[i, j] S_j."""
    nc = cl.shape[-1]
    seg = cl[..., :, None].expand(*cl.shape, nc)
    seg = seg.masked_fill(~_tril(nc, cl.device, -1), 0.0).cumsum(-2)
    return torch.exp(seg).masked_fill(~_tril(nc, cl.device), 0.0)


def ssd_chunked(x, dt, A, B, C, D: Optional[torch.Tensor] = None,
                dt_bias: Optional[torch.Tensor] = None, chunk_size: int = 128,
                dt_softplus: bool = True, intra=intra_chunk):
    """x (batch, L, H, P); dt (batch, L, H); A (H,) negative; B/C (batch, L,
    G, N) with H % G == 0 (head h reads group h // (H/G)); D (H,) skip.
    Returns (batch, L, H, P) in x's dtype. ``intra``: the intra-chunk term
    (:func:`intra_chunk`, or :func:`intra_chunk_plain` to compare)."""
    out_dtype = x.dtype
    ct = torch.promote_types(x.dtype, torch.float32)
    Bt, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if H % G:
        raise ValueError(f"{H} heads in {G} groups")
    dt = dt.to(ct)
    if dt_bias is not None:
        dt = dt + dt_bias.to(ct)
    if dt_softplus:
        dt = F.softplus(dt)
    xf = x.to(ct)

    Q = min(chunk_size, L)
    pad = (-L) % Q
    xp, Bp, Cp = xf, B.to(ct), C.to(ct)
    if pad:
        xp = F.pad(xp, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bp = F.pad(Bp, (0, 0, 0, 0, 0, pad))
        Cp = F.pad(Cp, (0, 0, 0, 0, 0, pad))
    nc = (L + pad) // Q
    BC, rep = Bt * nc, H // G

    xdt = xp * dt[..., None]                               # (Bt, Lp, H, P)
    cum = (dt * A.to(ct)).reshape(Bt, nc, Q, H).cumsum(2)     # (Bt, nc, Q, H)
    Bg = Bp.reshape(BC, Q, G, N).transpose(1, 2)           # (BC, G, Q, N)
    Cg = Cp.reshape(BC, Q, G, N).transpose(1, 2)

    # intra-chunk
    y = intra(Cg.contiguous(), Bg.contiguous(),
              cum.reshape(BC, Q, H).transpose(1, 2).contiguous(),
              xdt.reshape(BC, Q, H, P).transpose(1, 2).contiguous())
    y = y.view(Bt, nc, H, Q, P).transpose(2, 3)            # (Bt, nc, Q, H, P)

    # chunk states, each group's B against its heads' decayed inputs
    to_end = torch.exp(cum[:, :, -1:] - cum)               # (Bt, nc, Q, H)
    xd = (xdt.reshape(Bt, nc, Q, H, P) * to_end[..., None]).reshape(
        BC, Q, G, rep * P).transpose(1, 2)                 # (BC, G, Q, rep*P)
    S = Bg.transpose(-1, -2) @ xd                          # (BC, G, N, rep*P)
    S = S.view(Bt, nc, G, N, rep, P).permute(0, 2, 4, 1, 3, 5).reshape(
        Bt, H, nc, N * P)

    # state passing: the state leaving each chunk, then the one entering it
    S_end = chunk_decay(cum[:, :, -1].transpose(1, 2)) @ S  # (Bt, H, nc, N*P)
    H0 = F.pad(S_end[:, :, :-1], (0, 0, 1, 0))
    H0 = H0.view(Bt, G, rep, nc, N, P).permute(0, 3, 1, 4, 2, 5).reshape(
        BC, G, N, rep * P)

    # inter-chunk
    Z = (Cg @ H0).view(Bt, nc, G, Q, rep, P).permute(0, 1, 3, 2, 4, 5).reshape(
        Bt, nc, Q, H, P)
    y = y + Z * torch.exp(cum)[..., None]

    y = y.reshape(Bt, nc * Q, H, P)[:, :L]
    if D is not None:
        y = y + xf * D.to(ct)[:, None]
    return y.to(out_dtype)


def ssd_ref(x, dt, A, B, C, D=None, dt_bias=None, dt_softplus: bool = True):
    """The per-step recurrence (the tests' oracle), in fp32 (fp64 for fp64
    inputs)."""
    Bt, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    ct = torch.promote_types(x.dtype, torch.float32)
    A = A.to(ct)
    Bh = B.to(ct).repeat_interleave(rep, dim=2)
    Ch = C.to(ct).repeat_interleave(rep, dim=2)
    dt = dt.to(ct)
    if dt_bias is not None:
        dt = dt + dt_bias.to(ct)
    if dt_softplus:
        dt = F.softplus(dt)
    xf = x.to(ct)
    h = xf.new_zeros(Bt, H, N, P)
    ys = []
    for t in range(L):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + \
            Bh[:, t, :, :, None] * (xf[:, t] * dt[:, t, :, None])[:, :, None]
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    y = torch.stack(ys, 1)
    if D is not None:
        y = y + xf * D.to(ct)[:, None]
    return y.to(x.dtype)
