"""Fused cross-scan: the projections of each scan direction and its selective
scan as one function (port of ``nnuzoo_tpu/ops/cross_scan.py``).

SS2D scans G axis orders of its conv output ("streams"), each forwards and
backwards. For one traversal orientation, :func:`cross_scan_fused` computes,
per direction g, x_dbl = x_proj[g] u (dt, B, C), delta = softplus(dt_proj[g]
dt + bias), the selective scan and the D term, and returns y in natural
order. ``reverse=True`` scans the same streams from the right: no flipped
copy. On the card the forward writes no x_dbl, delta or B/C to device
memory; the backward keeps each step's x_dbl in its scratch for the call.

- :func:`cross_scan_ref`: the plain forward, the JAX oracle's math over the
  port's plain scan; autograd goes through it.
- :func:`cross_scan_fwd`: on a CUDA tensor the hand-written kernel
  ``csrc/cross_scan_fwd.cu`` (with the chunk carries the backward starts
  from only when asked); on a CPU tensor :func:`cross_scan_ref`.
- :func:`cross_scan_bwd`: its gradients; on CUDA tensors
  ``csrc/cross_scan_bwd.cu``, on CPU tensors :func:`cross_scan_bwd_plain`.
- :func:`cross_scan_fused`: the entry SS2D uses, differentiable; its
  forward is the operator :func:`cross_scan_fwd_op`.

The JAX kernel packs batch elements into the TPU's 128 lanes; the port has no
such layout, and its gradient of A comes back as (G*Dh, N) directly.
"""

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from .. import _build
from .selective_scan import (_FWD_SMEM_MAX, _aligned, _fwd_scratch_layout,
                             _pick_chunk, selective_scan_blkd)

KERNEL_STATE_SIZE = 16
KERNEL_MAX_RANK = 8
KERNEL_GROUPS = (2, 3)
KERNEL_MAX_DH = 256
# the forward kernel's most channels of a block
_FWD_BLOCK = 256


# ------------------------------------------------------------------ plain
def _glue(streams, x_proj_weight, dt_weight, dt_bias, A, Ds, reverse,
          scan_backend):
    G = len(streams)
    N = A.shape[1]
    R = x_proj_weight.shape[1] - 2 * N
    xs = torch.stack(list(streams), 2)                      # (B, L, G, Dh)
    if reverse:
        xs = xs.flip(1)
    x_dbl = torch.einsum("blgd,gcd->blgc", xs, x_proj_weight)
    dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
    dts = torch.einsum("blgr,gdr->blgd", dts, dt_weight)
    y = selective_scan_blkd(xs, dts, A, Bs, Cs, D=Ds,
                            delta_bias=dt_bias.reshape(-1), delta_softplus=True,
                            backend=scan_backend)           # (B, L, G, Dh)
    if reverse:
        y = y.flip(1)
    batch, L = xs.shape[:2]
    return y.reshape(batch, L, G * xs.shape[-1])


def cross_scan_ref(streams: Sequence[torch.Tensor], x_proj_weight, dt_weight,
                   dt_bias, A, Ds, reverse: bool = False) -> torch.Tensor:
    """The plain forward, also the kernel's oracle. streams: G tensors (B, L,
    Dh); x_proj_weight (G, R+2N, Dh); dt_weight (G, Dh, R); dt_bias (G, Dh);
    A (G*Dh, N), already negated; Ds (G*Dh,). Returns y (B, L, G*Dh) in
    natural order, ``u * D`` included, in fp32 (fp64 for fp64 inputs).
    Autograd through it keeps every level of the plain scan."""
    return _glue(streams, x_proj_weight, dt_weight, dt_bias, A, Ds, reverse,
                 "plain")


def cross_scan_bwd_plain(streams, x_proj_weight, dt_weight, dt_bias, A, Ds, dy,
                         reverse: bool = False):
    """The backward kernel's plain version: (d_streams, dWx, dWdt, dbias, dA,
    dD) of :func:`cross_scan_ref` for the output gradient ``dy`` (B, L,
    G*Dh). Autograd through the projections around the plain scan pair
    (``scan_core_plain`` with ``scan_core_bwd_plain`` as its gradient), which
    keeps the scan's inputs only."""
    G = len(streams)
    # copies that autograd may record, even when called in inference mode
    with torch.inference_mode(False), torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_() for t in
                  (*streams, x_proj_weight, dt_weight, dt_bias, A, Ds)]
        y = _glue(leaves[:G], *leaves[G:], reverse, "plain_pair")
        grads = torch.autograd.grad(y, leaves, dy.clone())
    return (tuple(grads[:G]), *grads[G:])


# ------------------------------------------------------------------ kernels
_fwd_fns = None
_bwd_fns = None


def _fwd_kernel_fns():
    """(the forward's entry, its steps a tile, its tiles a look-back group)."""
    global _fwd_fns
    if _fwd_fns is None:
        lib = _build.load("cross_scan_fwd")
        fn = lib.nnuzoo_cross_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sizes = []
        for name in ("nnuzoo_cross_scan_fwd_tile", "nnuzoo_cross_scan_fwd_group"):
            size = getattr(lib, name)
            size.argtypes, size.restype = [], ctypes.c_int
            sizes.append(size())
        _fwd_fns = (fn, *sizes)
    return _fwd_fns


def _bwd_kernel_fns():
    """(the backward's entry, its count of stored states per chunk, the
    floats of its x_dbl rows)."""
    global _bwd_fns
    if _bwd_fns is None:
        lib = _build.load("cross_scan_bwd")
        fn = lib.nnuzoo_cross_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        nsub = lib.nnuzoo_cross_scan_bwd_nsub
        nsub.argtypes = [ctypes.c_int] * 3
        nsub.restype = ctypes.c_int
        row = lib.nnuzoo_cross_scan_bwd_row
        row.argtypes, row.restype = [ctypes.c_int], ctypes.c_int
        _bwd_fns = (fn, nsub, row)
    return _bwd_fns


def _check_kernel_inputs(streams, x_proj_weight, dt_weight, dt_bias, A, Ds,
                         dy=None):
    """Raise on anything the kernels do not take. Returns (B, L, G, Dh, R)."""
    G = len(streams)
    if G not in KERNEL_GROUPS:
        raise ValueError(f"the cross-scan kernels take G in {KERNEL_GROUPS} "
                         f"streams, got {G}")
    tensors = {f"streams[{g}]": s for g, s in enumerate(streams)}
    tensors.update(x_proj_weight=x_proj_weight, dt_weight=dt_weight,
                   dt_bias=dt_bias, A=A, Ds=Ds)
    if dy is not None:
        tensors["dy"] = dy
    dev = streams[0].device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, streams[0] on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"the cross-scan kernels take float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the cross-scan kernels take contiguous tensors, "
                             f"{name} is not")
    if streams[0].dim() != 3 or any(s.shape != streams[0].shape for s in streams):
        raise ValueError(f"the streams must be G tensors (B, L, Dh) of one shape, "
                         f"got {[tuple(s.shape) for s in streams]}")
    batch, L, Dh = streams[0].shape
    if Dh % 32 or not 32 <= Dh <= KERNEL_MAX_DH:
        raise ValueError(f"the cross-scan kernels take Dh a multiple of 32 up to "
                         f"{KERNEL_MAX_DH} (a warp is 32 channels of one "
                         f"direction), got Dh={Dh}")
    N = KERNEL_STATE_SIZE
    if A.shape != (G * Dh, N):
        raise ValueError(f"A must be ({G * Dh}, {N}) (N={N} only), got "
                         f"{tuple(A.shape)}")
    R = x_proj_weight.shape[1] - 2 * N if x_proj_weight.dim() == 3 else 0
    if x_proj_weight.shape != (G, R + 2 * N, Dh) or not 1 <= R <= KERNEL_MAX_RANK:
        raise ValueError(f"x_proj_weight must be ({G}, R+{2 * N}, {Dh}) with R in "
                         f"1..{KERNEL_MAX_RANK}, got {tuple(x_proj_weight.shape)}")
    if dt_weight.shape != (G, Dh, R) or dt_bias.shape != (G, Dh) or \
            Ds.shape != (G * Dh,):
        raise ValueError(f"dt_weight, dt_bias, Ds must be ({G}, {Dh}, {R}), "
                         f"({G}, {Dh}), ({G * Dh},), got {tuple(dt_weight.shape)}, "
                         f"{tuple(dt_bias.shape)}, {tuple(Ds.shape)}")
    if dy is not None and dy.shape != (batch, L, G * Dh):
        raise ValueError(f"dy must be ({batch}, {L}, {G * Dh}), got "
                         f"{tuple(dy.shape)}")
    if batch > 65535 or L < 1:
        raise ValueError(f"batch {batch} or L {L} out of the kernels' grid")
    return batch, L, G, Dh, R


def _stream_ptrs(tensors):
    return [t.data_ptr() for t in tensors] + [None] * (3 - len(tensors))


def _cross_fwd_plan(batch, L, G, Dh, R, tile, group, N=KERNEL_STATE_SIZE):
    """The forward kernel's launch for tiles of ``tile`` steps in look-back
    groups of ``group`` tiles, as the C entry makes it: {ntiles, ngroups,
    dirs (directions a block: as many as fit in 256 channels), ncb (column
    blocks), threads, blocks, smem (bytes of a block's shared memory: each
    direction's u rows of the tile, wx in rows of Dh+4 and the tile's x_dbl
    in rows of R rounded up to 4, + 2N)}. Raises on a shape that does not
    fit."""
    if Dh % 32 or not 32 <= Dh <= _FWD_BLOCK:
        raise ValueError(f"the forward cross-scan kernel takes Dh a multiple of "
                         f"32 up to {_FWD_BLOCK}, got Dh={Dh}")
    dirs = min(G, _FWD_BLOCK // Dh)
    row = -(-R // 4) * 4 + 2 * N
    smem = 4 * dirs * (tile * Dh + (R + 2 * N) * (Dh + 4) + tile * row)
    if smem > _FWD_SMEM_MAX:
        raise ValueError(f"a {tile}-step tile of {dirs} directions of Dh={Dh} "
                         f"with R={R} needs {smem} bytes of shared memory, more "
                         f"than a block has ({_FWD_SMEM_MAX})")
    ntiles = math.ceil(L / tile)
    ncb = math.ceil(G / dirs)
    return dict(ntiles=ntiles, ngroups=math.ceil(ntiles / group), dirs=dirs,
                ncb=ncb, threads=dirs * Dh, blocks=batch * ntiles * ncb, smem=smem)


@functools.lru_cache(maxsize=256)
def _cross_fwd_launch(batch, L, G, Dh, R, tile, group):
    """(chunk, chunks, the offsets in floats of the scratch pieces in the
    order the C entry takes them, the scratch's size): one shape's plan and
    layout, kept, since at small L the wrapper's host time sets the call's.
    The look-back's scratch is the selective-scan forward's, over G*Dh
    channels (:func:`_fwd_scratch_layout`: flags and ticket, then the tiles'
    and the groups' aggregates); the chunks are the backward's, whose entry
    states the forward writes when asked."""
    plan = _cross_fwd_plan(batch, L, G, Dh, R, tile, group)
    layout, total = _fwd_scratch_layout(batch, plan["ntiles"], plan["ngroups"],
                                        plan["ncb"], KERNEL_STATE_SIZE, G * Dh)
    chunk = _pick_chunk(batch, L, G * Dh)
    return (chunk, math.ceil(L / chunk), tuple(off for off, _ in layout.values()),
            total)


def _cross_scan_fwd_cuda(streams, x_proj_weight, dt_weight, dt_bias, A, Ds,
                         reverse, carries: bool = False):
    """Launch the forward kernel: (y, carries). ``carries``: also write the
    state entering each traversal chunk of the backward, (B, chunks, N,
    G*Dh), or None with one chunk; else None and the kernel writes none."""
    batch, L, G, Dh, R = _check_kernel_inputs(streams, x_proj_weight, dt_weight,
                                              dt_bias, A, Ds)
    N = KERNEL_STATE_SIZE
    dev = streams[0].device
    fn, tile, group = _fwd_kernel_fns()
    chunk, nchunks, offsets, total = _cross_fwd_launch(batch, L, G, Dh, R, tile,
                                                       group)
    # the copy engine moves the u rows and float4 loads read wx
    streams = [_aligned(s) for s in streams]
    x_proj_weight = _aligned(x_proj_weight)
    y = torch.empty(batch, L, G * Dh, device=dev)
    states = None
    if carries and nchunks > 1:
        states = torch.empty(batch, nchunks, N, G * Dh, device=dev)
    # one allocation for the look-back's flags and states, handed out as
    # pointers
    scratch = torch.empty(total, device=dev)
    base = scratch.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*_stream_ptrs(streams), x_proj_weight.data_ptr(),
                dt_weight.data_ptr(), dt_bias.data_ptr(), A.data_ptr(),
                Ds.data_ptr(), y.data_ptr(),
                states.data_ptr() if states is not None else None,
                *(base + 4 * off for off in offsets),
                batch, L, G, Dh, R, N, chunk, int(reverse), stream)
    if rc != 0:
        raise RuntimeError(f"cross_scan_fwd kernel launch failed with CUDA error "
                           f"{rc}")
    cross_scan_fwd.launches += 1
    return y, states


def cross_scan_fwd(streams, x_proj_weight, dt_weight, dt_bias, A, Ds,
                   reverse: bool = False, return_carries: bool = False):
    """y (B, L, G*Dh) of :func:`cross_scan_ref` (no gradient: see
    :func:`cross_scan_fused`).

    On CUDA tensors this launches ``csrc/cross_scan_fwd.cu`` on the current
    stream and counts the launch in ``cross_scan_fwd.launches``; it raises on
    anything the kernel does not take. With ``return_carries`` the kernel
    also writes the state entering each traversal chunk (B, chunks, N,
    G*Dh), or None with one chunk, which :func:`cross_scan_bwd` starts from,
    and they are returned as (y, carries); without it the kernel writes
    none. On CPU tensors it runs :func:`cross_scan_ref` (which has no
    carries)."""
    if streams[0].device.type == "cuda":
        y, carries = _cross_scan_fwd_cuda(streams, x_proj_weight, dt_weight,
                                          dt_bias, A, Ds, reverse,
                                          carries=return_carries)
        return (y, carries) if return_carries else y
    if return_carries:
        raise ValueError("chunk carries come from the CUDA kernel only")
    return cross_scan_ref(streams, x_proj_weight, dt_weight, dt_bias, A, Ds,
                          reverse)


cross_scan_fwd.launches = 0


# the forward of the differentiable cross-scan as an operator of its own,
# kept by a selective checkpoint as the selective scan's is
# (``selective_scan.scan_core_fwd_op``)
@torch.library.custom_op(f"{__name__.replace('.', '_')}::cross_scan_fwd",
                         mutates_args=())
def cross_scan_fwd_op(streams: list[torch.Tensor], x_proj_weight: torch.Tensor,
                      dt_weight: torch.Tensor, dt_bias: torch.Tensor,
                      A: torch.Tensor, Ds: torch.Tensor, reverse: bool,
                      carries: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, carries) of :func:`cross_scan_fwd` with ``return_carries=carries``
    on CUDA tensors (an empty tensor where the kernel writes none); on CPU
    tensors y of :func:`cross_scan_ref` and an empty tensor."""
    weights = (x_proj_weight, dt_weight, dt_bias, A, Ds)
    if streams[0].device.type == "cuda":
        y, states = _cross_scan_fwd_cuda(streams, *weights, reverse,
                                         carries=carries)
        return y, states if states is not None else y.new_empty(0)
    y = cross_scan_ref(streams, *weights, reverse)
    return y, y.new_empty(0)


@cross_scan_fwd_op.register_fake
def _(streams, x_proj_weight, dt_weight, dt_bias, A, Ds, reverse, carries):
    """The outputs' shapes, for tensors without data (the meta device)."""
    batch, L, Dh = streams[0].shape
    GD = len(streams) * Dh
    y = streams[0].new_empty(batch, L, GD)
    nchunks = math.ceil(L / _pick_chunk(batch, L, GD))
    if not (carries and streams[0].device.type == "cuda" and nchunks > 1):
        return y, y.new_empty(0)
    return y, y.new_empty(batch, nchunks, KERNEL_STATE_SIZE, GD)


@functools.lru_cache(maxsize=64)
def _partial_pieces(G, Dh, R, N=KERNEL_STATE_SIZE):
    """The five weight gradients in a row of the backward kernel's partials,
    in the kernel's order: ((name, start, shape), ...) for dA (G*Dh, N), dWx
    (G, C, Dh), dWdt (G, Dh, R), dbias (G, Dh) and dD (G*Dh,); and the row's
    length P."""
    C = R + 2 * N
    pieces, off = [], 0
    for name, shape in (("dA", (G * Dh, N)), ("dWx", (G, C, Dh)),
                        ("dWdt", (G, Dh, R)), ("dbias", (G, Dh)),
                        ("dD", (G * Dh,))):
        pieces.append((name, off, shape))
        off += math.prod(shape)
    return tuple(pieces), off


def _cross_bwd_scratch_layout(batch, nchunks, L, G, Dh, R, nsub, row,
                              N=KERNEL_STATE_SIZE):
    """The backward kernel's scratch as one float32 allocation: ({name:
    (offset, shape)}, total floats). ``part`` comes first, the partials of
    the five weight gradients side by side, one row a (batch, chunk)
    (:func:`_partial_pieces`); then ``xdbl``, each traversal step's x_dbl in
    rows of ``row`` floats; ``ckpt``, the state entering every tile of
    ``nsub`` a chunk; and, with more than one chunk, ``adj`` (chunk adjoints)
    and ``dsum``. Every piece starts on a 16-byte boundary."""
    P = _partial_pieces(G, Dh, R, N)[1]
    parts = [("part", (batch * nchunks, P)), ("xdbl", (batch, G, L, row)),
             ("ckpt", (batch, nchunks, G, nsub, N, Dh))]
    if nchunks > 1:
        parts += [("adj", (batch, nchunks, N, G * Dh)),
                  ("dsum", (batch, nchunks, G * Dh))]
    layout, off = {}, 0
    for name, shape in parts:
        layout[name] = (off, shape)
        off += -(-math.prod(shape) // 4) * 4
    return layout, off


def _sum_partials(part, G, Dh, R, N=KERNEL_STATE_SIZE):
    """(dWx, dWdt, dbias, dA, dD) from the kernel's rows of partials ``part``
    (B*chunks, P): one sum over the rows, then a view of each gradient."""
    total = part.sum(0)
    grads = {name: total[off:off + math.prod(shape)].view(shape)
             for name, off, shape in _partial_pieces(G, Dh, R, N)[0]}
    return tuple(grads[k] for k in ("dWx", "dWdt", "dbias", "dA", "dD"))


@functools.lru_cache(maxsize=256)
def _cross_bwd_launch(batch, L, G, Dh, R):
    """(chunk, chunks, the offsets in floats of the scratch pieces in the
    order the C entry takes them, None for a piece absent with one chunk,
    the scratch's size): one shape's plan and layout, kept, since at small L
    the wrapper's host time sets the call's."""
    _, nsub, row = _bwd_kernel_fns()
    chunk = _pick_chunk(batch, L, G * Dh)
    nchunks = math.ceil(L / chunk)
    layout, total = _cross_bwd_scratch_layout(
        batch, nchunks, L, G, Dh, R, nsub(chunk, Dh, R), row(R))
    offsets = tuple(layout[k][0] if k in layout else None
                    for k in ("xdbl", "ckpt", "adj", "dsum", "part"))
    return chunk, nchunks, offsets, total


def _cross_scan_bwd_cuda(streams, x_proj_weight, dt_weight, dt_bias, A, Ds, dy,
                         reverse, carries):
    batch, L, G, Dh, R = _check_kernel_inputs(streams, x_proj_weight, dt_weight,
                                              dt_bias, A, Ds, dy)
    N = KERNEL_STATE_SIZE
    dev = streams[0].device
    chunk, nchunks, offsets, total = _cross_bwd_launch(batch, L, G, Dh, R)
    if nchunks > 1:
        if carries is None:
            carries = cross_scan_fwd(streams, x_proj_weight, dt_weight, dt_bias,
                                     A, Ds, reverse, return_carries=True)[1]
        if (carries.shape != (batch, nchunks, N, G * Dh) or carries.device != dev
                or carries.dtype != torch.float32 or not carries.is_contiguous()):
            raise ValueError(f"carries must be the forward kernel's, a contiguous "
                             f"float32 ({batch}, {nchunks}, {N}, {G * Dh}) on "
                             f"{dev}, got {tuple(carries.shape)}")
    fn = _bwd_kernel_fns()[0]
    d_streams = torch.empty(G, batch, L, Dh, device=dev).unbind(0)
    # the scratch is handed to the kernel as pointers into one allocation;
    # only the partials, its first piece, become a tensor
    scratch = torch.empty(total, device=dev)
    base = scratch.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*_stream_ptrs(streams), x_proj_weight.data_ptr(),
                dt_weight.data_ptr(), dt_bias.data_ptr(), A.data_ptr(),
                Ds.data_ptr(), dy.data_ptr(),
                carries.data_ptr() if nchunks > 1 else None,
                *(base + 4 * off if off is not None else None for off in offsets),
                *_stream_ptrs(d_streams),
                batch, L, G, Dh, R, N, chunk, int(reverse), stream)
    if rc != 0:
        raise RuntimeError(f"cross_scan_bwd kernel launch failed with CUDA error "
                           f"{rc}")
    cross_scan_bwd.launches += 1
    P = _partial_pieces(G, Dh, R, N)[1]
    part = scratch[:batch * nchunks * P].view(batch * nchunks, P)
    return (d_streams, *_sum_partials(part, G, Dh, R, N))


def cross_scan_bwd(streams, x_proj_weight, dt_weight, dt_bias, A, Ds, dy,
                   reverse: bool = False, carries=None):
    """(d_streams, dWx, dWdt, dbias, dA, dD) of :func:`cross_scan_fwd` for the
    output gradient ``dy`` (B, L, G*Dh); d_streams is a tuple of G (B, L, Dh).

    On CUDA tensors this launches ``csrc/cross_scan_bwd.cu`` on the current
    stream and counts the launch in ``cross_scan_bwd.launches``; it raises on
    anything the kernel does not take. ``carries`` are the forward kernel's
    for the same inputs; without them the forward kernel runs again to make
    them. On CPU tensors it runs :func:`cross_scan_bwd_plain`."""
    if streams[0].device.type == "cuda":
        return _cross_scan_bwd_cuda(streams, x_proj_weight, dt_weight, dt_bias,
                                    A, Ds, dy, reverse, carries)
    return cross_scan_bwd_plain(streams, x_proj_weight, dt_weight, dt_bias, A,
                                Ds, dy, reverse)


cross_scan_bwd.launches = 0


class _CrossScan(torch.autograd.Function):
    """:func:`cross_scan_fwd` with :func:`cross_scan_bwd` as its gradient; the
    forward kernel's chunk carries go to the backward kernel."""

    @staticmethod
    def forward(ctx, reverse, grad_enabled, x_proj_weight, dt_weight, dt_bias, A,
                Ds, *streams):
        weights = (x_proj_weight, dt_weight, dt_bias, A, Ds)
        # the carries only where a backward can follow (``grad_enabled`` is
        # the caller's grad mode: inside forward it is always off)
        y, carries = cross_scan_fwd_op(
            list(streams), *weights, reverse,
            grad_enabled and any(ctx.needs_input_grad[2:]))
        ctx.reverse = reverse
        ctx.save_for_backward(*weights, carries if carries.numel() else None,
                              *streams)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        weights, carries, streams = saved[:5], saved[5], saved[6:]
        d_streams, *d_weights = cross_scan_bwd(streams, *weights, dy.contiguous(),
                                               ctx.reverse, carries)
        return (None, None, *d_weights, *d_streams)


class _CrossScanPlainPair(torch.autograd.Function):
    """:func:`cross_scan_ref` with :func:`cross_scan_bwd_plain` as its
    gradient, on any device and in the inputs' dtype."""

    @staticmethod
    def forward(ctx, reverse, x_proj_weight, dt_weight, dt_bias, A, Ds, *streams):
        weights = (x_proj_weight, dt_weight, dt_bias, A, Ds)
        ctx.reverse = reverse
        ctx.save_for_backward(*weights, *streams)
        return cross_scan_ref(streams, *weights, reverse)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        weights, streams = ctx.saved_tensors[:5], ctx.saved_tensors[5:]
        d_streams, *d_weights = cross_scan_bwd_plain(streams, *weights, dy,
                                                     ctx.reverse)
        return (None, *d_weights, *d_streams)


def cross_scan_fused(streams: Sequence[torch.Tensor], x_proj_weight, dt_weight,
                     dt_bias, A, Ds, reverse: bool = False,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Fused projections and selective scan over the G directions of one
    traversal orientation, with the shapes of the JAX package's function.

    streams: G tensors (B, L, Dh), always the FORWARD sequences;
    ``reverse=True`` scans them back to front. x_proj_weight (G, R+2N, Dh);
    dt_weight (G, Dh, R); dt_bias (G, Dh); A (G*Dh, N) already negated; Ds
    (G*Dh,). Returns y (B, L, G*Dh) in natural order (direction g in
    channels [g*Dh, (g+1)*Dh)), ``u * D`` included.

    ``backend`` None: the kernels on the card forwards and backwards (their
    plain versions on the CPU); "plain": autograd through
    :func:`cross_scan_ref`; "plain_pair": :func:`cross_scan_ref` with
    :func:`cross_scan_bwd_plain` as its gradient, which keeps the inputs only
    and so fits a whole training step."""
    streams = [s.contiguous() for s in streams]
    weights = [t.contiguous() for t in (x_proj_weight, dt_weight, dt_bias, A, Ds)]
    if backend is None:
        return _CrossScan.apply(reverse, torch.is_grad_enabled(), *weights,
                                *streams)
    if backend == "plain":
        return cross_scan_ref(streams, *weights, reverse)
    if backend == "plain_pair":
        return _CrossScanPlainPair.apply(reverse, *weights, *streams)
    raise ValueError(f"unknown scan backend {backend!r}")
