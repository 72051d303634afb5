"""Mamba selective scan (port of ``nnuzoo_tpu/ops/selective_scan.py``).

Semantics follow the reference recurrence:

    delta' = softplus(delta + delta_bias)            (optional)
    h_t    = exp(delta'_t * A) * h_{t-1} + delta'_t * B_t * u_t     (fp32 state)
    y_t    = C_t . h_t  (+ D * u)  (* silu(z))

- :func:`selective_scan_ref`: per-step loop, the oracle of the tests.
- :func:`selective_scan_chunked`: the plain chunked scan (a Hillis-Steele scan
  inside each chunk, the state carried from chunk to chunk).
- :func:`scan_core`: the kernel contract. On a CUDA tensor it launches the
  hand-written kernel ``csrc/selective_scan_fwd.cu``; on a CPU tensor it runs
  :func:`scan_core_plain`.
- :func:`scan_core_bwd`: its gradients. On CUDA tensors it launches
  ``csrc/selective_scan_bwd.cu``; on CPU tensors it runs
  :func:`scan_core_bwd_plain`.
- :func:`scan_core_grad`: the two as one differentiable function (the
  counterpart of the JAX package's ``_scan_core_pallas`` and its ``defvjp``),
  whose forward is the operator :func:`scan_core_fwd_op`.
- :func:`selective_scan_blkd`: the entry SS2D uses, with the shapes of the
  JAX package's function of the same name.
- :func:`selective_scan`: the Mamba-convention entry (u/delta (batch, dim,
  L), plain or grouped B/C, ``D``, ``z``, ``delta_bias``), which MambaBlock
  calls; :func:`selective_scan_kernel` is its kernel route (the JAX
  package's ``selective_scan_pallas``) and :func:`selective_scan_packed` the
  entry for operands already in the kernel's layout.

The JAX package sends a shape whose K*Dh overflows a TPU core's VMEM to its
XLA scan (``_pallas_vmem_fits``); the port's kernels take those shapes, so
every entry here runs them on the kernels.
"""

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build

# Kernel contract ("K-packed"): the K scan directions live in the channel
# dimension. u, delta (B, L, K*Dh) fp32 with delta already softplus'ed;
# A_t (N, K*Dh); bc (B, L, K*2N) holding [B_k | C_k] per direction k;
# y (B, L, K*Dh).

KERNEL_STATE_SIZES = (16,)
# enough (batch, channel, chunk) threads for about half of the 132 SMs' thread
# slots of an H100; at most ceil(L / _MIN_CHUNK) chunks, so a chunk is at
# least L / ceil(L / _MIN_CHUNK) steps (28 at L=56), or L when L < _MIN_CHUNK
_TARGET_THREADS = 132 * 1024
_MIN_CHUNK = 32
# channels of a forward block; the dynamic shared memory a block may take on
# an H100 (227 KB, less the kernel's few static bytes)
_FWD_BLOCK = 128
_FWD_SMEM_MAX = 232448 - 256


# ------------------------------------------------------------------ normalization
def _apply_delta_bias(delta, delta_bias, delta_softplus):
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, None]
    if delta_softplus:
        delta = F.softplus(delta)
    return delta


def _expand_bc(Bmat, Cmat, dim):
    """B/C (batch, N, L) or (batch, G, N, L) -> (batch, D, N, L)."""
    out = []
    for M in (Bmat.float(), Cmat.float()):
        if M.dim() == 4:
            M = M.repeat_interleave(dim // M.shape[1], dim=1)
        else:
            M = M[:, None].expand(M.shape[0], dim, M.shape[1], M.shape[2])
        out.append(M)
    return out


def _finalize(y, u32, D, z, dtype_in):
    out = y if D is None else y + u32 * D.float()[None, :, None]
    if z is not None:
        out = out * F.silu(z.float())
    return out.to(dtype_in)


# ------------------------------------------------------------------ reference
def selective_scan_ref(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus=False, return_last_state=False):
    """Direct per-timestep recurrence. u/delta/z (batch, D, L); A (D, N);
    B/C (batch, N, L) or grouped (batch, G, N, L); D/delta_bias (D,)."""
    dtype_in = u.dtype
    u32 = u.float()
    delta32 = _apply_delta_bias(delta, delta_bias, delta_softplus)
    A32 = A.float()
    B32, C32 = _expand_bc(B, C, u.shape[1])
    h = u32.new_zeros(u.shape[0], A.shape[0], A.shape[1])
    ys = []
    for t in range(u.shape[2]):
        dA = torch.exp(delta32[:, :, t, None] * A32)
        h = dA * h + (delta32[:, :, t] * u32[:, :, t])[..., None] * B32[..., t]
        ys.append((h * C32[..., t]).sum(-1))
    y = torch.stack(ys, dim=2)
    out = _finalize(y, u32, D, z, dtype_in)
    return (out, h) if return_last_state else out


# ------------------------------------------------------------------ chunked
def _affine_scan(a, b, dim):
    """Inclusive Hillis-Steele scan of h_t = a_t h_{t-1} + b_t along ``dim``:
    returns (a_cum, b_cum) with h_t = a_cum_t * h_entry + b_cum_t."""
    T = a.shape[dim]
    step = 1
    while step < T:
        a_hi, a_lo = a.narrow(dim, step, T - step), a.narrow(dim, 0, T - step)
        b_hi, b_lo = b.narrow(dim, step, T - step), b.narrow(dim, 0, T - step)
        b = torch.cat([b.narrow(dim, 0, step), a_hi * b_lo + b_hi], dim)
        a = torch.cat([a.narrow(dim, 0, step), a_hi * a_lo], dim)
        step *= 2
    return a, b


def scan_core_plain(u, delta, A_t, bc, chunk: int = 256,
                    return_carries: bool = False):
    """The kernel's plain version, same contract as :func:`scan_core`. Walks L
    in chunks (the last one may be short), scans each chunk with
    :func:`_affine_scan` and carries the state between chunks.
    ``return_carries``: also the state entering each chunk, (B, chunks, N,
    K*Dh), as the kernel writes them for chunks of the same length."""
    batch, L, KD = u.shape
    N = A_t.shape[0]
    K = bc.shape[2] // (2 * N)
    Dh = KD // K
    A = A_t.t()                                          # (KD, N)
    bc5 = bc.reshape(batch, L, K, 2, N)
    h = u.new_zeros(batch, KD, N)
    ys, entries = [], []
    for t0 in range(0, L, chunk):
        entries.append(h.transpose(1, 2))
        t1 = min(t0 + chunk, L)
        T = t1 - t0
        d = delta[:, t0:t1, :, None]                     # (B, T, KD, 1)
        dA = torch.exp(d * A)                            # (B, T, KD, N)
        du = (d * u[:, t0:t1, :, None]).reshape(batch, T, K, Dh, 1)
        dBu = (du * bc5[:, t0:t1, :, None, 0]).reshape(batch, T, KD, N)
        a_cum, b_cum = _affine_scan(dA, dBu, dim=1)
        states = a_cum * h[:, None] + b_cum              # (B, T, KD, N)
        y = (states.reshape(batch, T, K, Dh, N) *
             bc5[:, t0:t1, :, None, 1]).sum(-1)
        ys.append(y.reshape(batch, T, KD))
        h = states[:, -1]
    y = torch.cat(ys, dim=1)
    return (y, torch.stack(entries, dim=1)) if return_carries else y


def selective_scan_chunked(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                           delta_softplus=False, chunk: int = 128):
    """Chunked scan with the arguments of :func:`selective_scan_ref` (B/C plain
    or grouped), through :func:`scan_core_plain`."""
    dtype_in = u.dtype
    batch, dim, L = u.shape
    u32 = u.float()
    delta32 = _apply_delta_bias(delta, delta_bias, delta_softplus)
    if B.dim() == 3:
        B, C = B[:, None], C[:, None]
    bc = torch.cat([B.float(), C.float()], dim=2)        # (batch, G, 2N, L)
    bc = bc.permute(0, 3, 1, 2).reshape(batch, L, -1)    # (batch, L, G*2N)
    y = scan_core_plain(u32.transpose(1, 2), delta32.transpose(1, 2),
                        A.float().t(), bc, chunk=chunk)
    return _finalize(y.transpose(1, 2), u32, D, z, dtype_in)


def scan_core_bwd_plain(u, delta, A_t, bc, dy, chunk: int = 256):
    """The backward kernel's plain version: (du, ddelta, dbc, dA_t) of
    :func:`scan_core` for the output gradient ``dy``, same contract.

    A forward walk over the chunks keeps each chunk's entry state; the chunks
    are then taken from the right: the states are computed again from the
    entry state, and the adjoint g_t = C_t dy_t + dA_{t+1} g_{t+1} is the same
    :func:`_affine_scan` on the flipped chunk, entered by the adjoint of the
    state that leaves the chunk."""
    batch, L, KD = u.shape
    N = A_t.shape[0]
    K = bc.shape[2] // (2 * N)
    Dh = KD // K
    A = A_t.t()                                          # (KD, N)
    bc5 = bc.reshape(batch, L, K, 2, N)

    def chunk_terms(t0):
        t1 = min(t0 + chunk, L)
        d = delta[:, t0:t1, :, None]                     # (B, T, KD, 1)
        dA = torch.exp(d * A)                            # (B, T, KD, N)
        dxu = (d * u[:, t0:t1, :, None]).reshape(batch, t1 - t0, K, Dh, 1)
        Bx = bc5[:, t0:t1, :, None, 0]                   # (B, T, K, 1, N)
        return t1, d, dA, dxu, Bx

    def chunk_states(h_in, dA, dxu, Bx):
        a_cum, b_cum = _affine_scan(dA, (dxu * Bx).reshape(dA.shape), dim=1)
        return a_cum * h_in[:, None] + b_cum

    h = u.new_zeros(batch, KD, N)
    entries = []
    for t0 in range(0, L, chunk):
        entries.append(h)
        _, _, dA, dxu, Bx = chunk_terms(t0)
        h = chunk_states(h, dA, dxu, Bx)[:, -1]

    du, ddelta, dbc = torch.empty_like(u), torch.empty_like(u), torch.empty_like(bc)
    dA_sum = u.new_zeros(KD, N)
    q = u.new_zeros(batch, KD, N)        # adjoint of the state leaving the chunk
    for t0, h_in in reversed(list(zip(range(0, L, chunk), entries))):
        t1, d, dA, dxu, Bx = chunk_terms(t0)
        T = t1 - t0
        states = chunk_states(h_in, dA, dxu, Bx)         # (B, T, KD, N)
        h_prev = torch.cat([h_in[:, None], states[:, :-1]], dim=1)
        dy_c = dy[:, t0:t1]
        cdy = (bc5[:, t0:t1, :, None, 1] *
               dy_c.reshape(batch, T, K, Dh, 1)).reshape(dA.shape)
        alpha = torch.cat([dA[:, 1:], torch.ones_like(dA[:, :1])], dim=1)
        a_cum, b_cum = _affine_scan(alpha.flip(1), cdy.flip(1), dim=1)
        G = (a_cum * q[:, None] + b_cum).flip(1)         # g_t (B, T, KD, N)
        q = dA[:, 0] * G[:, 0]
        gh = G * h_prev * dA                             # g_t h_{t-1} dA_t
        G5 = G.reshape(batch, T, K, Dh, N)
        GB = (G5 * Bx).sum(-1).reshape(batch, T, KD)
        ddelta[:, t0:t1] = (gh * A).sum(-1) + GB * u[:, t0:t1]
        du[:, t0:t1] = GB * delta[:, t0:t1]
        dB = (G5 * dxu).sum(3)                           # (B, T, K, N)
        dC = (states * dy_c[..., None]).reshape(batch, T, K, Dh, N).sum(3)
        dbc[:, t0:t1] = torch.stack([dB, dC], dim=3).reshape(batch, T, -1)
        dA_sum += (gh * d).sum((0, 1))
    return du, ddelta, dbc, dA_sum.t().contiguous()


# ------------------------------------------------------------------ kernel
def _pick_chunk(batch: int, L: int, KD: int) -> int:
    nchunks = max(1, min(math.ceil(_TARGET_THREADS / (batch * KD)),
                         math.ceil(L / _MIN_CHUNK)))
    return math.ceil(L / nchunks)


_fwd_fns = None
_bwd_fns = None


def _fwd_kernel_fns():
    """(the forward's entry, its tile length in steps, its tiles a group)."""
    global _fwd_fns
    if _fwd_fns is None:
        lib = _build.load("selective_scan_fwd")
        fn = lib.nnuzoo_selective_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sizes = []
        for name in ("nnuzoo_selective_scan_fwd_tile", "nnuzoo_selective_scan_fwd_group"):
            size = getattr(lib, name)
            size.argtypes, size.restype = [], ctypes.c_int
            sizes.append(size())
        _fwd_fns = (fn, *sizes)
    return _fwd_fns


def _bwd_kernel_fns():
    """(the backward's entry, its count of stored states per chunk)."""
    global _bwd_fns
    if _bwd_fns is None:
        lib = _build.load("selective_scan_bwd")
        fn = lib.nnuzoo_selective_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        nsub = lib.nnuzoo_selective_scan_bwd_nsub
        nsub.argtypes = [ctypes.c_int]
        nsub.restype = ctypes.c_int
        _bwd_fns = (fn, nsub)
    return _bwd_fns


def _check_kernel_inputs(u, delta, A_t, bc, **more):
    """Raise on anything the kernels do not take; ``more`` are further
    (B, L, K*Dh) tensors (the backward's dy). Returns (B, L, K*Dh, K, N)."""
    tensors = {"u": u, "delta": delta, "A_t": A_t, "bc": bc, **more}
    for name, t in tensors.items():
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the scan kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the scan kernel takes contiguous tensors, {name} "
                             "is not")
    if u.dim() != 3 or delta.shape != u.shape:
        raise ValueError(f"u and delta must be (B, L, K*Dh), got {tuple(u.shape)} "
                         f"and {tuple(delta.shape)}")
    for name, t in more.items():
        if t.shape != u.shape:
            raise ValueError(f"{name} must be {tuple(u.shape)} like u, got "
                             f"{tuple(t.shape)}")
    batch, L, KD = u.shape
    N = A_t.shape[0]
    if N not in KERNEL_STATE_SIZES:
        raise ValueError(f"the scan kernel takes N in {KERNEL_STATE_SIZES}, got {N}")
    if A_t.shape != (N, KD):
        raise ValueError(f"A_t must be ({N}, {KD}), got {tuple(A_t.shape)}")
    if bc.dim() != 3 or bc.shape[:2] != (batch, L) or bc.shape[2] % (2 * N):
        raise ValueError(f"bc must be ({batch}, {L}, K*{2 * N}), got "
                         f"{tuple(bc.shape)}")
    K = bc.shape[2] // (2 * N)
    if K == 0 or KD % K:
        raise ValueError(f"K*Dh={KD} is not a multiple of K={K}")
    if bc.data_ptr() % 16:
        raise ValueError("bc must be 16-byte aligned for the kernel's vector loads")
    # the backward's grid is (column blocks, chunks, batch), the forward's
    # one block a (batch, tile, column block); its tiles are at least 32 steps
    if batch > 65535 or math.ceil(L / _pick_chunk(batch, L, KD)) > 65535 or \
            batch * math.ceil(L / 32) * math.ceil(KD / _FWD_BLOCK) >= 2 ** 31 - 1:
        raise ValueError(f"batch {batch} or L {L} exceeds the kernel's grid")
    return batch, L, KD, K, N


def _fwd_plan(batch, L, KD, K, N, tile, group):
    """The forward kernel's launch for tiles of ``tile`` steps in look-back
    groups of ``group`` tiles, as the C entry makes it: {ntiles, ngroups,
    ncb (column blocks of 128 channels), blocks, bc_width (floats of bc a
    block stages per step: every direction its channels touch), smem (bytes
    of a block's staged tile: u and delta of its channels, its bc columns)}.
    Raises on a shape whose tile does not fit."""
    if KD % 4:
        raise ValueError(f"the forward scan kernel copies rows 16 bytes at a "
                         f"time: K*Dh must be a multiple of 4, got {KD}")
    Dh = KD // K
    ncb = math.ceil(KD / _FWD_BLOCK)
    bc_width = 0
    for cb in range(ncb):
        c0 = cb * _FWD_BLOCK
        c1 = min(c0 + _FWD_BLOCK, KD)
        bc_width = max(bc_width, ((c1 - 1) // Dh - c0 // Dh + 1) * 2 * N)
    smem = 4 * tile * (2 * min(KD, _FWD_BLOCK) + bc_width)
    if smem > _FWD_SMEM_MAX:
        raise ValueError(f"a {tile}-step tile of K*Dh={KD} with Dh={Dh} needs "
                         f"{smem} bytes of shared memory, more than a block has "
                         f"({_FWD_SMEM_MAX}): Dh is too small")
    ntiles = math.ceil(L / tile)
    return dict(ntiles=ntiles, ngroups=math.ceil(ntiles / group), ncb=ncb,
                blocks=batch * ntiles * ncb, bc_width=bc_width, smem=smem)


def _fwd_scratch_layout(batch, ntiles, ngroups, ncb, N, KD):
    """The forward kernel's look-back scratch as one 4-byte allocation:
    ({name: (offset, count)}, total). ``flags`` (one int32 a block, one a
    group and column block, then the ticket), zeroed by the kernel's entry,
    comes first; then each tile's aggregate, ``agg`` (its end state from
    zero) and ``agg_dsum`` (its sum of delta), and each group's, ``gagg`` and
    ``gdsum`` (its tiles composed in order), and ``gincl`` (the state leaving
    the group); every piece starts on a 16-byte boundary."""
    parts = [("flags", batch * (ntiles + ngroups) * ncb + 1),
             ("agg", batch * ntiles * N * KD),
             ("agg_dsum", batch * ntiles * KD),
             ("gagg", batch * ngroups * N * KD),
             ("gdsum", batch * ngroups * KD),
             ("gincl", batch * ngroups * N * KD)]
    layout, off = {}, 0
    for name, count in parts:
        layout[name] = (off, count)
        off += -(-count // 4) * 4
    return layout, off


@functools.lru_cache(maxsize=256)
def _fwd_launch(batch, L, KD, K, N, tile, group):
    """The offsets (floats) of the forward's scratch pieces, in the order the
    C entry takes them, and its size: the plan and layout of one shape,
    kept, since at small L the wrapper's host time sets the call's."""
    plan = _fwd_plan(batch, L, KD, K, N, tile, group)
    layout, total = _fwd_scratch_layout(batch, plan["ntiles"], plan["ngroups"],
                                        plan["ncb"], N, KD)
    return tuple(off for off, _ in layout.values()), total


def _aligned(t):
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary (the kernels copy rows 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scan_core_cuda(u, delta, A_t, bc, carries: bool = False):
    """Launch the forward kernel: (y, carries). ``carries``: also write the
    state entering each chunk of :func:`_pick_chunk`, (B, chunks, N, K*Dh),
    which the backward kernel starts from; else None."""
    batch, L, KD, K, N = _check_kernel_inputs(u, delta, A_t, bc)
    fn, tile, group = _fwd_kernel_fns()
    offsets, total = _fwd_launch(batch, L, KD, K, N, tile, group)
    u, delta = _aligned(u), _aligned(delta)
    y = torch.empty_like(u)
    states, chunk = None, 0
    if carries:
        chunk = _pick_chunk(batch, L, KD)
        states = torch.empty(batch, math.ceil(L / chunk), N, KD, device=u.device)
    # one allocation for the look-back's flags and states, handed out as
    # pointers
    scratch = torch.empty(total, device=u.device)
    base = scratch.data_ptr()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(u.data_ptr(), delta.data_ptr(), A_t.data_ptr(), bc.data_ptr(),
                y.data_ptr(), states.data_ptr() if states is not None else None,
                *(base + 4 * off for off in offsets),
                batch, L, K, KD // K, N, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan_fwd kernel launch failed with CUDA "
                           f"error {rc}")
    scan_core.launches += 1
    return y, states


def scan_core(u, delta, A_t, bc, return_carries: bool = False):
    """y (B, L, K*Dh) of the kernel contract above (no gradient: see
    :func:`scan_core_grad`).

    On CUDA tensors this launches ``csrc/selective_scan_fwd.cu`` on the
    current stream and counts the launch in ``scan_core.launches``; it raises
    on anything the kernel does not take. ``return_carries``: the kernel also
    writes the state entering each chunk of :func:`_pick_chunk`, (B, chunks,
    N, K*Dh), which the backward kernel starts from, and they are returned as
    (y, carries); without it the kernel writes none. On CPU tensors it runs
    :func:`scan_core_plain` and takes no ``return_carries``."""
    if u.device.type == "cuda":
        y, states = _scan_core_cuda(u, delta, A_t, bc, carries=return_carries)
        return (y, states) if return_carries else y
    if return_carries:
        raise ValueError("chunk carries come from the CUDA kernel only")
    return scan_core_plain(u, delta, A_t, bc)


scan_core.launches = 0


# the forward of the differentiable scan as an operator of its own, so that a
# selective checkpoint (``torch.utils.checkpoint`` with
# ``create_selective_checkpoint_contexts``) can keep its outputs instead of
# running it again; its name space is this module's import name, which keeps
# a second copy of the package imported under another name apart
@torch.library.custom_op(f"{__name__.replace('.', '_')}::scan_core_fwd",
                         mutates_args=())
def scan_core_fwd_op(u: torch.Tensor, delta: torch.Tensor, A_t: torch.Tensor,
                     bc: torch.Tensor, carries: bool) -> tuple[torch.Tensor,
                                                               torch.Tensor]:
    """(y, carries) of :func:`scan_core` with ``return_carries=carries`` on a
    CUDA tensor (an empty tensor where the kernel writes none); on a CPU
    tensor y of :func:`scan_core_plain` and an empty tensor."""
    if u.device.type == "cuda":
        y, states = _scan_core_cuda(u, delta, A_t, bc, carries=carries)
        return y, states if states is not None else u.new_empty(0)
    return scan_core_plain(u, delta, A_t, bc), u.new_empty(0)


@scan_core_fwd_op.register_fake
def _(u, delta, A_t, bc, carries):
    """The outputs' shapes, for tensors without data (the meta device)."""
    if not (carries and u.device.type == "cuda"):
        return torch.empty_like(u), u.new_empty(0)
    batch, L, KD = u.shape
    nchunks = math.ceil(L / _pick_chunk(batch, L, KD))
    return torch.empty_like(u), u.new_empty(batch, nchunks, A_t.shape[0], KD)


def _bwd_scratch_layout(batch, nchunks, nsub, N, KD):
    """The backward kernel's scratch as one float32 allocation: ({name:
    (offset, shape)}, total floats). ``da_part`` (dA per batch and chunk)
    comes first, then ``ckpt`` (the state every few steps) and, with more
    than one chunk, ``adj`` (chunk adjoints) and ``dsum``; every piece starts
    on a 16-byte boundary."""
    parts = [("da_part", (batch, nchunks, N, KD)),
             ("ckpt", (batch, nchunks, nsub, N, KD))]
    if nchunks > 1:
        parts += [("adj", (batch, nchunks, N, KD)), ("dsum", (batch, nchunks, KD))]
    layout, off = {}, 0
    for name, shape in parts:
        layout[name] = (off, shape)
        off += -(-math.prod(shape) // 4) * 4
    return layout, off


def _scan_core_bwd_cuda(u, delta, A_t, bc, dy, carries):
    batch, L, KD, K, N = _check_kernel_inputs(u, delta, A_t, bc, dy=dy)
    Dh = KD // K
    if Dh % 32:
        raise ValueError(f"the backward scan kernel takes Dh a multiple of 32 (a "
                         f"warp sums one direction's dB and dC), got Dh={Dh}")
    chunk = _pick_chunk(batch, L, KD)
    nchunks = math.ceil(L / chunk)
    if nchunks > 1:
        if carries is None:
            carries = scan_core(u, delta, A_t, bc, return_carries=True)[1]
        if (carries.shape != (batch, nchunks, N, KD) or carries.device != u.device
                or carries.dtype != torch.float32 or not carries.is_contiguous()):
            raise ValueError(f"carries must be the forward kernel's, a contiguous "
                             f"float32 ({batch}, {nchunks}, {N}, {KD}) on "
                             f"{u.device}, got {tuple(carries.shape)}")
    fn, nsub = _bwd_kernel_fns()
    u, delta, dy = _aligned(u), _aligned(delta), _aligned(dy)
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dbc_part = torch.empty(batch, L, KD // 32, 2 * N, device=u.device)
    # the scratch is handed to the kernel as pointers into one allocation;
    # only the dA partials become a tensor
    layout, total = _bwd_scratch_layout(batch, nchunks, nsub(chunk), N, KD)
    scratch = torch.empty(total, device=u.device)
    base = scratch.data_ptr()
    ptr = {name: base + 4 * off for name, (off, _) in layout.items()}
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(u.data_ptr(), delta.data_ptr(), A_t.data_ptr(), bc.data_ptr(),
                dy.data_ptr(), carries.data_ptr() if nchunks > 1 else None,
                du.data_ptr(), ddelta.data_ptr(), dbc_part.data_ptr(),
                ptr["da_part"], ptr.get("adj"), ptr.get("dsum"), ptr["ckpt"],
                batch, L, K, Dh, N, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan_bwd kernel launch failed with CUDA "
                           f"error {rc}")
    scan_core_bwd.launches += 1
    # the kernel leaves one [dB | dC] sum per warp of 32 channels and one dA
    # sum per (batch, chunk): the rest of each sum is taken here
    dbc = dbc_part.reshape(batch, L, K, Dh // 32, 2 * N)
    dbc = dbc.sum(3) if Dh > 32 else dbc
    da_part = scratch[:math.prod(layout["da_part"][1])]
    return (du, ddelta, dbc.reshape(batch, L, K * 2 * N),
            da_part.view(batch * nchunks, N * KD).sum(0).view(N, KD))


def scan_core_bwd(u, delta, A_t, bc, dy, carries=None):
    """(du, ddelta, dbc, dA_t) of :func:`scan_core` for the output gradient
    ``dy`` (B, L, K*Dh).

    On CUDA tensors this launches ``csrc/selective_scan_bwd.cu`` on the
    current stream and counts the launch in ``scan_core_bwd.launches``; it
    raises on anything the kernel does not take. ``carries`` are the forward
    kernel's chunk-entry states for the same inputs; without them the forward
    kernel runs again to make them. On CPU tensors it runs
    :func:`scan_core_bwd_plain`; on tensors without data (the meta device)
    it gives the gradients' shapes, as the forward operator's fake does."""
    if u.device.type == "cuda":
        return _scan_core_bwd_cuda(u, delta, A_t, bc, dy, carries)
    if u.device.type == "meta":
        return (torch.empty_like(u), torch.empty_like(delta), torch.empty_like(bc),
                torch.empty_like(A_t))
    return scan_core_bwd_plain(u, delta, A_t, bc, dy)


scan_core_bwd.launches = 0


class _ScanCore(torch.autograd.Function):
    """:func:`scan_core` with :func:`scan_core_bwd` as its gradient."""

    @staticmethod
    def forward(ctx, u, delta, A_t, bc, grad_enabled):
        # the carries only where a backward can follow (``grad_enabled`` is
        # the caller's grad mode: inside forward it is always off)
        y, carries = scan_core_fwd_op(
            u, delta, A_t, bc, grad_enabled and any(ctx.needs_input_grad[:4]))
        ctx.save_for_backward(u, delta, A_t, bc,
                              carries if carries.numel() else None)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        u, delta, A_t, bc, carries = ctx.saved_tensors
        du, ddelta, dbc, dA_t = scan_core_bwd(u, delta, A_t, bc,
                                              dy.contiguous(), carries)
        return du, ddelta, dA_t, dbc, None


class _ScanCorePlainPair(torch.autograd.Function):
    """:func:`scan_core_plain` with :func:`scan_core_bwd_plain` as its
    gradient, on any device and in the inputs' dtype."""

    @staticmethod
    def forward(ctx, u, delta, A_t, bc):
        ctx.save_for_backward(u, delta, A_t, bc)
        return scan_core_plain(u, delta, A_t, bc)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        du, ddelta, dbc, dA_t = scan_core_bwd_plain(*ctx.saved_tensors, dy)
        return du, ddelta, dA_t, dbc


def scan_core_grad(u, delta, A_t, bc):
    """:func:`scan_core`, differentiable: the forward keeps its inputs and,
    on the card where a backward can follow, the kernel's chunk carries; the
    backward is :func:`scan_core_bwd`."""
    return _ScanCore.apply(u, delta, A_t, bc, torch.is_grad_enabled())


def _scan_core_by_backend(args, backend):
    """:func:`scan_core_grad` (None), or the plain scan with autograd through
    it ("plain") or with its plain backward ("plain_pair")."""
    if backend is None:
        return scan_core_grad(*args)
    if backend == "plain":
        return scan_core_plain(*args)
    if backend == "plain_pair":
        return _ScanCorePlainPair.apply(*args)
    raise ValueError(f"unknown scan backend {backend!r}")


def selective_scan_blkd(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                        delta_softplus=True, backend: Optional[str] = None):
    """Entry for cross-scan modules.

    u/delta (B, L, K, Dh); A (K*Dh, N) (row k*Dh+d); Bmat/Cmat (B, L, K, N);
    D/delta_bias (K*Dh,). Returns y (B, L, K, Dh) in fp32 (fp64 for fp64
    inputs). ``backend`` None goes through :func:`scan_core_grad` (the
    kernels on the card, forwards and backwards); "plain" calls
    :func:`scan_core_plain` on any device and leaves its gradient to
    autograd, which is how the kernel path is compared with the plain one,
    and with an fp64 reference, on the card. Autograd keeps every level of
    the plain scan (some 12 KB per scan position in fp32), which a whole
    training step at full size cannot hold; "plain_pair" is the plain
    forward with :func:`scan_core_bwd_plain` as its gradient, on any device,
    and keeps the inputs only."""
    batch, L, K, Dh = u.shape
    dstate = A.shape[1]
    ct = torch.promote_types(u.dtype, torch.float32)
    u32 = u.to(ct)
    delta32 = delta.to(ct)
    if delta_bias is not None:
        delta32 = delta32 + delta_bias.to(ct).reshape(1, 1, K, Dh)
    if delta_softplus:
        delta32 = F.softplus(delta32)
    A_t = A.to(ct).t().contiguous()                            # (N, K*Dh)
    bc = torch.cat([Bmat.to(ct), Cmat.to(ct)], dim=3).reshape(
        batch, L, K * 2 * dstate)
    args = (u32.reshape(batch, L, K * Dh).contiguous(),
            delta32.reshape(batch, L, K * Dh).contiguous(), A_t, bc)
    y = _scan_core_by_backend(args, backend).reshape(batch, L, K, Dh)
    if D is not None:
        y = y + u32 * D.to(ct).reshape(1, 1, K, Dh)
    return y


def selective_scan_packed(u, delta, A_t, bc, D=None, delta_bias=None,
                          delta_softplus=True, backend: Optional[str] = None):
    """Entry for operands already in the kernel's layout (the JAX package's
    function of the same name): u/delta (B, L, K*Dh) with direction-major
    channel blocks; A_t (N, K*Dh); bc (B, L, K*2N) holding [B_k | C_k] per
    direction k; D/delta_bias (K*Dh,). Returns y (B, L, K*Dh) in fp32 (fp64
    for fp64 inputs). ``backend`` as :func:`selective_scan_blkd`'s."""
    ct = torch.promote_types(u.dtype, torch.float32)
    u32 = u.to(ct)
    delta32 = delta.to(ct)
    if delta_bias is not None:
        delta32 = delta32 + delta_bias.to(ct)
    if delta_softplus:
        delta32 = F.softplus(delta32)
    y = _scan_core_by_backend((u32.contiguous(), delta32.contiguous(),
                               A_t.to(ct).contiguous(), bc.to(ct).contiguous()),
                              backend)
    if D is not None:
        y = y + u32 * D.to(ct)
    return y


def _mamba_to_packed(u, delta, B, C):
    """Mamba-convention operands -> (u, delta (batch, L, dim), bc (batch, L,
    K*2N)), K the groups of B/C (1 for plain B/C)."""
    if B.dim() == 3:
        B, C = B[:, None], C[:, None]
    batch, K, _, L = B.shape
    if C.shape != B.shape or u.shape[1] % K:
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must be "
                         f"(batch, K, N, L) with K dividing dim={u.shape[1]}")
    bc = torch.cat([B, C], dim=2).permute(0, 3, 1, 2).reshape(batch, L, -1)
    return u.transpose(1, 2), delta.transpose(1, 2), bc


def selective_scan_kernel(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                          delta_softplus=False, return_last_state=False,
                          backend: Optional[str] = None):
    """The Mamba-convention entry on the kernel contract (the JAX package's
    ``selective_scan_pallas``): u/delta/z (batch, dim, L); A (dim, N);
    B/C (batch, N, L) or grouped (batch, K, N, L), group k owning channels
    [k*dim/K, (k+1)*dim/K); D/delta_bias (dim,). The operands go to
    :func:`selective_scan_packed`, so on CUDA tensors the scan runs on the
    kernels, forwards and backwards (``backend`` None). Returns y in u's
    dtype. The kernels keep no last state: ``return_last_state`` raises."""
    if return_last_state:
        raise ValueError("return_last_state: the scan kernels keep no last "
                         "state; selective_scan(..., backend='ref') returns it")
    u_p, d_p, bc = _mamba_to_packed(u, delta, B, C)
    y = selective_scan_packed(u_p, d_p, A.t(), bc, D=D, delta_bias=delta_bias,
                              delta_softplus=delta_softplus,
                              backend=backend).transpose(1, 2)
    if z is not None:
        y = y * F.silu(z.to(y.dtype))
    return y.to(u.dtype)


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   delta_softplus=False, return_last_state=False,
                   backend: Optional[str] = None):
    """Dispatching entry point (the JAX package's ``selective_scan``), with
    :func:`selective_scan_ref`'s arguments. ``backend``: None runs
    :func:`selective_scan_kernel` (the kernels on the card, their plain
    versions on the CPU); "plain" and "plain_pair" the same route on the
    plain scan (see :func:`selective_scan_blkd`); "ref" the per-step
    recurrence, the one route that returns the last state."""
    if backend == "ref":
        return selective_scan_ref(u, delta, A, B, C, D, z, delta_bias,
                                  delta_softplus, return_last_state)
    return selective_scan_kernel(u, delta, A, B, C, D, z, delta_bias,
                                 delta_softplus, return_last_state, backend)
