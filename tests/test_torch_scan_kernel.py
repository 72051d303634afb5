"""The wrappers of the CUDA selective-scan kernels (``scan_core``,
``scan_core_bwd`` and the two as one differentiable ``scan_core_grad``).

This file imports no JAX, so its ``cuda`` tests also run on a machine with
the GPU and no JAX, where the repository's ``conftest.py`` cannot load:

    python -m pytest --noconftest -q tests/test_torch_scan_kernel.py

On the CPU the ``cuda`` tests skip; the others check what the wrapper does
before a launch and that a CPU tensor runs the plain version.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nnuzoo_tpu_torch.ops import selective_scan as tscan  # noqa: E402


def _contract_inputs(gen_device, B, L, KD, K, N, seed):
    """Seeded (u, softplus'ed delta, A_t, bc) of the kernel contract, with
    delta in [0.001, 0.1] and A in [-N, 0) as the model gives them."""
    g = torch.Generator(device=gen_device).manual_seed(seed)
    u = torch.randn(B, L, KD, device=gen_device, generator=g)
    d = 0.001 + 0.099 * torch.rand(B, L, KD, device=gen_device, generator=g)
    A_t = -N * torch.rand(N, KD, device=gen_device, generator=g) - 1e-3
    bc = torch.randn(B, L, K * 2 * N, device=gen_device, generator=g)
    return u, d, A_t, bc


def test_scan_core_cpu_runs_plain_version_and_counts_no_launch():
    args = _contract_inputs("cpu", 2, 56, 12, 4, 16, seed=3)
    before = tscan.scan_core.launches
    y = tscan.scan_core(*args)
    assert tscan.scan_core.launches == before
    assert torch.equal(y, tscan.scan_core_plain(*args))
    # another chunking of the plain version: only the association changes
    assert torch.allclose(tscan.scan_core_plain(*args, chunk=16), y,
                          rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tscan.scan_core(*args, return_carries=True)


def test_plain_path_keeps_float64():
    """The plain path computes in fp64 when given fp64, which is how the card
    run builds its reference for the fp32 paths; fp32 agrees to 1e-5."""
    rs = np.random.RandomState(5)
    B, L, K, Dh, N = 2, 40, 4, 3, 16
    u, dt = rs.randn(2, B, L, K, Dh)
    A = -np.exp(rs.rand(K * Dh, N))
    Bm, Cm = rs.randn(2, B, L, K, N)
    D, bias = rs.randn(2, K * Dh)
    args64 = [torch.from_numpy(a) for a in (u, dt, A, Bm, Cm, D, bias)]
    args32 = [a.float() for a in args64]
    y64 = tscan.selective_scan_blkd(*args64[:6], delta_bias=args64[6])
    y32 = tscan.selective_scan_blkd(*args32[:6], delta_bias=args32[6])
    assert y64.dtype == torch.float64 and y32.dtype == torch.float32
    assert (y64 - y32).abs().max().item() <= 1e-5 * y64.abs().max().item()


def _kernel_args(N=16, L=20, KD=8, K=2, dtype=torch.float32):
    return (torch.zeros(2, L, KD, dtype=dtype), torch.zeros(2, L, KD, dtype=dtype),
            torch.zeros(N, KD, dtype=dtype), torch.zeros(2, L, K * 2 * N, dtype=dtype))


def test_kernel_wrapper_checks_inputs():
    """The checks the CUDA wrapper makes before a launch (they read shapes,
    types and strides only, so they run here)."""
    assert tscan._check_kernel_inputs(*_kernel_args()) == (2, 20, 8, 2, 16)
    with pytest.raises(ValueError, match="N in"):
        tscan._check_kernel_inputs(*_kernel_args(N=8))
    with pytest.raises(TypeError):
        tscan._check_kernel_inputs(*_kernel_args(dtype=torch.float64))
    u, d, A_t, bc = _kernel_args()
    with pytest.raises(ValueError, match="contiguous"):
        tscan._check_kernel_inputs(u.transpose(0, 1), d, A_t, bc)
    with pytest.raises(ValueError, match="bc must be"):
        tscan._check_kernel_inputs(u, d, A_t, bc[..., :-1].contiguous())
    # inputs that require a gradient are taken: the backward is a kernel too
    tscan._check_kernel_inputs(u.clone().requires_grad_(), d, A_t, bc)
    with pytest.raises(ValueError, match="dy must be"):
        tscan._check_kernel_inputs(u, d, A_t, bc, dy=u[:, :-1].contiguous())
    assert tscan._check_kernel_inputs(u, d, A_t, bc, dy=u.clone()) == (2, 20, 8, 2, 16)


@pytest.mark.parametrize("L", [57344, 14336, 3584, 896, 224, 56, 12])
def test_pick_chunk_covers_any_length(L):
    chunk = tscan._pick_chunk(4, L, 128)
    nchunks = -(-L // chunk)
    assert 1 <= chunk <= L and (nchunks - 1) * chunk < L <= nchunks * chunk
    assert nchunks <= -(-L // tscan._MIN_CHUNK)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the scan kernel is CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L,KD", [(56, 128), (12, 128), (3584, 128), (200, 1024),
                                  (1000, 96)])
def test_cuda_kernel_matches_plain_version(cuda_device, L, KD):
    """On the card: kernel against its plain version, same inputs; fp32 with
    exp2 against exp and another association, so 1e-4 * max|y|."""
    args = _contract_inputs(cuda_device, 2, L, KD, 4, 16, seed=L)
    before = tscan.scan_core.launches
    with torch.inference_mode():
        y = tscan.scan_core(*args)
        want = tscan.scan_core_plain(*args)
    torch.cuda.synchronize()
    assert tscan.scan_core.launches == before + 1
    assert (y - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_cuda_kernel_carries_are_the_chunk_entry_states(cuda_device):
    """``return_carries``: the state entering chunk j is the state after the
    first j*chunk steps, which the per-step reference gives."""
    B, L, KD, K, N = 1, 300, 32, 4, 16
    u, d, A_t, bc = _contract_inputs(cuda_device, B, L, KD, K, N, seed=1)
    with torch.inference_mode():
        y, carries = tscan.scan_core(u, d, A_t, bc, return_carries=True)
        torch.cuda.synchronize()
        chunk = tscan._pick_chunk(B, L, KD)
        assert carries.shape == (B, -(-L // chunk), N, KD)
        assert torch.equal(carries[:, 0], torch.zeros_like(carries[:, 0]))
        bc5 = bc.reshape(B, L, K, 2, N)
        for j in range(1, carries.shape[1]):
            t = j * chunk
            # reference layout: u/delta (B, KD, t), grouped B/C (B, K, N, t)
            _, h = tscan.selective_scan_ref(
                u[:, :t].transpose(1, 2), d[:, :t].transpose(1, 2), A_t.t(),
                bc5[:, :t, :, 0].permute(0, 2, 3, 1),
                bc5[:, :t, :, 1].permute(0, 2, 3, 1), return_last_state=True)
            want = h.transpose(1, 2)                         # (B, N, KD)
            err = (carries[:, j] - want).abs().max().item()
            assert err <= 1e-4 * want.abs().max().item(), (j, err)
    assert y.shape == (B, L, KD)


def test_scan_core_bwd_cpu_runs_plain_version_and_counts_no_launch():
    """On CPU tensors the backward wrapper and the differentiable function
    run the plain pair; their gradients are autograd's through the plain
    forward (fp32, another association of the same sums: 1e-4 of each
    gradient's max)."""
    args = _contract_inputs("cpu", 2, 70, 64, 2, 16, seed=4)
    dy = torch.randn(2, 70, 64, generator=torch.Generator().manual_seed(5))
    before = tscan.scan_core_bwd.launches, tscan.scan_core.launches
    got = tscan.scan_core_bwd(*args, dy)
    leaves = [a.clone().requires_grad_() for a in args]
    via_function = torch.autograd.grad(tscan.scan_core_grad(*leaves), leaves, dy)
    assert (tscan.scan_core_bwd.launches, tscan.scan_core.launches) == before
    leaves = [a.clone().requires_grad_() for a in args]
    du, dd, dA, dbc = torch.autograd.grad(tscan.scan_core_plain(*leaves), leaves, dy)
    for name, g, w in zip(("du", "ddelta", "dbc", "dA"), got, (du, dd, dbc, dA)):
        assert g.shape == w.shape, name
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item(), name
    for g, w in zip(via_function, (du, dd, dA, dbc)):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def _grad_errors(got, want):
    return {name: ((g.double() - w).abs().max().item(), w.abs().max().item())
            for name, g, w in zip(("du", "ddelta", "dbc", "dA"), got, want)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,KD,K", [
    (2, 12, 128, 4),        # one chunk, shorter than a sub-chunk
    (2, 56, 128, 4),        # two chunks of 28
    (12, 56, 1024, 4),      # Dh=256: eight warps a direction
    (2, 1000, 96, 3),       # L no multiple of the chunk, KD no multiple of 128
    (1, 301, 32, 1),        # a ragged last chunk and last sub-chunk
    (12, 3584, 128, 4),
    # the backward's tiles (and stored states) are 4 steps
    (2, 3, 128, 4),         # one chunk shorter than a tile
    (2, 4, 128, 4),         # one chunk of one tile
    (2, 5, 128, 4),         # a tile and one step
    (2, 7, 128, 4),         # two tiles short of one step
    (2, 9, 128, 4),         # two tiles and one step
    (2, 92, 128, 4),        # chunks of 31, a step short of 8 tiles, last 30
    (2, 97, 128, 4),        # chunks of 25, a step past 6 tiles, last 22
    (1, 1, 128, 4),         # one chunk of one step
    (2, 333, 1024, 4),      # K*Dh=1024: eight blocks a (batch, chunk), ragged
])
def test_cuda_backward_kernel_matches_plain_version(cuda_device, B, L, KD, K):
    """On the card: the backward kernel against the plain backward in fp64 on
    the same inputs; fp32 with exp2 against exp and other orders of the sums,
    so 1e-4 of each gradient's max magnitude."""
    args = _contract_inputs(cuda_device, B, L, KD, K, 16, seed=L)
    dy = torch.randn(B, L, KD, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(L + 1))
    before = tscan.scan_core_bwd.launches
    got = tscan.scan_core_bwd(*args, dy)
    torch.cuda.synchronize()
    assert tscan.scan_core_bwd.launches == before + 1
    want = tscan.scan_core_bwd_plain(*(a.double() for a in args), dy.double())
    for name, (err, scale) in _grad_errors(got, want).items():
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.cuda
def test_cuda_autograd_function_runs_both_kernels(cuda_device):
    """``scan_core_grad`` on the card: one forward and one backward launch,
    the forward's carries reused, gradients as autograd's through the plain
    forward (1e-4 of each gradient's max)."""
    B, L, KD, K = 2, 700, 128, 4
    args = _contract_inputs(cuda_device, B, L, KD, K, 16, seed=9)
    dy = torch.randn(B, L, KD, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(10))
    before = tscan.scan_core.launches, tscan.scan_core_bwd.launches
    leaves = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(tscan.scan_core_grad(*leaves), leaves, dy)
    torch.cuda.synchronize()
    assert (tscan.scan_core.launches, tscan.scan_core_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    leaves = [a.double().requires_grad_() for a in args]
    want = torch.autograd.grad(tscan.scan_core_plain(*leaves), leaves, dy.double())
    for g, w in zip(got, want):
        assert (g.double() - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.cuda
def test_cuda_backward_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    args = _contract_inputs(cuda_device, 1, 40, 48, 3, 16, seed=2)   # Dh = 16
    with pytest.raises(ValueError, match="multiple of 32"):
        tscan.scan_core_bwd(*args, torch.zeros_like(args[0]))


@pytest.mark.cuda
def test_cuda_backward_kernel_steep_decay(cuda_device):
    """delta up to 4 and A down to -16: the decay of a step reaches e^-64 and
    the kernel's running decay across a chunk underflows to zero; held to
    the plain backward in fp64 as above (1e-4 of each gradient's max)."""
    B, L, KD, K, N = 2, 1000, 128, 4, 16
    g = torch.Generator(device=cuda_device).manual_seed(21)
    u = torch.randn(B, L, KD, device=cuda_device, generator=g)
    d = 4.0 * torch.rand(B, L, KD, device=cuda_device, generator=g)
    A_t = -16.0 * torch.rand(N, KD, device=cuda_device, generator=g) - 1e-3
    bc = torch.randn(B, L, K * 2 * N, device=cuda_device, generator=g)
    dy = torch.randn(B, L, KD, device=cuda_device, generator=g)
    args = (u, d, A_t, bc)
    got = tscan.scan_core_bwd(*args, dy)
    torch.cuda.synchronize()
    want = tscan.scan_core_bwd_plain(*(a.double() for a in args), dy.double())
    for name, (err, scale) in _grad_errors(got, want).items():
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.cuda
def test_cuda_backward_kernel_is_deterministic(cuda_device):
    """No atomics: two calls on the same inputs give the same bits."""
    B, L, KD, K = 12, 3584, 128, 4
    args = _contract_inputs(cuda_device, B, L, KD, K, 16, seed=33)
    dy = torch.randn(B, L, KD, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(34))
    first = tscan.scan_core_bwd(*args, dy)
    second = tscan.scan_core_bwd(*args, dy)
    torch.cuda.synchronize()
    for name, a, b in zip(("du", "ddelta", "dbc", "dA"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("B,nchunks,nsub,KD", [
    (12, 88, 82, 128), (2, 1, 2, 96), (1, 1, 1, 32), (3, 5, 3, 1024)])
def test_backward_scratch_layout(B, nchunks, nsub, KD):
    """The wrapper's one scratch allocation: each piece holds its shape,
    starts on a 16-byte boundary and overlaps no other, the dA partials
    first; the chunk adjoints are there only with more than one chunk."""
    N = 16
    layout, total = tscan._bwd_scratch_layout(B, nchunks, nsub, N, KD)
    assert set(layout) == ({"da_part", "ckpt", "adj", "dsum"} if nchunks > 1
                           else {"da_part", "ckpt"})
    assert layout["da_part"] == (0, (B, nchunks, N, KD))
    assert layout["ckpt"][1] == (B, nchunks, nsub, N, KD)
    spans = sorted((off, off + math.prod(shape)) for off, shape in layout.values())
    assert all(off % 4 == 0 for off, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= total < spans[-1][1] + 4


def test_aligned_copies_only_a_misaligned_tensor():
    t = torch.arange(40, dtype=torch.float32)
    assert tscan._aligned(t) is t
    view = t[1:33]
    fixed = tscan._aligned(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)


# kernel names as the profiler reports them, one per pass of K1-K4
_PROFILED_KERNELS = {
    "k1": ["void (anonymous namespace)::scan_lookback_kernel<16>(float const*, "
           "float const*, float const*, float const*, float*, float*, int*, "
           "unsigned int*, float*, float*, float*, int, int, int, int, int, int, "
           "int, int)"],
    "k2": ["void (anonymous namespace)::forward_chunk_kernel<16>(float const*, "
           "float const*, float const*, float const*, float const*, float const*, "
           "float*, float*, float*, int, int, int, int, int, int)",
           "(anonymous namespace)::adjoint_carry_kernel(float const*, float*, "
           "float const*, int, int, int, int)",
           "void (anonymous namespace)::grad_tile_kernel<16>(float const*, "
           "float const*, float const*, float const*, float const*, float const*, "
           "float const*, float*, float*, float*, float*, int, int, int, int, int, int)"],
    "k3": ["void (anonymous namespace)::cross_fwd_tile_kernel<1>(cross_scan::Streams, "
           "float const*, float const*, float const*, float const*, float const*, "
           "float*, float*, int*, unsigned int*, float*, float*, float*, float*, "
           "float*, int, int, int, int, int, int, int, int, int)",
           "void (anonymous namespace)::cross_fwd_tile_kernel<8>(cross_scan::Streams, "
           "float const*, float const*, float const*, float const*, float const*, "
           "float*, float*, int*, unsigned int*, float*, float*, float*, float*, "
           "float*, int, int, int, int, int, int, int, int, int)"],
    "k4": ["void (anonymous namespace)::cross_walk_kernel<1>(cross_scan::Streams, "
           "float const*, float const*, float*, int)",
           "void (anonymous namespace)::cross_grad_kernel<8>(cross_scan::Streams, "
           "float const*, float const*, float*, int)"],
    "k4_carry": ["void cross_scan::carry_kernel(float const*, float*, "
                 "float const*, int, int, int)"],
}


def test_profile_kernel_names_split_the_scan_kernels():
    """chip_smoke.py adds up profiled device time by kernel-name fragments:
    each pass of K1-K4 must count under its own kernel and no other."""
    import chip_smoke

    class Event:
        def __init__(self, key):
            self.key, self.self_device_time_total = key, 1000.0

    for kernel, names in _PROFILED_KERNELS.items():
        for name in names:
            hits = [k for k, (frags, excl) in chip_smoke.SCAN_KERNEL_NAMES.items()
                    if chip_smoke.kernel_ms([Event(name)], *frags, exclude=excl)]
            assert hits == [kernel], (name, hits)


# ---------------------------------------------------------------- forward (K1)
@pytest.mark.parametrize("chunk", [7, 30, 64])
def test_plain_forward_carries_are_the_chunk_entry_states(chunk):
    """``scan_core_plain(..., return_carries=True)``, the reference of the
    kernel's carries: the state entering chunk j is the per-step reference's
    state after j*chunk steps, and y does not change."""
    B, L, KD, K, N = 2, 150, 32, 4, 16
    u, d, A_t, bc = _contract_inputs("cpu", B, L, KD, K, N, seed=chunk)
    y, carries = tscan.scan_core_plain(u, d, A_t, bc, chunk=chunk,
                                       return_carries=True)
    assert torch.equal(y, tscan.scan_core_plain(u, d, A_t, bc, chunk=chunk))
    want = _ref_carries(u, d, A_t, bc, K, chunk)
    assert carries.shape == want.shape == (B, -(-L // chunk), N, KD)
    assert (carries - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _ref_carries(u, d, A_t, bc, K, chunk):
    """The state entering each chunk from :func:`selective_scan_ref` on each
    prefix, (B, chunks, N, K*Dh)."""
    B, L, KD = u.shape
    N = A_t.shape[0]
    bc5 = bc.reshape(B, L, K, 2, N)
    out = [torch.zeros(B, N, KD, dtype=u.dtype, device=u.device)]
    for t in range(chunk, L, chunk):
        # reference layout: u/delta (B, KD, t), grouped B/C (B, K, N, t)
        _, h = tscan.selective_scan_ref(
            u[:, :t].transpose(1, 2), d[:, :t].transpose(1, 2), A_t.t(),
            bc5[:, :t, :, 0].permute(0, 2, 3, 1),
            bc5[:, :t, :, 1].permute(0, 2, 3, 1), return_last_state=True)
        out.append(h.transpose(1, 2))
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("B,L,KD,K,tile,want", [
    # M2NetP's widest scan at the training batch: one block a (batch, tile)
    (12, 57344, 128, 4, 32, dict(ntiles=1792, ngroups=224, ncb=1, blocks=21504,
                                 bc_width=128, smem=49152)),
    (12, 57344, 128, 4, 48, dict(ntiles=1195, ngroups=150, ncb=1, blocks=14340,
                                 bc_width=128, smem=73728)),
    (4, 57344, 128, 4, 64, dict(ntiles=896, ngroups=112, ncb=1, blocks=3584,
                                bc_width=128, smem=98304)),
    # one step, a tile of it
    (1, 1, 128, 4, 32, dict(ntiles=1, ngroups=1, ncb=1, blocks=1, bc_width=128,
                            smem=49152)),
    # Dh=256: eight column blocks, each inside one direction
    (2, 333, 1024, 4, 32, dict(ntiles=11, ngroups=2, ncb=8, blocks=176,
                               bc_width=32, smem=36864)),
    # three warps; Dh=24, so the block touches all four directions
    (2, 1000, 96, 4, 32, dict(ntiles=32, ngroups=4, ncb=1, blocks=64,
                              bc_width=128, smem=40960)),
    # one warp, Dh=8
    (1, 300, 32, 4, 64, dict(ntiles=5, ngroups=1, ncb=1, blocks=5, bc_width=128,
                             smem=49152)),
    # Dh=48 over 128-channel blocks: the second block spans directions 2-5
    (1, 65, 384, 8, 32, dict(ntiles=3, ngroups=1, ncb=3, blocks=9, bc_width=128,
                             smem=49152)),
])
def test_forward_plan(B, L, KD, K, tile, want):
    """The forward kernel's launch: blocks of 128 channels of one (batch,
    tile), tiles in look-back groups of 8, and the bc columns of every
    direction a block touches staged with u and delta (the C entry makes the
    same plan)."""
    assert tscan._fwd_plan(B, L, KD, K, 16, tile, 8) == want


def test_forward_plan_raises_on_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 4"):
        tscan._fwd_plan(2, 100, 6, 2, 16, 32, 8)
    # Dh=1: a block would stage 128 directions' bc columns a step
    with pytest.raises(ValueError, match="shared memory"):
        tscan._fwd_plan(2, 100, 128, 128, 16, 32, 8)


@pytest.mark.parametrize("B,ntiles,ngroups,ncb,KD", [
    (12, 1792, 224, 1, 128), (2, 1, 1, 1, 96), (1, 5, 1, 1, 32), (3, 11, 2, 8, 1024),
    # the fused cross-scan forward's, over G*Dh channels: M2NetP's longest
    # level, and M2Net's width in two column blocks
    (12, 1195, 150, 1, 64), (12, 2, 1, 2, 512)])
def test_forward_scratch_layout(B, ntiles, ngroups, ncb, KD):
    """The forward's look-back scratch (the selective-scan and the fused
    cross-scan forward's): the flags (one a block, one a group and column
    block) and the ticket first, then each tile's aggregate (end state and
    sum of delta), each group's, and each group's inclusive state; each
    piece holds its count, starts on a 16-byte boundary and overlaps no
    other."""
    N = 16
    layout, total = tscan._fwd_scratch_layout(B, ntiles, ngroups, ncb, N, KD)
    assert list(layout) == ["flags", "agg", "agg_dsum", "gagg", "gdsum", "gincl"]
    assert layout["flags"] == (0, B * (ntiles + ngroups) * ncb + 1)
    assert layout["agg"][1] == B * ntiles * N * KD
    assert layout["agg_dsum"][1] == B * ntiles * KD
    assert layout["gagg"][1] == layout["gincl"][1] == B * ngroups * N * KD
    assert layout["gdsum"][1] == B * ngroups * KD
    spans = sorted((off, off + count) for off, count in layout.values())
    assert all(off % 4 == 0 for off, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= total < spans[-1][1] + 4


def test_forward_launch_is_the_plan_and_layout_in_argument_order():
    """The wrapper's kept launch of a shape: the scratch pieces' offsets in
    the order of the C entry's pointers, and the allocation's size."""
    B, L, KD, K, N, tile, group = 12, 57344, 128, 4, 16, 48, 8
    offsets, total = tscan._fwd_launch(B, L, KD, K, N, tile, group)
    plan = tscan._fwd_plan(B, L, KD, K, N, tile, group)
    layout, want_total = tscan._fwd_scratch_layout(
        B, plan["ntiles"], plan["ngroups"], plan["ncb"], N, KD)
    assert total == want_total
    assert offsets == tuple(layout[name][0] for name in
                            ("flags", "agg", "agg_dsum", "gagg", "gdsum", "gincl"))
    assert tscan._fwd_launch(B, L, KD, K, N, tile, group) is tscan._fwd_launch(
        B, L, KD, K, N, tile, group)
    with pytest.raises(ValueError, match="shared memory"):
        tscan._fwd_launch(2, 100, 128, 128, 16, tile, group)


def _check_forward(args, K, ref_carries=True):
    """Run the forward kernel with carries; y against the plain version in
    fp64 (1e-4 * max|y|: fp32, exp2 against exp, another association) and
    the carries against the per-step reference (or, where L makes that slow,
    the plain version's fp64 carries) at 1e-4 of their max. Returns (y,
    carries)."""
    u = args[0]
    B, L, KD = u.shape
    chunk = tscan._pick_chunk(B, L, KD)
    before = tscan.scan_core.launches
    with torch.inference_mode():
        y, carries = tscan.scan_core(*args, return_carries=True)
        torch.cuda.synchronize()
        assert tscan.scan_core.launches == before + 1
        args64 = [a.double() for a in args]
        want, want_carries = tscan.scan_core_plain(*args64, chunk=chunk,
                                                   return_carries=True)
        if ref_carries:
            want_carries = _ref_carries(*args64, K, chunk)
    assert y.shape == u.shape
    assert carries.shape == (B, -(-L // chunk), args[2].shape[0], KD)
    assert (y.double() - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    err = (carries.double() - want_carries).abs().max().item()
    assert err <= 1e-4 * max(want_carries.abs().max().item(), 1e-30), err
    return y, carries


@pytest.mark.cuda
@pytest.mark.parametrize("groups,tiles,offset", [
    (0, 0, 1),      # L=1
    (0, 1, -1),     # a step short of one tile
    (0, 1, 0),      # one tile
    (0, 1, 1),      # a tile and one step
    (0, 2, -1),
    (0, 2, 1),
    (0, 5, 3),
    (1, 0, -1),     # a step short of one look-back group of tiles
    (1, 0, 0),
    (1, 0, 1),      # a group and one step
    (2, 3, 5),      # a ragged third group
])
def test_cuda_forward_kernel_around_its_tile(cuda_device, groups, tiles, offset):
    """L one step either side of the kernel's tile and of its look-back
    group (and L=1): y and the carries of the backward's chunks (which start
    inside the tiles)."""
    _, tile, group = tscan._fwd_kernel_fns()
    L = (groups * group + tiles) * tile + offset
    args = _contract_inputs(cuda_device, 2, L, 128, 4, 16, seed=L)
    _check_forward(args, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,KD,K", [
    (1, 300, 32, 4),        # Dh=8, chunks of 30 inside 32- or 64-step tiles
    (2, 1000, 96, 3),       # three warps, KD no multiple of 128
    (2, 1000, 96, 4),       # Dh=24: a block touches four directions
    (2, 333, 1024, 4),      # K*Dh=1024: eight blocks a (batch, tile), ragged
    (1, 65, 384, 8),        # Dh=48: a block's directions straddle its edge
])
def test_cuda_forward_kernel_widths(cuda_device, B, L, KD, K):
    args = _contract_inputs(cuda_device, B, L, KD, K, 16, seed=L + KD)
    _check_forward(args, K)


@pytest.mark.cuda
def test_cuda_forward_kernel_deep_look_back(cuda_device):
    """B=12, L=57344 (M2NetP's widest scan at the training batch): far more
    tiles a chain than blocks resident at once, and the backward's chunks of
    652 steps starting inside the tiles; carries against the plain version's
    in fp64 (the per-step reference would walk 57344 steps 88 times)."""
    args = _contract_inputs(cuda_device, 12, 57344, 128, 4, 16, seed=7)
    _check_forward(args, 4, ref_carries=False)


@pytest.mark.cuda
def test_cuda_forward_kernel_steep_decay(cuda_device):
    """delta up to 4 and A down to -16: a step's decay reaches e^-64 and the
    decays across a tile and across the look-back's aggregates underflow."""
    B, L, KD, K, N = 2, 1000, 128, 4, 16
    g = torch.Generator(device=cuda_device).manual_seed(22)
    u = torch.randn(B, L, KD, device=cuda_device, generator=g)
    d = 4.0 * torch.rand(B, L, KD, device=cuda_device, generator=g)
    A_t = -16.0 * torch.rand(N, KD, device=cuda_device, generator=g) - 1e-3
    bc = torch.randn(B, L, K * 2 * N, device=cuda_device, generator=g)
    _check_forward((u, d, A_t, bc), K)


@pytest.mark.cuda
def test_cuda_forward_kernel_is_deterministic(cuda_device):
    """The look-back applies the aggregates one at a time whichever
    predecessor it met, so reruns give the same bits, y with and without the
    carries alike."""
    args = _contract_inputs(cuda_device, 12, 57344, 128, 4, 16, seed=35)
    with torch.inference_mode():
        y, carries = tscan.scan_core(*args, return_carries=True)
        for _ in range(2):
            y2, carries2 = tscan.scan_core(*args, return_carries=True)
            assert torch.equal(y, y2) and torch.equal(carries, carries2)
        assert torch.equal(y, tscan.scan_core(*args))


@pytest.mark.cuda
def test_cuda_serving_writes_no_carries(cuda_device, monkeypatch):
    """``scan_core_grad`` asks the kernel for carries only where a backward
    can follow: not under ``torch.inference_mode()`` or ``torch.no_grad()``
    (as the Predictor runs), nor when no input needs a gradient."""
    asked = []
    launch = tscan._scan_core_cuda

    def spy(*a, carries=False):
        asked.append(carries)
        return launch(*a, carries=carries)

    monkeypatch.setattr(tscan, "_scan_core_cuda", spy)
    args = _contract_inputs(cuda_device, 2, 700, 128, 4, 16, seed=11)
    leaves = [a.clone().requires_grad_() for a in args]
    with torch.inference_mode():
        y_serving = tscan.scan_core_grad(*leaves)
    with torch.no_grad():
        tscan.scan_core_grad(*leaves)
    tscan.scan_core_grad(*args)
    y = tscan.scan_core_grad(*leaves)
    assert asked == [False, False, False, True]
    assert torch.equal(y.detach(), y_serving)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,KD,K", [
    (12, 3584, 128, 4),     # chunks of 41 across 32- or 64-step tiles
    (2, 1000, 96, 3),
    (2, 333, 1024, 4),
    (1, 301, 32, 1),
])
def test_cuda_backward_kernel_on_the_new_carries(cuda_device, B, L, KD, K):
    """The backward kernel fed the forward kernel's carries, against the
    plain backward in fp64 (1e-4 of each gradient's max)."""
    args = _contract_inputs(cuda_device, B, L, KD, K, 16, seed=L + 3)
    dy = torch.randn(B, L, KD, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(L))
    with torch.inference_mode():
        _, carries = tscan.scan_core(*args, return_carries=True)
        got = tscan.scan_core_bwd(*args, dy, carries)
        torch.cuda.synchronize()
    want = tscan.scan_core_bwd_plain(*(a.double() for a in args), dy.double())
    for name, (err, scale) in _grad_errors(got, want).items():
        assert err <= 1e-4 * scale, (name, err, scale)
