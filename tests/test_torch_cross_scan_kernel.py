"""The wrappers of the fused cross-scan CUDA kernels (``cross_scan_fwd``,
``cross_scan_bwd`` and the two as one differentiable ``cross_scan_fused``).

This file imports no JAX, so its ``cuda`` tests also run on a machine with
the GPU and no JAX, where the repository's ``conftest.py`` cannot load:

    python -m pytest --noconftest -q tests/test_torch_cross_scan_kernel.py

On the CPU the ``cuda`` tests skip; the others check what the wrappers do
before a launch, that a CPU tensor runs the plain versions, and how the
SS2D glue is chosen.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from nnuzoo_tpu_torch.models import ss2d as tss2d  # noqa: E402
from nnuzoo_tpu_torch.ops import cross_scan as tcs  # noqa: E402
from nnuzoo_tpu_torch.ops.selective_scan import (  # noqa: E402
    _fwd_scratch_layout, _pick_chunk, scan_core_plain)

NAMES = ("d_streams", "dWx", "dWdt", "dbias", "dA", "dD")


def _inputs(device, B, L, G, Dh, R, seed, N=16):
    """Seeded (streams, wx, wdt, dtb, A, Ds) in the model's regime: delta
    around softplus(-3) = 0.05, A near -(1..N), D near 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device=device, generator=g)
    streams = [rnd(B, L, Dh) for _ in range(G)]
    wx = rnd(G, R + 2 * N, Dh) / math.sqrt(Dh)
    wdt = 0.5 * rnd(G, Dh, R) / math.sqrt(R)
    dtb = -3.0 + 0.5 * rnd(G, Dh)
    A = -torch.arange(1, N + 1, device=device).float() * torch.exp(0.1 * rnd(G * Dh, N))
    Ds = 1.0 + 0.1 * rnd(G * Dh)
    return streams, wx, wdt, dtb, A, Ds


def _flat(grads):
    d_streams, *weights = grads
    return [torch.cat(list(d_streams), -1), *weights]


def test_cpu_runs_plain_versions_and_counts_no_launch():
    streams, *w = _inputs("cpu", 2, 40, 2, 32, 1, seed=1)
    dy = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(2))
    before = tcs.cross_scan_fwd.launches, tcs.cross_scan_bwd.launches
    for reverse in (False, True):
        y = tcs.cross_scan_fwd(streams, *w, reverse)
        assert torch.equal(y, tcs.cross_scan_ref(streams, *w, reverse))
        got = tcs.cross_scan_bwd(streams, *w, dy, reverse)
        leaves = [t.clone().requires_grad_() for t in (*streams, *w)]
        want = torch.autograd.grad(tcs.cross_scan_ref(leaves[:2], *leaves[2:], reverse),
                                   leaves, dy)
        want = [torch.cat(want[:2], -1), *want[2:]]
        for name, a, b in zip(NAMES, _flat(got), want):
            assert a.shape == b.shape, name
            assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name
    assert (tcs.cross_scan_fwd.launches, tcs.cross_scan_bwd.launches) == before
    with pytest.raises(ValueError, match="CUDA kernel only"):
        tcs.cross_scan_fwd(streams, *w, return_carries=True)
    with pytest.raises(ValueError, match="unknown scan backend"):
        tcs.cross_scan_fused(streams, *w, backend="pallas")


def test_kernel_wrapper_checks_inputs():
    """The checks the CUDA wrappers make before a launch (they read shapes,
    types and strides only, so they run here)."""
    streams, *w = _inputs("cpu", 2, 20, 2, 32, 1, seed=3)
    check = tcs._check_kernel_inputs
    assert check(streams, *w) == (2, 20, 2, 32, 1)
    assert check(streams, *w, dy=torch.zeros(2, 20, 64)) == (2, 20, 2, 32, 1)
    s3, *w3 = _inputs("cpu", 1, 9, 3, 64, 8, seed=4)
    assert check(s3, *w3) == (1, 9, 3, 64, 8)
    with pytest.raises(ValueError, match="G in"):
        check(streams[:1], w[0][:1], w[1][:1], w[2][:1], w[3][:32], w[4][:32])
    with pytest.raises(TypeError, match="float32"):
        check([s.double() for s in streams], *w)
    with pytest.raises(ValueError, match="contiguous"):
        check([streams[0].transpose(0, 1), streams[1]], *w)
    with pytest.raises(ValueError, match="dy must be"):
        check(streams, *w, dy=torch.zeros(2, 20, 32))
    s16, *w16 = _inputs("cpu", 2, 20, 2, 16, 1, seed=5)
    with pytest.raises(ValueError, match="multiple of 32"):
        check(s16, *w16)
    s8, *w8 = _inputs("cpu", 2, 20, 2, 32, 1, seed=6, N=8)
    with pytest.raises(ValueError, match="N=16 only"):
        check(s8, *w8)
    s9, *w9 = _inputs("cpu", 2, 20, 2, 32, 9, seed=7)
    with pytest.raises(ValueError, match="R in 1..8"):
        check(s9, *w9)


def test_glue_is_read_when_the_ss2d_is_built(monkeypatch):
    monkeypatch.delenv("NNUZOO_SS2D_FUSED", raising=False)
    assert tss2d.SS2D(16).glue == "default"
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "0")
    assert tss2d.SS2D(16).glue == "default"
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "1")
    block = tss2d.VSSBlock(16)
    assert block.self_attention.glue == "fused"
    tss2d.set_ss2d_glue(block, "default")
    assert block.self_attention.glue == "default"
    with pytest.raises(ValueError, match="glue must be"):
        tss2d.set_ss2d_glue(block, "packed")
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "interpret")
    with pytest.raises(ValueError, match="NNUZOO_SS2D_FUSED"):
        tss2d.SS2D(16)


def test_fused_glue_goes_through_cross_scan_fused(monkeypatch):
    """The fused SS2D makes two cross-scan calls, forwards and reversed, and
    no selective-scan call; on the CPU it equals the default glue."""
    from nnuzoo_tpu_torch.models.layers import init_parameters
    calls = []
    inner = tss2d.cross_scan_fused

    def spy(*args, **kwargs):
        calls.append(kwargs["reverse"])
        return inner(*args, **kwargs)

    def no_blkd(*args, **kwargs):
        raise AssertionError("the fused glue called selective_scan_blkd")

    module = tss2d.SS2D(16)
    init_parameters(module, torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 6, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = module(x)
        tss2d.set_ss2d_glue(module, "fused")
        monkeypatch.setattr(tss2d, "cross_scan_fused", spy)
        monkeypatch.setattr(tss2d, "selective_scan_blkd", no_blkd)
        got = module(x)
    assert calls == [False, True]
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# (B, chunks, L, G, Dh, R, nsub, row): M2NetP's longest level, one chunk, G=3
# with R=2, M2Net's width
LAYOUT_CASES = [(12, 176, 57344, 2, 32, 1, 41, 36), (2, 1, 12, 2, 32, 1, 2, 36),
                (2, 10, 301, 3, 64, 2, 4, 36), (12, 2, 56, 2, 256, 8, 14, 40)]


@pytest.mark.parametrize("B,nchunks,L,G,Dh,R,nsub,row", LAYOUT_CASES)
def test_backward_scratch_layout(B, nchunks, L, G, Dh, R, nsub, row):
    """The backward kernel's one scratch allocation: its pieces are disjoint,
    start on 16 bytes and have the sizes the kernel indexes; with one chunk
    there are no chunk adjoints."""
    N = 16
    layout, total = tcs._cross_bwd_scratch_layout(B, nchunks, L, G, Dh, R, nsub,
                                                  row)
    P = G * Dh * (N + R + 2 * N + R + 2)
    want = {"part": (B * nchunks, P), "xdbl": (B, G, L, row),
            "ckpt": (B, nchunks, G, nsub, N, Dh)}
    if nchunks > 1:
        want.update(adj=(B, nchunks, N, G * Dh), dsum=(B, nchunks, G * Dh))
    assert {k: shape for k, (_, shape) in layout.items()} == want
    assert next(iter(layout)) == "part"         # the wrapper's view starts at 0
    spans = sorted((off, off + math.prod(shape)) for off, shape in layout.values())
    for off, _ in spans:
        assert off % 4 == 0
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start
    assert spans[-1][1] <= total < spans[-1][1] + 4


@pytest.mark.parametrize("G,Dh,R", [(2, 32, 1), (3, 64, 2), (2, 256, 8)])
def test_one_sum_over_packed_partials_gives_the_five_sums(G, Dh, R):
    """The kernel leaves one row of partials a (batch, chunk) with the five
    weight gradients side by side; one sum over the rows and five views give
    what five separate sums of the partials in their own layouts give."""
    N, B, nchunks = 16, 3, 5
    C = R + 2 * N
    gen = torch.Generator().manual_seed(G * Dh + R)
    # integer values: every order of the sums gives the same floats
    rnd = lambda *shape: torch.randint(-50, 50, shape, generator=gen).float()
    parts = {"dA": rnd(B, nchunks, G * Dh, N), "dWx": rnd(B, nchunks, G, C, Dh),
             "dWdt": rnd(B, nchunks, G, Dh, R), "dbias": rnd(B, nchunks, G, Dh),
             "dD": rnd(B, nchunks, G * Dh)}
    pieces, P = tcs._partial_pieces(G, Dh, R)
    assert [name for name, _, _ in pieces] == ["dA", "dWx", "dWdt", "dbias", "dD"]
    rows = torch.cat([parts[name].reshape(B * nchunks, -1) for name, _, _ in pieces],
                     1)
    assert rows.shape == (B * nchunks, P)
    got = tcs._sum_partials(rows, G, Dh, R)
    for name, g in zip(("dWx", "dWdt", "dbias", "dA", "dD"), got):
        assert torch.equal(g, parts[name].sum((0, 1))), name


# ------------------------------------------------------- forward plan (K3)
@pytest.mark.parametrize("B,L,G,Dh,R,want", [
    # M2NetP's longest level, training and serving: both directions a block
    (12, 57344, 2, 32, 1, dict(ntiles=1195, ngroups=150, dirs=2, ncb=1,
                               threads=64, blocks=14340, smem=35616)),
    (4, 57344, 2, 32, 1, dict(ntiles=1195, ngroups=150, dirs=2, ncb=1,
                              threads=64, blocks=4780, smem=35616)),
    # one step, one tile
    (2, 1, 2, 32, 1, dict(ntiles=1, ngroups=1, dirs=2, ncb=1, threads=64,
                          blocks=2, smem=35616)),
    # G=3 with Dh=64 and R=2: three directions, 192 channels
    (2, 301, 3, 64, 2, dict(ntiles=7, ngroups=1, dirs=3, ncb=1, threads=192,
                            blocks=14, smem=85344)),
    # M2Net's width: one direction a block, two column blocks
    (12, 56, 2, 256, 8, dict(ntiles=2, ngroups=1, dirs=1, ncb=2, threads=256,
                             blocks=48, smem=98432)),
    # G=3 with Dh=128: the second column block holds one direction of two
    (1, 1000, 3, 128, 1, dict(ntiles=21, ngroups=3, dirs=2, ncb=2, threads=256,
                              blocks=42, smem=2 * 4 * (48 * 128 + 33 * 132 + 48 * 36))),
])
def test_cross_forward_plan(B, L, G, Dh, R, want):
    """The forward kernel's launch: blocks of one (batch, 48-step tile) over
    as many directions as fit in 256 channels, tiles in look-back groups of
    8, and each direction's u rows, wx and x_dbl in shared memory (the C
    entry makes the same plan)."""
    assert tcs._cross_fwd_plan(B, L, G, Dh, R, 48, 8) == want


def test_cross_forward_plan_raises_on_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 32"):
        tcs._cross_fwd_plan(2, 100, 2, 48, 1, 48, 8)
    with pytest.raises(ValueError, match="multiple of 32"):
        tcs._cross_fwd_plan(2, 100, 2, 512, 1, 48, 8)
    # a tile of 512 steps of Dh=256 does not fit in a block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        tcs._cross_fwd_plan(2, 1000, 2, 256, 8, 512, 8)


def test_cross_forward_launch_is_the_plan_and_layout_in_argument_order():
    """The wrapper's kept launch of a shape: the backward's chunks, the
    offsets of the look-back scratch's pieces (the selective-scan forward's
    layout over G*Dh channels and the plan's column blocks) in the order of
    the C entry's pointers, and the allocation's size."""
    B, L, G, Dh, R, tile, group = 12, 57344, 2, 32, 1, 48, 8
    chunk, nchunks, offsets, total = tcs._cross_fwd_launch(B, L, G, Dh, R, tile,
                                                           group)
    plan = tcs._cross_fwd_plan(B, L, G, Dh, R, tile, group)
    layout, want_total = _fwd_scratch_layout(
        B, plan["ntiles"], plan["ngroups"], plan["ncb"], 16, G * Dh)
    assert (chunk, nchunks) == (_pick_chunk(B, L, G * Dh),
                                math.ceil(L / _pick_chunk(B, L, G * Dh)))
    assert total == want_total
    assert offsets == tuple(layout[name][0] for name in
                            ("flags", "agg", "agg_dsum", "gagg", "gdsum", "gincl"))
    assert tcs._cross_fwd_launch(B, L, G, Dh, R, tile, group) is \
        tcs._cross_fwd_launch(B, L, G, Dh, R, tile, group)
    with pytest.raises(ValueError, match="shared memory"):
        tcs._cross_fwd_launch(2, 1000, 2, 256, 8, 512, group)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cross-scan kernels are CUDA C++ "
                    "with no CPU mode")
    return torch.device("cuda")


# (B, L, G, Dh, R): one chunk shorter than a tile; two chunks; a ragged last
# chunk and tile; G=3 with Dh=64 and R=2; M2Net's width; a long level; and
# K4's chunks of 32 and 30 steps across the forward's 48-step tiles
CUDA_CASES = [(2, 12, 2, 32, 1), (2, 56, 2, 32, 1), (2, 1000, 2, 32, 1),
              (2, 301, 3, 64, 2), (2, 56, 2, 256, 8), (4, 3584, 2, 32, 1),
              (12, 3584, 2, 32, 1), (2, 385, 2, 32, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,L,G,Dh,R", CUDA_CASES)
def test_cuda_forward_kernel_matches_plain_version(cuda_device, B, L, G, Dh, R,
                                                   reverse):
    """K3 against the plain forward in fp64 on the same inputs; fp32 with
    exp2 and another order of the sums, so 1e-4 * max|y|."""
    streams, *w = _inputs(cuda_device, B, L, G, Dh, R, seed=L + G)
    before = tcs.cross_scan_fwd.launches
    with torch.inference_mode():
        y = tcs.cross_scan_fwd(streams, *w, reverse)
        torch.cuda.synchronize()
        want = tcs.cross_scan_ref([s.double() for s in streams],
                                  *(t.double() for t in w), reverse)
    assert tcs.cross_scan_fwd.launches == before + 1
    assert y.shape == (B, L, G * Dh)
    assert (y - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,L,G,Dh,R", CUDA_CASES)
def test_cuda_backward_kernel_matches_plain_version(cuda_device, B, L, G, Dh, R,
                                                    reverse):
    """K4 (from K3's carries) against the plain backward in fp64: d_streams
    to 1e-4 of its max, the weight gradients, sums over B*L positions in
    another order, to 1e-3 of each one's max."""
    streams, *w = _inputs(cuda_device, B, L, G, Dh, R, seed=L + G)
    dy = torch.randn(B, L, G * Dh, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(L))
    before = tcs.cross_scan_bwd.launches
    with torch.inference_mode():
        _, carries = tcs.cross_scan_fwd(streams, *w, reverse, return_carries=True)
        got = tcs.cross_scan_bwd(streams, *w, dy, reverse, carries)
        torch.cuda.synchronize()
    assert tcs.cross_scan_bwd.launches == before + 1
    want = tcs.cross_scan_bwd_plain([s.double() for s in streams],
                                    *(t.double() for t in w), dy.double(), reverse)
    for name, a, b in zip(NAMES, _flat(got), _flat(want)):
        assert a.shape == b.shape, name
        tol = 1e-4 if name == "d_streams" else 1e-3
        err = (a.double() - b).abs().max().item()
        assert err <= tol * b.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_carries_are_the_traversal_chunk_entry_states(cuda_device, reverse):
    """The state entering traversal chunk i is the state after the first
    i*chunk steps of the traversal: with ``reverse`` the state of the scan
    over the LAST i*chunk positions, which the plain forward of those
    positions gives (its state is read through C = one-hot rows)."""
    B, L, G, Dh, R = 1, 700, 2, 32, 1
    streams, *w = _inputs(cuda_device, B, L, G, Dh, R, seed=11)
    with torch.inference_mode():
        _, carries = tcs.cross_scan_fwd(streams, *w, reverse, return_carries=True)
    torch.cuda.synchronize()
    chunk = _pick_chunk(B, L, G * Dh)
    assert carries.shape == (B, -(-L // chunk), 16, G * Dh)
    assert torch.equal(carries[:, 0], torch.zeros_like(carries[:, 0]))
    from nnuzoo_tpu_torch.ops.selective_scan import selective_scan_ref
    wx, wdt, dtb, A, Ds = (t.double() for t in w)
    for i in range(1, carries.shape[1]):
        t = i * chunk
        for g in range(G):
            u = streams[g].double()
            u = u.flip(1)[:, :t] if reverse else u[:, :t]
            x_dbl = u @ wx[g].t()
            dt = x_dbl[..., :R] @ wdt[g].t()
            Bm, Cm = x_dbl[..., R:R + 16], x_dbl[..., R + 16:]
            _, h = selective_scan_ref(
                u.transpose(1, 2), dt.transpose(1, 2), A[g * Dh:(g + 1) * Dh],
                Bm.transpose(1, 2), Cm.transpose(1, 2), delta_bias=dtb[g],
                delta_softplus=True, return_last_state=True)     # (B, Dh, N)
            got = carries[:, i, :, g * Dh:(g + 1) * Dh].transpose(1, 2)
            err = (got.double() - h).abs().max().item()
            assert err <= 1e-4 * h.abs().max().item(), (i, g, err)


@pytest.mark.cuda
def test_cuda_autograd_function_runs_both_kernels(cuda_device):
    """``cross_scan_fused`` on the card: one forward and one backward launch
    (the forward's carries reused), gradients as autograd's through the plain
    forward in fp64."""
    B, L, G, Dh, R = 2, 900, 2, 32, 1
    streams, *w = _inputs(cuda_device, B, L, G, Dh, R, seed=12)
    dy = torch.randn(B, L, G * Dh, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(13))
    for reverse in (False, True):
        before = tcs.cross_scan_fwd.launches, tcs.cross_scan_bwd.launches
        leaves = [t.clone().requires_grad_() for t in (*streams, *w)]
        got = torch.autograd.grad(
            tcs.cross_scan_fused(leaves[:G], *leaves[G:], reverse), leaves, dy)
        torch.cuda.synchronize()
        assert (tcs.cross_scan_fwd.launches, tcs.cross_scan_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        leaves = [t.double().requires_grad_() for t in (*streams, *w)]
        want = torch.autograd.grad(
            tcs.cross_scan_ref(leaves[:G], *leaves[G:], reverse), leaves,
            dy.double())
        for k, (a, b) in enumerate(zip(got, want)):
            tol = 1e-4 if k < G else 1e-3
            assert (a.double() - b).abs().max().item() <= \
                tol * b.abs().max().item(), (reverse, k)


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    streams, *w = _inputs(cuda_device, 1, 40, 2, 16, 1, seed=2)     # Dh = 16
    with pytest.raises(ValueError, match="multiple of 32"):
        tcs.cross_scan_fwd(streams, *w)
    with pytest.raises(ValueError, match="multiple of 32"):
        tcs.cross_scan_bwd(streams, *w, torch.zeros(1, 40, 32, device=cuda_device))


def _grads_of(streams, w, dy, reverse):
    """The backward kernel from the forward kernel's carries, synchronised."""
    with torch.inference_mode():
        _, carries = tcs.cross_scan_fwd(streams, *w, reverse, return_carries=True)
        got = tcs.cross_scan_bwd(streams, *w, dy, reverse, carries)
    torch.cuda.synchronize()
    return got


def _assert_matches_plain(got, streams, w, dy, reverse):
    want = tcs.cross_scan_bwd_plain([s.double() for s in streams],
                                    *(t.double() for t in w), dy.double(), reverse)
    for name, a, b in zip(NAMES, _flat(got), _flat(want)):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        tol = 1e-4 if name == "d_streams" else 1e-3
        err = (a.double() - b).abs().max().item()
        assert err <= tol * b.abs().max().item(), (name, err)


# (B, L): chunks of 31 steps (not a multiple of the 8-step tile) with a last
# chunk of 22; one chunk of 5 steps, shorter than a tile; one chunk of 17,
# one step past two tiles and pass A's 16-step tile
TILE_EDGE_CASES = [(2, 301), (2, 5), (1, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,L", TILE_EDGE_CASES)
def test_cuda_backward_kernel_around_its_tiles(cuda_device, B, L, reverse):
    """K4 where chunks and tiles do not line up, against the plain backward
    in fp64 (d_streams 1e-4, weight gradients 1e-3 of each one's max)."""
    G, Dh, R = 2, 32, 1
    assert _pick_chunk(B, L, G * Dh) % 8
    streams, *w = _inputs(cuda_device, B, L, G, Dh, R, seed=L + 40)
    dy = torch.randn(B, L, G * Dh, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(L))
    got = _grads_of(streams, w, dy, reverse)
    _assert_matches_plain(got, streams, w, dy, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_backward_kernel_steep_decay(cuda_device, reverse):
    """delta near 4 and A down to -16 (and -48 at its steepest): a step's
    decay reaches e^-190, so the chunk's products P of decays underflow to
    zero within a few steps and the forward sum of pass A must still give
    the chunk's entry adjoint; several chunks so that it is used."""
    B, L, G, Dh, R = 2, 700, 2, 32, 1
    streams, wx, wdt, dtb, A, Ds = _inputs(cuda_device, B, L, G, Dh, R, seed=21)
    dtb = dtb + 7.0                                  # softplus(~4) ~ 4
    A = A * 3.0
    w = [wx, wdt, dtb, A, Ds]
    assert _pick_chunk(B, L, G * Dh) < L
    dy = torch.randn(B, L, G * Dh, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(22))
    got = _grads_of(streams, w, dy, reverse)
    _assert_matches_plain(got, streams, w, dy, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,G,Dh,R", [(4, 3584, 2, 32, 1), (2, 301, 3, 64, 2)])
def test_cuda_backward_kernel_reruns_are_bit_identical(cuda_device, B, L, G, Dh,
                                                        R):
    """No atomics: every sum has one order, so two runs on the same inputs
    give the same bits in all six outputs."""
    streams, *w = _inputs(cuda_device, B, L, G, Dh, R, seed=23)
    dy = torch.randn(B, L, G * Dh, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(24))
    for reverse in (False, True):
        first, second = (_flat(_grads_of(streams, w, dy, reverse)) for _ in range(2))
        for name, a, b in zip(NAMES, first, second):
            assert torch.equal(a, b), (reverse, name)


# ------------------------------------------------------- forward kernel (K3)
def _plain_with_carries(streams, w, reverse, chunk):
    """y and the state entering each traversal chunk of ``chunk`` steps, in
    fp64, from the plain scan of the traversal (``scan_core_plain``): the
    reference of the forward kernel's carries."""
    wx, wdt, dtb, A, Ds = (t.double() for t in w)
    G, N = len(streams), A.shape[1]
    R = wx.shape[1] - 2 * N
    xs = torch.stack([s.double() for s in streams], 2)          # (B, L, G, Dh)
    if reverse:
        xs = xs.flip(1)
    B, L, _, Dh = xs.shape
    x_dbl = torch.einsum("blgd,gcd->blgc", xs, wx)
    dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
    delta = torch.nn.functional.softplus(
        torch.einsum("blgr,gdr->blgd", dts, wdt) + dtb)
    bc = torch.cat([Bs, Cs], -1).reshape(B, L, G * 2 * N)
    u = xs.reshape(B, L, G * Dh)
    y, carries = scan_core_plain(u, delta.reshape(B, L, G * Dh), A.t(), bc,
                                 chunk=chunk, return_carries=True)
    y = y + u * Ds
    return (y.flip(1) if reverse else y), carries


def _check_forward(streams, w, reverse):
    """The forward kernel with carries, synchronised: y against the plain
    forward in fp64 (1e-4 of max|y|) and the carries against the plain
    scan's chunk-entry states (1e-4 of their max); y without carries the
    same bits as with them."""
    B, L, Dh = streams[0].shape
    G = len(streams)
    chunk = _pick_chunk(B, L, G * Dh)
    with torch.inference_mode():
        y, carries = tcs.cross_scan_fwd(streams, *w, reverse, return_carries=True)
        y_serving = tcs.cross_scan_fwd(streams, *w, reverse)
        torch.cuda.synchronize()
    want, want_carries = _plain_with_carries(streams, w, reverse, chunk)
    assert torch.isfinite(y).all()
    err = (y.double() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    assert torch.equal(y, y_serving)
    if want_carries.shape[1] == 1:
        assert carries is None
    else:
        assert carries.shape == want_carries.shape
        err = (carries.double() - want_carries).abs().max().item()
        assert err <= 1e-4 * want_carries.abs().max().item(), err
    return y, carries


# L around the 48-step tile and the 8-tile look-back group: one step short
# of a tile, a tile, one past it; one short of a group, a group, one past it
TILE = 48
FWD_EDGE_LENGTHS = [1, TILE - 1, TILE, TILE + 1, 8 * TILE - 1, 8 * TILE,
                    8 * TILE + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", FWD_EDGE_LENGTHS)
def test_cuda_forward_kernel_around_its_tile(cuda_device, L, reverse):
    """K3 where L meets a tile's or a group's edge, y and the carries
    against the plain scan in fp64."""
    assert tcs._fwd_kernel_fns()[1:] == (TILE, 8)
    streams, *w = _inputs(cuda_device, 3, L, 2, 32, 1, seed=L + 60)
    _check_forward(streams, w, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_forward_kernel_deep_look_back(cuda_device, reverse):
    """Many groups in each chain (B=12, L=57344: 150 groups of 8 tiles), so
    the look-back meets every state a predecessor can be in."""
    streams, *w = _inputs(cuda_device, 12, 57344, 2, 32, 1, seed=61)
    _check_forward(streams, w, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_forward_kernel_steep_decay(cuda_device, reverse):
    """delta near 4 and A down to -48: a step's decay reaches e^-190, below
    ex2's flush to zero, and the aggregates across tiles and groups
    underflow; y and the carries still agree."""
    streams, wx, wdt, dtb, A, Ds = _inputs(cuda_device, 2, 3000, 2, 32, 1, seed=62)
    w = [wx, wdt, dtb + 7.0, A * 3.0, Ds]
    _check_forward(streams, w, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,G,Dh,R", [(12, 14336, 2, 32, 1), (2, 1000, 3, 128, 1),
                                        (2, 301, 3, 64, 2)])
def test_cuda_forward_kernel_reruns_are_bit_identical(cuda_device, B, L, G, Dh, R):
    """The look-back applies the aggregates one at a time whichever
    predecessor it met, so reruns give the same bits, y and carries, and
    the column blocks of a wide shape agree with the plain version."""
    streams, *w = _inputs(cuda_device, B, L, G, Dh, R, seed=63)
    for reverse in (False, True):
        y, carries = _check_forward(streams, w, reverse)
        with torch.inference_mode():
            for _ in range(2):
                y2, carries2 = tcs.cross_scan_fwd(streams, *w, reverse,
                                                  return_carries=True)
                assert torch.equal(y, y2) and torch.equal(carries, carries2)


@pytest.mark.cuda
def test_cuda_serving_writes_no_carries(cuda_device, monkeypatch):
    """``cross_scan_fused`` asks the kernel for carries only where a
    backward can follow: not under ``torch.inference_mode()`` or
    ``torch.no_grad()`` (as the Predictor runs), nor when no input needs a
    gradient; y is the same either way."""
    asked = []
    launch = tcs._cross_scan_fwd_cuda

    def spy(*a, carries=False):
        asked.append(carries)
        return launch(*a, carries=carries)

    monkeypatch.setattr(tcs, "_cross_scan_fwd_cuda", spy)
    streams, *w = _inputs(cuda_device, 2, 700, 2, 32, 1, seed=64)
    leaves = [t.clone().requires_grad_() for t in (*streams, *w)]
    with torch.inference_mode():
        y_serving = tcs.cross_scan_fused(leaves[:2], *leaves[2:], True)
    with torch.no_grad():
        tcs.cross_scan_fused(leaves[:2], *leaves[2:], True)
    tcs.cross_scan_fused(streams, *w, True)
    y = tcs.cross_scan_fused(leaves[:2], *leaves[2:], True)
    assert asked == [False, False, False, True]
    assert torch.equal(y.detach(), y_serving)
