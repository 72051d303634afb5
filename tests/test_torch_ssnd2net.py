"""The port's MUSSND, SSND2Net and SSND2NetP against the JAX package's.

Seeded numpy input, converted parameters (which convert back to the flax
tree exactly), fp32 on both sides (the minis' depthwise convolutions have
no fast fp64 path on the CPU in either package), the JAX modules applied
without ``jax.jit`` but for their selective scans (a jitted SSND2Net takes
minutes of XLA compile):

- MUSSND with its own scale plan (16x12: two merges), without one (no
  merge: the bottleneck minis), with an odd axis (6x5: the plan (2, 1),
  (1, 1), (1, 1) compacts to one merge, and the decoder expands only at
  its last step) and at 3d with an odd axis (4x6x5: merges (2, 2, 1) and
  (2, 1, 1)): the output to rtol
  1e-3 with atol 1e-4 of its largest magnitude;
- the full-width parameter counts (1 input channel, 3 classes) against the
  JAX model's ``jax.eval_shape`` at the 2d plan for SSND2NetP, and against
  the counts it gives for the other three (the JAX ``eval_shape`` takes
  some 18 s a model on the CPU); the selective-scan calls of one forward,
  (L, K*Dh, K) and how many, against the JAX model's calls of
  ``selective_scan_blkd`` there; and the port's tables of both glues at
  both plans, on the meta device, against ``chip_smoke.py``'s, which K1-K4
  are held to on the card;
- ``remat`` (each mini rerun whole in the backward pass): the same outputs
  and gradients as without, DropPath live, and every SSND run twice a
  step.
"""

import collections
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from nnuzoo_tpu.models import ssnd as jssnd  # noqa: E402
from nnuzoo_tpu.models import ssnd2net as js  # noqa: E402
from nnuzoo_tpu_torch.convert import flatten_params, params_from_state_dict  # noqa: E402
from nnuzoo_tpu_torch.models import ss2d as tss2d  # noqa: E402
from nnuzoo_tpu_torch.models import ssnd as tssnd  # noqa: E402
from nnuzoo_tpu_torch.models import ssnd2net as ts  # noqa: E402
from nnuzoo_tpu_torch.models.layers import (init_parameters,  # noqa: E402
                                            set_drop_path_generator)
from nnuzoo_tpu_torch.ops import selective_scan as tscan  # noqa: E402

from .torch_port_helpers import (load_converted, one_torch_thread,  # noqa: E402
                                 random_flax_params)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

NC = 3
FULL_WIDTH = {  # (small, patch): the JAX model's parameter count
    (True, (256, 224)): 1_919_300, (False, (256, 224)): 39_787_124,
    (True, (48, 192, 192)): 2_767_958, (False, (48, 192, 192)): 46_269_958}
NAMES = {True: chip_smoke.SSND2NET_P, False: chip_smoke.SSND2NET}


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assert_round_trip(tmod, params):
    back = flatten_params(params_from_state_dict(tmod.state_dict(), tmod))
    flat = flatten_params(params["params"])
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("shape,ips,n,add_last,downs", [
    ((1, 16, 12, 3), (16, 12), 3, True, [(2, 2), (2, 2)]),
    ((1, 6, 5, 3), None, 3, True, []),
    ((2, 6, 5, 3), (6, 5), 4, False, [(2, 1)]),
    ((1, 4, 6, 5, 3), (4, 6, 5), 3, True, [(2, 2, 1), (2, 1, 1)]),
], ids=["plan", "no_plan", "odd_axis", "3d_odd_axis"])
def test_mussnd_matches_jax(shape, ips, n, add_last, downs, monkeypatch):
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "")
    jitted_jax_scans(monkeypatch)
    dim = len(shape) - 2
    x = _x(1, shape)
    jmod = js.MUSSND(16, 8, n, dim, ips, add_last=add_last)
    params = random_flax_params(jmod, jnp.asarray(x), train=False)
    want = np.asarray(jmod.apply(params, jnp.asarray(x), train=False))
    tmod = load_converted(ts.MUSSND(shape[-1], 16, 8, n, dim, ips,
                                    add_last=add_last), params)
    assert tmod.downs == downs
    _assert_round_trip(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == shape[:-1] + (8,)
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * float(np.abs(want).max()))


def one_level_minis(monkeypatch):
    """Every mini of both packages at one level."""
    jmini, tmini = js.MUSSND, ts.MUSSND
    monkeypatch.setattr(js, "MUSSND", lambda mid, out, n, *a, **k:
                        jmini(mid, out, 1, *a, **k))
    monkeypatch.setattr(ts, "MUSSND", lambda c, mid, out, n, *a, **k:
                        tmini(c, mid, out, 1, *a, **k))


def jitted_jax_scans(monkeypatch):
    """The JAX SSND's selective scans under ``jax.jit``, one compile a
    shape: applied without jit, the JAX package's chunked XLA scan is traced
    and compiled again at every call, most of an eager SSND2Net's time on
    the CPU."""
    monkeypatch.setattr(jssnd, "selective_scan_blkd", jax.jit(
        jssnd.selective_scan_blkd,
        static_argnames=("delta_softplus", "backend", "interpret")))


def _port_tables(model, patch, glue):
    """{(L, K*Dh, K): calls} of one forward of the port's model on the meta
    device (the fused glue: {(L, G, Dh, R): calls in each orientation})."""
    calls = collections.Counter()
    model.eval()
    tss2d.set_ss2d_glue(model, glue)
    real_scan, real_cross = tscan.scan_core_grad, tss2d.cross_scan_fused

    def scan(u, d, A_t, bc):
        calls[(u.shape[1], u.shape[2], bc.shape[2] // (2 * A_t.shape[0]))] += 1
        return torch.empty_like(u)

    def cross(streams, x_proj_weight, dt_weight, dt_bias, A, Ds, reverse=False,
              backend=None):
        B, L, Dh = streams[0].shape
        if not reverse:
            calls[(L, len(streams), Dh, x_proj_weight.shape[1] - 32)] += 1
        return streams[0].new_empty(B, L, len(streams) * Dh)

    tscan.scan_core_grad, tss2d.cross_scan_fused = scan, cross
    try:
        with torch.no_grad():
            model(torch.empty(1, *patch, 1, device="meta"))
    finally:
        tscan.scan_core_grad, tss2d.cross_scan_fused = real_scan, real_cross
    return dict(calls)


@pytest.mark.parametrize("small,patch", list(FULL_WIDTH),
                         ids=["P_2d", "full_2d", "P_3d", "full_3d"])
def test_full_width_counts_and_tables(small, patch):
    with torch.device("meta"):
        model = ts.SSND2Net(1, NC, patch, small=small)
    assert sum(p.numel() for p in model.parameters()) == FULL_WIDTH[small, patch]
    dim = len(patch)
    name = NAMES[small]
    assert _port_tables(model, patch, "default") == \
        chip_smoke.SSND2NET_SCANS[dim][name]
    if small:
        assert _port_tables(model, patch, "fused") == chip_smoke.SSND2NET_CROSS[dim]
        assert chip_smoke.ssnd2net_calls(name, dim, "fused") == \
            2 * chip_smoke.ssnd2net_calls(name, dim)
    else:
        with pytest.raises(ValueError, match="Dh=512, R=16"):
            tss2d.set_ss2d_glue(model, "fused")


def test_jax_counts_and_scan_table_at_the_2d_plan(monkeypatch):
    """SSND2NetP at 256x224 through ``jax.eval_shape``: its parameter count
    and its ``selective_scan_blkd`` calls (the scans stand in by zeros)."""
    calls = collections.Counter()

    def record(xs, dts, A, Bs, Cs, *args, **kwargs):
        B, L, K, Dh = xs.shape
        calls[(L, K * Dh, K)] += 1
        return jnp.zeros_like(xs)

    monkeypatch.setattr(jssnd, "selective_scan_blkd", record)
    patch = (256, 224)
    init = functools.partial(
        js.SSND2Net(NC, 2, small=True, patch_size=patch).init, train=False)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *patch, 1)))
    n = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert n == FULL_WIDTH[True, patch]
    assert dict(calls) == chip_smoke.SSND2NET_SCANS[2][chip_smoke.SSND2NET_P]


def test_chip_smoke_shape_rows_cover_the_tables():
    """Every (L, K*Dh, K) of the family is held on the card, here or in an
    earlier phase's rows, and every fused (L, G, Dh, R): at G=3 all seven
    3d lengths, L=1,769,472 included."""
    rows = {(L, kd, k) for L, kd, k, _, steep in chip_smoke.ssnd2net_scan_shapes()
            if not steep}
    earlier = {(L, chip_smoke.KD, chip_smoke.K_DIRS)
               for L, _ in chip_smoke.PATH_SHAPES} | \
        {(L, kd, chip_smoke.K_DIRS) for L, kd in chip_smoke.M2NET_SCANS} | \
        {k for t in (chip_smoke.MAMBA_SCANS_2D, chip_smoke.LM2NET_SCANS_2D)
         for scans in t.values() for k in scans}
    for dim in (2, 3):
        for scans in chip_smoke.SSND2NET_SCANS[dim].values():
            assert set(scans) <= rows | earlier
    cross = {row[:4] for row in chip_smoke.ssnd2net_cross_shapes()}
    assert set(chip_smoke.SSND2NET_CROSS[3]) <= cross
    assert (1769472, 3, 32, 1) in cross
    assert set(chip_smoke.SSND2NET_CROSS[2]) <= cross | set(
        chip_smoke.CROSS_SHAPES["M2NetP"])


def test_remat_gives_the_same_outputs_and_gradients(monkeypatch):
    """SSND2NetP at 32x32 with two-level stage minis, DropPath live (a
    rate of 0.5 everywhere, one seeded generator), remat on against off:
    outputs and gradients equal to fp32 rounding, and each SSND runs twice
    in the step with remat (each mini's forward again in the backward)."""
    monkeypatch.setattr(ts, "_N_LAYERS", (2, 2, 2, 2))
    model = ts.SSND2Net(1, NC, (32, 32), small=True)
    init_parameters(model, torch.Generator().manual_seed(0))
    for m in model.modules():
        if hasattr(m, "rate"):
            m.rate = 0.5
    runs = {}
    x = torch.from_numpy(_x(3, (2, 32, 32, 1)))
    for remat in (False, True):
        model.remat = remat
        set_drop_path_generator(model, torch.Generator().manual_seed(1))
        count = [0]
        hooks = [m.register_forward_hook(lambda *_: count.__setitem__(
            0, count[0] + 1)) for m in model.modules()
            if isinstance(m, tssnd.SSND)]
        model.train()
        outs = model(x)
        loss = sum((o ** 2).mean() for o in outs)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        for h in hooks:
            h.remove()
        runs[remat] = ([o.detach() for o in outs], grads, count[0])
    n_ssnd = sum(isinstance(m, tssnd.SSND) for m in model.modules())
    assert runs[False][2] == n_ssnd and runs[True][2] == 2 * n_ssnd
    for a, b in zip(runs[False][0], runs[True][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(runs[False][1], runs[True][1]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=1e-6 * float(b.abs().max()))
