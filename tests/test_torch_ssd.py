"""The port's Mamba2 SSD (``ops/ssd.py``) and ``Mamba2Block`` against the JAX
package's.

Seeded numpy inputs in the model's regime (dt around softplus(-3 + N(0,
0.5)), A in [-16, -1]). ``ssd_chunked`` in fp32 against the JAX
``ssd_chunked`` (fp32 math, HIGHEST precision), forward and the gradient of
every input for one seeded cotangent, each to 1e-4 of its largest
magnitude, with the chunk Q dividing L, not dividing it and larger than L;
in fp64 against the JAX per-step ``ssd_ref`` (under x64) to 1e-10 of the
largest magnitude (dD to 1e-6: the JAX recurrence casts D to fp32). The intra-chunk term that keeps no (Q, Q) block
(``intra_chunk``) equals plain autograd through the same blocks
(``intra_chunk_plain``) to 1e-12 in fp64, forward and gradients, and passes
``gradcheck`` over several slices; a ``saved_tensors_hooks`` check finds no
saved tensor with two dimensions of size Q on its route and finds them on
the plain one. ``Mamba2Block`` on each route against the JAX block on the
same route (``NNUZOO_SCAN_BACKEND``), fp32, output rtol 1e-4 with atol 1e-4
of its largest magnitude and the input's and every parameter's gradient to
1e-3 of each one's largest; the two routes against each other by the JAX
package's own test's 2e-3.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import mamba as jm  # noqa: E402
from nnuzoo_tpu.ops import ssd as jssd  # noqa: E402
from nnuzoo_tpu_torch.models import mamba as tm  # noqa: E402
from nnuzoo_tpu_torch.ops import ssd as tssd  # noqa: E402

from .torch_port_helpers import load_converted, random_flax_params  # noqa: E402

NAMES = ("x", "dt", "A", "B", "C", "D", "dt_bias")


def _inputs(seed, Bt=2, L=30, H=4, P=3, G=2, N=5):
    rng = np.random.RandomState(seed)
    # D fp32-exact: the JAX ssd_ref adds D x with D cast to fp32
    return (rng.randn(Bt, L, H, P), rng.randn(Bt, L, H),
            -rng.uniform(1.0, 16.0, H), rng.randn(Bt, L, G, N),
            rng.randn(Bt, L, G, N),
            (1.0 + 0.1 * rng.randn(H)).astype(np.float32).astype(np.float64),
            -3.0 + 0.5 * rng.randn(H))


def _torch_run(arrays, dtype, cot, **kw):
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]
    y = tssd.ssd_chunked(*leaves, **kw)
    grads = torch.autograd.grad(y, leaves, torch.tensor(cot, dtype=dtype))
    return y.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, rel, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("L,Q", [(32, 8), (30, 8), (5, 8)])
def test_ssd_chunked_matches_jax_in_fp32(L, Q):
    """Q divides L; Q does not (L padded to 32); L < Q (one chunk of L)."""
    arrays = [a.astype(np.float32) for a in _inputs(1, L=L)]
    cot = np.random.RandomState(2).randn(2, L, 4, 3).astype(np.float32)
    fn = functools.partial(jssd.ssd_chunked, chunk_size=Q)
    want, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    want_grads = vjp(jnp.asarray(cot))
    got, grads = _torch_run(arrays, torch.float32, cot, chunk_size=Q)
    _close(got, np.asarray(want), 1e-4, "y")
    for name, g, w in zip(NAMES, grads, want_grads):
        _close(g, np.asarray(w), 1e-4, f"d{name}")


@pytest.mark.parametrize("L,Q", [(32, 8), (30, 8), (5, 8)])
def test_ssd_chunked_matches_the_jax_recurrence_in_fp64(L, Q):
    arrays = _inputs(3, L=L)
    cot = np.random.RandomState(4).randn(2, L, 4, 3)
    with jax.enable_x64(True):
        want, vjp = jax.vjp(jssd.ssd_ref, *[jnp.asarray(a) for a in arrays])
        want_grads = vjp(jnp.asarray(cot))
        want_ref = np.asarray(want)
    got, grads = _torch_run(arrays, torch.float64, cot, chunk_size=Q)
    _close(got, want_ref, 1e-10, "y")
    for name, g, w in zip(NAMES, grads, want_grads):
        # the JAX recurrence takes D through an fp32 cast: its dD is fp32
        _close(g, np.asarray(w), 1e-6 if name == "D" else 1e-10, f"d{name}")
    ref = tssd.ssd_ref(*[torch.tensor(a) for a in arrays]).numpy()
    _close(ref, want_ref, 1e-12, "ssd_ref")


def test_memory_saving_backward_equals_plain_autograd(monkeypatch):
    """The whole function with each intra-chunk term, fp64, and the term
    alone through ``gradcheck`` with slices of one (batch x chunk) pair."""
    arrays = _inputs(5, L=44, H=6, G=3)
    cot = np.random.RandomState(6).randn(2, 44, 6, 3)
    got, grads = _torch_run(arrays, torch.float64, cot, chunk_size=8)
    want, want_grads = _torch_run(arrays, torch.float64, cot, chunk_size=8,
                                  intra=tssd.intra_chunk_plain)
    _close(got, want, 1e-12, "y")
    for name, g, w in zip(NAMES, grads, want_grads):
        _close(g, w, 1e-12, f"d{name}")

    monkeypatch.setattr(tssd, "_SLICE_BYTES", 1)
    g = torch.Generator().manual_seed(7)
    BC, G, H, Q, N, P = 3, 2, 4, 5, 3, 2
    args = (torch.randn(BC, G, Q, N, generator=g, dtype=torch.float64),
            torch.randn(BC, G, Q, N, generator=g, dtype=torch.float64),
            (-torch.rand(BC, H, Q, generator=g, dtype=torch.float64)).cumsum(-1),
            torch.randn(BC, H, Q, P, generator=g, dtype=torch.float64))
    args = [a.requires_grad_() for a in args]
    assert torch.autograd.gradcheck(tssd.intra_chunk, args)
    torch.testing.assert_close(tssd.intra_chunk(*args),
                               tssd.intra_chunk_plain(*args), rtol=0, atol=1e-12)


def _saved_shapes(intra):
    shapes = []
    leaves = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
              for a in _inputs(8, L=40, H=3, P=2, G=1, N=4)]
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        tssd.ssd_chunked(*leaves, chunk_size=8, intra=intra).sum().backward()
    return shapes


def test_no_saved_tensor_holds_a_QxQ_block():
    """Q = 8 over L = 40 (5 chunks) at batch 2, 3 heads of 2 channels, N = 4:
    no other dimension is 8, so two dimensions of 8 are a (Q, Q) block."""
    shapes = _saved_shapes(tssd.intra_chunk)
    assert shapes and all(s.count(8) <= 1 for s in shapes), shapes
    assert any(s.count(8) >= 2 for s in _saved_shapes(tssd.intra_chunk_plain))


def test_route_from_the_environment(monkeypatch):
    monkeypatch.delenv("NNUZOO_SCAN_BACKEND", raising=False)
    assert tm.mamba2_route() == "ssd"
    for value, route in (("mamba1", "mamba1"), ("ref", "ssd"), ("xla", "ssd"),
                         ("pallas", "ssd"), ("", "ssd")):
        monkeypatch.setenv("NNUZOO_SCAN_BACKEND", value)
        assert tm.mamba2_route() == route
        assert tm.Mamba2Block(8, 16, headdim=4).route == route
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "mamba2")
    with pytest.raises(ValueError, match="NNUZOO_SCAN_BACKEND"):
        tm.Mamba2Block(8, 16, headdim=4)
    with pytest.raises(ValueError, match="route"):
        tm.Mamba2Block(8, 16, headdim=4, route="scan")


def _block_run(module, x, cot):
    xt = torch.tensor(x, requires_grad=True)
    y = module(xt)
    grads = torch.autograd.grad(y, [xt] + list(module.parameters()),
                                torch.tensor(cot))
    names = ["input"] + [n for n, _ in module.named_parameters()]
    return y.detach().numpy(), dict(zip(names, (g.numpy() for g in grads)))


@pytest.mark.parametrize("route", ["ssd", "mamba1"])
def test_mamba2_block_matches_jax_on_each_route(route, monkeypatch):
    """d_model 16, d_state 16, 4 heads of 8 channels, L = 200 (two chunks,
    the second padded) at batch 2."""
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "mamba1" if route == "mamba1"
                       else "xla")
    rng = np.random.RandomState(9)
    x = rng.randn(2, 200, 16).astype(np.float32)
    cot = rng.randn(2, 200, 16).astype(np.float32)
    jblock = jm.Mamba2Block(d_model=16, d_state=16, headdim=8)
    params = random_flax_params(jblock, jnp.asarray(x), seed=10)
    want, vjp = jax.vjp(lambda p, v: jblock.apply(p, v), params, jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(cot))
    block = load_converted(tm.Mamba2Block(16, 16, headdim=8), params)
    assert block.route == route
    got, grads = _block_run(block, x, cot)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    from nnuzoo_tpu_torch.convert import convert_params
    want_grads = {"input": np.asarray(dx),
                  **{k: v.numpy() for k, v in convert_params(dparams, block).items()}}
    assert sorted(want_grads) == sorted(grads)
    for name, w in want_grads.items():
        _close(grads[name], w, 1e-3, name)


def test_the_two_routes_agree():
    """The port's SSD route against its mamba1 route on one block, as the
    JAX package's ``test_mamba2_block_backends_agree`` holds its own."""
    block = tm.Mamba2Block(16, 16, headdim=8, route="ssd")
    from nnuzoo_tpu_torch.models.layers import init_parameters
    init_parameters(block, torch.Generator().manual_seed(11))
    x = torch.from_numpy(np.random.RandomState(12).randn(1, 300, 16)
                         .astype(np.float32))
    with torch.no_grad():
        ssd = block(x)
        block.route = "mamba1"
        mamba1 = block(x)
    np.testing.assert_allclose(ssd.numpy(), mamba1.numpy(), rtol=2e-3, atol=2e-3)
