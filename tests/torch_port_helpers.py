"""Shared helpers of the ``test_torch_*`` files: seeded parameters for a flax
module (through ``jax.eval_shape``, which costs a trace and no compile, where
``init`` compiles for tens of seconds at M2NetP's widths), their conversion
into the port's twin, and the comparison of the two."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnuzoo_tpu_torch.convert import convert_params


def _leaf_value(rng, path, shape):
    """A well-conditioned value for one parameter, chosen by its name: SS2D
    and Mamba scan-branch parameters near their reference initialisation, so
    the scan runs in its real regime (decays in (0, 1), steps around 0.05)."""
    leaf = path[-1]
    if leaf == "kernel":
        return rng.randn(*shape) / math.sqrt(max(1, int(np.prod(shape[:-1]))))
    if leaf == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if leaf == "bias":
        return 0.1 * rng.randn(*shape)
    if leaf == "x_proj_weight":
        return rng.randn(*shape) / math.sqrt(shape[-1])
    if leaf == "dt_projs_weight":
        return 0.5 * rng.randn(*shape) / math.sqrt(shape[-1])
    if leaf == "dt_projs_bias":
        return -3.0 + 0.5 * rng.randn(*shape)
    if leaf == "A_logs":
        return np.log(np.arange(1, shape[-1] + 1)) + 0.1 * rng.randn(*shape)
    if leaf in ("Ds", "D", "skip_scale", "weight"):     # weight: RMSNorm's
        return 1.0 + 0.1 * rng.randn(*shape)
    if leaf == "conv1d_weight":                          # (d_conv, d_inner)
        return rng.randn(*shape) / math.sqrt(shape[0])
    if leaf == "conv1d_bias":
        return 0.1 * rng.randn(*shape)
    if leaf == "dt_proj_weight":                         # (d_inner, R)
        return 0.5 * rng.randn(*shape) / math.sqrt(shape[-1])
    if leaf == "dt_proj_bias":
        return -3.0 + 0.5 * rng.randn(*shape)
    if leaf == "A_log":                                  # (d_inner, N)
        return np.log(np.arange(1, shape[-1] + 1)) + 0.1 * rng.randn(*shape)
    if leaf == "dt_bias":                                # Mamba2's (nheads,)
        return -3.0 + 0.5 * rng.randn(*shape)
    if leaf == "norm_weight":                            # Mamba2's RMSNorm
        return 1.0 + 0.1 * rng.randn(*shape)
    if leaf in ("relative_position_bias_table", "pos_embed"):
        # larger than their 0.02 initialisation, so that a misplaced entry shows
        return 0.5 * rng.randn(*shape)
    raise KeyError(f"no value rule for parameter {'/'.join(path)}")


def random_flax_params(module, *inputs, seed=0, **kwargs):
    """Seeded numpy values in the tree shape of ``module.init(key, *inputs)``."""
    init = functools.partial(module.init, **kwargs)   # kwargs stay static
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = tuple(getattr(p, "key", str(p)) for p in path)
        return _leaf_value(rng, keys, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one thread for a module's tests, as it was before after them:
    the test run shares the cores among its workers, and torch's intra-op
    threads, which meet at every operation, run tens of times slower when
    the workers' threads together outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_converted(torch_module, flax_params):
    """Load the converted flax params into ``torch_module`` (CPU, eval)."""
    torch_module.load_state_dict(convert_params(flax_params, torch_module))
    return torch_module.eval()


def assert_close(got, want, rtol, atol, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=f"{what} max abs err {err}")



def fp64_twin(torch_module):
    """A copy of ``torch_module`` in fp64 on the plain scan (autograd through
    it)."""
    import copy
    from nnuzoo_tpu_torch.models.ss2d import set_scan_backend
    twin = copy.deepcopy(torch_module).double()
    set_scan_backend(twin, "plain")
    return twin


def to_fp64(tree):
    """A tree of arrays as fp64 JAX arrays (inside ``jax.enable_x64(True)``)."""
    import jax.numpy as jnp
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def jax_apply_fp64(module, params, *inputs, **kwargs):
    """``module.apply`` with 64-bit types on and the parameters and inputs in
    fp64: the JAX package's function with its fp32 rounding taken out but
    for its selective scans, which compute in fp32 whatever their inputs.
    A small model with random weights can be ill-conditioned in fp32 (the
    two packages' fp32 outputs then differ by their rounding, not their
    functions); in fp64 on both sides the comparison is tight. Returns
    numpy arrays."""
    import functools
    with jax.enable_x64(True):
        out = jax.jit(functools.partial(module.apply, **kwargs))(
            to_fp64(params), *to_fp64(list(inputs)))
        return jax.tree.map(lambda a: np.asarray(a, np.float64), out)


def assert_model_matches_jax(jmod, tmod, x, **kw):
    """Every output of the port in fp64 against the JAX model in fp64 (its
    scans in fp32) to rtol 1e-3 with atol 1e-4 of its largest magnitude,
    and the port's fp32 output against its own fp64 output to 5e-3 of that
    magnitude. Returns the port's fp32 outputs."""
    params = random_flax_params(jmod, jnp.asarray(x), **kw)
    want = jax_apply_fp64(jmod, params, x, **kw)
    tmod = load_converted(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
        ref = fp64_twin(tmod)(torch.from_numpy(x).double())
    assert len(got) == len(want) == len(ref)
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        scale = float(np.abs(w).max())
        assert_close(r, w, rtol=1e-3, atol=1e-4 * scale, what=f"fp64 output {i}")
        assert_close(g.double(), r, rtol=0, atol=5e-3 * scale,
                     what=f"fp32 output {i} against the port in fp64")
    return got
