"""The port's ``MixerLayer`` against the JAX package's, for each of the seven
token mixers, at depth 2 with a per-block drop-path tuple.

Seeded numpy input, converted parameters (which convert back to the flax
tree exactly), fp32 on both sides, eval mode: the output agrees to rtol
1e-4 with atol 1e-4 of its largest magnitude (1e-3 for the Mamba mixers,
whose random-weight scans amplify the two packages' rounding), as the
blocks of ``test_torch_blocks.py`` do. Each block's stochastic-depth rate
is the JAX block's: the JAX model's DropPath calls are recorded with their
module paths and rates, and the port's DropPath modules carry the same rate
under the same path. ``NNUZOO_SCAN_BACKEND=ref`` puts the JAX Mamba blocks
on their per-step reference scan and leaves the port's Mamba2Block on the
SSD (its default route).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import layers as jlayers  # noqa: E402
from nnuzoo_tpu.models import mixers as jmixers  # noqa: E402
from nnuzoo_tpu_torch.convert import flatten_params, params_from_state_dict  # noqa: E402
from nnuzoo_tpu_torch.models import mixers as tmixers  # noqa: E402
from nnuzoo_tpu_torch.models.layers import DropPath, init_parameters  # noqa: E402

from .torch_port_helpers import (load_converted, one_torch_thread,  # noqa: E402
                                 random_flax_params)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# mixer -> (input shape, spatial dims, tolerance)
CASES = {
    "ss2d": ((2, 6, 5, 16), 2, 1e-4),
    "ssnd": ((1, 4, 5, 6, 16), 3, 1e-4),
    "swin": ((2, 9, 8, 32), 2, 1e-4),
    "vit": ((2, 5, 6, 32), 2, 1e-4),
    "mamba_alt": ((2, 5, 6, 16), 2, 1e-3),
    "mamba2": ((2, 5, 6, 16), 2, 1e-3),
    "mamba_nd": ((1, 3, 4, 5, 16), 3, 1e-3),
}
RATES = (0.05, 0.15)


def _jax_apply(jmod, params, x):
    """The JAX layer's output, and {module path: rate} of each DropPath
    that it calls."""
    rates = {}

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, jlayers.DropPath):
            rates[".".join(context.module.scope.path)] = context.module.rate
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        out = jmod.apply(params, x, train=False)
    return np.asarray(out), rates


@pytest.mark.parametrize("mixer", list(CASES))
def test_mixer_layer_matches_jax(mixer, monkeypatch):
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "ref")
    shape, dims, tol = CASES[mixer]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    C = shape[-1]
    jmod = jmixers.MixerLayer(C, 2, mixer, spatial_dims=dims, drop_path=RATES)
    params = random_flax_params(jmod, jnp.asarray(x), train=False)
    want, jrates = _jax_apply(jmod, params, jnp.asarray(x))
    tmod = load_converted(tmixers.MixerLayer(
        C, 2, mixer, spatial_dims=dims, drop_path=RATES,
        spatial=shape[1:-1] if mixer == "swin" else None), params)
    back = flatten_params(params_from_state_dict(tmod.state_dict(), tmod))
    flat = flatten_params(params["params"])
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))

    trates = {n: m.rate for n, m in tmod.named_modules() if isinstance(m, DropPath)}
    assert jrates == trates
    assert sorted(set(trates.values())) == sorted(RATES)


def test_one_rate_for_every_block_and_train_mode_drops():
    """A float rate goes to every block; in training mode a block's
    DropPath drops whole samples of its branch from its generator."""
    layer = tmixers.MixerLayer(16, 3, "ssnd", spatial_dims=2, drop_path=0.5)
    assert [layer.get_submodule(f"drop_path{i}").rate for i in range(3)] == [0.5] * 3
    gen = torch.Generator().manual_seed(0)
    for m in layer.modules():
        if isinstance(m, DropPath):
            m.generator = gen
    x = torch.randn(4, 5, 6, 16)
    branch = torch.ones(4, 5, 6, 16)
    out = layer.drop_path0.train()(branch)
    kept = out.flatten(1).amax(1)
    assert set(kept.tolist()) <= {0.0, 2.0} and len(set(kept.tolist())) == 2
    # eval mode: every branch kept, whatever the generator
    init_parameters(layer, torch.Generator().manual_seed(1))
    layer.eval()
    with torch.no_grad():
        first = layer(x)
        for m in layer.modules():
            if isinstance(m, DropPath):
                m.rate = 0.0
        assert torch.isfinite(first).all() and torch.equal(layer(x), first)


def test_unknown_mixer_and_swin_without_a_size_raise():
    with pytest.raises(ValueError, match="unknown token mixer"):
        tmixers.MixerLayer(16, 1, "conv")
    with pytest.raises(ValueError, match="swin"):
        tmixers.MixerLayer(32, 1, "swin")
