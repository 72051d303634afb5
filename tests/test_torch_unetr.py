"""The port's UNETR against the JAX package's (``nnuzoo_tpu/models/unetr.py``).

Seeded numpy inputs and converted parameters, fp32 on the CPU on both
sides. UnetrPrUpBlock to rtol 1e-4 with atol 1e-4 of the output's largest
magnitude; the whole model, small (hidden size 32, MLP 64, 2 heads, 4
layers tapped at 1, 2 and 3, feature size 4, patch 16), at 2d (32x48) and 3d
(16x32x32) to rtol 1e-3 with atol 5e-4 of its largest magnitude. The
converter carries the parameters both ways exactly, ``pos_embed`` included.
At full width (ViT-B, patch 16, feature size 16) the parameter count equals
the JAX model's at 256x224 and at 48x192x192.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import unetr as ju  # noqa: E402
from nnuzoo_tpu_torch.convert import flatten_params, params_from_state_dict  # noqa: E402
from nnuzoo_tpu_torch.models import unetr as tu  # noqa: E402
from nnuzoo_tpu_torch.models.registry import get_model_builder  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402

from .torch_port_helpers import load_converted, random_flax_params  # noqa: E402

NC = 3
SMALL = dict(feature_size=4, hidden_size=32, mlp_dim=64, num_heads=2, num_layers=4)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def compare_model(jmod, tmod, x, rtol=1e-3, atol=5e-4, **kw):
    """The port's outputs against the JAX model's, fp32 on both sides;
    returns the JAX params."""
    params = random_flax_params(jmod, jnp.asarray(x), seed=1, **kw)
    want = jax.jit(lambda p, y: jmod.apply(p, y, **kw))(params, jnp.asarray(x))
    tmod = load_converted(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=atol * float(np.abs(w).max()))
    return params


def assert_round_trip(tmod, params):
    """params -> state_dict -> params is the identity."""
    back = flatten_params(params_from_state_dict(tmod.state_dict(), tmod))
    want = flatten_params(params["params"])
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


def param_counts(jmod, tmod_factory, shape, **kw):
    """(JAX count through ``eval_shape``, the port's on the meta device)."""
    tree = jax.eval_shape(lambda k, x: jmod.init(k, x, **kw), jax.random.PRNGKey(0),
                          jnp.zeros(shape))
    with torch.device("meta"):
        tmod = tmod_factory()
    return (sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree)),
            sum(p.numel() for p in tmod.parameters()))


@pytest.mark.parametrize("dim,shape,ups", [(2, (2, 3, 4, 16), 3),
                                           (3, (1, 2, 3, 2, 16), 2)])
def test_pr_up_block(dim, shape, ups):
    compare_model(ju.UnetrPrUpBlock(8, ups, dim), tu.UnetrPrUpBlock(16, 8, ups, dim),
                  _x(1, *shape), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dim,shape", [(2, (2, 32, 48, 1)), (3, (1, 16, 32, 32, 1))])
def test_unetr_matches_jax_and_converts_both_ways(dim, shape):
    tmod = tu.UNETR(1, NC, shape[1:-1], **SMALL)
    assert tmod.taps == [1, 2, 3]
    params = compare_model(ju.UNETR(NC, dim, **SMALL), tmod, _x(2, *shape),
                           train=False)
    assert params["params"]["pos_embed"].shape == (
        1, int(np.prod(shape[1:-1])) // 16 ** dim, 32)
    assert_round_trip(tmod, params)


@pytest.mark.parametrize("dim,shape,count", [(2, (1, 256, 224, 1), 87_431_491),
                                             (3, (1, 48, 192, 192, 1), 93_366_883)])
def test_full_width_parameter_count_equals_jax(dim, shape, count):
    assert param_counts(ju.UNETR(NC, dim), lambda: tu.UNETR(1, NC, shape[1:-1]),
                        shape, train=False) == (count, count)


def test_builder_follows_the_plan():
    dj = {"labels": {"background": 0, "a": 1, "b": 2}}
    pm = PlansManager({"configurations": {
        "2d": {"patch_size": [32, 48]},
        "3d_fullres": {"patch_size": [16, 32, 32]}}})
    build = get_model_builder("nnUNetTrainerUNETR")
    for name, shape in (("2d", (1, 32, 48, 1)), ("3d_fullres", (1, 16, 32, 32, 1))):
        m = build(pm, dj, pm.get_configuration(name), 1, device="cpu", **SMALL)
        with torch.no_grad():
            assert m(torch.zeros(shape))[0].shape == shape[:-1] + (NC,)
        # pos_embed drawn as flax's truncated_normal(0.02)
        assert 0 < float(m.pos_embed.detach().abs().max()) <= 0.04
    assert get_model_builder("nnUNetTrainerUNETR_75Percent") is build
