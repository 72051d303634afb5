"""SSND2Net and SSND2NetP against the JAX package's, child by child,
SSND2NetP at 2d (32x32) and SSND2Net at 3d (16x32x32), each model's table
once (the outer network's code is the same for both at either dim), every
mini cut to one level in both packages (the outer network, its stage
tables and the bottleneck minis stay; the minis at depth are in
``test_torch_ssnd2net.py``).

Seeded numpy input, converted parameters (which convert back to the flax
tree exactly), fp32 on both sides, the JAX model applied without
``jax.jit`` but for its selective scans (a jitted SSND2Net takes minutes
of XLA compile; the scans, jitted alone, one compile a shape). Each direct
child of the model (the stages, the patch mergings and expansions, the
concat-back Linears, the side heads, the fused head) is held to the JAX
child on the input the JAX model gave it, rtol 1e-3 with atol 1e-4 of its
largest magnitude (``test_torch_lm2net_models._Replay``); and the port's
own forward, each child replaying the JAX child's output, gives each child
the JAX child's input to 1e-6 of its largest magnitude (the outer
network's merges, pads and concatenations).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import ssnd2net as js  # noqa: E402
from nnuzoo_tpu_torch.models import ssnd2net as ts  # noqa: E402

from .test_torch_lm2net_models import _Replay  # noqa: E402
from .test_torch_ssnd2net import (NC, _assert_round_trip, _x,  # noqa: E402
                                  jitted_jax_scans, one_level_minis)
from .torch_port_helpers import (load_converted, one_torch_thread,  # noqa: E402
                                 random_flax_params)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def jax_children(jmod, params, x):
    """The JAX model applied without jit: its outputs, and each direct
    child's first argument and output, {name: (input, output)}."""
    calls = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        scope = context.module.scope
        if context.method_name == "__call__" and scope is not None \
                and len(scope.path) == 1:
            calls[scope.path[0]] = (args[0], out)
        return out

    with fnn.intercept_methods(record):
        outs = jmod.apply(params, jnp.asarray(x), train=False)
    return jax.tree.map(np.asarray, (outs, calls))


@pytest.mark.parametrize("small,shape", [(True, (1, 32, 32, 1)),
                                         (False, (1, 16, 32, 32, 1))],
                         ids=["P_2d", "full_3d"])
def test_model_child_by_child_matches_jax(small, shape, monkeypatch):
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "")
    one_level_minis(monkeypatch)
    jitted_jax_scans(monkeypatch)
    patch = shape[1:-1]
    x = _x(2, shape)
    jmod = js.SSND2Net(NC, len(patch), small=small, patch_size=patch)
    params = random_flax_params(jmod, jnp.asarray(x), train=False)
    want, calls = jax_children(jmod, params, x)
    tmod = load_converted(ts.SSND2Net(1, NC, patch, small=small), params)
    _assert_round_trip(tmod, params)
    names = [n for n, _ in tmod.named_children()]
    assert sorted(names) == sorted(calls)
    checked = []
    for n in names:
        setattr(tmod, n, _Replay(n, getattr(tmod, n), *calls[n], checked))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert sorted(checked) == sorted(names)
    assert len(got) == 7 and got[0].shape == shape[:-1] + (NC,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
