"""U²-Net of the port (RSU, U2Net, U2NetP) against the JAX package's, with
converted parameters.

Seeded numpy inputs and parameters (``torch_port_helpers``), fp32 on the CPU
on both sides. An RSU block agrees to rtol 1e-4 with atol 1e-4 times the
output's largest magnitude; a whole U2Net, some forty convs and norms deep,
to rtol 1e-3 with atol 5e-4 times it. The RSUs pool five times, so the
smallest map a U2Net takes is 32 voxels an axis: the 3d case is U2NetP at
32x32x32, the 2d cases U2NetP and U2Net at 32x48.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import u2net as ju2net  # noqa: E402
from nnuzoo_tpu_torch.models import u2net as tu2net  # noqa: E402
from nnuzoo_tpu_torch.models.registry import get_model_builder  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402

from .torch_port_helpers import load_converted, random_flax_params  # noqa: E402


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _check(jmod, tmod, x, rtol, atol_rel, seed=0):
    params = random_flax_params(jmod, jnp.asarray(x), seed=seed)
    # one compile costs a third of the op-by-op run of a whole U2Net
    want = jax.jit(jmod.apply)(params, jnp.asarray(x))
    tmod = load_converted(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    if not isinstance(want, (list, tuple)):
        got, want = [got], [want]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=atol_rel * float(np.abs(w).max()),
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("levels,shape", [(4, (2, 12, 10, 3)), (5, (2, 17, 16, 3)),
                                          (4, (1, 8, 9, 6, 3))],
                         ids=["rsu4_2d", "rsu5_2d_odd", "rsu4_3d"])
def test_rsu(levels, shape):
    """Odd sizes floor in the pools and come back through the linear
    upsampling to the encoder's size."""
    dim = len(shape) - 2
    _check(ju2net.RSU(levels, 4, 6, dim), tu2net.RSU(3, levels, 4, 6, dim),
           _x(levels, *shape), 1e-4, 1e-4)


def test_rsu4f_3d():
    _check(ju2net.RSU4F(4, 6, 3), tu2net.RSU4F(3, 4, 6, 3), _x(9, 1, 6, 7, 5, 3),
           1e-4, 1e-4)


@pytest.mark.parametrize("small", [True, False], ids=["U2NetP", "U2Net"])
def test_u2net_2d(small):
    _check(ju2net.U2Net(3, small=small), tu2net.U2Net(1, 3, small=small),
           _x(1, 1, 32, 48, 1), 1e-3, 5e-4, seed=2)


def test_u2netp_3d():
    _check(ju2net.U2Net(2, small=True, dim=3), tu2net.U2Net(1, 2, small=True, dim=3),
           _x(2, 1, 32, 32, 32, 1), 1e-3, 5e-4, seed=3)


def test_u2net_without_deep_supervision_returns_d0():
    _check(ju2net.U2Net(3, small=True, deep_supervision=False),
           tu2net.U2Net(1, 3, small=True, deep_supervision=False),
           _x(4, 2, 32, 32, 1), 1e-3, 5e-4, seed=5)


@pytest.mark.parametrize("name,small", [("nnUNetTrainerU2Net", False),
                                        ("nnUNetTrainerU2NetP", True),
                                        ("nnUNetTrainerU2NetP_50Percent", True)])
@pytest.mark.parametrize("patch", [[32, 32], [32, 32, 32]])
def test_builders_take_the_dimension_from_the_patch(name, small, patch):
    pm = PlansManager({"configurations": {"c": {"patch_size": patch}}})
    dj = {"labels": {"background": 0, "a": 1, "b": 2}}
    a = get_model_builder(name)(pm, dj, pm.get_configuration("c"), 2,
                                device="cpu", seed=1)
    b = get_model_builder(name)(pm, dj, pm.get_configuration("c"), 2,
                                device="cpu", seed=1)
    conv = a.side1
    assert isinstance(a, tu2net.U2Net)
    assert conv.weight.dim() == len(patch) + 2 and conv.out_channels == 3
    assert a.stage1.rebnconvin.conv.in_channels == 2
    assert a.stage5.rebnconvin.conv.out_channels == (64 if small else 512)
    # the same seed draws the same weights
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
