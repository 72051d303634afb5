"""The LM2Net family at full width (256x224, 1 channel, 3 classes) on the
meta device against the JAX package's ``jax.eval_shape`` of the same
model: the parameter counts are equal, and the selective-scan calls of one
forward, (L, K*Dh, K) and how many, are equal to the JAX model's calls of
its ``selective_scan`` and to ``chip_smoke.py``'s tables, which K1/K2 are
held to on the card: LM2Net and LM2NetP scan with every MambaLayer,
LightMamba2Net(P) with none on the SSD route and with every Mamba2Block on
the mamba1 route (``NNUZOO_SCAN_BACKEND=mamba1``), K=1 over d_inner = 2C
channels at N=16.
"""

import collections

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from nnuzoo_tpu.models import lm2net as jl  # noqa: E402
from nnuzoo_tpu.models import mamba as jmamba  # noqa: E402
from nnuzoo_tpu_torch.models import lm2net as tl  # noqa: E402
from nnuzoo_tpu_torch.ops import selective_scan as tscan  # noqa: E402

PATCH = (256, 224)
# trainer name -> (small, use_mamba2)
FAMILY = {chip_smoke.LM2NET: (False, False), chip_smoke.LM2NET_P: (True, False),
          chip_smoke.LIGHT_M2: (False, True), chip_smoke.LIGHT_M2_P: (True, True)}


def _torch_table(monkeypatch, model):
    shapes = []
    monkeypatch.setattr(tscan, "scan_core_grad", lambda u, d, A_t, bc: (
        shapes.append((u.shape[1], u.shape[2], bc.shape[2] // (2 * A_t.shape[0])))
        or torch.empty_like(u)))
    with torch.no_grad():
        model(torch.empty(1, *PATCH, 1, device="meta"))
    return collections.Counter(shapes)


def _jax_params_and_table(monkeypatch, module):
    """The JAX model's parameter count and the (L, dim, 1) of each
    ``selective_scan`` call of its forward, from one abstract trace (the
    scans stand in by zeros)."""
    calls = []

    def record(u, delta, A, B, C, *args, **kwargs):
        assert B.ndim == 3 and A.shape[1] == 16    # plain B/C: K=1, N=16
        calls.append((u.shape[2], u.shape[1], 1))
        return jnp.zeros_like(u)

    monkeypatch.setattr(jmamba, "selective_scan", record)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *PATCH, 1)))
    n = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    return n, collections.Counter(calls)


@pytest.mark.parametrize("name", list(FAMILY))
def test_full_width_counts_and_scan_tables_match_jax(name, monkeypatch):
    small, m2 = FAMILY[name]
    side = 3 if (small and m2) else 1
    for route in ("ssd", "mamba1") if m2 else ("ssd",):
        if route == "mamba1":
            monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "mamba1")
        else:
            monkeypatch.delenv("NNUZOO_SCAN_BACKEND", raising=False)
        with torch.device("meta"):
            model = tl.LM2NetBase(1, 3, PATCH, small=small, use_mamba2=m2,
                                  side_kernel=side)
        got = _torch_table(monkeypatch, model)
        table = (chip_smoke.LM2NET_MAMBA1_SCANS_2D if route == "mamba1"
                 else chip_smoke.LM2NET_SCANS_2D)[name]
        assert got == table, route
        if route == "ssd" and m2:
            assert not got
            continue
        n, want = _jax_params_and_table(monkeypatch, jl.LM2NetBase(
            3, 2, small=small, use_mamba2=m2, patch_size=PATCH, side_kernel=side))
        assert got == want, route
        assert sum(p.numel() for p in model.parameters()) == n
