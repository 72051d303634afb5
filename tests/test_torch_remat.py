"""``remat`` keeps the scans' outputs: a rematted stage runs again in the
backward pass without running its scan forwards again, as the JAX package's
remat policy saves ``scan_y`` and ``scan_carries``
(``nnuzoo_tpu/models/m2net.py:_stage_blocks``,
``tests/test_m2net.py::test_remat_policy_grad_parity``).

On the CPU the scan forward is the plain scan, so a training step with
``remat`` on must call ``scan_core_plain`` exactly as often as with it off
(80 times a forward with the default glue), and give the gradients of
``remat`` off to rtol 1e-5 / atol 1e-6 (the JAX test's limits; the port
gives them bit for bit), DropPath live: the second run draws the masks of
the first and leaves the generator where the forward pass left it. M2Net at
full width and depth (every stage rematted) on 32x32 maps, with either
glue, and M2NetP with its deep stages rematted too.
"""

import numpy as np
import pytest
import torch

from nnuzoo_tpu_torch.models import m2net as tm2net
from nnuzoo_tpu_torch.models.layers import (DropPath, init_parameters,
                                            set_drop_path_generator)
from nnuzoo_tpu_torch.models.ss2d import SS2D, set_ss2d_glue
from nnuzoo_tpu_torch.ops import selective_scan as tscan

MODELS = {
    "M2Net": lambda remat: tm2net.M2Net(1, 3, remat=remat),
    "M2NetP": lambda remat: tm2net.M2NetP(1, 3, remat=remat,
                                          remat_deep_stages=True,
                                          stage_layers=(2, 2, 1, 1)),
}


@pytest.mark.parametrize("name,glue", [("M2Net", "default"), ("M2Net", "fused"),
                                       ("M2NetP", "default")])
def test_remat_keeps_the_scans_and_the_gradients(name, glue, monkeypatch):
    calls = []
    plain = tscan.scan_core_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tscan, "scan_core_plain", counted)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 32, 32, 1)
                         .astype(np.float32))
    grads, states, counts = {}, {}, {}
    for remat in (False, True):
        model = MODELS[name](remat)
        init_parameters(model, torch.Generator().manual_seed(5))
        set_ss2d_glue(model, glue)
        gen = torch.Generator().manual_seed(6)
        set_drop_path_generator(model, gen)
        for m in model.modules():
            if isinstance(m, DropPath) and m.rate > 0:
                m.rate = 0.5                   # so that masks do drop samples
        model.train()
        calls.clear()
        loss = sum((o ** 2).mean() for o in model(x))
        loss.backward()
        counts[remat] = len(calls)
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
        states[remat] = gen.get_state()
    ss2ds = sum(isinstance(m, SS2D) for m in model.modules())
    # the default glue scans once an SS2D; the fused glue's plain version
    # scans twice an SS2D forwards and twice again in its plain backward
    assert counts[False] == (ss2ds if glue == "default" else 4 * ss2ds)
    assert counts[True] == counts[False]
    assert torch.equal(states[False], states[True])
    assert sorted(grads[False]) == sorted(grads[True])
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, rtol=1e-5, atol=1e-6,
                                   msg=n)
