"""The port's learning-rate schedules (plain Python functions of the epoch)
against the JAX package's at every epoch of a run and past its end; float64
Python arithmetic against float32 jnp, so rtol 1e-5."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from nnuzoo_tpu.training import schedulers as js  # noqa: E402
from nnuzoo_tpu.training.trainer import cosine_annealing as j_cosine  # noqa: E402
from nnuzoo_tpu_torch.training import schedulers as ts  # noqa: E402

EPOCHS = list(range(0, 34))


def _same(t_sched, j_sched):
    for e in EPOCHS:
        got = t_sched(e)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(j_sched(e)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"epoch {e}")


@pytest.mark.parametrize("name,args", [
    ("poly_lr", (1e-2, 30)),
    ("poly_lr_with_warmup", (1e-2, 30, 5)),
    ("linear_warmup_cosine_annealing", (1e-3, 30, 4, 1e-6, 1e-7)),
    ("linear_warmup_cosine_annealing", (1e-3, 30, 0)),
    ("lin_incr_lr", (1e-2, 30)),
    ("continued_poly_lr_with_warmup", (1e-3, 30, 5, 3)),
    ("finetune_double_warmup_lr", (1e-3, 30, 10, 4, 6)),
])
def test_schedule_matches_jax(name, args):
    _same(getattr(ts, name)(*args), getattr(js, name)(*args))


def test_cosine_annealing_matches_jax():
    _same(ts.cosine_annealing(1e-4, 30, 1e-6), j_cosine(1e-4, 30, 1e-6))


def test_per_step_is_constant_within_an_epoch():
    sched = ts.per_step(ts.cosine_annealing(1e-4, 30, 1e-6), steps_per_epoch=5)
    want = js.per_step(j_cosine(1e-4, 30, 1e-6), 5)
    for step in range(0, 40):
        np.testing.assert_allclose(sched(step), float(want(step)), rtol=1e-5)
    assert sched(5) == sched(9) != sched(10)
