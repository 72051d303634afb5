"""The port's ``Trainer`` of the LM2Net family against the JAX package's:
``nnUNetTrainerLM2Net``, ``nnUNetTrainerLM2NetP``,
``nnUNetTrainerLightMamba2Net`` and ``nnUNetTrainerLightMamba2NetP``
(AdamW lr 1e-4, weight decay 5e-2, eps 1e-5, cosine; ``ds_mode="x2net"``
with seven outputs whose scales the probe reads off the model).

Every mini is cut to one level on both sides (the stage tables and the
outer network stay; the minis at depth are in ``test_torch_lm2net.py``),
patch 32x32, batch 2, no augmentation, converted weights, fp32 on both
sides (these widths' depthwise convolutions have no fast fp64 path on the
CPU in either package; the JAX scans run their per-step reference,
``NNUZOO_SCAN_BACKEND=ref``). For each name, the step around the model: the
loss of the JAX model's seven outputs and the clip and AdamW update from
one seeded gradient against the JAX trainer's optax chain, in
``test_torch_lm2net_update.py``. For LM2NetP the whole step from the model on, by ``PERF.md``'s
one-step limits: the loss to 1e-5; each gradient to 1e-3 of its own
largest entry plus 1e-5 of the largest entry of all, plus twice the port's
own fp32 spread (how far its gradient moves when only the plain scan's
chunk, so its rounding order, changes:
``test_torch_jax_checkpoint._rounding_spread``; the JAX gradient is a
second fp32 rounding of the same function); AdamW's update to 2% of lr,
but for entries whose gradient is so small that eps decides it (within
2.05 lr). The other three names' gradients are not held whole: LM2Net's
sit up to 1.5x outside those limits in fp32 at a few entries, and
LightMamba2Net(P) with random weights amplify rounding some 10^4 times
across their minis (``PERF.md``); their blocks' gradients are held in
``test_torch_ssd.py``. Also: the deep-supervision scales against the JAX
trainer's probe at 256x224 (the last one anisotropic, (1/32, 1/16), for the
Mamba2 minis' merge), and the registry's names with their data fractions.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.models import lm2net as jl  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.data.augment import prepare_val_batch  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.models.ss2d import set_scan_backend  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402

from .test_torch_jax_checkpoint import _rounding_spread  # noqa: E402
from .test_torch_lm2net_models import one_level_minis  # noqa: E402
from .test_torch_mamba_trainer import DATASET, PATCH, _batch  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402

# trainer name -> (small, use_mamba2)
FAMILY = {"nnUNetTrainerLM2Net": (False, False),
          "nnUNetTrainerLM2NetP": (True, False),
          "nnUNetTrainerLightMamba2Net": (False, True),
          "nnUNetTrainerLightMamba2NetP": (True, True)}


def _plans(patch=PATCH):
    from .test_torch_mamba_trainer import _plans as plans
    p = plans()
    p["configurations"]["2d"]["patch_size"] = list(patch)
    return p


@pytest.fixture(autouse=True)
def _folders(tmp_path, monkeypatch):
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pp"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))


def _jax_model(name, patch=PATCH):
    small, m2 = FAMILY[name]
    return jl.LM2NetBase(3, 2, small=small, use_mamba2=m2, patch_size=patch,
                         side_kernel=3 if (small and m2) else 1)


def _jax_step(jt, params, scales):
    """The JAX trainer's loss and optax chain, one step from ``params`` on
    ``_batch()``: (loss, grads, new params) as numpy trees."""
    data, seg = _batch()
    jcfg = ja.AugmentConfig(patch_size=PATCH, initial_patch_size=PATCH,
                            rotation=0.0, deep_supervision_scales=scales)
    _, targets = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(seg))
    x = jnp.moveaxis(jnp.asarray(data), 1, -1)
    tx = jt._build_optimizer()

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(
            lambda q: jt._compute_loss(jt.model.apply(q, x), targets))(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates)

    return jax.tree.map(np.asarray, step(params))


def test_step_matches_the_optax_step(monkeypatch, name="nnUNetTrainerLM2NetP"):
    one_level_minis(monkeypatch)
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "ref")
    t = Trainer(_plans(), "2d", "all", DATASET, device="cpu", seed=0,
                trainer_name=name)
    t.initialize()
    jt = JaxTrainer(_plans(), "2d", "all", DATASET, trainer_name=name)
    jt.model = _jax_model(name)
    cfg = t.config
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jt.config)
    assert (cfg.optimizer, cfg.ds_mode, cfg.num_ds_outputs) == ("adamw", "x2net", 7)
    assert isinstance(t.optimizer, torch.optim.AdamW)
    scales = t.train_aug_cfg.deep_supervision_scales
    assert scales == jt._get_deep_supervision_scales()
    assert len(scales) == 7 and scales[0] == scales[1] == (1.0, 1.0)

    params = random_flax_params(jt.model, jnp.zeros((1, *PATCH, 1)), seed=3,
                                train=False)
    t.model.load_state_dict(convert_params(params, t.model))
    jloss, jgrads, jnew = _jax_step(jt, params, scales)

    set_scan_backend(t.model, "plain")
    data, seg = _batch()
    d, targets = prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                   torch.from_numpy(seg))
    spread = _rounding_spread(t, d, targets)
    loss = t.loss_and_grads(d, targets)
    # a deep-supervision head of loss weight 0 gets no gradient; copies, as
    # the clip scales the gradients in place
    grads = flatten_params(params_from_state_dict(
        {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
         for n, p in t.model.named_parameters()}))
    t.apply_gradients()
    new = flatten_params(params_from_state_dict(t.model.state_dict()))

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = flatten_params(jgrads["params"])
    assert sorted(jflat) == sorted(grads)
    gmax = max(float(np.abs(v).max()) for v in jflat.values())
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in jflat.values()))
    for k, w in jflat.items():
        np.testing.assert_allclose(
            grads[k], w, rtol=0,
            atol=1e-3 * float(np.abs(w).max()) + 1e-5 * gmax + 2 * spread[k],
            err_msg=k)
    old = flatten_params(params["params"])
    lr = t._step_schedule(0)
    scale = min(1.0, cfg.grad_clip_norm / norm)
    for k, w in flatten_params(jnew["params"]).items():
        upd_t, upd_j = new[k] - old[k], w - old[k]
        solid = np.abs(jflat[k]) * scale > 1e-3
        np.testing.assert_allclose(upd_t[solid], upd_j[solid], rtol=0,
                                   atol=0.02 * lr, err_msg=k)
        np.testing.assert_allclose(upd_t, upd_j, rtol=0, atol=2.05 * lr,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["nnUNetTrainerLM2NetP",
                                  "nnUNetTrainerLightMamba2Net"])
def test_ds_scales_at_the_chip_plan_match_the_jax_probe(name, monkeypatch):
    """The port's model at full depth on the meta device, its output
    scales against the JAX trainer's probe (``eval_shape``) at 256x224; the
    JAX model's minis stand in by a shape-keeping Dense (a mini keeps its
    map's shape), which spares a minute of tracing."""
    from nnuzoo_tpu_torch.plans.plans_handler import PlansManager
    plans = _plans((256, 224))
    pm = PlansManager(plans)
    model = registry.get_model_builder(name)(pm, DATASET, pm.get_configuration("2d"),
                                             1, device="meta")
    with torch.no_grad():
        outs = model(torch.empty(1, 256, 224, 1, device="meta"))
    got = tuple(tuple(o.shape[1 + i] / (256, 224)[i] for i in range(2))
                for o in outs)
    jt = JaxTrainer(plans, "2d", "all", DATASET, trainer_name=name)
    jt.model = _jax_model(name, (256, 224))
    monkeypatch.setattr(jl, "MiniLightMUNet", functools.partial(
        _ShapeOnlyMini, jl.MiniLightMUNet))
    assert got == jt._get_deep_supervision_scales()
    want_last = (1 / 32, 1 / 16) if FAMILY[name][1] else (1 / 32, 1 / 32)
    assert got[-1] == want_last


class _ShapeOnlyMini:
    """A mini's output shape without its work: the JAX probe traces the
    whole model, which at full depth costs a minute of tracing."""

    def __new__(cls, mini, mid, out, n, dim, ips, **kwargs):
        import flax.linen as fnn

        class Head(fnn.Module):
            @fnn.compact
            def __call__(self, x, train=True):
                return fnn.Dense(out, name="conv_final")(x)
        return Head(name=kwargs.get("name"))


def test_registry_names_and_data_fractions():
    for name in FAMILY:
        build = registry.get_model_builder(name)
        for suffix in ("_05Percent", "_75Percent"):
            assert registry.get_model_builder(name + suffix) is build
        t = Trainer(_plans(), "2d", "all", DATASET, device="cpu", seed=0,
                    trainer_name=name + "_10Percent")
        assert t.config.data_fraction == 0.10
