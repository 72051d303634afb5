"""One training step of M2NetP on a translation target: the port's
``Trainer`` against the JAX trainer's loss and the optax chain, on the CPU.

Stage layers (1, 1, 1, 1), patch 64x64, batch 2, one output channel (the
dataset's labels less one), a float target, converted weights, DropPath off
and no augmentation, as ``tests/test_torch_train_step.py`` for the
segmentation target: the deep-supervision MSE of the JAX trainer's
``_compute_loss`` (1e-5 on given outputs), then the step's loss (1e-5), every
gradient (1e-3 of its max plus 1e-5 of the largest entry of the whole
gradient) and AdamW's update after the clip at 12, which acts here (2% of
lr). The target is an intensity mapping with an offset (2x + 10), as an
MR-to-CT target has. Without the offset (2x) the loss's gradient depends on
the model's outputs as much as on the target, and twelve parameters of the
encoder (norm scales, stage-2 to stage-4 kernels) differ between the packages
by up to 1.2x the limit: M2NetP amplifies fp32 rounding (``ROADMAP.md`` §3).
``validation_epoch``
returns the mean loss and minus it, the value whose EMA picks the best
checkpoint.
"""

import functools
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.models.m2net import M2NetP as JaxM2NetP  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.data import augment as ta  # noqa: E402
from nnuzoo_tpu_torch.models import m2net as tm2net  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.models.layers import DropPath  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402

from .test_torch_train_step import BATCH, LAYERS, PATCH  # noqa: E402
from .test_torch_train_step import _plans as _step_plans  # noqa: E402
from .test_torch_translation import TRANSLATION  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """The port's Trainer of M2NetP (1, 1, 1, 1) on a translation dataset
    with the JAX trainer's seeded weights, the JAX trainer, a batch, and
    the JAX step (loss, gradients, new params) on it."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("translation_step")
    mp.setenv("nnUNet_preprocessed", str(root / "pp"))
    mp.setenv("nnUNet_results", str(root / "res"))
    mp.setitem(registry.MODEL_BUILDERS, "nnUNetTrainerM2NetP",
               functools.partial(tm2net.get_m2net_from_plans, small=True,
                                 stage_layers=LAYERS))
    plans, _ = _step_plans()
    t = Trainer(plans, "2d", "all", TRANSLATION, device="cpu", seed=0,
                trainer_name="nnUNetTrainerM2NetP")
    t.initialize()
    jt = JaxTrainer(plans, "2d", "all", TRANSLATION,
                    trainer_name="nnUNetTrainerM2NetP")
    rng = np.random.RandomState(0)
    data = rng.randn(BATCH, 1, *PATCH).astype(np.float32)
    # an intensity mapping with an offset, as an MR-to-CT target has
    target = (2 * data + 10 + 0.5 * rng.randn(BATCH, 1, *PATCH)).astype(np.float32)
    jmodel = JaxM2NetP(num_classes=1, stage_layers=LAYERS)
    params = random_flax_params(jmodel, jnp.asarray(data.transpose(0, 2, 3, 1)),
                                seed=3, train=False)
    t.model.load_state_dict(convert_params(params, t.model))
    for m in t.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    scales = t.train_aug_cfg.deep_supervision_scales
    jcfg = ja.AugmentConfig(patch_size=PATCH, initial_patch_size=PATCH,
                            rotation=0.0, deep_supervision_scales=scales,
                            target_type="translation")
    _, jtargets = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(target))
    cfg = t.config
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                     optax.adamw(learning_rate=cfg.initial_lr,
                                 weight_decay=cfg.weight_decay, eps=cfg.adam_eps,
                                 b1=0.9, b2=0.999))
    x = jnp.moveaxis(jnp.asarray(data), 1, -1)

    @jax.jit
    def jstep(p):
        loss, grads = jax.value_and_grad(
            lambda q: jt._compute_loss(jmodel.apply(q, x, train=True), jtargets))(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates)

    yield t, jt, data, target, params, jtargets, jstep(params)
    mp.undo()


def test_mse_loss_with_deep_supervision_matches_jax(step):
    t, jt, _, _, _, jtargets, _ = step
    rng = np.random.RandomState(2)
    outputs = [rng.randn(BATCH, *tg.shape[2:], 1).astype(np.float32)
               for tg in jtargets]
    want = jt._compute_loss([jnp.asarray(o) for o in outputs], jtargets)
    got = t._compute_loss([torch.from_numpy(o) for o in outputs],
                          [torch.from_numpy(np.asarray(tg)) for tg in jtargets])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the deepest output's weight is 0, the full-resolution ones' are not
    assert len(outputs) == 7


def test_translation_step_matches_the_optax_step(step):
    t, _, data, target, params, _, (jloss, jgrads, jnew) = step
    assert t.label_manager.num_segmentation_heads == 1
    d, targets = ta.prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                      torch.from_numpy(target))
    before = params_from_state_dict({k: v.clone()
                                     for k, v in t.model.state_dict().items()})
    loss = t.loss_and_grads(d, targets)
    # a copy: the clip at 12 scales the gradients in place
    grads = flatten_params(params_from_state_dict(
        {n: p.grad.clone() for n, p in t.model.named_parameters()}))
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
            atol=1e-3 * float(np.abs(w).max()) + 1e-5 * gmax, err_msg=k)
    assert norm > 12.0          # the clip acts on this step
    cfg = t.config
    scale = min(1.0, cfg.grad_clip_norm / norm)
    old = flatten_params(before)
    for k, w in flatten_params(jnew["params"]).items():
        upd_t, upd_j = new[k] - old[k], w - old[k]
        solid = np.abs(jflat[k]) * scale > 1e-3
        np.testing.assert_allclose(upd_t[solid], upd_j[solid], rtol=0,
                                   atol=0.02 * cfg.initial_lr, err_msg=k)
        np.testing.assert_allclose(upd_t, upd_j, rtol=0,
                                   atol=2.05 * cfg.initial_lr, err_msg=k)


def test_validation_epoch_returns_minus_the_mean_loss(step):
    """Two validation batches: the val step gives zeros for the Dice
    statistics and ``validation_epoch`` returns the mean loss and, as the
    value whose EMA picks the best checkpoint, minus it; the first batch's
    loss is the JAX trainer's (its val step is its training loss without
    dropout)."""
    t, _, data, target, params, _, (jloss, _, _) = step
    t.model.load_state_dict(convert_params(params, t.model))
    batches = iter([{"data": torch.from_numpy(data), "target": torch.from_numpy(target)},
                    {"data": torch.from_numpy(-data),
                     "target": torch.from_numpy(target)}])
    t.dataloader_val = batches
    t.config = replace(t.config, num_val_iterations_per_epoch=2)
    _, tp, fp, fn = t.val_step(torch.from_numpy(data), torch.from_numpy(target))
    assert tp.tolist() == fp.tolist() == fn.tolist() == [0.0]
    loss, value = t.validation_epoch()
    first = t.val_step(torch.from_numpy(data), torch.from_numpy(target))[0]
    second = t.val_step(torch.from_numpy(-data), torch.from_numpy(target))[0]
    assert loss == pytest.approx(float(first + second) / 2, rel=1e-6)
    assert value.tolist() == [-loss]
    np.testing.assert_allclose(float(first), float(jloss), rtol=1e-5)
