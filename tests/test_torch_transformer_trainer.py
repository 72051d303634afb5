"""The port's ``Trainer`` of the three Transformer baselines against the JAX
package's: ``nnUNetTrainerUNETR`` (AdamW, weight decay 0.01, poly),
``nnUNetTrainerSwinTransformerUnet`` and ``nnUNetTrainerSwUNETR`` (AdamW,
weight decay 5e-2, cosine), none with deep supervision.

Small models (UNETR at hidden size 32 and 4 layers, SwT at embed 8, SwinUNETR
at feature size 4, each the same on both sides), patch 32x32, batch 2,
converted weights, DropPath off and no augmentation; fp32 on the CPU on
both sides (the JAX attention computes its logits in fp32 whatever its
inputs). The loss to 1e-5; each gradient to 1e-3 of its own largest entry
plus 1e-5 of the largest entry of all; AdamW's update to 2% of lr, but for
entries whose gradient is so small that eps decides it (within 2.05 lr).
Also the registry's names with their data fractions, and a name still
unported raising.
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
from nnuzoo_tpu.models import swt as js  # noqa: E402
from nnuzoo_tpu.models import unetr as ju  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.data.augment import prepare_val_batch  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.models.layers import DropPath  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402

from .test_torch_mamba_trainer import DATASET, PATCH, _batch, _plans  # noqa: E402
from .test_torch_swt import SWIN_UNETR_SMALL, SWT_SMALL  # noqa: E402
from .test_torch_unetr import SMALL as UNETR_SMALL  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402

# trainer name -> (the port builder's kwargs, the JAX model)
CASES = {
    "nnUNetTrainerUNETR": (UNETR_SMALL, lambda: ju.UNETR(3, 2, **UNETR_SMALL)),
    "nnUNetTrainerSwinTransformerUnet": (
        SWT_SMALL, lambda: js.SwinTransformerUnet(3, **SWT_SMALL)),
    "nnUNetTrainerSwUNETR": (SWIN_UNETR_SMALL,
                             lambda: js.SwinUNETR(3, 2, **SWIN_UNETR_SMALL)),
}


@pytest.fixture(autouse=True)
def _folders(tmp_path, monkeypatch):
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pp"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))


def _jax_step(jt, params):
    """The JAX trainer's loss and optax chain, one step from ``params`` on
    ``_batch()``, fp32: (loss, grads, new params) as numpy trees."""
    data, seg = _batch()
    jcfg = ja.AugmentConfig(patch_size=PATCH, initial_patch_size=PATCH,
                            rotation=0.0, deep_supervision_scales=None)
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_the_optax_step(name, monkeypatch):
    kwargs, jax_model = CASES[name]
    monkeypatch.setitem(registry.MODEL_BUILDERS, name, functools.partial(
        registry.get_model_builder(name), **kwargs))
    t = Trainer(_plans(), "2d", "all", DATASET, device="cpu", seed=0,
                trainer_name=name)
    t.initialize()
    jt = JaxTrainer(_plans(), "2d", "all", DATASET, trainer_name=name)
    jt.model = jax_model()
    cfg = t.config
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jt.config)
    assert (cfg.optimizer, cfg.weight_decay, cfg.scheduler) == \
        (("adamw", 0.01, "poly") if name == "nnUNetTrainerUNETR"
         else ("adamw", 5e-2, "cosine"))
    assert isinstance(t.optimizer, torch.optim.AdamW)
    assert t.train_aug_cfg.deep_supervision_scales is None
    assert jt._get_deep_supervision_scales() is None

    params = random_flax_params(jt.model, jnp.zeros((1, *PATCH, 1)), seed=3,
                                train=False)
    t.model.load_state_dict(convert_params(params, t.model))
    for m in t.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    jloss, jgrads, jnew = _jax_step(jt, params)

    data, seg = _batch()
    d, targets = prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                   torch.from_numpy(seg))
    loss = t.loss_and_grads(d, targets)
    grads = flatten_params(params_from_state_dict(
        {n: p.grad for n, p in t.model.named_parameters()}))
    t.apply_gradients()
    new = flatten_params(params_from_state_dict(t.model.state_dict()))

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = flatten_params(jgrads["params"])
    assert sorted(jflat) == sorted(grads)
    gmax = max(float(np.abs(v).max()) for v in jflat.values())
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in jflat.values()))
    for k, w in jflat.items():
        np.testing.assert_allclose(grads[k], w, rtol=0,
                                   atol=1e-3 * float(np.abs(w).max()) + 1e-5 * gmax,
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


def test_registry_names_and_data_fractions():
    for name in CASES:
        build = registry.get_model_builder(name)
        for suffix in ("_05Percent", "_75Percent"):
            assert registry.get_model_builder(name + suffix) is build
        t = Trainer(_plans(), "2d", "all", DATASET, device="cpu", seed=0,
                    trainer_name=name + "_50Percent")
        assert t.config.data_fraction == 0.5
        assert not t.config.enable_deep_supervision
    with pytest.raises(RuntimeError, match="No model registered"):
        registry.get_model_builder("nnUNetTrainerSwT2Net")
