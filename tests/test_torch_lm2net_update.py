"""Each LM2Net-family trainer's step around its model against the JAX
package's (``nnUNetTrainerLM2Net``, ``nnUNetTrainerLM2NetP``,
``nnUNetTrainerLightMamba2Net``, ``nnUNetTrainerLightMamba2NetP``): the
port's loss of the JAX model's seven outputs (deep-supervision weights and
targets at the probed scales) against the JAX trainer's, to 1e-5; and, from
the same seeded gradient, the port's clip and AdamW update against the JAX
trainer's optax chain, to 2% of lr in every entry. Every mini at one level
on both sides, patch 32x32, batch 2, fp32 (``test_torch_lm2net_trainer.py``
says why, and holds LM2NetP's whole step).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.convert import convert_params  # noqa: E402
from nnuzoo_tpu_torch.data.augment import prepare_val_batch  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402

from .test_torch_lm2net_models import one_level_minis  # noqa: E402
from .test_torch_lm2net_trainer import FAMILY, _jax_model, _plans  # noqa: E402
from .test_torch_mamba_trainer import DATASET, PATCH, _batch  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402


@pytest.fixture(autouse=True)
def _folders(tmp_path, monkeypatch):
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pp"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))


@pytest.mark.parametrize("name", list(FAMILY))
def test_loss_and_update_match_optax(name, monkeypatch):
    one_level_minis(monkeypatch)
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "ref")
    t = Trainer(_plans(), "2d", "all", DATASET, device="cpu", seed=0,
                trainer_name=name)
    t.initialize()
    jt = JaxTrainer(_plans(), "2d", "all", DATASET, trainer_name=name)
    jt.model = _jax_model(name)
    scales = t.train_aug_cfg.deep_supervision_scales
    assert scales == jt._get_deep_supervision_scales()
    params = random_flax_params(jt.model, jnp.zeros((1, *PATCH, 1)), seed=3,
                                train=False)
    t.model.load_state_dict(convert_params(params, t.model))

    data, seg = _batch()
    jcfg = ja.AugmentConfig(patch_size=PATCH, initial_patch_size=PATCH,
                            rotation=0.0, deep_supervision_scales=scales)
    _, jtargets = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(seg))
    outs = jax.jit(jt.model.apply)(params, jnp.moveaxis(jnp.asarray(data), 1, -1))
    jloss = jt._compute_loss(outs, jtargets)
    _, targets = prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                   torch.from_numpy(seg))
    loss = t._compute_loss([torch.from_numpy(np.array(o)) for o in outs], targets)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    rng = np.random.RandomState(4)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.randn(*p.shape).astype(np.float32)), params)
    tx = jt._build_optimizer()
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    want = convert_params(jax.tree.map(np.asarray, updates), t.model)
    tgrads = convert_params(jax.tree.map(np.asarray, grads), t.model)
    before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    for n, p in t.model.named_parameters():
        p.grad = tgrads[n].clone()
    t.apply_gradients()
    lr = t._step_schedule(0)
    for n, p in t.model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[n]).numpy(),
                                   want[n].numpy(), rtol=0, atol=0.02 * lr,
                                   err_msg=n)
