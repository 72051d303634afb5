"""The port's ``Trainer`` of the nnU-Net CNN baselines against the JAX
package's: ``nnUNetTrainer`` (SGD with nesterov momentum 0.99 and weight
decay added after the clip, poly schedule, the ``arch`` deep-supervision
scales) on PlainConvUNet, 2d and 3d.

Small plans (3 stages, widths 4-16, patch 16x12 or 8x16x16, batch 2),
converted weights and no augmentation: the same deep-supervision loss, the
same gradient of every parameter and the same update as the JAX trainer's
optax chain gives. A JAX checkpoint after one SGD step (its ``trace`` is the
momentum) continues in the port as the JAX trainer continues. fp32 on the
CPU on both sides. Tolerances: the loss to 1e-5 (sums over the patch in
other orders); each gradient to 1e-3 of its own largest entry and each
update to 1e-3 of its own; a conv bias in front of a norm has a zero
gradient up to rounding, which differs between the two: such an array
(below 1e-4 of the largest entry of all) must be below that on both sides.
"""

import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.models import dynamic_unet as jdyn  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.data.augment import prepare_val_batch  # noqa: E402
from nnuzoo_tpu_torch.models import dynamic_unet as tdyn  # noqa: E402
from nnuzoo_tpu_torch.models.registry import get_model_builder  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402

from .test_torch_dynamic_unet import ARCH_2D, ARCH_3D  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402

DATASET = {"channel_names": {"0": "MRI"},
           "labels": {"background": 0, "organ": 1, "tumor": 2},
           "file_ending": ".nii.gz"}
CASES = {2: ("2d", (16, 12), ARCH_2D), 3: ("3d_fullres", (8, 16, 16), ARCH_3D)}


def _plans(dim, patch=None, arch=None, arch_class="PlainConvUNet"):
    name, default_patch, default_arch = CASES[dim]
    rs = {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None}
    return {
        "dataset_name": "Dataset996_Cnn", "plans_name": "nnUNetPlans",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {},
        "configurations": {name: {
            "data_identifier": f"nnUNetPlans_{name}", "batch_size": 2,
            "batch_dice": True, "patch_size": list(patch or default_patch),
            "spacing": [1.0] * dim,
            "normalization_schemes": ["ZScoreNormalization"],
            "use_mask_for_norm": [False],
            "resampling_fn_data": "resample_data_or_seg_to_shape",
            "resampling_fn_data_kwargs": rs,
            "resampling_fn_seg": "resample_data_or_seg_to_shape",
            "resampling_fn_seg_kwargs": dict(rs, is_seg=True, order=1),
            "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
            "resampling_fn_probabilities_kwargs": dict(rs, order=1),
            "architecture": {"network_class_name": arch_class,
                             "arch_kwargs": arch or default_arch}}},
    }


@pytest.fixture(autouse=True)
def _folders(tmp_path, monkeypatch):
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pp"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))


def _batch(dim, seed=0):
    patch = CASES[dim][1]
    rng = np.random.RandomState(seed)
    data = rng.randn(2, 1, *patch).astype(np.float32)
    seg = rng.randint(0, 3, (2, 1, *patch)).astype(np.int16)
    seg[(slice(None), slice(None)) + (slice(0, 6),) * dim] = 1   # some structure
    return data, seg


def _port_trainer(dim, trainer_name="nnUNetTrainer"):
    t = Trainer(_plans(dim), CASES[dim][0], "all", DATASET, device="cpu", seed=0,
                trainer_name=trainer_name)
    t.initialize()
    return t


def _jax_setup(dim):
    """The JAX trainer of the same plans with seeded PlainConvUNet params,
    its optax chain's initial state, and its step on ``_batch(dim)`` (no
    augmentation) as a function of the state."""
    name, patch, arch = CASES[dim]
    jt = JaxTrainer(_plans(dim), name, "all", DATASET)
    jt.jmodel = jdyn.PlainConvUNet(arch, 3)
    params = random_flax_params(jt.jmodel, jnp.zeros((1, *patch, 1)), seed=3)
    jt.tx = jt._build_optimizer()
    jt.state = {"params": params, "opt_state": jt.tx.init(params),
                "step": jnp.zeros((), jnp.int32)}
    scales = jt._get_deep_supervision_scales()
    data, seg = _batch(dim)
    jcfg = ja.AugmentConfig(patch_size=patch, initial_patch_size=patch,
                            rotation=0.0, deep_supervision_scales=scales)
    _, targets = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(seg))
    x = jnp.moveaxis(jnp.asarray(data), 1, -1)

    @jax.jit
    def step(state):
        loss, grads = jax.value_and_grad(
            lambda p: jt._compute_loss(jt.jmodel.apply(p, x), targets))(
            state["params"])
        updates, opt_state = jt.tx.update(grads, state["opt_state"],
                                          state["params"])
        return loss, grads, {"params": optax.apply_updates(state["params"], updates),
                             "opt_state": opt_state, "step": state["step"] + 1}

    return jt, scales, step


def _port_step(t, dim):
    data, seg = _batch(dim)
    d, targets = prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                   torch.from_numpy(seg))
    before = flatten_params(params_from_state_dict(
        {k: v.clone() for k, v in t.model.state_dict().items()}))
    loss = t.loss_and_grads(d, targets)
    # the deepest head's weight in the loss is 0: no gradient reaches it
    grads = flatten_params(params_from_state_dict(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in t.model.named_parameters()}))
    t.apply_gradients()
    after = flatten_params(params_from_state_dict(t.model.state_dict()))
    return float(loss), grads, {k: after[k] - before[k] for k in after}


def _close_or_rounding(got, want, what):
    """Each array to 1e-3 of its own largest entry; an array whose largest
    entry is below 1e-4 of the largest of all is zero up to rounding (the
    gradient of a conv bias in front of a norm, and that bias's update) and
    must be so on both sides."""
    top = max(float(np.abs(v).max()) for v in want.values())
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        wmax = float(np.abs(w).max())
        if wmax < 1e-4 * top:
            assert np.abs(got[k]).max() < 1e-4 * top, (what, k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-3 * wmax,
                                       err_msg=f"{what} {k}")


def _compare(port, jloss, jgrads, old, jnew):
    loss, grads, updates = port
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    jflat = flatten_params(jax.tree.map(np.asarray, jgrads)["params"])
    _close_or_rounding(grads, jflat, "gradient")
    old = flatten_params(jax.tree.map(np.asarray, old)["params"])
    jupd = {k: w - old[k] for k, w in
            flatten_params(jax.tree.map(np.asarray, jnew)["params"]).items()}
    _close_or_rounding(updates, jupd, "update")


@pytest.mark.parametrize("dim", [2, 3])
def test_sgd_step_matches_the_optax_step(dim):
    t = _port_trainer(dim)
    cfg = t.config
    assert isinstance(t.model, tdyn.PlainConvUNet)
    assert isinstance(t.optimizer, torch.optim.SGD)
    assert (cfg.optimizer, cfg.initial_lr, cfg.weight_decay, cfg.momentum,
            cfg.nesterov, cfg.scheduler) == ("sgd", 1e-2, 3e-5, 0.99, True, "poly")
    jt, scales, jstep = _jax_setup(dim)
    assert t.train_aug_cfg.deep_supervision_scales == scales
    t.model.load_state_dict(convert_params(jt.state["params"], t.model))
    assert t._step_schedule(0) == pytest.approx(cfg.initial_lr)
    jloss, jgrads, jnew = jstep(jt.state)
    _compare(_port_step(t, dim), jloss, jgrads, jt.state["params"], jnew["params"])


def test_jax_sgd_checkpoint_continues_with_the_jax_step(tmp_path):
    """One JAX step at 3d, saved by the JAX ``save_checkpoint``: the port
    loads the params and optax's ``trace`` as torch's momentum buffers
    exactly, and its next step is the JAX trainer's next step."""
    jt, _, jstep = _jax_setup(3)
    _, _, state1 = jstep(jt.state)
    jt.state = state1
    for key, value in (("epoch_start_timestamps", 1.0), ("train_losses", 1.25),
                       ("val_losses", 1.5), ("mean_fg_dice", 0.25),
                       ("dice_per_class_or_region", [0.2, 0.3]), ("lrs", 1e-2),
                       ("epoch_end_timestamps", 2.0)):
        jt.logger.log(key, value, 0)
    jt._best_ema = jt.logger.my_fantastic_logging["ema_fg_dice"][0]
    path = str(tmp_path / "jax_step1.pth")
    jt.save_checkpoint(path)
    with open(path, "rb") as f:
        assert isinstance(pickle.load(f)["optimizer_state"], bytes)

    t = _port_trainer(3)
    t.load_checkpoint(path)
    assert t.step == 1 and t.current_epoch == 1
    state1 = jax.tree.map(np.asarray, state1)
    want = convert_params(state1["params"], t.model)
    for k, v in t.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    trace = convert_params(state1["opt_state"][2][0].trace, t.model)
    for name, p in t.model.named_parameters():
        torch.testing.assert_close(t.optimizer.state[p]["momentum_buffer"],
                                   trace[name], rtol=0, atol=0, msg=name)
    jloss, jgrads, state2 = jstep(jax.tree.map(jnp.asarray, state1))
    _compare(_port_step(t, 3), jloss, jgrads, state1["params"], state2["params"])
    assert t.step == 2


@pytest.mark.parametrize("trainer_name,dim,patch", [
    ("nnUNetTrainer", 2, (16, 12)), ("nnUNetTrainer", 2, (64, 16)),
    ("nnUNetTrainer", 3, (8, 16, 16)), ("nnUNetTrainer", 3, (4, 16, 16)),
    ("nnUNetTrainerU2NetP", 3, (32, 32, 32)), ("nnUNetTrainerU2Net", 2, (32, 32))])
def test_augmentation_setup_matches_jax(trainer_name, dim, patch):
    """The rotation, the dummy-2d option for anisotropic 3d patches (4x16x16
    has it, 8x16x16 not), the mirror axes, the initial patch size and the
    deep-supervision scales (``arch`` from the plan's strides, anisotropic
    at 3d; ``fullres`` for U2Net) are the JAX trainer's."""
    plans = _plans(dim, patch)
    name = CASES[dim][0]
    t = Trainer(plans, name, "all", DATASET, device="cpu", seed=0,
                trainer_name=trainer_name)
    jt = JaxTrainer(plans, name, "all", DATASET, trainer_name=trainer_name)
    got = t.configure_rotation_dummyDA_mirroring_and_initial_patch_size()
    want = jt.configure_rotation_dummyDA_mirroring_and_initial_patch_size()
    assert got == want
    assert t._get_deep_supervision_scales() == jt._get_deep_supervision_scales()
    if dim == 3 and trainer_name == "nnUNetTrainer":
        assert got[1] == (patch[0] == 4)
        assert t._get_deep_supervision_scales() == ((1.0, 1.0, 1.0), (1.0, 0.5, 0.5))


@pytest.mark.parametrize("suffix,fraction", [("", 1.0), ("_05Percent", 0.05),
                                             ("_25Percent", 0.25),
                                             ("_75Percent", 0.75)])
def test_data_fraction_variants_build_the_base_model(suffix, fraction):
    """``nnUNetTrainer_25Percent`` trains the plan's PlainConvUNet with the
    base trainer's SGD on a quarter of the fold's training cases."""
    t = _port_trainer(3, "nnUNetTrainer" + suffix)
    assert isinstance(t.model, tdyn.PlainConvUNet)
    assert isinstance(t.optimizer, torch.optim.SGD)
    assert t.config.data_fraction == fraction
    assert get_model_builder("nnUNetTrainer" + suffix) is \
        get_model_builder("nnUNetTrainer")


def test_resenc_trainer_builds_the_plan_s_residual_unet():
    arch = dict(ARCH_3D, n_blocks_per_stage=[1, 2, 1])
    plans = _plans(3, arch=arch, arch_class="ResidualEncoderUNet")
    t = Trainer(plans, "3d_fullres", "all", DATASET, device="cpu", seed=0,
                trainer_name="nnUNetTrainerResEncUNet")
    t.initialize()
    assert isinstance(t.model, tdyn.ResidualEncoderUNet)
    assert isinstance(t.optimizer, torch.optim.SGD)
    assert len(list(t.model.encoder.children())) == 4
    plans["configurations"]["3d_fullres"]["architecture"]["network_class_name"] = \
        "dynamic_network_architectures.architectures.residual_unet.ResidualEncoderUNet"
    t = Trainer(plans, "3d_fullres", "all", DATASET, device="cpu", seed=0)
    t.initialize()
    assert isinstance(t.model, tdyn.ResidualEncoderUNet)
    plans["configurations"]["3d_fullres"]["architecture"]["network_class_name"] = "X"
    with pytest.raises(RuntimeError, match="Unknown architecture"):
        Trainer(plans, "3d_fullres", "all", DATASET, device="cpu").initialize()


def test_unknown_trainer_name_raises():
    with pytest.raises(RuntimeError, match="No model registered"):
        get_model_builder("nnUNetTrainerNoSuchModel_25Percent")
