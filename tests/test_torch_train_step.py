"""One training step of M2NetP: the port's ``Trainer`` against the JAX step.

Stage layers (1, 1, 1, 1), patch 64x64, batch 2, converted weights, DropPath
off on both sides (the JAX model is applied without a dropout rng, the port's
rates are set to 0) and no augmentation: the same deep-supervision loss, the
same gradient of every parameter and the same parameters after the clip at
12 and one AdamW update as ``optax`` gives. fp32 on the CPU on both sides;
the tolerances are stated at each comparison. The same holds with the
fused cross-scan glue on both sides. ``remat=True`` must give the gradients
of ``remat=False``, DropPath live, with either glue.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.models.m2net import M2NetP as JaxM2NetP  # noqa: E402
from nnuzoo_tpu.training import losses as jl  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.models import m2net as tm2net  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.models.layers import DropPath  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer, clip_by_global_norm_  # noqa: E402

from .torch_port_helpers import random_flax_params  # noqa: E402

LAYERS = (1, 1, 1, 1)
PATCH = (64, 64)
BATCH = 2


def _plans():
    rs = {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None}
    plans = {
        "dataset_name": "Dataset998_Step", "plans_name": "nnUNetPlans",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {},
        "configurations": {"2d": {
            "data_identifier": "nnUNetPlans_2d", "batch_size": BATCH,
            "batch_dice": True, "patch_size": list(PATCH), "spacing": [1.0, 1.0],
            "normalization_schemes": ["ZScoreNormalization"],
            "use_mask_for_norm": [False],
            "resampling_fn_data": "resample_data_or_seg_to_shape",
            "resampling_fn_data_kwargs": rs,
            "resampling_fn_seg": "resample_data_or_seg_to_shape",
            "resampling_fn_seg_kwargs": dict(rs, is_seg=True, order=1),
            "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
            "resampling_fn_probabilities_kwargs": dict(rs, order=1)}},
    }
    dataset_json = {"channel_names": {"0": "MRI"},
                    "labels": {"background": 0, "organ": 1, "tumor": 2},
                    "file_ending": ".nii.gz"}
    return plans, dataset_json


@pytest.fixture
def trainer(tmp_path, monkeypatch):
    """The port's Trainer on the CPU with the shallow M2NetP."""
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pp"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    monkeypatch.setitem(registry.MODEL_BUILDERS, "nnUNetTrainerM2NetP",
                        functools.partial(tm2net.get_m2net_from_plans,
                                          small=True, stage_layers=LAYERS))
    plans, dataset_json = _plans()
    t = Trainer(plans, "2d", "all", dataset_json, device="cpu", seed=0,
                trainer_name="nnUNetTrainerM2NetP")
    t.initialize()
    return t


def _batch(seed):
    rng = np.random.RandomState(seed)
    data = rng.randn(BATCH, 1, *PATCH).astype(np.float32)
    seg = rng.randint(0, 3, (BATCH, 1, *PATCH)).astype(np.int16)
    seg[:, :, :20, :20] = 1          # some structure, so every class has a region
    return data, seg


def test_step_matches_the_optax_step(trainer):
    _check_step_against_optax(trainer)


def test_fused_step_matches_the_optax_step(trainer, monkeypatch):
    """The same step with the fused cross-scan glue in every SS2D, against
    the JAX step with its default glue, tolerances as above. The two glues
    compute the same function (``tests/test_cross_scan.py``); the JAX step
    with its fused glue in interpret mode (``NNUZOO_SS2D_FUSED=interpret``)
    takes 75 s on a CPU, and its fp32 gradients differ from its own
    default glue's by up to 5x the tolerance in the decoder's first conv, so
    the default glue is the reference. ``test_torch_cross_scan.py`` holds
    the fused function against the JAX Pallas pair itself."""
    from nnuzoo_tpu_torch.models.ss2d import set_ss2d_glue
    set_ss2d_glue(trainer.model, "fused")
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "0")
    _check_step_against_optax(trainer)


def _check_step_against_optax(trainer):
    cfg = trainer.config
    assert (cfg.optimizer, cfg.initial_lr, cfg.weight_decay, cfg.adam_eps,
            cfg.grad_clip_norm) == ("adamw", 1e-4, 5e-2, 1e-5, 12.0)
    data, seg = _batch(0)
    jmodel = JaxM2NetP(num_classes=3, stage_layers=LAYERS)
    params = random_flax_params(jmodel, jnp.asarray(data.transpose(0, 2, 3, 1)),
                                seed=3, train=False)
    trainer.model.load_state_dict(convert_params(params, trainer.model))
    for m in trainer.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    scales = trainer.train_aug_cfg.deep_supervision_scales
    assert len(scales) == 7 and scales[0] == scales[1] == (1.0, 1.0)

    # ---- the JAX step: the trainer's loss_fn and optimizer chain
    jcfg = ja.AugmentConfig(patch_size=PATCH, initial_patch_size=PATCH,
                            rotation=0.0, deep_supervision_scales=scales)
    _, jtargets = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(seg))
    weights = jl.get_deep_supervision_weights(7)

    def loss_fn(p):
        outs = jmodel.apply(p, jnp.moveaxis(jnp.asarray(data), 1, -1), train=True)
        fn = lambda o, t: jl.dice_ce_loss(jnp.moveaxis(o, -1, 1), t,
                                          batch_dice=True, ignore_label=None)
        return jl.deep_supervision_loss(fn, outs, jtargets[:len(outs)], weights)

    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                     optax.adamw(learning_rate=cfg.initial_lr,
                                 weight_decay=cfg.weight_decay, eps=cfg.adam_eps,
                                 b1=0.9, b2=0.999))

    @jax.jit
    def jstep(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates)

    jloss, jgrads, jnew = jstep(params)

    # ---- the port's step, without augmentation
    from nnuzoo_tpu_torch.data.augment import prepare_val_batch
    d, targets = prepare_val_batch(trainer.train_aug_cfg, torch.from_numpy(data),
                                   torch.from_numpy(seg))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    loss = trainer.loss_and_grads(d, targets)
    grads = params_from_state_dict(
        {n: p.grad for n, p in trainer.model.named_parameters()})
    assert trainer._step_schedule(0) == pytest.approx(cfg.initial_lr)
    trainer.apply_gradients()
    assert trainer.step == 1
    new = params_from_state_dict(trainer.model.state_dict())

    # the loss: sums over 64x64x2 voxels in other orders
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # gradients: each parameter to 1e-3 of its own largest entry plus 1e-5 of
    # the largest entry of the whole gradient (norm statistics summed in
    # other orders feed every gradient)
    jflat = flatten_params(jgrads["params"])
    tflat = flatten_params(grads)
    assert sorted(jflat) == sorted(tflat)
    gmax = max(float(np.abs(v).max()) for v in jflat.values())
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in jflat.values()))
    for k, w in jflat.items():
        np.testing.assert_allclose(
            tflat[k], w, rtol=0,
            atol=1e-3 * float(np.abs(w).max()) + 1e-5 * gmax, err_msg=k)
    # updated parameters: Adam's first step moves every entry by about lr
    # whatever its gradient's size, so the update (new - old) is compared:
    # to 2% of lr, but for entries whose gradient is so small that eps and
    # rounding decide its sign and size (|g| below 1e-3 of the clip-scaled
    # mean magnitude), which may differ by up to 2 lr
    jnewflat = flatten_params(jnew["params"])
    tnewflat = flatten_params(new)
    oldflat = flatten_params(params_from_state_dict(before))
    scale = min(1.0, cfg.grad_clip_norm / norm)
    for k, w in jnewflat.items():
        upd_t = tnewflat[k] - oldflat[k]
        upd_j = w - oldflat[k]
        solid = np.abs(jflat[k]) * scale > 1e-3
        np.testing.assert_allclose(upd_t[solid], upd_j[solid], rtol=0,
                                   atol=0.02 * cfg.initial_lr, err_msg=k)
        np.testing.assert_allclose(upd_t, upd_j, rtol=0,
                                   atol=2.05 * cfg.initial_lr, err_msg=k)
        np.testing.assert_allclose(oldflat[k],
                                   flatten_params(params["params"])[k], rtol=0,
                                   atol=0, err_msg=k)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.RandomState(1)
    for factor in (0.1, 10.0):          # below and above the threshold
        arrays = [(factor * rng.randn(*s)).astype(np.float32)
                  for s in ((3, 4), (5,), (2, 2, 2))]
        want, _ = optax.clip_by_global_norm(2.0).update(
            [jnp.asarray(a) for a in arrays], optax.EmptyState())
        grads = [torch.from_numpy(a.copy()) for a in arrays]
        norm = clip_by_global_norm_(grads, 2.0)
        np.testing.assert_allclose(
            float(norm), np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                                     for a in arrays)), rtol=1e-6)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_other_optimizer_chains_match_optax(trainer, optimizer):
    """SGD (nesterov, L2 decay added to the gradient) and "adam" (decoupled
    AdamW, as in the JAX package) over three steps of a changing rate,
    against the optax chains of the JAX trainer; rtol 1e-5."""
    from dataclasses import replace
    trainer.config = replace(trainer.config, optimizer=optimizer, initial_lr=1e-2,
                             weight_decay=3e-3, num_iterations_per_epoch=1,
                             scheduler="poly", num_epochs=5)
    rng = np.random.RandomState(2)
    w0 = rng.randn(4, 3).astype(np.float32)
    trainer.model = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        trainer.model.weight.copy_(torch.from_numpy(w0))
    trainer.optimizer = trainer._build_optimizer()
    trainer.step = 0
    cfg = trainer.config
    sched = lambda step: cfg.initial_lr * (1 - jnp.minimum(step, 4) / 5) ** 0.9
    if optimizer == "sgd":
        tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                         optax.add_decayed_weights(cfg.weight_decay),
                         optax.sgd(learning_rate=sched, momentum=cfg.momentum,
                                   nesterov=cfg.nesterov))
    else:
        tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                         optax.adamw(learning_rate=sched,
                                     weight_decay=cfg.weight_decay,
                                     eps=cfg.adam_eps))
    p = jnp.asarray(w0)
    state = tx.init(p)
    for step in range(3):
        g = (10 * rng.randn(4, 3)).astype(np.float32)      # step 0 gets clipped
        updates, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, updates)
        trainer.model.weight.grad = torch.from_numpy(g.copy())
        trainer.apply_gradients()
        np.testing.assert_allclose(trainer.model.weight.detach().numpy(),
                                   np.asarray(p), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{optimizer} step {step}")


def test_remat_gives_the_same_gradients_with_droppath_live():
    """``remat=True`` runs stages 1, 2, 2d, 1d again in the backward pass; the
    second run must draw the DropPath masks of the first, from the modules'
    own generator, and leave the generator where the forward pass left it."""
    _check_remat("default")


def test_remat_gives_the_same_gradients_with_the_fused_glue():
    """As above with the fused cross-scan glue, whose forward runs again in
    the recomputation."""
    _check_remat("fused")


def _check_remat(glue):
    from nnuzoo_tpu_torch.models.ss2d import set_ss2d_glue
    x = torch.from_numpy(np.random.RandomState(4).randn(4, 32, 32, 1)
                         .astype(np.float32))
    grads, states = {}, {}
    for remat in (False, True):
        model = tm2net.M2NetP(1, 3, remat=remat, stage_layers=(2, 2, 1, 1))
        from nnuzoo_tpu_torch.models.layers import init_parameters, \
            set_drop_path_generator
        init_parameters(model, torch.Generator().manual_seed(5))
        set_ss2d_glue(model, glue)
        gen = torch.Generator().manual_seed(6)
        set_drop_path_generator(model, gen)
        for m in model.modules():
            if isinstance(m, DropPath) and m.rate > 0:
                m.rate = 0.5                   # so that masks do drop samples
        model.train()
        loss = sum((o ** 2).mean() for o in model(x))
        loss.backward()
        # (at 32x32 stage6 sees a 1x1 map, whose norms pass no gradient on)
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
        states[remat] = gen.get_state()
    assert torch.equal(states[False], states[True])
    assert sorted(grads[False]) == sorted(grads[True]) and len(grads[True]) > 300
    for n, g in grads[False].items():
        assert torch.equal(g, grads[True][n]) or torch.allclose(
            g, grads[True][n], rtol=1e-6, atol=1e-8), n
