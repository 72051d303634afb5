"""The port's ``Trainer`` of the five Mamba baselines against the JAX
package's: ``nnUNetTrainerSwinUMamba`` and ``nnUNetTrainerSwinUMambaD``
(AdamW, cosine, ``ds_mode="halving"`` with 4 outputs),
``nnUNetTrainerLightMUNet`` and ``nnUNetTrainerLightSS2DMambaUNet`` (the
``_LIGHT`` config: "adam" as decoupled AdamW, weight decay 1e-5, poly, no
deep supervision) and ``nnUNetTrainerSegMamba`` (AdamW, cosine, no deep
supervision); the step of the first two is in
``test_torch_swin_umamba_trainer.py``.

Small models (LightMUNet at 16 filters and three stages, SegMamba at
``feat_size=(4, 8, 16, 32)`` and one block a stage, SwinUMamba's encoder
cut to one block a stage of widths 16-128, each the same on both sides), patch 32x32, batch 2, converted weights,
DropPath off and no augmentation. These small models are ill-conditioned in
fp32 with random weights, so the step runs in fp64 on both sides (the JAX
scans stay fp32 inside): the loss to 1e-6; each gradient to 1e-3 of its own
largest entry plus 1e-5 of the largest entry of all; AdamW's update to 2%
of lr, but for entries whose gradient is so small that eps decides it
(within 2.05 lr). Also: the deep-supervision scales against the JAX
trainer's probe, the registry's names with their data fractions,
``use_mamba2`` raising on an unknown ``NNUZOO_SCAN_BACKEND``, and the fused
SS2D glue raising where its kernels cannot take the widths.
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
from nnuzoo_tpu.models import light_munet as jl  # noqa: E402
from nnuzoo_tpu.models import seg_mamba as js  # noqa: E402
from nnuzoo_tpu.models import swin_umamba as jsw  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.data.augment import prepare_val_batch  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.models import seg_mamba as tsm  # noqa: E402
from nnuzoo_tpu_torch.models import swin_umamba as tsw  # noqa: E402
from nnuzoo_tpu_torch.models.layers import DropPath  # noqa: E402
from nnuzoo_tpu_torch.models.ss2d import (SS2D, set_scan_backend,  # noqa: E402
                                          set_ss2d_glue)
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402

from .torch_port_helpers import random_flax_params, to_fp64  # noqa: E402

PATCH = (32, 32)
DATASET = {"channel_names": {"0": "MRI"},
           "labels": {"background": 0, "organ": 1, "tumor": 2},
           "file_ending": ".nii.gz"}
VSSM = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
FEAT = (8, 16, 32, 64, 128)
LIGHT = dict(init_filters=16, blocks_down=(1, 1, 1), blocks_up=(1, 1))
SEG = dict(feat_size=(4, 8, 16, 32), hidden_size=32)
SEG_DEPTHS = (1, 1, 1, 1)
# trainer name -> (the port builder's kwargs, the JAX model, its DS outputs)
CASES = {
    "nnUNetTrainerSwinUMamba": (dict(feat_size=FEAT),
                                lambda: jsw.SwinUMamba(3, feat_size=FEAT), 4),
    "nnUNetTrainerSwinUMambaD": (dict(feat_size=FEAT),
                                 lambda: jsw.SwinUMambaD(3, feat_size=FEAT), 4),
    "nnUNetTrainerLightMUNet": (LIGHT, lambda: jl.LightMUNet(3, 2, **LIGHT), 1),
    "nnUNetTrainerLightSS2DMambaUNet": (
        LIGHT, lambda: jl.LightMUNet(3, 2, use_ss2d=True, **LIGHT), 1),
    "nnUNetTrainerSegMamba": (SEG, lambda: js.SegMamba(3, 2, **SEG), 1),
}


def _plans():
    rs = {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None}
    return {
        "dataset_name": "Dataset995_Mamba", "plans_name": "nnUNetPlans",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {},
        "configurations": {"2d": {
            "data_identifier": "nnUNetPlans_2d", "batch_size": 2,
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


@pytest.fixture(autouse=True)
def _folders(tmp_path, monkeypatch):
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pp"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))


def _small_builders(monkeypatch):
    """The registry's builders of the five names, shrunk; SwinUMamba's and
    SegMamba's encoders shrunk alike on both sides; the JAX side's scans on
    its per-step reference scan, which XLA compiles in a fraction of the
    chunked scan's time."""
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "ref")
    for name, (kwargs, _, _) in CASES.items():
        monkeypatch.setitem(registry.MODEL_BUILDERS, name, functools.partial(
            registry.get_model_builder(name), **kwargs))
    for module in (jsw, tsw):
        monkeypatch.setattr(module, "_VSSMBackbone",
                            functools.partial(module._VSSMBackbone, **VSSM))
    for module in (js, tsm):
        monkeypatch.setattr(module, "MambaEncoder",
                            functools.partial(module.MambaEncoder, depths=SEG_DEPTHS))


def _batch():
    rng = np.random.RandomState(0)
    data = rng.randn(2, 1, *PATCH).astype(np.float32)
    seg = rng.randint(0, 3, (2, 1, *PATCH)).astype(np.int16)
    seg[:, :, :12, :12] = 1
    return data, seg


def _jax_step(jt, params, scales):
    """The JAX trainer's loss and optax chain, one step from ``params`` on
    ``_batch()``, in fp64: (loss, grads, new params) as numpy trees."""
    data, seg = _batch()
    with jax.enable_x64(True):
        jcfg = ja.AugmentConfig(patch_size=PATCH, initial_patch_size=PATCH,
                                rotation=0.0, deep_supervision_scales=scales)
        _, targets = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(seg))
        x = jnp.moveaxis(jnp.asarray(data, jnp.float64), 1, -1)
        tx = jt._build_optimizer()

        @jax.jit
        def step(p):
            loss, grads = jax.value_and_grad(
                lambda q: jt._compute_loss(jt.model.apply(q, x), targets))(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            return loss, grads, optax.apply_updates(p, updates)

        out = step(to_fp64(params))
        return jax.tree.map(lambda a: np.asarray(a, np.float64), out)


def check_step_against_optax(name, monkeypatch):
    _small_builders(monkeypatch)
    _, jax_model, n_outputs = CASES[name]
    t = Trainer(_plans(), "2d", "all", DATASET, device="cpu", seed=0,
                trainer_name=name)
    t.initialize()
    jt = JaxTrainer(_plans(), "2d", "all", DATASET, trainer_name=name)
    jt.model = jax_model()
    cfg = t.config
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jt.config)
    light = "Light" in name
    assert (cfg.optimizer, cfg.weight_decay, cfg.scheduler) == \
        (("adam", 1e-5, "poly") if light else ("adamw", 5e-2, "cosine"))
    assert isinstance(t.optimizer, torch.optim.AdamW)
    scales = t.train_aug_cfg.deep_supervision_scales
    assert scales == jt._get_deep_supervision_scales()
    if n_outputs > 1:
        assert scales == tuple((0.5 ** i,) * 2 for i in range(4))
    else:
        assert scales is None

    params = random_flax_params(jt.model, jnp.zeros((1, *PATCH, 1)), seed=3,
                                train=False)
    t.model.load_state_dict(convert_params(params, t.model))
    for m in t.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    jloss, jgrads, jnew = _jax_step(jt, params, scales)

    t.model.double()
    set_scan_backend(t.model, "plain")
    data, seg = _batch()
    d, targets = prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                   torch.from_numpy(seg))
    assert len(t.model(d.double().movedim(1, -1))) == n_outputs
    loss = t.loss_and_grads(d.double(), targets)
    # the deepest deep-supervision head's weight in the loss is 0: no
    # gradient reaches it
    grads = flatten_params(params_from_state_dict(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in t.model.named_parameters()}))
    t.apply_gradients()
    new = flatten_params(params_from_state_dict(t.model.state_dict()))

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    jflat = flatten_params(jgrads["params"])
    assert sorted(jflat) == sorted(grads)
    gmax = max(float(np.abs(v).max()) for v in jflat.values())
    norm = np.sqrt(sum(float((v ** 2).sum()) for v in jflat.values()))
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


@pytest.mark.parametrize("name", ["nnUNetTrainerLightMUNet",
                                  "nnUNetTrainerLightSS2DMambaUNet",
                                  "nnUNetTrainerSegMamba"])
def test_step_matches_the_optax_step_in_fp64(name, monkeypatch):
    """SwinUMamba's and SwinUMambaD's are in
    ``test_torch_swin_umamba_trainer.py`` (a file takes a minute of XLA
    compiles for three)."""
    check_step_against_optax(name, monkeypatch)


def test_registry_names_and_data_fractions():
    for name in CASES:
        build = registry.get_model_builder(name)
        for suffix in ("_05Percent", "_50Percent"):
            assert registry.get_model_builder(name + suffix) is build
        t = Trainer(_plans(), "2d", "all", DATASET, device="cpu", seed=0,
                    trainer_name=name + "_25Percent")
        assert t.config.data_fraction == 0.25
    with pytest.raises(RuntimeError, match="No model registered"):
        registry.get_model_builder("nnUNetTrainerSwT2Net")


def test_mamba2_layer_raises(monkeypatch):
    """Mamba2 layers are built (the LM2Net family's), on SSD unless
    NNUZOO_SCAN_BACKEND says mamba1; a value it does not know raises."""
    from nnuzoo_tpu_torch.models.light_munet import MambaLayer, ResMambaBlock
    from nnuzoo_tpu_torch.models.mamba import Mamba2Block
    monkeypatch.delenv("NNUZOO_SCAN_BACKEND", raising=False)
    block = ResMambaBlock(32, 2, (0, 1), use_mamba2=True)
    assert isinstance(block.mamba1.mamba, Mamba2Block)
    assert block.mamba2.mamba.route == "ssd"
    monkeypatch.setenv("NNUZOO_SCAN_BACKEND", "bogus")
    with pytest.raises(ValueError, match="NNUZOO_SCAN_BACKEND"):
        MambaLayer(32, 32, use_mamba2=True)
    with pytest.raises(ValueError, match="NNUZOO_SCAN_BACKEND"):
        ResMambaBlock(32, 2, (0, 1), use_mamba2=True)


@pytest.mark.parametrize("name", ["nnUNetTrainerSwinUMamba",
                                  "nnUNetTrainerLightSS2DMambaUNet"])
def test_fused_glue_raises_where_its_kernels_cannot_run(name, monkeypatch):
    """SwinUMamba's SS2Ds (Dh 192-1536, R 6-48) and LightSS2DMambaUNet's
    deepest (Dh 512, R 16) are wider than K3/K4 take: with
    NNUZOO_SS2D_FUSED=1 the model is refused when it is built, and
    ``set_ss2d_glue(model, "fused")`` refuses and changes nothing."""
    from nnuzoo_tpu_torch.plans.plans_handler import PlansManager
    pm = PlansManager(_plans())
    cfg = pm.get_configuration("2d")
    build = registry.get_model_builder(name)
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "1")
    with pytest.raises(ValueError, match=r"K3/K4.*up to 256.*up to 8"):
        build(pm, DATASET, cfg, 1, device="cpu")
    monkeypatch.setenv("NNUZOO_SS2D_FUSED", "0")
    model = build(pm, DATASET, cfg, 1, device="cpu")
    with pytest.raises(ValueError, match="K3/K4"):
        set_ss2d_glue(model, "fused")
    assert {m.glue for m in model.modules() if isinstance(m, SS2D)} == {"default"}
