"""The port's ``Trainer`` of the SSND2Net family against the JAX package's,
and the family through the port's command line.

``nnUNetTrainerSSND2NetP`` (AdamW lr 1e-4, weight decay 5e-2, eps 1e-5,
cosine; ``ds_mode="x2net"`` with seven outputs), every mini cut to one
level (the stage tables and the outer network stay), patch 32x32, batch 2,
no augmentation, DropPath off, fp32: the trainer's configuration and
deep-supervision scales equal the JAX trainer's; the port's loss of its
model's seven outputs against the JAX trainer's loss of the same outputs,
to 1e-5; and, from the gradients of that loss (the parameters of the 1x1
bottleneck stage's GSCs, which normalise a single voxel to zero, get none:
the Trainer steps them with a zero one, as optax does), the port's clip and
AdamW update against the JAX trainer's optax chain, to 2% of lr in every
entry. The model itself is held to the JAX model child by child in
``test_torch_ssnd2net_models.py``; its SSNDs' gradients in
``test_torch_ssnd.py``. Neither the JAX model nor its step is traced here:
XLA's compile of a jitted SSND2Net step takes minutes.

Also: the registry's names with their data fractions, and ``train -tr
nnUNetTrainerSSND2NetP`` at full width (one-level minis) through the
command line on a raw 2d dataset, then ``predict_from_modelfolder`` and
``evaluate_simple``.
"""

import dataclasses
import functools
import os
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.cli.entry_points import main  # noqa: E402
from nnuzoo_tpu_torch.data.augment import prepare_val_batch  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.models.layers import DropPath  # noqa: E402
from nnuzoo_tpu_torch.models.ss2d import set_scan_backend  # noqa: E402
from nnuzoo_tpu_torch.models.ssnd2net import SSND2Net  # noqa: E402
from nnuzoo_tpu_torch.training import trainer as ttrainer  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402
from nnuzoo_tpu_torch.utilities.io import load_json, load_pickle  # noqa: E402

from .helpers import set_paths  # noqa: E402
from .test_torch_lm2net_cli import RAW, _write_raw_dataset  # noqa: E402
from .test_torch_mamba_trainer import DATASET, PATCH, _batch, _plans  # noqa: E402
from .test_torch_ssnd2net import one_level_minis  # noqa: E402
from .torch_port_helpers import one_torch_thread  # noqa: E402

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

NAME = "nnUNetTrainerSSND2NetP"
NAMES = ("nnUNetTrainerSSND2Net", NAME)


@pytest.fixture(autouse=True)
def _folders(tmp_path, monkeypatch):
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pp"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    one_level_minis(monkeypatch)


def test_step_matches_the_optax_step():
    t = Trainer(_plans(), "2d", "all", DATASET, device="cpu", seed=0,
                trainer_name=NAME)
    t.initialize()
    jt = JaxTrainer(_plans(), "2d", "all", DATASET, trainer_name=NAME)
    cfg = t.config
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jt.config)
    assert (cfg.optimizer, cfg.ds_mode, cfg.num_ds_outputs) == ("adamw", "x2net", 7)
    assert isinstance(t.optimizer, torch.optim.AdamW)
    assert isinstance(t.model, SSND2Net) and not t.model.remat
    scales = t.train_aug_cfg.deep_supervision_scales
    assert scales == jt._get_deep_supervision_scales()
    assert len(scales) == 7 and scales[0] == scales[1] == (1.0, 1.0)
    for m in t.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    set_scan_backend(t.model, "plain")

    data, seg = _batch()
    d, targets = prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                   torch.from_numpy(seg))
    jcfg = ja.AugmentConfig(patch_size=PATCH, initial_patch_size=PATCH,
                            rotation=0.0, deep_supervision_scales=scales)
    _, jtargets = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(seg))
    t.model.train()
    with torch.no_grad():
        outs = t.model(d.movedim(1, -1).contiguous())
    assert len(outs) == 7
    jloss = jax.jit(jt._compute_loss)([jnp.asarray(o.numpy()) for o in outs],
                                      jtargets)
    np.testing.assert_allclose(float(t._compute_loss(list(outs), targets)),
                               float(jloss), rtol=1e-5)

    before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    loss = t.loss_and_grads(d, targets)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert any(p.grad is None for p in t.model.parameters())
    # the chain is elementwise but for the global norm, so one leaf of every
    # parameter gives the same update, and XLA compiles it in a second
    names = [n for n, _ in t.model.named_parameters()]
    flat = [before[n].reshape(-1) for n in names]
    flat_grad = [torch.zeros_like(f) if p.grad is None else p.grad.reshape(-1)
                 for f, (_, p) in zip(flat, t.model.named_parameters())]
    params = jnp.asarray(torch.cat(flat).numpy())
    tx = jt._build_optimizer()
    updates, _ = jax.jit(tx.update)(jnp.asarray(torch.cat(flat_grad).numpy()),
                                    tx.init(params), params)
    want = dict(zip(names, np.split(np.asarray(updates),
                                    np.cumsum([f.numel() for f in flat])[:-1])))
    t.apply_gradients()
    lr = t._step_schedule(0)
    for n, p in t.model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[n]).reshape(-1).numpy(),
                                   want[n], rtol=0, atol=0.02 * lr, err_msg=n)


def test_registry_names_and_data_fractions(monkeypatch):
    monkeypatch.setenv("NNUZOO_REMAT", "1")
    for name in NAMES:
        build = registry.get_model_builder(name)
        for suffix in ("_05Percent", "_75Percent"):
            assert registry.get_model_builder(name + suffix) is build
        t = Trainer(_plans(), "2d", "all", DATASET, device="cpu", seed=0,
                    trainer_name=name + "_10Percent")
        assert t.config.data_fraction == 0.10
        t.initialize()
        assert isinstance(t.model, SSND2Net) and t.model.remat
        assert len(t.train_aug_cfg.deep_supervision_scales) == 7


def test_train_validate_predict_and_score(tmp_path, monkeypatch):
    raw, pp, res = set_paths(tmp_path)
    ds = _write_raw_dataset(raw)
    main(["plan_and_preprocess", "-d", "993", "-c", "2d", "-npfp", "2", "-np", "2"])
    short = functools.partial(replace, num_iterations_per_epoch=1,
                              num_val_iterations_per_epoch=1)
    get_config = ttrainer.get_trainer_config
    monkeypatch.setattr(ttrainer, "get_trainer_config",
                        lambda n: short(get_config(n)))
    main(["train", "993", "2d", "0", "-tr", NAME, "-num_epochs", "1",
          "-device", "cpu"])
    model_folder = os.path.join(res, RAW, f"{NAME}__nnUNetPlans__2d")
    fold = os.path.join(model_folder, "fold_0")
    ckpt = load_pickle(os.path.join(fold, "checkpoint_final.pth"))
    assert ckpt["trainer_name"] == NAME
    summary = load_json(os.path.join(fold, "validation", "summary.json"))
    assert np.isfinite(summary["foreground_mean"]["Dice"])

    out = os.path.join(res, "predicted")
    predictor = main(["predict_from_modelfolder", "-i", os.path.join(ds, "imagesTr"),
                      "-o", out, "-m", model_folder, "-f", "0", "-device", "cpu",
                      "--disable_tta"])
    assert isinstance(predictor.model, SSND2Net) and predictor.forward_count > 0
    scores = main(["evaluate_simple", os.path.join(ds, "labelsTr"), out,
                   "-l", "1", "2", "-o", os.path.join(out, "summary.json"),
                   "-np", "1"])
    assert len(scores["metric_per_case"]) == 4
    assert np.isfinite(scores["foreground_mean"]["Dice"])
