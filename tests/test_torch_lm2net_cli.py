"""The LM2Net family through the port's command line and from the JAX
package's checkpoints, on the CPU, at full width, every mini cut to one
level on both sides (the registry's builder reaches the cut; the minis at
depth are in ``test_torch_lm2net.py``).

A raw Dataset993 (four cases of (z, y, x) 4x32x48 with spherical labels 1
and 2, ``.nii``) is planned and preprocessed for ``2d`` (patch [32, 48]);
``train 993 2d 0 -tr nnUNetTrainerLM2NetP`` (one step an epoch) writes its
final validation's ``summary.json``, ``predict_from_modelfolder`` predicts
the raw images with the fold (``--disable_tta``) and ``evaluate_simple``
scores them.

A fold of ``nnUNetTrainerLM2NetP`` written by the JAX ``Trainer``
(``save_checkpoint`` after one optax AdamW update) loads into the port's
``Trainer``: the weights and the moments exactly, in the port's layouts;
from the same gradient the port's next update is the JAX package's next
update to 2% of lr in every entry, and a training step of the port's own
runs from it. ``load_pretrained_weights`` moves as many arrays from it
into a 2-class LM2NetP as the JAX function does, each equal to its source.
"""

import functools
import os
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import lm2net as jl  # noqa: E402
from nnuzoo_tpu.run.load_pretrained_weights import \
    load_pretrained_weights as jax_load_pretrained_weights  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.cli.entry_points import main  # noqa: E402
from nnuzoo_tpu_torch.convert import convert_params  # noqa: E402
from nnuzoo_tpu_torch.data.augment import prepare_val_batch  # noqa: E402
from nnuzoo_tpu_torch.imageio.nifti import write_nifti  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.models.lm2net import LM2NetBase  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402
from nnuzoo_tpu_torch.run.load_pretrained_weights import \
    load_pretrained_weights  # noqa: E402
from nnuzoo_tpu_torch.training import trainer as ttrainer  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402
from nnuzoo_tpu_torch.utilities.io import load_json, load_pickle, save_json  # noqa: E402

from .helpers import set_paths  # noqa: E402
from .test_torch_jax_checkpoint import _log_one_epoch  # noqa: E402
from .test_torch_lm2net_models import one_level_minis  # noqa: E402
from .test_torch_mamba_trainer import DATASET, PATCH, _batch, _plans  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402

NAME = "nnUNetTrainerLM2NetP"
RAW = "Dataset993_LM2Net"
SHAPE_XYZ = (48, 32, 4)


def _write_raw_dataset(root, num_cases=4, seed=0):
    rng = np.random.RandomState(seed)
    ds = os.path.join(root, RAW)
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(ds, sub))
    xx, yy, zz = np.meshgrid(*[np.arange(s) for s in SHAPE_XYZ], indexing="ij")
    for i in range(num_cases):
        cx, cy = rng.randint(16, 32), rng.randint(10, 22)
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2 + 4 * (zz - 2) ** 2
        seg = np.zeros(SHAPE_XYZ, dtype=np.uint8)
        seg[r2 < 60] = 1
        seg[r2 < 16] = 2
        vol = (20 * seg + 10 * rng.rand(*SHAPE_XYZ) + 5).astype(np.float32)
        write_nifti(os.path.join(ds, "imagesTr", f"case_{i:03d}_0000.nii"), vol,
                    spacing_xyz=(1.0, 1.0, 1.0))
        write_nifti(os.path.join(ds, "labelsTr", f"case_{i:03d}.nii"), seg,
                    spacing_xyz=(1.0, 1.0, 1.0))
    save_json({"channel_names": {"0": "MRI"},
               "labels": {"background": 0, "organ": 1, "tumor": 2},
               "numTraining": num_cases, "file_ending": ".nii"},
              os.path.join(ds, "dataset.json"))
    return ds


@pytest.fixture(autouse=True)
def _one_level_minis(monkeypatch):
    one_level_minis(monkeypatch)


def test_train_validate_predict_and_score(tmp_path, monkeypatch):
    raw, pp, res = set_paths(tmp_path)
    ds = _write_raw_dataset(raw)
    main(["plan_and_preprocess", "-d", "993", "-c", "2d", "-npfp", "2", "-np", "2"])
    plan = load_json(os.path.join(pp, RAW, "nnUNetPlans.json"))[
        "configurations"]["2d"]
    assert plan["patch_size"] == [32, 48]
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
    assert len(summary["metric_per_case"]) == 1
    assert np.isfinite(summary["foreground_mean"]["Dice"])

    out = os.path.join(res, "predicted")
    predictor = main(["predict_from_modelfolder", "-i", os.path.join(ds, "imagesTr"),
                      "-o", out, "-m", model_folder, "-f", "0", "-device", "cpu",
                      "--disable_tta"])
    assert isinstance(predictor.model, LM2NetBase) and predictor.model.small
    assert predictor.forward_count > 0
    scores = main(["evaluate_simple", os.path.join(ds, "labelsTr"), out,
                   "-l", "1", "2", "-o", os.path.join(out, "summary.json"),
                   "-np", "1"])
    assert len(scores["metric_per_case"]) == 4
    assert np.isfinite(scores["foreground_mean"]["Dice"])


def _fake_grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        1e-2 * rng.randn(*p.shape).astype(np.float32)), params)


@pytest.fixture(scope="module")
def jax_fold(tmp_path_factory):
    """A JAX LM2NetP fold after one AdamW update, and the JAX package's next
    update from a second seeded gradient."""
    mp = pytest.MonkeyPatch()
    one_level_minis(mp)
    yield _jax_fold(tmp_path_factory)
    mp.undo()


def _jax_fold(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm2net_fold")
    jt = JaxTrainer(_plans(), "2d", "all", DATASET, trainer_name=NAME)
    jt.model = jl.LM2NetBase(3, 2, small=True, patch_size=PATCH)
    params = random_flax_params(jt.model, jnp.zeros((1, *PATCH, 1)), seed=4,
                                train=False)
    jt.tx = jt._build_optimizer()
    update = jax.jit(jt.tx.update)

    def step(state, seed):
        grads = _fake_grads(state["params"], seed)
        updates, opt_state = update(grads, state["opt_state"], state["params"])
        new = jax.tree.map(lambda p, u: p + u, state["params"], updates)
        return grads, {"params": new, "opt_state": opt_state,
                       "step": state["step"] + 1}

    state = {"params": params, "opt_state": jt.tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    _, jt.state = step(state, 5)
    _log_one_epoch(jt)
    path = str(root / "checkpoint_final.pth")
    jt.save_checkpoint(path)
    grads, state2 = step(jt.state, 6)
    return {"path": path, "state1": jax.tree.map(np.asarray, jt.state),
            "grads": jax.tree.map(np.asarray, grads),
            "state2": jax.tree.map(np.asarray, state2), "root": root}


def test_a_jax_fold_loads_and_continues(jax_fold, monkeypatch):
    monkeypatch.setenv("nnUNet_preprocessed", str(jax_fold["root"] / "pp"))
    monkeypatch.setenv("nnUNet_results", str(jax_fold["root"] / "res"))
    t = Trainer(_plans(), "2d", "all", DATASET, device="cpu", seed=0,
                trainer_name=NAME)
    t.initialize()
    t.load_checkpoint(jax_fold["path"])
    assert t.step == 1 and t.current_epoch == 1
    state1 = jax_fold["state1"]
    want = convert_params(state1["params"], t.model)
    for k, v in t.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    adam = state1["opt_state"][1][0]
    mu, nu = convert_params(adam.mu, t.model), convert_params(adam.nu, t.model)
    for name, p in t.model.named_parameters():
        s = t.optimizer.state[p]
        assert float(s["step"]) == 1.0
        torch.testing.assert_close(s["exp_avg"], mu[name], rtol=0, atol=0)
        torch.testing.assert_close(s["exp_avg_sq"], nu[name], rtol=0, atol=0)

    grads = convert_params(jax_fold["grads"], t.model)
    before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    for n, p in t.model.named_parameters():
        p.grad = grads[n].clone()
    t.apply_gradients()
    lr = t._step_schedule(1)
    want = convert_params(jax_fold["state2"]["params"], t.model)
    for n, p in t.model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[n]).numpy(),
                                   (want[n] - before[n]).numpy(), rtol=0,
                                   atol=0.02 * lr, err_msg=n)
    data, seg = _batch()
    d, targets = prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                   torch.from_numpy(seg))
    loss = t.loss_and_grads(d, targets)
    t.apply_gradients()
    assert np.isfinite(float(loss)) and t.step == 3


def test_pretrained_transfer_counts_as_the_jax_function(jax_fold):
    target = jl.LM2NetBase(2, 2, small=True, patch_size=PATCH)
    target_params = random_flax_params(target, jnp.zeros((1, *PATCH, 1)), seed=7,
                                       train=False)
    jax_new, jax_count = jax_load_pretrained_weights(target_params,
                                                     jax_fold["path"])
    pm = PlansManager(_plans())
    model = registry.get_model_builder(NAME)(
        pm, dict(DATASET, labels={"background": 0, "organ": 1}),
        pm.get_configuration("2d"), 1, deep_supervision=True, device="cpu")
    model.load_state_dict(convert_params(target_params, model))
    new_state, count = load_pretrained_weights(model, jax_fold["path"])
    assert 0 < count < len(model.state_dict())
    assert count == jax_count
    want = convert_params(jax.tree.map(np.asarray, jax_new), model)
    for k, v in new_state.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)

