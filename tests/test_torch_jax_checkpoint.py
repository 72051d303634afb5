"""The JAX package's checkpoints in the port's ``Trainer`` and in
``run.load_pretrained_weights``.

A checkpoint written by the JAX ``Trainer.save_checkpoint`` after one optax
step of M2NetP (stage layers (1, 1, 1, 1), patch 64x64, batch 2, DropPath off
on both sides) loads into the port's ``Trainer``, and the port's next step
matches the JAX package's next step within ``test_torch_train_step.py``'s
limits (loss 1e-5, each gradient 1e-3 of its own largest entry plus 1e-5 of
the largest of all, the AdamW update 2% of lr). That needs optax's ``mu`` and
``nu`` in exactly the layouts of the converted params. An optimizer state of
another kind than the port's optimizer raises. The pretrained-weight
transfer moves as many arrays as the JAX function on the same pair of
checkpoints, and the pickle unpickles where JAX cannot be imported.

Most of the file's time (about 40 s on one CPU core) is XLA's compile of the
JAX gradient, shared by the two JAX steps.
"""

import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import serialization  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.models.m2net import M2NetP as JaxM2NetP  # noqa: E402
from nnuzoo_tpu.run.load_pretrained_weights import \
    load_pretrained_weights as jax_load_pretrained_weights  # noqa: E402
from nnuzoo_tpu.training import losses as jl  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.data.augment import prepare_val_batch  # noqa: E402
from nnuzoo_tpu_torch.models import m2net as tm2net  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.models.layers import DropPath  # noqa: E402
from nnuzoo_tpu_torch.run.load_pretrained_weights import \
    load_pretrained_weights  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402

from .test_torch_train_step import LAYERS, PATCH, _batch, _plans  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_checkpoint")
    mp = pytest.MonkeyPatch()
    mp.setenv("nnUNet_preprocessed", str(root / "pp"))
    mp.setenv("nnUNet_results", str(root / "res"))
    mp.setitem(registry.MODEL_BUILDERS, "nnUNetTrainerM2NetP",
               functools.partial(tm2net.get_m2net_from_plans, small=True,
                                 stage_layers=LAYERS))
    yield root
    mp.undo()


def _jax_trainer(num_classes=3):
    """The JAX ``Trainer`` of the step test's plans, with seeded M2NetP params
    and its optimizer's initial state (no compile: ``initialize`` is not
    called)."""
    plans, dataset_json = _plans()
    if num_classes != 3:
        dataset_json = dict(dataset_json, labels={"background": 0, "organ": 1})
    jt = JaxTrainer(plans, "2d", "all", dataset_json,
                    trainer_name="nnUNetTrainerM2NetP")
    data, _ = _batch(0)
    jt.jmodel = JaxM2NetP(num_classes=num_classes, stage_layers=LAYERS)
    params = random_flax_params(jt.jmodel, jnp.asarray(data.transpose(0, 2, 3, 1)),
                                seed=3, train=False)
    jt.tx = jt._build_optimizer()
    jt.state = {"params": params, "opt_state": jt.tx.init(params),
                "step": jnp.zeros((), jnp.int32)}
    return jt


def _log_one_epoch(jt):
    """What the JAX ``run_training`` logs in an epoch, so the pickle carries
    the same types."""
    for key, value in (("epoch_start_timestamps", 1.0), ("train_losses", 1.25),
                       ("val_losses", 1.5), ("mean_fg_dice", 0.25),
                       ("dice_per_class_or_region", [0.2, 0.3]), ("lrs", 1e-4),
                       ("epoch_end_timestamps", 2.0)):
        jt.logger.log(key, value, 0)
    jt._best_ema = jt.logger.my_fantastic_logging["ema_fg_dice"][0]
    jt.current_epoch = 0


def _port_trainer(**config):
    plans, dataset_json = _plans()
    t = Trainer(plans, "2d", "all", dataset_json, device="cpu", seed=0,
                trainer_name="nnUNetTrainerM2NetP")
    if config:
        from dataclasses import replace
        t.config = replace(t.config, **config)
    t.initialize()
    for m in t.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    return t


@pytest.fixture(scope="module")
def initial_checkpoint(folders):
    """A JAX checkpoint of the initial state (no step taken)."""
    jt = _jax_trainer()
    _log_one_epoch(jt)
    path = str(folders / "jax_initial.pth")
    jt.save_checkpoint(path)
    return jt, path


def test_jax_checkpoint_unpickles_without_jax(initial_checkpoint):
    """The pickle holds bytes and Python/numpy values only: it unpickles, and
    its params decode, in a process in which ``import jax`` fails."""
    _, path = initial_checkpoint
    code = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack",
                                  "nnuzoo_tpu"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
try:
    import jax
    raise SystemExit("jax imported")
except ImportError:
    pass
from nnuzoo_tpu_torch.utilities.flax_msgpack import msgpack_restore
from nnuzoo_tpu_torch.utilities.io import load_pickle
ckpt = load_pickle(sys.argv[1])
assert isinstance(ckpt["network_weights"], bytes)
assert isinstance(ckpt["optimizer_state"], bytes)
params = msgpack_restore(ckpt["network_weights"])
print(sorted(ckpt), sorted(params), ckpt["step"], ckpt["_best_ema"])
"""
    out = subprocess.run([sys.executable, "-c", code, path], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "['params']" in out.stdout and "logging" in out.stdout


def test_other_optimizer_states_raise(initial_checkpoint, folders):
    """SGD's optax state (the JAX ``nnUNetTrainer``'s chain) does not go into
    the port's AdamW, nor a JAX AdamW state into its SGD
    (``tests/test_torch_cnn_trainer.py`` continues an SGD state in SGD)."""
    jt, path = initial_checkpoint
    cfg = jt.config
    sgd = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                      optax.add_decayed_weights(cfg.weight_decay),
                      optax.sgd(learning_rate=1e-2, momentum=0.99, nesterov=True))
    params = jax.tree.map(np.asarray, jt.state["params"])
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    ckpt_sgd = dict(ckpt, optimizer_state=serialization.to_bytes(
        jax.tree.map(np.asarray, sgd.init(params))))
    t = _port_trainer()
    with pytest.raises(NotImplementedError, match="adamw"):
        t.load_checkpoint(ckpt_sgd)
    t_sgd = _port_trainer(optimizer="sgd")
    with pytest.raises(NotImplementedError, match="AdamW"):
        t_sgd.load_checkpoint(path)


def test_pretrained_transfer_counts_as_the_jax_function(initial_checkpoint, folders):
    """A 2-class M2NetP from the 3-class JAX checkpoint: the same number of
    arrays as the JAX function moves, each equal to the source, the heads
    kept; the same again from the port's own checkpoint of those weights."""
    _, path = initial_checkpoint
    target_jax = _jax_trainer(num_classes=2).state["params"]
    jax_new, jax_count = jax_load_pretrained_weights(target_jax, path)

    plans, dataset_json = _plans()
    from nnuzoo_tpu_torch.plans.plans_handler import PlansManager
    pm = PlansManager(plans)
    model = registry.get_model_builder("nnUNetTrainerM2NetP")(
        pm, dict(dataset_json, labels={"background": 0, "organ": 1}),
        pm.get_configuration("2d"), 1, deep_supervision=True, device="cpu")
    model.load_state_dict(convert_params(target_jax, model))
    new_state, count = load_pretrained_weights(model, path)
    total = len(model.state_dict())
    assert 0 < count < total
    assert count == jax_count
    assert new_state.keys() == model.state_dict().keys()
    want = convert_params(jax.tree.map(np.asarray, jax_new), model)
    for k, v in new_state.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)

    # the port's own checkpoint of the 3-class weights transfers the same
    t = _port_trainer()
    t.load_checkpoint(path)
    own = str(folders / "port_initial.pth")
    t.save_checkpoint(own)
    own_state, own_count = load_pretrained_weights(model.state_dict(), own)
    assert own_count == count
    for k, v in own_state.items():
        torch.testing.assert_close(v, new_state[k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def jax_steps(folders):
    """Two JAX steps from the seeded params on batch 0: the checkpoint after
    the first (written by the JAX ``save_checkpoint``) and the second step's
    loss, gradients and params."""
    jt = _jax_trainer()
    data, seg = _batch(0)
    scales = _port_trainer().train_aug_cfg.deep_supervision_scales
    assert len(scales) == 7 and scales[0] == scales[1] == (1.0, 1.0)
    jcfg = ja.AugmentConfig(patch_size=PATCH, initial_patch_size=PATCH,
                            rotation=0.0, deep_supervision_scales=scales)
    _, jtargets = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(seg))
    weights = jl.get_deep_supervision_weights(7)

    def loss_fn(p):
        outs = jt.jmodel.apply(p, jnp.moveaxis(jnp.asarray(data), 1, -1),
                               train=True)
        fn = lambda o, t: jl.dice_ce_loss(jnp.moveaxis(o, -1, 1), t,
                                          batch_dice=True, ignore_label=None)
        return jl.deep_supervision_loss(fn, outs, jtargets[:len(outs)], weights)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    update = jax.jit(jt.tx.update)

    def step(state):
        loss, grads = grad_fn(state["params"])
        updates, opt_state = update(grads, state["opt_state"], state["params"])
        return loss, grads, {"params": optax.apply_updates(state["params"], updates),
                             "opt_state": opt_state, "step": state["step"] + 1}

    _, _, jt.state = step(jt.state)
    _log_one_epoch(jt)
    path = str(folders / "jax_step1.pth")
    jt.save_checkpoint(path)
    loss, grads, state2 = step(jt.state)
    return {"path": path, "scales": scales, "state1": jt.state, "loss": loss,
            "grads": grads, "state2": state2}


def test_jax_checkpoint_continues_with_the_jax_step(jax_steps):
    t = _port_trainer()
    cfg = t.config
    assert t.train_aug_cfg.deep_supervision_scales == jax_steps["scales"]
    t.load_checkpoint(jax_steps["path"])
    assert t.step == 1 and t.current_epoch == 1
    assert t.logger.my_fantastic_logging["train_losses"] == [1.25]

    # the params and the moments load exactly, in the port's layouts
    state1 = jax.tree.map(np.asarray, jax_steps["state1"])
    want = convert_params(state1["params"], t.model)
    for k, v in t.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    adam = state1["opt_state"][1][0]
    mu = convert_params(adam.mu, t.model)
    nu = convert_params(adam.nu, t.model)
    for name, p in t.model.named_parameters():
        s = t.optimizer.state[p]
        assert float(s["step"]) == 1.0
        torch.testing.assert_close(s["exp_avg"], mu[name], rtol=0, atol=0)
        torch.testing.assert_close(s["exp_avg_sq"], nu[name], rtol=0, atol=0)

    # the next step against the JAX package's
    data, seg = _batch(0)
    d, targets = prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                   torch.from_numpy(seg))
    spread = _rounding_spread(t, d, targets)
    loss = t.loss_and_grads(d, targets)
    grads = params_from_state_dict(
        {n: p.grad for n, p in t.model.named_parameters()})
    t.apply_gradients()
    assert t.step == 2
    new = flatten_params(params_from_state_dict(t.model.state_dict()))

    np.testing.assert_allclose(float(loss), float(jax_steps["loss"]), rtol=1e-5)
    jflat = flatten_params(jax.tree.map(np.asarray, jax_steps["grads"])["params"])
    tflat = flatten_params(grads)
    assert sorted(jflat) == sorted(tflat)
    gmax = max(float(np.abs(v).max()) for v in jflat.values())
    for k, w in jflat.items():
        np.testing.assert_allclose(
            tflat[k], w, rtol=0,
            atol=1e-3 * float(np.abs(w).max()) + 1e-5 * gmax + spread[k],
            err_msg=k)
    # the update (new - old): 2% of lr, but for entries whose gradient is so
    # small that eps and rounding decide it, which may differ by up to 2 lr
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in jflat.values()))
    scale = min(1.0, cfg.grad_clip_norm / norm)
    lr = t._step_schedule(1)
    assert lr == pytest.approx(cfg.initial_lr)
    old = flatten_params(state1["params"]["params"])
    jnew = flatten_params(jax.tree.map(np.asarray,
                                       jax_steps["state2"]["params"])["params"])
    for k, w in jnew.items():
        upd_t, upd_j = new[k] - old[k], w - old[k]
        solid = np.abs(jflat[k]) * scale > 1e-3
        np.testing.assert_allclose(upd_t[solid], upd_j[solid], rtol=0,
                                   atol=0.02 * lr, err_msg=k)
        np.testing.assert_allclose(upd_t, upd_j, rtol=0, atol=2.05 * lr,
                                   err_msg=k)


def test_jax_state_continues_with_the_jax_update(jax_steps):
    """The AdamW update from the loaded state, given the JAX step's own
    gradients, is the JAX step's update to 2% of lr in every entry: optax's
    count, mu and nu carry over as AdamW's step, exp_avg and exp_avg_sq."""
    t = _port_trainer()
    t.load_checkpoint(jax_steps["path"])
    jgrads = convert_params(jax.tree.map(np.asarray, jax_steps["grads"]), t.model)
    before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    for n, p in t.model.named_parameters():
        p.grad = jgrads[n].clone()
    t.apply_gradients()
    lr = t._step_schedule(1)
    want = convert_params(jax.tree.map(np.asarray, jax_steps["state2"]["params"]),
                          t.model)
    for n, p in t.model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[n]).numpy(),
                                   (want[n] - before[n]).numpy(), rtol=0,
                                   atol=0.02 * lr, err_msg=n)


def _rounding_spread(trainer, d, targets):
    """Per parameter, how far the port's own fp32 gradient moves when only the
    rounding order of the plain scan changes (its chunk, 64 or 128 instead of
    256): the largest entry of the difference. M2NetP's gradient is that
    sensitive at some points: here one decoder conv kernel moves by several
    times the step test's limit, as the JAX package's own two scan glues do
    at its first step. The gradient comparison above allows this on top of
    the step test's limits; the params, the moments and the update are held
    without it."""
    from nnuzoo_tpu_torch.ops import selective_scan as tscan
    plain = tscan.scan_core_plain
    trainer.loss_and_grads(d, targets)
    base = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    spread = {n: torch.zeros_like(g) for n, g in base.items()}
    try:
        for chunk in (64, 128):
            tscan.scan_core_plain = functools.partial(plain, chunk=chunk)
            trainer.loss_and_grads(d, targets)
            for n, p in trainer.model.named_parameters():
                spread[n] = torch.maximum(spread[n], (p.grad - base[n]).abs())
    finally:
        tscan.scan_core_plain = plain
    flat = flatten_params(params_from_state_dict(spread))
    return {k: float(v.max()) for k, v in flat.items()}
