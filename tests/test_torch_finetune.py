"""The fine-tuning trainer (``nnUNetTrainerFineTuneDecoderWarmUp``) of the
port against the JAX package: the encoder freeze.

The freeze mask names the same parameters as the JAX ``Trainer``'s mask, on
M2Net's and on M2NetP's parameter trees (``jax.eval_shape``: no compile).
Two steps of M2NetP (stage layers (1, 1, 1, 1), patch 64x64, batch 2,
DropPath off on both sides, no augmentation), the first with the encoder
frozen and the second after the unfreeze, match the JAX step (its masked
gradients, ``optax.chain(clip_by_global_norm, adamw)`` and its masked
updates): the frozen parameters stay bit for bit, their moments decay and
their step counts advance, and after the unfreeze their update is the
optax update, which takes its bias correction from the shared count. The
tolerances are ``test_torch_train_step.py``'s, each gradient also allowed
the port's own spread under the plain scan's rounding
(``test_torch_jax_checkpoint.py``) and each update the parameter's fp32
spacing (the warmup's rate is 1e-5). A checkpoint of the frozen step, the
port's own or the JAX package's, continues with the same step.

Most of the file's time is XLA's compile of the JAX gradient, shared by the
JAX steps.
"""

import functools
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.models.m2net import M2Net as JaxM2Net  # noqa: E402
from nnuzoo_tpu.models.m2net import M2NetP as JaxM2NetP  # noqa: E402
from nnuzoo_tpu.models import vssm as jvssm  # noqa: E402
from nnuzoo_tpu.training import losses as jl  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.data.augment import prepare_val_batch  # noqa: E402
from nnuzoo_tpu_torch.models import m2net as tm2net  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.models import vssm as tvssm  # noqa: E402
from nnuzoo_tpu_torch.models.layers import DropPath  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402

from .test_torch_jax_checkpoint import _rounding_spread  # noqa: E402
from .test_torch_train_step import LAYERS, PATCH, _batch, _plans  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402

NAME = "nnUNetTrainerFineTuneDecoderWarmUp"
# one frozen epoch of one step, then one unfrozen step; one warmup epoch in
# each phase, so each step's rate is the schedule's own
SHORT = dict(num_epochs=2, num_iterations_per_epoch=1, freeze_encoder_epochs=1,
             encoder_warmup_epochs=1, decoder_warmup_epochs=1)


def _torch_name(flax_key):
    """A flattened flax name under the port's names (``convert.py``)."""
    *path, leaf = flax_key.split(".")
    return ".".join(path + [{"kernel": "weight", "scale": "weight"}.get(leaf, leaf)])


@pytest.mark.parametrize("jmodel,tmodel", [
    (lambda: JaxM2Net(num_classes=3), lambda: tm2net.M2Net(1, 3)),
    (lambda: JaxM2NetP(num_classes=3, stage_layers=(3, 3, 2, 2)),
     lambda: tm2net.M2NetP(1, 3, stage_layers=(3, 3, 2, 2)))],
    ids=["M2Net", "M2NetP_3322"])
def test_freeze_mask_names_the_jax_parameters(jmodel, tmodel):
    """Every parameter with a name component stage1..6 or patch_merging1..4,
    the VSS layers named stage1.. of every MU's decoder included."""
    shapes = jax.eval_shape(functools.partial(jmodel().init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    mask = flatten_params(JaxTrainer._encoder_freeze_mask(shapes["params"]))
    want = {_torch_name(k) for k, frozen in mask.items() if frozen}
    with torch.device("meta"):
        model = tmodel()
    got = Trainer._encoder_freeze_mask(model)
    names = {n for n, _ in model.named_parameters()}
    assert {_torch_name(k) for k in mask} == names
    assert set(got) == want and len(got) == len(want)
    # a decoder MU's own decoder layers are frozen too
    assert any(n.split(".")[0].endswith("d") and ".vssm_decoder.stage1." in n
               for n in got)
    assert not any(n.startswith(("side", "outconv", "patch_expand")) for n in got)


class _JaxDecoderMU(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jvssm.MU(2, 8, 16, 4, name="stage4d")(x, False)


def test_a_decoder_mu_freezes_its_own_decoder_layers():
    """A ``MU(2, 8, 16, 4)`` placed as ``stage4d``: 26 of its 122 parameters
    are frozen, those of ``vssm_decoder.stage1`` and ``.stage2``, in both
    packages' masks."""
    shapes = jax.eval_shape(_JaxDecoderMU().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 2)))
    mask = flatten_params(JaxTrainer._encoder_freeze_mask(shapes["params"]))
    with torch.device("meta"):
        model = torch.nn.Module()
        model.stage4d = tvssm.MU(2, 8, 16, 4)
    got = Trainer._encoder_freeze_mask(model)
    assert {_torch_name(k) for k, frozen in mask.items() if frozen} == set(got)
    assert (len(got), len(list(model.parameters())), len(mask)) == (26, 122, 122)
    assert {".".join(n.split(".")[:3]) for n in got} == {
        "stage4d.vssm_decoder.stage1", "stage4d.vssm_decoder.stage2"}


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune")
    mp = pytest.MonkeyPatch()
    mp.setenv("nnUNet_preprocessed", str(root / "pp"))
    mp.setenv("nnUNet_results", str(root / "res"))
    mp.setitem(registry.MODEL_BUILDERS, NAME,
               functools.partial(tm2net.get_m2net_from_plans, small=True,
                                 stage_layers=LAYERS))
    yield root
    mp.undo()


def _port_trainer():
    plans, dataset_json = _plans()
    t = Trainer(plans, "2d", "all", dataset_json, device="cpu", seed=0,
                trainer_name=NAME)
    t.config = replace(t.config, **SHORT)
    t.initialize()
    for m in t.model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    return t


@pytest.fixture(scope="module")
def jax_steps(folders):
    """The JAX trainer's two steps from seeded params on batch 0, frozen and
    unfrozen as its ``train_step`` masks them: each step's state, gradients
    and updates; the checkpoint after the first, written by the JAX
    ``save_checkpoint``."""
    plans, dataset_json = _plans()
    jt = JaxTrainer(plans, "2d", "all", dataset_json, trainer_name=NAME)
    jt.config = replace(jt.config, **SHORT)
    data, seg = _batch(0)
    jmodel = JaxM2NetP(num_classes=3, stage_layers=LAYERS)
    params = random_flax_params(jmodel, jnp.asarray(data.transpose(0, 2, 3, 1)),
                                seed=3, train=False)
    jt.tx = jt._build_optimizer()
    jt.state = {"params": params, "opt_state": jt.tx.init(params),
                "step": jnp.zeros((), jnp.int32)}
    mask = JaxTrainer._encoder_freeze_mask(params)

    scales = tuple((1.0, 1.0) if i < 2 else (2.0 ** (1 - i),) * 2
                   for i in range(7))
    jcfg = ja.AugmentConfig(patch_size=PATCH, initial_patch_size=PATCH,
                            rotation=0.0, deep_supervision_scales=scales)
    _, jtargets = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(seg))
    weights = jl.get_deep_supervision_weights(7)

    def loss_fn(p):
        outs = jmodel.apply(p, jnp.moveaxis(jnp.asarray(data), 1, -1), train=True)
        fn = lambda o, t: jl.dice_ce_loss(jnp.moveaxis(o, -1, 1), t,
                                          batch_dice=True, ignore_label=None)
        return jl.deep_supervision_loss(fn, outs, jtargets[:len(outs)], weights)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    update = jax.jit(jt.tx.update)
    live_from = SHORT["freeze_encoder_epochs"] * SHORT["num_iterations_per_epoch"]

    def step(state):
        # the JAX Trainer's train_step: frozen gradients and updates zeroed
        live = int(state["step"]) >= live_from
        masked = lambda tree: jax.tree.map(
            lambda t, m: t * float(live) if m else t, tree, mask)
        loss, grads = grad_fn(state["params"])
        updates, opt_state = update(masked(grads), state["opt_state"],
                                    state["params"])
        return grads, {"params": optax.apply_updates(state["params"],
                                                     masked(updates)),
                       "opt_state": opt_state, "step": state["step"] + 1}

    states, grads = [jt.state], []
    for _ in range(2):
        g, s = step(states[-1])
        grads.append(g)
        states.append(s)
    jt.state = states[1]
    jt.current_epoch = 0
    path = str(folders / "jax_frozen_step.pth")
    jt.save_checkpoint(path)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return {"scales": scales, "path": path, "states": np_tree(states),
            "grads": np_tree(grads), "lrs": [float(jt._epoch_schedule(e))
                                             for e in range(2)]}


def _port_step(t, data, seg, spread=None):
    """One step of the port's trainer without augmentation: its gradients
    (flax names) and its parameters before and after (flax names). A dict
    ``spread`` gets each gradient's spread under the plain scan's rounding
    (``test_torch_jax_checkpoint._rounding_spread``)."""
    d, targets = prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                   torch.from_numpy(seg))
    if spread is not None:
        spread.update(_rounding_spread(t, d, targets))
    before = flatten_params(params_from_state_dict(
        {k: v.clone() for k, v in t.model.state_dict().items()}))
    t.loss_and_grads(d, targets)
    grads = flatten_params(params_from_state_dict(
        {n: p.grad.clone() for n, p in t.model.named_parameters()}))
    t.apply_gradients()
    return grads, before, flatten_params(params_from_state_dict(
        t.model.state_dict()))


def _check_step(t, jax_steps, k, spread, grads, before, after):
    """The port's step ``k`` against the JAX step ``k``: the gradient as the
    step test holds it, each allowed its ``spread`` under the plain scan's
    rounding on top (one decoder conv's fp32 gradient is that sensitive at
    some points, ``ROADMAP.md`` section 3); the update (new - old) to 2% of
    lr (2.05 lr where eps and rounding decide an entry), both moments to the
    limits that the gradients' own give them, and every parameter's step
    count."""
    jgrads = flatten_params(jax_steps["grads"][k]["params"])
    jold = flatten_params(jax_steps["states"][k]["params"]["params"])
    jnew = flatten_params(jax_steps["states"][k + 1]["params"]["params"])
    adam = jax_steps["states"][k + 1]["opt_state"][1][0]
    mu = flatten_params(adam.mu["params"])
    nu = flatten_params(adam.nu["params"])
    assert sorted(jgrads) == sorted(grads)
    gmax = max(float(np.abs(v).max()) for v in jgrads.values())
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in jgrads.values()))
    frozen = set(Trainer._encoder_freeze_mask(t.model))
    live = k >= SHORT["freeze_encoder_epochs"]
    if not live:        # the clip takes the norm of the masked gradient
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                           for key, v in jgrads.items()
                           if _torch_name(key) not in frozen))
    scale = min(1.0, t.config.grad_clip_norm / norm)
    lr = jax_steps["lrs"][k]
    assert t._step_schedule(k) == pytest.approx(lr)
    names = {_torch_name(key): key for key in jgrads}
    state = {n: t.optimizer.state[p] for n, p in t.model.named_parameters()}
    moments = {m: flatten_params(params_from_state_dict(
        {n: s[m] for n, s in state.items()})) for m in ("exp_avg", "exp_avg_sq")}
    for name, key in names.items():
        w = jgrads[key]
        tol = 1e-3 * float(np.abs(w).max()) + 1e-5 * gmax
        np.testing.assert_allclose(grads[key], w, rtol=0, atol=tol + spread[key],
                                   err_msg=key)
        s = state[name]
        assert float(s["step"]) == k + 1, name
        if name in frozen and not live:
            np.testing.assert_array_equal(after[key], before[key], err_msg=key)
            assert not moments["exp_avg"][key].any(), name
            assert not moments["exp_avg_sq"][key].any(), name
            continue
        # (new - old) of fp32 parameters is a multiple of their spacing,
        # which exceeds 2% of the warmup's rate of 1e-5 where |p| > 0.17
        upd_t, upd_j = after[key] - before[key], jnew[key] - jold[key]
        diff = np.abs(upd_t - upd_j) - np.spacing(np.abs(before[key]))
        solid = np.abs(w) * scale > 1e-3
        assert np.all(diff[solid] <= 0.02 * lr), (key, diff.max(), lr)
        assert np.all(diff <= 2.05 * lr), (key, diff.max(), lr)
        gbound = (float(np.abs(w).max()) + tol) * scale
        np.testing.assert_allclose(moments["exp_avg"][key], mu[key], rtol=0,
                                   atol=0.1 * tol * scale * (k + 1), err_msg=key)
        np.testing.assert_allclose(moments["exp_avg_sq"][key], nu[key], rtol=0,
                                   atol=2e-3 * gbound * tol * scale * (k + 1),
                                   err_msg=key)


def test_steps_across_the_unfreeze_match_the_optax_steps(jax_steps):
    t = _port_trainer()
    assert t.train_aug_cfg.deep_supervision_scales == jax_steps["scales"]
    state0 = jax_steps["states"][0]["params"]
    t.model.load_state_dict(convert_params(state0, t.model))
    data, seg = _batch(0)
    for k in range(2):
        spread = {}
        _check_step(t, jax_steps, k, spread, *_port_step(t, data, seg, spread))
    assert t.step == 2


def test_frozen_checkpoints_continue_with_the_same_step(jax_steps, folders):
    """The port's checkpoint after the frozen step continues bit for bit as
    the trainer that wrote it. The JAX package's loads optax's count and
    moments as every parameter's step count and moments, and the update
    from them, given the JAX step's own gradients, is the JAX update to 2%
    of lr (and the parameters' spacing)."""
    data, seg = _batch(0)
    t = _port_trainer()
    t.model.load_state_dict(convert_params(jax_steps["states"][0]["params"],
                                           t.model))
    _port_step(t, data, seg)
    path = str(folders / "port_frozen_step.pth")
    t.save_checkpoint(path)
    resumed = _port_trainer()
    resumed.load_checkpoint(path)
    assert resumed.step == 1
    _, _, want = _port_step(t, data, seg)
    _, _, got = _port_step(resumed, data, seg)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)

    from_jax = _port_trainer()
    from_jax.load_checkpoint(jax_steps["path"])
    assert from_jax.step == 1
    model = from_jax.model
    adam = jax_steps["states"][1]["opt_state"][1][0]
    mu, nu = convert_params(adam.mu, model), convert_params(adam.nu, model)
    jgrads = convert_params(jax_steps["grads"][1], model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        s = from_jax.optimizer.state[p]
        assert float(s["step"]) == 1.0, n
        torch.testing.assert_close(s["exp_avg"], mu[n], rtol=0, atol=0)
        torch.testing.assert_close(s["exp_avg_sq"], nu[n], rtol=0, atol=0)
        p.grad = jgrads[n].clone()
    from_jax.apply_gradients()
    lr = jax_steps["lrs"][1]
    want = convert_params(jax_steps["states"][2]["params"], model)
    for n, p in model.named_parameters():
        diff = ((p.detach() - before[n]) - (want[n] - before[n])).abs() - \
            torch.from_numpy(np.spacing(before[n].abs().numpy()))
        assert float(diff.max()) <= 0.02 * lr, (n, float(diff.max()), lr)
        assert float(from_jax.optimizer.state[p]["step"]) == 2.0, n
