"""The nnU-Net cascade (``3d_lowres`` -> ``3d_cascade_fullres``) in the port
against the JAX package, on the CPU.

Augmentation at 2d 32x32 and 3d 16^3: the cascade move (the previous stage's
segmentation as one-hot input channels) exactly, with and without regions;
the ball footprint, dilate, erode, close and open at fixed radii bit for bit;
the removal of the component of a given seed voxel bit for bit against the
JAX function and against ``scipy.ndimage.label`` (full 3^d structure); the
channel loop of the morphology against the JAX loop at given orders,
operations and radii; the noise's gates (p=0.4, p=0.2), its random channel
order and its one-hot invariant over seeded draws.

The Trainer on PlainConvUNet of three stages of 4-16 features: one cascaded
3d SGD step against the JAX trainer's optax step (by
``tests/test_torch_cnn_trainer.py``'s rules: loss 1e-5, each gradient and
update 1e-3 of its own max); on a planned raw dataset (four 24x20x16 cases,
widths cut to 4-8), the ``fold all`` final validation of ``3d_lowres``, whose
``predicted_next_stage`` files must equal the JAX package's, and the
cascaded stage's final validation, whose logits must be the JAX
``Predictor``'s on the same one-hot input to 1e-3 of their range (the JAX
package's own cascaded validation fails on its shapes). Then the command
line trains both stages, predicts with ``-prev_stage_predictions`` and
scores the result.
"""

import copy
import functools
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from scipy import ndimage  # noqa: E402

from nnuzoo_tpu.data import augment as ja  # noqa: E402
from nnuzoo_tpu.models import dynamic_unet as jdyn  # noqa: E402
from nnuzoo_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from nnuzoo_tpu_torch.cli.entry_points import main  # noqa: E402
from nnuzoo_tpu_torch.convert import (convert_params, flatten_params,  # noqa: E402
                                      params_from_state_dict)
from nnuzoo_tpu_torch.data import augment as ta  # noqa: E402
from nnuzoo_tpu_torch.inference import predictor as tpredictor  # noqa: E402
from nnuzoo_tpu_torch.planning import api as torch_api  # noqa: E402
from nnuzoo_tpu_torch.planning.plans_editing import add_lowres_and_cascade  # noqa: E402
from nnuzoo_tpu_torch.training import trainer as ttrainer  # noqa: E402
from nnuzoo_tpu_torch.training.trainer import Trainer  # noqa: E402
from nnuzoo_tpu_torch.utilities.io import load_json, save_json  # noqa: E402

from .helpers import set_paths  # noqa: E402
from .test_torch_cnn_cli import DATASET as RAW_DATASET  # noqa: E402
from .test_torch_cnn_cli import _write_raw_dataset  # noqa: E402
from .test_torch_cnn_trainer import DATASET, _compare, _plans  # noqa: E402
from .test_torch_dynamic_unet import ARCH_3D  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402

PATCHES = {2: (32, 32), 3: (16, 16, 16)}
RADII = (1.0, 2.5, 4.0, 7.5)


def _configs(dim, **kwargs):
    patch = PATCHES[dim]
    common = dict(patch_size=patch, initial_patch_size=patch, rotation=0.0,
                  is_cascaded=True, foreground_labels=(1, 2), **kwargs)
    return ja.AugmentConfig(**common), ta.AugmentConfig(**common)


def _cascade_batch(dim, seed=0, batch=2):
    """data (B, 1, *patch), seg (B, 2, *patch) int16: the target with an
    ignored (-1) border, and the previous stage's labels 0-2 with the -1 of
    the sampler's padding in one corner."""
    rng = np.random.RandomState(seed)
    patch = PATCHES[dim]
    data = rng.randn(batch, 1, *patch).astype(np.float32)
    seg = rng.randint(0, 3, (batch, 2, *patch)).astype(np.int16)
    seg[(slice(None), 0) + (slice(0, 2),) * dim] = -1
    seg[(slice(None), 1) + (slice(-3, None),) * dim] = -1
    return data, seg


# ------------------------------------------------------------- cascade move
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("regions", [None, ((1, 2), (2,))])
def test_cascade_move_matches_jax(dim, regions):
    """prepare_val_batch of a cascaded configuration: the data gains one
    channel per foreground label, the targets keep seg channel 0 (RemoveLabel,
    regions, deep supervision); exact."""
    scales = ((1.0,) * dim, (0.5,) * dim)
    jcfg, tcfg = _configs(dim, regions=regions, deep_supervision_scales=scales)
    data, seg = _cascade_batch(dim)
    jd, jt = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(seg))
    td, tt = ta.prepare_val_batch(tcfg, torch.from_numpy(data), torch.from_numpy(seg))
    assert td.shape == (2, 3, *PATCHES[dim])
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert len(tt) == len(jt) == 2
    for got, want in zip(tt, jt):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (td[:, 1:].sum(1) <= 1).all()


# ------------------------------------------------------------- morphology
@pytest.mark.parametrize("dim", [2, 3])
def test_ball_morphology_matches_jax_bit_for_bit(dim):
    rng = np.random.RandomState(dim)
    x = (rng.rand(*PATCHES[dim]) > 0.6).astype(np.float32)
    for r in RADII:
        kernel = ja._ball_mask(r, 8, dim)
        np.testing.assert_array_equal(
            ta.ball_mask(torch.tensor([r]), 8, dim)[0].numpy(), np.asarray(kernel))
        ops = (lambda v: ja._dilate(v, kernel), lambda v: ja._erode(v, kernel),
               lambda v: ja._erode(ja._dilate(v, kernel), kernel),
               lambda v: ja._dilate(ja._erode(v, kernel), kernel))
        for op, fn in enumerate(ops):
            want = np.asarray(fn(jnp.asarray(x)))
            got = ta.binary_operation_apply(torch.from_numpy(x)[None],
                                            torch.tensor([op]), torch.tensor([r]),
                                            8)[0]
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"r={r} op={op}")
    # a batch of volumes, each with its own radius and operation
    xs = torch.from_numpy(np.stack([x, 1 - x, x]))
    got = ta.binary_operation_apply(xs, torch.tensor([0, 3, 2]),
                                    torch.tensor([2.5, 1.0, 7.5]), 8)
    for i, (op, r) in enumerate(((0, 2.5), (3, 1.0), (2, 7.5))):
        one = ta.binary_operation_apply(xs[i:i + 1], torch.tensor([op]),
                                        torch.tensor([r]), 8)
        assert torch.equal(got[i:i + 1], one)


def _components(dim):
    """A 0/1 volume with small components (two of them touching only at a
    corner) and one above 15% of the patch."""
    x = np.zeros(PATCHES[dim], np.float32)
    x[(slice(1, 3),) * dim] = 1
    x[(slice(3, 5),) * dim] = 1          # touches the first at a corner
    x[(slice(6, 8),) * dim] = 1
    x[(slice(0, 1),) + (slice(12, 14),) * (dim - 1)] = 1
    if dim == 2:
        x[16:, 16:] = 1                   # 25% of the patch
    else:
        x[10:, :, :7] = 1                 # 16.4% of the patch
        x[12:14, 12:14, 13:15] = 1
    return x


@pytest.mark.parametrize("dim", [2, 3])
def test_remove_component_matches_jax_and_scipy(dim):
    """At the seed voxel of the JAX function's own categorical draw: the
    port's removal equals the JAX removal and the component that
    ``scipy.ndimage.label`` gives (3^d structure), removed only below 15%."""
    x = _components(dim)
    labels, _ = ndimage.label(x > 0, structure=np.ones((3,) * dim))
    flat = jnp.asarray(x).reshape(-1)
    remove = jax.jit(ja._remove_random_component)
    outcomes = set()
    for seed in range(48):
        key = jax.random.PRNGKey(seed)
        idx = int(jax.random.categorical(key, jnp.where(flat > 0, 0.0, -jnp.inf)))
        want = np.asarray(remove(key, jnp.asarray(x)))
        comp = labels == labels.reshape(-1)[idx]
        expect = np.where(comp, 0.0, x) if comp.sum() < 0.15 * x.size else x
        np.testing.assert_array_equal(want, expect)
        for every in (1, 8):
            got = ta.remove_component_apply(torch.from_numpy(x)[None],
                                            torch.tensor([idx]), check_every=every)
            np.testing.assert_array_equal(got[0].numpy(), want)
        outcomes.add(int(want.sum()))
    # the large component (kept) and small ones (removed) were hit
    assert x.sum() in outcomes and min(outcomes) < x.sum()
    empty = torch.zeros(1, *PATCHES[dim])
    assert torch.equal(ta.remove_component_apply(empty, torch.tensor([5])), empty)


def test_remove_component_is_exact_along_a_long_path():
    """A serpentine component of geodesic length ~1100 is removed whole,
    whatever the number of dilations between the host's looks."""
    x = np.zeros((96, 96), np.float32)
    for i, row in enumerate(range(1, 95, 8)):
        x[row, 1:95] = 1
        if row + 8 < 96:
            x[row:row + 9, 94 if i % 2 == 0 else 1] = 1
    assert x.sum() < 0.15 * x.size
    for every in (1, 8, 64):
        out = ta.remove_component_apply(torch.from_numpy(x)[None],
                                        torch.tensor([1 * 96 + 1]), check_every=every)
        assert out.sum() == 0


def _jax_channel_loop(onehot, perm, op, radius):
    """The JAX package's morphology loop (``_cascade_onehot_noise``'s
    ``per_channel``) at given channel orders, operations and radii, on its
    own ``_ball_mask``, ``_dilate`` and ``_erode``."""
    out = []
    for b in range(onehot.shape[0]):
        oh = jnp.asarray(onehot[b])
        for j in range(oh.shape[0]):
            c = int(perm[b, j])
            kernel = ja._ball_mask(float(radius[b, j]), 8, oh.ndim - 1)
            workon = oh[c]
            fn = (lambda v: ja._dilate(v, kernel), lambda v: ja._erode(v, kernel),
                  lambda v: ja._erode(ja._dilate(v, kernel), kernel),
                  lambda v: ja._dilate(ja._erode(v, kernel), kernel))[int(op[b, j])]
            res = jnp.where(jnp.sum(workon) > 0, fn(workon), workon)
            added = ((res - workon) > 0).astype(oh.dtype)
            oh = (oh * (1.0 - added[None])).at[c].set(res)
        out.append(np.asarray(oh))
    return np.stack(out)


@pytest.mark.parametrize("dim", [2, 3])
def test_channel_loop_matches_jax(dim):
    rng = np.random.RandomState(7)
    prev = rng.randint(0, 4, (2, *PATCHES[dim]))
    prev = ndimage.median_filter(prev, size=(1,) + (3,) * dim)   # some blobs
    onehot = np.stack([(prev == label) for label in (1, 2, 3)], 1).astype(np.float32)
    onehot[1, 2] = 0                                      # an empty channel
    perm = np.array([[2, 0, 1], [1, 2, 0]])
    op = np.array([[0, 3, 1], [2, 0, 3]])
    radius = np.array([[2.5, 1.0, 3.0], [1.5, 4.0, 2.0]], np.float32)
    want = _jax_channel_loop(onehot, perm, op, radius)
    got = ta.binary_operations_apply(torch.from_numpy(onehot), torch.from_numpy(perm),
                                     torch.from_numpy(op), torch.from_numpy(radius), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(1) <= 1).all()


def test_noise_gates_order_and_onehot_invariant(monkeypatch):
    """Over 600 seeded samples: the morphology runs on about 40% of them and
    the component removal on about 20% (each within 4.5 standard
    deviations), every order of the three channels comes up about as often,
    a sample that neither gate picks is untouched, and every output is
    one-hot (0/1, channels disjoint)."""
    calls = {"ops": [], "cc": []}
    ops_fn, cc_fn = ta.binary_operations_apply, ta.remove_component_apply

    def spy_ops(onehot, perm, *args):
        calls["ops"].append(perm.clone())
        return ops_fn(onehot, perm, *args)

    def spy_cc(x, seed, *args, **kwargs):
        calls["cc"].append(x.shape[0])
        return cc_fn(x, seed, *args, **kwargs)

    monkeypatch.setattr(ta, "binary_operations_apply", spy_ops)
    monkeypatch.setattr(ta, "remove_component_apply", spy_cc)
    n, shape = 600, (12, 12)
    rng = np.random.RandomState(3)
    prev = ndimage.median_filter(rng.randint(0, 4, (n, *shape)), size=(1, 3, 3))
    onehot = torch.from_numpy(
        np.stack([(prev == label) for label in (1, 2, 3)], 1).astype(np.float32))
    _, cfg = _configs(2)
    cfg = replace(cfg, patch_size=shape, initial_patch_size=shape,
                  foreground_labels=(1, 2, 3))
    out = ta.cascade_onehot_noise(cfg, torch.Generator().manual_seed(0), onehot)
    again = ta.cascade_onehot_noise(cfg, torch.Generator().manual_seed(0), onehot)
    assert torch.equal(out, again)
    (perm,), (n_cc,) = calls["ops"][:1], calls["cc"][:1]
    for count, p in ((perm.shape[0], 0.4), (n_cc // 3, 0.2)):
        assert abs(count - n * p) < 4.5 * np.sqrt(n * p * (1 - p)), (count, p)
    orders = {}
    for row in perm.tolist():
        orders[tuple(row)] = orders.get(tuple(row), 0) + 1
    assert len(orders) == 6 and min(orders.values()) > perm.shape[0] / 6 / 2
    assert set(torch.unique(out).tolist()) <= {0.0, 1.0}
    assert (out.sum(1) <= 1).all()
    changed = (out != onehot).flatten(1).any(1)
    assert perm.shape[0] + n_cc // 3 >= int(changed.sum()) > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_augment_train_batch_moves_and_noises_the_previous_stage(dim):
    """The training path: (B, C + F) data whose one-hot channels are 0/1 and
    disjoint, one target channel, the same result for the same generator;
    with both noise gates closed the one-hot channels are the move of the
    transformed previous-stage segmentation."""
    data, seg = _cascade_batch(dim, batch=3)
    _, cfg = _configs(dim, p_rotation=0.0, p_scaling=0.0, mirror_axes=())
    run = functools.partial(ta.augment_train_batch, cfg)
    d, targets = run(torch.Generator().manual_seed(1), torch.from_numpy(data),
                     torch.from_numpy(seg))
    d2, _ = run(torch.Generator().manual_seed(1), torch.from_numpy(data),
                torch.from_numpy(seg))
    assert torch.equal(d, d2) and d.shape == (3, 3, *PATCHES[dim])
    assert targets[0].shape == (3, 1, *PATCHES[dim])
    assert set(torch.unique(d[:, 1:]).tolist()) <= {0.0, 1.0}
    assert (d[:, 1:].sum(1) <= 1).all()
    closed = replace(cfg, p_cascade_binary_op=0.0, p_cascade_remove_component=0.0)
    d, _ = ta.augment_train_batch(closed, torch.Generator().manual_seed(1),
                                  torch.from_numpy(data), torch.from_numpy(seg))
    want = np.stack([(seg[:, 1] == label) for label in (1, 2)], 1)
    np.testing.assert_array_equal(d[:, 1:].numpy(), want.astype(np.float32))


def test_sampler_pads_the_previous_stage_with_minus_one(tmp_path):
    """The previous stage's segmentation (uint8, stored without a channel
    axis) is cropped and padded with -1 as the second target channel; the
    JAX sampler's copy, on the same draws, pads a uint8 array with -1, which
    numpy wraps to 255 (and newer numpy refuses), so its one-hot channels
    are the same."""
    from nnuzoo_tpu.data.dataset import DatasetNumpy as JaxDataset
    from nnuzoo_tpu.data.patch_sampler import PatchSampler as JaxSampler
    from nnuzoo_tpu.plans.label_handling import LabelManager as JaxLabels
    from nnuzoo_tpu_torch.data.dataset import DatasetNumpy
    from nnuzoo_tpu_torch.data.patch_sampler import PatchSampler
    from nnuzoo_tpu_torch.plans.label_handling import LabelManager

    rng = np.random.RandomState(0)
    data_dir, prev_dir = tmp_path / "data", tmp_path / "prev"
    data_dir.mkdir()
    prev_dir.mkdir()
    labels = {"background": 0, "organ": 1, "tumor": 2}
    for i in range(2):
        seg = rng.randint(0, 3, (1, 6, 10, 8)).astype(np.int8)
        locations = {c: np.argwhere(seg == c) for c in (1, 2)}
        DatasetNumpy.save_case(rng.randn(1, 6, 10, 8).astype(np.float32), seg,
                               {"class_locations": locations},
                               str(data_dir / f"c{i}"))
        np.savez_compressed(prev_dir / f"c{i}.npz",
                            seg=rng.randint(0, 3, (6, 10, 8)).astype(np.uint8))
    kwargs = dict(initial_patch_size=(8, 12, 12), final_patch_size=(8, 12, 12),
                  oversample_foreground_percent=0.5, seed=3)
    got = next(PatchSampler(DatasetNumpy(str(data_dir),
                                         folder_with_segs_from_previous_stage=
                                         str(prev_dir)), 2,
                            label_manager=LabelManager(labels, None), **kwargs))
    want = next(JaxSampler(JaxDataset(str(data_dir),
                                      folder_with_segs_from_previous_stage=
                                      str(prev_dir)), 2,
                           label_manager=JaxLabels(labels, None), **kwargs))
    assert got["target"].dtype == np.int16 and got["target"].shape[1] == 2
    assert (got["target"][:, 1] == -1).any()
    assert set(np.unique(got["target"][:, 1])) <= {-1, 0, 1, 2}
    np.testing.assert_array_equal(got["data"], want["data"])
    np.testing.assert_array_equal(got["target"][:, 0], want["target"][:, 0])
    for label in (1, 2):
        np.testing.assert_array_equal(got["target"][:, 1] == label,
                                      want["target"][:, 1] == label)


# ------------------------------------------------------------- the Trainer
def _cascade_plans():
    """``tests/test_torch_cnn_trainer.py``'s 3d plans with a lowres stage
    (next stage ``3d_cascade_fullres``) and the cascaded stage."""
    plans = _plans(3)
    full = plans["configurations"]["3d_fullres"]
    plans["configurations"]["3d_lowres"] = dict(
        copy.deepcopy(full), data_identifier="nnUNetPlans_3d_lowres",
        spacing=[2.0] * 3, batch_dice=False, next_stage="3d_cascade_fullres")
    plans["configurations"]["3d_cascade_fullres"] = {
        "inherits_from": "3d_fullres", "previous_stage": "3d_lowres"}
    return plans


@pytest.fixture
def folders(tmp_path, monkeypatch):
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pp"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))


def test_trainer_builds_the_cascade(folders):
    """The cascaded stage takes C + F input channels and augments with the
    cascade move; the lowres stage has a next stage; both build, and the
    converter carries a JAX PlainConvUNet of C + F input channels across and
    back."""
    plans = _cascade_plans()
    t = Trainer(plans, "3d_cascade_fullres", 0, DATASET, device="cpu", seed=0)
    t.initialize()
    assert t.num_input_channels == 3
    for cfg in (t.train_aug_cfg, t.val_aug_cfg):
        assert cfg.is_cascaded and cfg.foreground_labels == (1, 2)
    assert t._previous_stage_folder().endswith(
        os.path.join("predicted_next_stage", "3d_cascade_fullres"))
    params = random_flax_params(jdyn.PlainConvUNet(ARCH_3D, 3),
                                jnp.zeros((1, 8, 16, 16, 3)), seed=1)
    t.model.load_state_dict(convert_params(params, t.model))
    back = flatten_params(params_from_state_dict(t.model.state_dict()))
    for k, v in flatten_params(params["params"]).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    low = Trainer(plans, "3d_lowres", "all", DATASET, device="cpu", seed=0)
    assert low.configuration_manager.next_stage_names == ["3d_cascade_fullres"]
    assert low.num_input_channels == 1 and low._previous_stage_folder() is None
    low.initialize()
    assert not low.train_aug_cfg.is_cascaded


def test_cascaded_step_matches_the_optax_step(folders):
    """One SGD step of the cascaded stage on a batch moved by
    prepare_val_batch (no noise) on both sides: the loss, every gradient and
    every update as the JAX trainer's loss and optax chain give them."""
    plans = _cascade_plans()
    t = Trainer(plans, "3d_cascade_fullres", "all", DATASET, device="cpu", seed=0)
    t.initialize()
    jt = JaxTrainer(plans, "3d_cascade_fullres", "all", DATASET)
    scales = jt._get_deep_supervision_scales()
    assert t.train_aug_cfg.deep_supervision_scales == scales
    jmodel = jdyn.PlainConvUNet(ARCH_3D, 3)
    params = random_flax_params(jmodel, jnp.zeros((1, 8, 16, 16, 3)), seed=3)
    t.model.load_state_dict(convert_params(params, t.model))
    tx = jt._build_optimizer()
    rng = np.random.RandomState(0)
    data = rng.randn(2, 1, 8, 16, 16).astype(np.float32)
    seg = rng.randint(0, 3, (2, 2, 8, 16, 16)).astype(np.int16)
    seg[:, :, :4, :6, :6] = 1
    jcfg = ja.AugmentConfig(patch_size=(8, 16, 16), initial_patch_size=(8, 16, 16),
                            rotation=0.0, deep_supervision_scales=scales,
                            is_cascaded=True, foreground_labels=(1, 2))
    jd, jtargets = ja.prepare_val_batch(jcfg, jnp.asarray(data), jnp.asarray(seg))
    x = jnp.moveaxis(jd, 1, -1)

    @jax.jit
    def jstep(p):
        loss, grads = jax.value_and_grad(
            lambda q: jt._compute_loss(jmodel.apply(q, x), jtargets))(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates)

    jloss, jgrads, jnew = jstep(params)
    d, targets = ta.prepare_val_batch(t.train_aug_cfg, torch.from_numpy(data),
                                      torch.from_numpy(seg))
    assert d.shape[1] == 3
    before = flatten_params(params_from_state_dict(
        {k: v.clone() for k, v in t.model.state_dict().items()}))
    loss = t.loss_and_grads(d, targets)
    grads = flatten_params(params_from_state_dict(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in t.model.named_parameters()}))
    t.apply_gradients()
    after = flatten_params(params_from_state_dict(t.model.state_dict()))
    _compare((float(loss), grads, {k: after[k] - before[k] for k in after}),
             jloss, jgrads, params, jnew)


# ------------------------------------------------------------- planned dataset
def _plan_cascade(root):
    """The raw 24x20x16 dataset planned for 3d_fullres by the port's CLI,
    its widths cut to 4-8 features, then ``add_lowres_and_cascade`` and the
    lowres preprocessing."""
    raw, pp, res = set_paths(root)
    ds = _write_raw_dataset(raw)
    main(["plan_and_preprocess", "-d", "995", "-c", "3d_fullres", "-npfp", "2",
          "-np", "2"])
    plans_file = os.path.join(pp, RAW_DATASET, "nnUNetPlans.json")
    plans = load_json(plans_file)
    arch = plans["configurations"]["3d_fullres"]["architecture"]["arch_kwargs"]
    arch["features_per_stage"] = [min(4 * 2 ** i, 8)
                                  for i in range(arch["n_stages"])]
    save_json(plans, plans_file, sort_keys=False)
    add_lowres_and_cascade(995)
    main(["preprocess", "-d", "995", "-c", "3d_lowres", "-np", "2"])
    return ds, pp, res


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """The planned dataset, with the fingerprint sampling 1e6 foreground
    voxels, not 1e8, and trainers of one step an epoch."""
    mp = pytest.MonkeyPatch()
    for var in ("nnUNet_raw", "nnUNet_preprocessed", "nnUNet_results"):
        mp.setenv(var, os.environ.get(var, ""))

    class Extractor(torch_api.DatasetFingerprintExtractor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.num_foreground_voxels_for_intensitystats = 1e6

    mp.setattr(torch_api, "DatasetFingerprintExtractor", Extractor)
    short = functools.partial(replace, num_iterations_per_epoch=1,
                              num_val_iterations_per_epoch=1)
    get_config = ttrainer.get_trainer_config
    mp.setattr(ttrainer, "get_trainer_config", lambda n: short(get_config(n)))
    yield _plan_cascade(tmp_path_factory.mktemp("cascade"))
    mp.undo()


@pytest.fixture(scope="module")
def lowres_validated(planned):
    """The JAX trainer and the port's, both on the JAX trainer's initial
    weights of 3d_lowres ``fold all``, each through its final validation;
    the JAX package's ``predicted_next_stage`` files are kept apart."""
    ds, pp, res = planned
    base = os.path.join(pp, RAW_DATASET)
    plans = load_json(os.path.join(base, "nnUNetPlans.json"))
    dataset_json = load_json(os.path.join(base, "dataset.json"))
    jt = JaxTrainer(plans, "3d_lowres", "all", dataset_json)
    jt.initialize()
    jt.perform_actual_validation()
    next_stage = os.path.join(base, "predicted_next_stage", "3d_cascade_fullres")
    jax_files = os.path.join(res, "jax_next_stage")
    shutil.move(next_stage, jax_files)
    t = Trainer(plans, "3d_lowres", "all", dataset_json, device="cpu", seed=0)
    t.initialize()
    t.model.load_state_dict(convert_params(jt.state["params"], t.model))
    t.perform_actual_validation()
    return plans, dataset_json, jt.state["params"], next_stage, jax_files


def test_lowres_fold_all_writes_the_next_stage_inputs_of_the_jax_package(
        lowres_validated):
    """Every training case (``fold all`` validates them all) gets a
    ``predicted_next_stage/3d_cascade_fullres/<case>.npz`` at the 3d_fullres
    shape, equal to the JAX package's file."""
    plans, _, _, port_files, jax_files = lowres_validated
    names = sorted(os.listdir(port_files))
    assert names == sorted(os.listdir(jax_files)) == [
        f"case_{i:03d}.npz" for i in range(4)]
    full = os.path.join(os.path.dirname(os.path.dirname(port_files)),
                        plans["configurations"]["3d_fullres"]["data_identifier"])
    for name in names:
        got, want = (np.load(os.path.join(f, name))["seg"]
                     for f in (port_files, jax_files))
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == np.load(os.path.join(full, name))["data"].shape[1:]
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_cascaded_final_validation_matches_the_jax_predictor(lowres_validated,
                                                            monkeypatch):
    """The cascaded stage's final validation stacks the previous stage's
    prediction onto each case one-hot: its logits are the JAX Predictor's on
    that input (1e-3 of their range). The JAX trainer's own final validation
    of the same stage builds its dataset without the previous stage's folder
    and fails on the model's C + F input channels (``ROADMAP.md`` §3)."""
    from nnuzoo_tpu.inference.predictor import Predictor as JaxPredictor
    from nnuzoo_tpu.models.registry import get_model_builder as jax_builder
    from nnuzoo_tpu.plans.plans_handler import PlansManager as JaxPlansManager

    plans, dataset_json, _, _, _ = lowres_validated
    t = Trainer(plans, "3d_cascade_fullres", 0, dataset_json, device="cpu", seed=0)
    t.initialize()
    logits = []
    inner = tpredictor.Predictor.predict_sliding_window_return_logits

    def record(self, data, *args, **kwargs):
        out = inner(self, data, *args, **kwargs)
        logits.append((data, out))
        return out

    monkeypatch.setattr(tpredictor.Predictor, "predict_sliding_window_return_logits",
                        record)
    metrics = t.perform_actual_validation()
    assert np.isfinite(metrics["foreground_mean"]["Dice"])
    _, val_keys = t.do_split()
    assert len(logits) == len(val_keys) == 1
    data, got = logits[0]
    assert data.shape[0] == 3 and set(np.unique(data[1:])) <= {0.0, 1.0}

    pm = JaxPlansManager(plans)
    cm = pm.get_configuration("3d_cascade_fullres")
    jparams = params_from_state_dict(t.model.state_dict())
    predictor = JaxPredictor(tile_step_size=0.5, use_gaussian=True,
                             use_mirroring=True)
    predictor.manual_initialization(
        jax_builder("nnUNetTrainer")(pm, dataset_json, cm, 3, deep_supervision=False),
        [{"params": jparams}], pm, cm, dataset_json, "nnUNetTrainer",
        t.inference_allowed_mirroring_axes)
    want = predictor.predict_sliding_window_return_logits(data)
    scale = float(want.max() - want.min())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)

    jt = JaxTrainer(plans, "3d_cascade_fullres", 0, dataset_json)
    jt.initialize()
    with pytest.raises(Exception, match="shape"):
        jt.perform_actual_validation()


def test_cli_trains_and_predicts_the_cascade(tmp_path_factory, planned):
    """``train 995 3d_lowres all``, then ``train 995 3d_cascade_fullres 0``
    (one step an epoch, cascade noise on), ``predict`` with each stage, the
    second with ``-prev_stage_predictions``, and ``evaluate_folder``."""
    ds, pp, res = _plan_cascade(tmp_path_factory.mktemp("cascade_cli"))
    main(["train", "995", "3d_lowres", "all", "-num_epochs", "1", "-device", "cpu"])
    next_stage = os.path.join(pp, RAW_DATASET, "predicted_next_stage",
                              "3d_cascade_fullres")
    assert len(os.listdir(next_stage)) == 4
    main(["train", "995", "3d_cascade_fullres", "0", "-num_epochs", "1",
          "-device", "cpu"])
    folder = os.path.join(res, RAW_DATASET,
                          "nnUNetTrainer__nnUNetPlans__3d_cascade_fullres")
    summary = load_json(os.path.join(folder, "fold_0", "validation", "summary.json"))
    assert np.isfinite(summary["foreground_mean"]["Dice"])
    low, cascade = os.path.join(res, "low"), os.path.join(res, "cascade")
    main(["predict", "-i", os.path.join(ds, "imagesTr"), "-o", low, "-d", "995",
          "-c", "3d_lowres", "-f", "all", "-device", "cpu"])
    predictor = main(["predict", "-i", os.path.join(ds, "imagesTr"), "-o", cascade,
                      "-d", "995", "-c", "3d_cascade_fullres", "-f", "0",
                      "-prev_stage_predictions", low, "-device", "cpu"])
    assert predictor.forward_count > 0
    metrics = main(["evaluate_folder", os.path.join(ds, "labelsTr"), cascade,
                    "-djfile", os.path.join(folder, "dataset.json"),
                    "-pfile", os.path.join(folder, "plans.json"), "-np", "1"])
    assert len(metrics["metric_per_case"]) == 4
    assert np.isfinite(metrics["foreground_mean"]["Dice"])
