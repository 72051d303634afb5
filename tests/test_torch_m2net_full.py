"""M2Net (``nnUNetTrainerM2Net``) of the port against the JAX package's.

The parts that M2NetP does not have, at M2Net's widths on small maps, with
converted parameters: the stage-4 MU (``MU(256, 128, 256, 4)``), the RSU4F of
stages 5 and 6 (512 -> 256 -> 512), PatchMerging2D to twice its width, and
PatchExpand(512) with the skip concatenated and mapped back by
``concat_back_dim4d``; fp32 on the CPU on both sides, rtol 1e-4 with atol
1e-4 times the output's largest magnitude (``test_torch_blocks.py``'s limits).
``convert_params`` maps every key of M2Net's flax tree (``jax.eval_shape``:
no compile, no JAX forward), the port's seven outputs have the JAX model's
shapes, and at 256x224 a forward makes 80 scans at the (L, K*Dh) pairs of
M2Net's four stage widths. The builder picks M2Net for its two trainer
names, and an M2Net fold trains, loads its checkpoint to continue and
predicts on the CPU (the port's seven outputs have the JAX model's shapes
on the meta device). The whole M2Net at full depth against the JAX model at 64x64,
held to the port's own conditioning as M2NetP's is, is marked slow.
"""

import collections
import os
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.models import u2net as ju2net  # noqa: E402
from nnuzoo_tpu.models import vssm as jvssm  # noqa: E402
from nnuzoo_tpu.models.layers import pad_to_match as jpad_to_match  # noqa: E402
from nnuzoo_tpu.models.m2net import M2Net as JaxM2Net  # noqa: E402
from nnuzoo_tpu_torch.convert import convert_params  # noqa: E402
from nnuzoo_tpu_torch.models import m2net as tm2net  # noqa: E402
from nnuzoo_tpu_torch.models import u2net as tu2net  # noqa: E402
from nnuzoo_tpu_torch.models import vssm as tvssm  # noqa: E402
from nnuzoo_tpu_torch.models.registry import get_model_builder  # noqa: E402
from nnuzoo_tpu_torch.models.ss2d import SS2D  # noqa: E402
from nnuzoo_tpu_torch.ops import selective_scan as tscan  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402

from .test_torch_blocks import _compare, _x  # noqa: E402
from .torch_port_helpers import load_converted, random_flax_params  # noqa: E402

NC = 3


def test_stage4_mu_matches_jax():
    """Four VSS layers of d_model 128 (K*Dh = 1024, dt rank 8) at 16x16."""
    _compare(jvssm.MU(256, 128, 256, 4), tvssm.MU(256, 128, 256, 4),
             _x(20, 1, 16, 16, 256), train=False)


def test_rsu4f_at_stage5_width_matches_jax():
    _compare(ju2net.RSU4F(256, 512), tu2net.RSU4F(512, 256, 512),
             _x(21, 1, 8, 7, 512))


def test_patch_merging_to_twice_the_width_matches_jax():
    _compare(jvssm.PatchMerging2D(128, 2), tvssm.PatchMerging2D(128, 2),
             _x(22, 2, 8, 6, 128))


class _JaxUp4(fnn.Module):
    """M2Net's decoder entry at stage 4: PatchExpand(512), the skip
    concatenated, ``concat_back_dim4d``."""

    @fnn.compact
    def __call__(self, x, skip):
        up = jvssm.PatchExpand(512, 2, name="patch_expand4d")(x)
        return fnn.Dense(256, name="concat_back_dim4d")(
            jnp.concatenate([jpad_to_match(up, skip.shape[1:-1]), skip], -1))


class _Up4(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.patch_expand4d = tvssm.PatchExpand(512, 2)
        self.concat_back_dim4d = torch.nn.Linear(512, 256)

    def forward(self, x, skip):
        return self.concat_back_dim4d(tm2net._cat_skip(self.patch_expand4d(x),
                                                       skip))


def test_patch_expand_and_concat_back_dim_match_jax():
    """An odd skip (9x7 under a 4x3 map) pads the expanded map first."""
    x, skip = _x(23, 2, 4, 3, 512), _x(24, 2, 9, 7, 256)
    jmod = _JaxUp4()
    params = random_flax_params(jmod, jnp.asarray(x), jnp.asarray(skip))
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(skip)))
    got = load_converted(_Up4(), params)(torch.from_numpy(x),
                                         torch.from_numpy(skip))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def jax_params():
    """Seeded numpy values in M2Net's flax tree (shapes by ``eval_shape``)."""
    return random_flax_params(JaxM2Net(num_classes=NC), jnp.zeros((1, 64, 64, 1)),
                              seed=7, train=False)


def test_converter_maps_every_m2net_key(jax_params):
    with torch.device("meta"):
        model = tm2net.M2Net(1, NC)
    sd = convert_params(jax_params, model)
    target = model.state_dict()
    assert set(sd) == set(target) and len(sd) == len(target)
    assert all(sd[k].shape == v.shape for k, v in target.items())
    inner = jax_params["params"]
    np.testing.assert_array_equal(
        sd["concat_back_dim4d.weight"].numpy(),
        np.asarray(inner["concat_back_dim4d"]["kernel"]).T)
    assert sd["concat_back_dim1d.weight"].shape == (32, 64)
    assert sd["stage5d.rebnconvin.conv.weight"].shape == (512, 1024, 3, 3)
    assert sd["patch_merging4.reduction.weight"].shape == (512, 1024)
    key = "stage4.vssm_encoder.layer0.block0.self_attention."
    assert sd[key + "x_proj_weight"].shape == (4, 8 + 32, 256)
    assert sd[key + "A_logs"].shape == (4 * 256, 16)


def test_output_shapes_match_jax_at_64x64(jax_params):
    x = np.random.RandomState(8).randn(1, 64, 64, 1).astype(np.float32)
    want = jax.eval_shape(
        lambda p, v: JaxM2Net(num_classes=NC).apply(p, v, train=False),
        jax_params, jnp.asarray(x))
    with torch.device("meta"):
        model = tm2net.M2Net(1, NC).eval()
        got = model(torch.from_numpy(x).to("meta"))
    assert [tuple(o.shape) for o in got] == [w.shape for w in want]
    assert [tuple(o.shape[1:3]) for o in got] == [
        (64, 64), (64, 64), (32, 32), (16, 16), (8, 8), (4, 4), (2, 2)]


def test_full_size_forward_runs_80_scans_at_the_path_lengths(monkeypatch):
    """Full depth at 256x224 on the meta device (shapes only): one forward
    makes 80 SS2D calls at the (L, K*Dh) pairs of M2Net's stages, d_model
    16/32/64/128 (K*Dh = 8*d_model), each stage with its decoder twin."""
    monkeypatch.setattr(tscan, "scan_core_plain",
                        lambda u, *args, **kw: torch.empty_like(u))
    with torch.device("meta"):
        model = tm2net.M2Net(1, NC, deep_supervision=False)
    pairs = []
    for mod in model.modules():
        if isinstance(mod, SS2D):
            mod.register_forward_pre_hook(
                lambda m, args: pairs.append(
                    (args[0].shape[1] * args[0].shape[2], 4 * m.d_inner)))
    with torch.no_grad():
        out = model(torch.empty(4, 256, 224, 1, device="meta"))
    assert out[0].shape == (4, 256, 224, NC)
    assert collections.Counter(pairs) == {
        (57344, 128): 4, (14336, 128): 4, (3584, 128): 4, (896, 128): 4,
        (224, 128): 4, (56, 128): 6,
        (14336, 256): 4, (3584, 256): 4, (896, 256): 4, (224, 256): 4,
        (56, 256): 6,
        (3584, 512): 4, (896, 512): 4, (224, 512): 4, (56, 512): 6,
        (896, 1024): 4, (224, 1024): 4, (56, 1024): 6}


def test_builder_picks_m2net_for_its_trainer_names():
    pm = PlansManager({
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "configurations": {"2d": {"patch_size": [32, 32], "spacing": [1.0, 1.0]}}})
    dj = {"channel_names": {"0": "MRI"},
          "labels": {"background": 0, "organ": 1, "tumor": 2}}
    cfg = pm.get_configuration("2d")
    built = {}
    for name in ("nnUNetTrainerM2Net", "nnUNetTrainerFineTuneDecoderWarmUp",
                 "nnUNetTrainerM2NetP"):
        built[name] = get_model_builder(name)(pm, dj, cfg, 1, device="cpu", seed=0)
    assert type(built["nnUNetTrainerM2Net"]) is tm2net.M2Net
    assert type(built["nnUNetTrainerFineTuneDecoderWarmUp"]) is tm2net.M2Net
    assert type(built["nnUNetTrainerM2NetP"]) is tm2net.M2NetP
    a, b = (built[n].state_dict() for n in ("nnUNetTrainerM2Net",
                                            "nnUNetTrainerFineTuneDecoderWarmUp"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="stage_layers"):
        get_model_builder("nnUNetTrainerM2Net")(pm, dj, cfg, 1, device="cpu",
                                                stage_layers=(1, 1, 1, 1))


def test_an_m2net_fold_trains_continues_and_predicts(tmp_path, monkeypatch):
    """``nnUNetTrainerM2Net`` on ``chip_smoke.py``'s seeded preprocessed
    dataset (3 cases of 2x80x80) and plans cut to a 32x32 patch at batch 2:
    one step and one validation step, the checkpoint loaded to continue
    (weights, step and moments), and the predictor that the folder's
    ``plans.json`` and trainer name set up predicts a volume."""
    import chip_smoke
    from nnuzoo_tpu_torch.inference.predictor import Predictor
    from nnuzoo_tpu_torch.training.trainer import Trainer
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "pp"))
    monkeypatch.setenv("nnUNet_results", str(tmp_path / "res"))
    plans, dataset_json = chip_smoke.plans_and_dataset()
    plans["configurations"]["2d"].update(patch_size=[32, 32], batch_size=2)
    chip_smoke.write_dataset(str(tmp_path / "pp" / plans["dataset_name"] /
                                 "nnUNetPlans_2d"), shape=(2, 80, 80))
    name = "nnUNetTrainerM2Net"

    def trainer(seed):
        t = Trainer(plans, "2d", "all", dataset_json, trainer_name=name,
                    device="cpu", seed=seed)
        t.config = replace(t.config, num_epochs=1, num_iterations_per_epoch=1,
                           num_val_iterations_per_epoch=1)
        return t

    trained = trainer(0)
    trained.run_training()
    assert type(trained.model) is tm2net.M2Net and trained.step == 1
    assert np.isfinite(trained.logger.my_fantastic_logging["train_losses"]).all()
    resumed = trainer(1)
    resumed.load_checkpoint(os.path.join(trained.output_folder,
                                         "checkpoint_final.pth"))
    assert resumed.step == 1 and resumed.current_epoch == 1 and all(
        torch.equal(resumed.model.state_dict()[k], v)
        for k, v in trained.model.state_dict().items())
    assert all(int(s["step"]) == 1
               for s in resumed.optimizer.state_dict()["state"].values())

    pred = Predictor(tile_batch_size=2, use_mirroring=False, device="cpu")
    pred.initialize_from_trained_model_folder(trained.output_folder_base,
                                              use_folds=["all"])
    assert pred.trainer_name == name and type(pred.model) is tm2net.M2Net
    volume = (100 * np.random.RandomState(0).rand(1, 2, 36, 34)).astype(np.float32)
    seg = pred.predict_single_npy_array(volume, {"spacing": [1.0, 1.0, 1.0]})
    assert seg.shape == volume.shape[1:] and set(np.unique(seg)) <= {0, 1, 2}


@pytest.mark.slow
def test_m2net_full_depth_matches_jax(jax_params):
    """The whole M2Net at 64x64 against the JAX model, held (as M2NetP's
    full-depth test is) to the change that a relative nudge of 1e-6 of the
    input makes in the port itself, plus 1e-5. Marked slow: about a minute
    on an 8-core CPU host, most of it XLA's compile of the JAX forward."""
    x = np.random.RandomState(9).randn(1, 64, 64, 1).astype(np.float32)
    jmodel = JaxM2Net(num_classes=NC)
    want = jax.jit(lambda p, v: jmodel.apply(p, v, train=False))(
        jax_params, jnp.asarray(x))
    tmodel = load_converted(tm2net.M2Net(1, NC), jax_params)
    noise = np.random.RandomState(10).randn(*x.shape)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
        nudged = tmodel(torch.from_numpy((x * (1 + 1e-6 * noise)).astype(np.float32)))
    for i, (g, w, n) in enumerate(zip(got, want, nudged)):
        floor = float((g - n).abs().max())
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        assert err <= floor + 1e-5, (f"d{i}", err, floor)
