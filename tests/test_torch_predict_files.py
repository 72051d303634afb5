"""The port's prediction from files against the JAX package's.

Both ``Predictor.predict_from_files`` run on the same folder of two
``.nii.gz`` cases with the same weights (M2NetP at one layer per stage,
patch 32x32, mirror TTA off: ``test_torch_predictor.py`` holds the TTA):
the written segmentations are identical, the ``--save_probabilities``
``.npz`` agree to 1e-3 and the ``.pkl`` properties are equal;
``num_parts``/``part_id`` and ``overwrite=False`` pick the same cases; the
cascade input (a previous stage's segmentation, as a file or as the ``.npz``
the JAX trainer writes) preprocesses to the same array as JAX
``_preprocess_one``; ``predict_single_npy_array`` with that input and
``predict_from_list_of_npy_arrays`` give the JAX package's segmentations.
A case that fails raises in the caller.
"""

import os
import pickle
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.imageio.nifti import NiftiIO as JaxNiftiIO, write_nifti  # noqa: E402
from nnuzoo_tpu.inference.predictor import Predictor as JaxPredictor  # noqa: E402
from nnuzoo_tpu.models.m2net import M2NetP as JaxM2NetP  # noqa: E402
from nnuzoo_tpu.plans.plans_handler import PlansManager as JaxPlans  # noqa: E402
from nnuzoo_tpu.preprocessing.preprocessor import \
    DefaultPreprocessor as JaxPreprocessor  # noqa: E402
from nnuzoo_tpu_torch.convert import convert_params  # noqa: E402
from nnuzoo_tpu_torch.inference import predictor as tpredictor  # noqa: E402
from nnuzoo_tpu_torch.inference.predictor import Predictor  # noqa: E402
from nnuzoo_tpu_torch.models.m2net import M2NetP  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402
from nnuzoo_tpu_torch.preprocessing.preprocessor import \
    DefaultPreprocessor  # noqa: E402

from .test_torch_imageio import _assert_same  # noqa: E402
from .test_torch_predictor import DATASET, PATCH, PLANS, STAGES  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402

NAME = "nnUNetTrainerM2NetP"
CASES = {"case_a": (36, 40, 2), "case_b": (30, 44, 3)}      # on-disk (x, y, z)


def _pair(in_channels, seed):
    """A JAX and a port Predictor on the same random weights."""
    jmodel = JaxM2NetP(num_classes=3, deep_supervision=False, stage_layers=STAGES)
    params = random_flax_params(jmodel, jnp.zeros((1, *PATCH, in_channels)),
                                seed=seed, train=False)
    jpm, pm = JaxPlans(PLANS), PlansManager(PLANS)
    jp = JaxPredictor(use_mirroring=False, tile_batch_size=3)
    jp.manual_initialization(jmodel, [params], jpm, jpm.get_configuration("2d"),
                             DATASET, NAME, (0, 1))
    tmodel = M2NetP(in_channels, 3, deep_supervision=False, stage_layers=STAGES)
    tp = Predictor(use_mirroring=False, tile_batch_size=3, device="cpu")
    tp.manual_initialization(tmodel, [convert_params(params, tmodel)], pm,
                             pm.get_configuration("2d"), DATASET, NAME, (0, 1))
    return jp, tp


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict_files")
    folder = root / "imagesTs"
    folder.mkdir()
    rng = np.random.RandomState(0)
    for case, shape in CASES.items():
        vol = (rng.rand(*shape) * 100 + 5).astype(np.float32)
        vol[:2] = 0                                  # cropped away
        write_nifti(str(folder / f"{case}_0000.nii.gz"), vol,
                    spacing_xyz=(1.0, 1.0, 2.5))
    jp, tp = _pair(1, seed=3)
    return root, str(folder), jp, tp


def _files(folder):
    return sorted(f for f in os.listdir(folder) if not f.startswith("."))


def _read_seg(path):
    return JaxNiftiIO().read_seg(path)[0][0]


def test_written_files_match_jax(setup):
    root, folder, jp, tp = setup
    out_j, out_t = str(root / "out_jax"), str(root / "out_port")
    jp.predict_from_files(folder, out_j, save_probabilities=True)
    tp.predict_from_files(folder, out_t, save_probabilities=True)
    assert _files(out_t) == _files(out_j) == sorted(
        ["predict_from_raw_data_args.json"] +
        [c + e for c in CASES for e in (".nii.gz", ".npz", ".pkl")])
    assert open(f"{out_t}/predict_from_raw_data_args.json").read() == \
        open(f"{out_j}/predict_from_raw_data_args.json").read()
    for case, shape in CASES.items():
        got, want = _read_seg(f"{out_t}/{case}.nii.gz"), _read_seg(f"{out_j}/{case}.nii.gz")
        assert got.shape == shape[::-1]
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {0, 1, 2}
        p_got = np.load(f"{out_t}/{case}.npz")["probabilities"]
        p_want = np.load(f"{out_j}/{case}.npz")["probabilities"]
        assert p_got.shape == p_want.shape == (3, *shape[::-1])
        np.testing.assert_allclose(p_got, p_want, rtol=0, atol=1e-3)
        _assert_same(pickle.load(open(f"{out_t}/{case}.pkl", "rb")),
                     pickle.load(open(f"{out_j}/{case}.pkl", "rb")), case)
    times = tp.case_times
    assert sorted(times) == sorted(os.path.join(out_t, c) for c in CASES)
    for t in times.values():
        assert sorted(t) == ["device_s", "export_s", "preprocess_s", "read_s"]
        assert all(v >= 0 for v in t.values())


@pytest.mark.parametrize("part_id", [0, 1])
def test_parts_select_the_same_cases(setup, part_id):
    root, folder, jp, tp = setup
    out_j, out_t = str(root / f"part{part_id}_jax"), str(root / f"part{part_id}_port")
    jp.predict_from_files(folder, out_j, num_parts=2, part_id=part_id)
    tp.predict_from_files(folder, out_t, num_parts=2, part_id=part_id)
    assert _files(out_t) == _files(out_j)
    assert len(_files(out_t)) == 2           # one case and the args file
    for f in _files(out_t):
        if f.endswith(".nii.gz"):
            np.testing.assert_array_equal(_read_seg(f"{out_t}/{f}"),
                                          _read_seg(f"{out_j}/{f}"))


def test_no_overwrite_skips_the_same_cases(setup):
    root, folder, jp, tp = setup
    stale = np.zeros(CASES["case_a"][::-1], np.uint8)
    for pred, name in ((jp, "keep_jax"), (tp, "keep_port")):
        out = root / name
        out.mkdir()
        JaxNiftiIO().write_seg(stale, str(out / "case_a.nii.gz"), {"spacing": [1, 1, 1]})
        pred.predict_from_files(folder, str(out), overwrite=False)
    for name in ("keep_jax", "keep_port"):
        np.testing.assert_array_equal(_read_seg(str(root / name / "case_a.nii.gz")),
                                      stale)
    assert _files(root / "keep_port") == _files(root / "keep_jax")
    np.testing.assert_array_equal(_read_seg(str(root / "keep_port" / "case_b.nii.gz")),
                                  _read_seg(str(root / "keep_jax" / "case_b.nii.gz")))


def test_lists_of_files_and_outputs(setup):
    root, folder, jp, tp = setup
    lists = [[os.path.join(folder, "case_b_0000.nii.gz")]]
    outs_j, outs_t = [str(root / "list_jax" / "b")], [str(root / "list_port" / "b")]
    for d in ("list_jax", "list_port"):
        (root / d).mkdir()
    jp.predict_from_files(lists, outs_j)
    tp.predict_from_files(lists, outs_t)
    assert _files(root / "list_port") == _files(root / "list_jax") == \
        ["b.nii.gz", "predict_from_raw_data_args.json"]
    np.testing.assert_array_equal(_read_seg(outs_t[0] + ".nii.gz"),
                                  _read_seg(outs_j[0] + ".nii.gz"))


@pytest.fixture(scope="module")
def prev_stage(setup):
    """A previous stage's predictions: a segmentation file for case_a and the
    ``.npz`` in preprocessed geometry (what the JAX trainer exports for the
    next stage) for case_b."""
    root, folder, jp, _ = setup
    prev = root / "prev_stage"
    prev.mkdir()
    rng = np.random.RandomState(1)
    shape_a = CASES["case_a"][::-1]
    JaxNiftiIO().write_seg(rng.randint(0, 3, size=shape_a).astype(np.uint8),
                           str(prev / "case_a.nii.gz"), {"spacing": [2.5, 1.0, 1.0]})
    data_b, _, _ = JaxPreprocessor().run_case(
        [os.path.join(folder, "case_b_0000.nii.gz")], None, jp.plans_manager,
        jp.configuration_manager, DATASET)
    np.savez_compressed(str(prev / "case_b.npz"),
                        seg=rng.randint(0, 3, size=data_b.shape[1:]).astype(np.uint8))
    return str(prev)


@pytest.mark.parametrize("case", ["case_a", "case_b"])
def test_cascade_input_preprocesses_as_jax(setup, prev_stage, case):
    _, folder, jp, tp = setup
    files = [os.path.join(folder, f"{case}_0000.nii.gz")]
    want, _, want_props = jp._preprocess_one(JaxPreprocessor(), files, prev_stage)
    times = {}
    got, got_props = tp._preprocess_one(DefaultPreprocessor(), files, prev_stage,
                                        times)
    assert got.shape[0] == 3 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    _assert_same(got_props, want_props, "properties")
    assert sorted(times) == ["preprocess_s", "read_s"]


@pytest.mark.parametrize("with_seg", [False, True])
def test_run_case_matches_jax(setup, prev_stage, with_seg):
    """``DefaultPreprocessor.run_case`` reads a case (and a segmentation
    file) through the plans' reader into what JAX ``run_case`` gives, and
    times its two parts."""
    _, folder, jp, tp = setup
    files = [os.path.join(folder, "case_a_0000.nii.gz")]
    seg_file = os.path.join(prev_stage, "case_a.nii.gz") if with_seg else None
    want_data, want_seg, want_props = JaxPreprocessor().run_case(
        files, seg_file, jp.plans_manager, jp.configuration_manager, DATASET)
    times = {}
    got_data, got_seg, got_props = DefaultPreprocessor().run_case(
        files, seg_file, tp.plans_manager, tp.configuration_manager, DATASET, times)
    np.testing.assert_array_equal(got_data, want_data)
    if with_seg:
        assert got_seg.dtype == want_seg.dtype
        np.testing.assert_array_equal(got_seg, want_seg)
    else:
        assert got_seg is None
    _assert_same(got_props, want_props, "properties")
    assert sorted(times) == ["preprocess_s", "read_s"]


def test_preprocessing_runs_one_case_ahead(setup, tmp_path, monkeypatch):
    """While the device predicts case i, at most case i+1 has been handed
    to the preprocessing thread: host memory holds two preprocessed cases,
    not the whole folder's."""
    _, folder, _, tp = setup
    lists = [[os.path.join(folder, f"{c}_0000.nii.gz")] for c in CASES] * 2
    outs = [str(tmp_path / f"out{i}") for i in range(len(lists))]
    started, seen = [], []
    preprocess_one, predict = tp._preprocess_one, tp.predict_logits_from_preprocessed_data

    def counting_preprocess(*args):
        started.append(1)
        return preprocess_one(*args)

    def slow_predict(data):
        seen.append(len(started))
        time.sleep(0.2)                          # the preprocessing would run on
        return predict(data)

    monkeypatch.setattr(tp, "_preprocess_one", counting_preprocess)
    monkeypatch.setattr(tp, "predict_logits_from_preprocessed_data", slow_predict)
    tp.predict_from_files(lists, outs)
    assert len(started) == len(lists)
    assert all(n <= i + 2 for i, n in enumerate(seen)), seen
    assert all(os.path.isfile(o + ".nii.gz") for o in outs)


def test_cascade_prediction_from_an_array_matches_jax(setup, tmp_path):
    _, folder, _, _ = setup
    jp, tp = _pair(3, seed=4)                    # image + one-hot of labels 1, 2
    vol, props = JaxNiftiIO().read_images([os.path.join(folder, "case_a_0000.nii.gz")])
    seg_prev = np.random.RandomState(2).randint(0, 3, size=vol.shape[1:])
    want = jp.predict_single_npy_array(vol, dict(props), seg_prev)
    got = tp.predict_single_npy_array(vol, dict(props), seg_prev)
    np.testing.assert_array_equal(got, want)
    out = str(tmp_path / "cascade")
    assert tp.predict_single_npy_array(vol, dict(props), seg_prev, out) is None
    np.testing.assert_array_equal(_read_seg(out + ".nii.gz"), want)


def test_list_of_npy_arrays_matches_jax(setup, tmp_path):
    _, folder, jp, tp = setup
    images, props = [], []
    for case in CASES:
        v, p = JaxNiftiIO().read_images([os.path.join(folder, f"{case}_0000.nii.gz")])
        images.append(v)
        props.append(p)
    want = jp.predict_from_list_of_npy_arrays(images, None, props, None)
    got = tp.predict_from_list_of_npy_arrays(images, None, props, None)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    outs = [str(tmp_path / c) for c in CASES]
    assert tp.predict_from_list_of_npy_arrays(images, [None, None], props, outs) == \
        [None, None]
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(_read_seg(o + ".nii.gz"), w)


def test_a_failing_case_raises_in_the_caller(setup, tmp_path, monkeypatch):
    root, folder, _, tp = setup
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "broken_0000.nii.gz").write_bytes(b"not a nifti file")
    with pytest.raises(Exception):
        tp.predict_from_files(str(bad), str(tmp_path / "out_bad"))

    def failing_export(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(tpredictor, "export_prediction_from_logits", failing_export)
    with pytest.raises(OSError, match="disk full"):
        tp.predict_from_files(folder, str(tmp_path / "out_export"))


def test_resample_and_save_matches_jax(setup, tmp_path):
    """The next-stage export of a cascade: logits resampled to the next
    stage's shape, argmax, saved as ``.npz``."""
    from nnuzoo_tpu.inference.export import resample_and_save as jax_save
    from nnuzoo_tpu_torch.inference.export import resample_and_save
    _, _, jp, tp = setup
    logits = np.random.RandomState(3).randn(3, 2, 20, 18).astype(np.float32)
    props = {"spacing": [2.5, 1.0, 1.0]}
    jax_save(logits, (2, 31, 27), str(tmp_path / "jax"), jp.plans_manager,
             jp.configuration_manager, props, DATASET)
    resample_and_save(logits, (2, 31, 27), str(tmp_path / "port"), tp.plans_manager,
                      tp.configuration_manager, props, DATASET)
    got, want = (np.load(str(tmp_path / f"{n}.npz"))["seg"] for n in ("port", "jax"))
    assert got.shape == (2, 31, 27) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
