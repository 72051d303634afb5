"""The port's Predictor against the JAX package's Predictor.

Both are set up through ``manual_initialization`` with the same plans dict
and the same weights (flax params and their conversion), 2d configuration
with patch 32x32, mirror TTA on. The model is M2NetP at one layer per stage
to keep the JAX compile short; the model itself is covered by
``test_torch_m2net.py``. Logits agree to 1e-3 of their range (fp32 on both
sides, summed in different orders); the segmentations are identical.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from nnuzoo_tpu.inference import sliding_window as jsw  # noqa: E402
from nnuzoo_tpu.inference.predictor import Predictor as JaxPredictor  # noqa: E402
from nnuzoo_tpu.models.m2net import M2NetP as JaxM2NetP  # noqa: E402
from nnuzoo_tpu.plans.plans_handler import PlansManager as JaxPlans  # noqa: E402
from nnuzoo_tpu.preprocessing.preprocessor import \
    DefaultPreprocessor as JaxPreprocessor  # noqa: E402
from nnuzoo_tpu_torch.convert import convert_params  # noqa: E402
from nnuzoo_tpu_torch.inference import sliding_window as tsw  # noqa: E402
from nnuzoo_tpu_torch.inference.predictor import Predictor  # noqa: E402
from nnuzoo_tpu_torch.models.m2net import M2NetP  # noqa: E402
from nnuzoo_tpu_torch.plans.plans_handler import PlansManager  # noqa: E402
from nnuzoo_tpu_torch.preprocessing.preprocessor import \
    DefaultPreprocessor  # noqa: E402

from .torch_port_helpers import random_flax_params  # noqa: E402

PATCH = (32, 32)
STAGES = (1, 1, 1, 1)
_RS = {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None}
PLANS = {
    "dataset_name": "Dataset999_Port", "plans_name": "nnUNetPlans",
    "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
    "image_reader_writer": "NiftiIO",
    "foreground_intensity_properties_per_channel": {},
    "configurations": {"2d": {
        "data_identifier": "nnUNetPlans_2d", "batch_size": 2,
        "patch_size": list(PATCH), "spacing": [1.0, 1.0],
        "normalization_schemes": ["ZScoreNormalization"],
        "use_mask_for_norm": [False],
        "resampling_fn_data": "resample_data_or_seg_to_shape",
        "resampling_fn_data_kwargs": _RS,
        "resampling_fn_seg": "resample_data_or_seg_to_shape",
        "resampling_fn_seg_kwargs": dict(_RS, is_seg=True, order=1),
        "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
        "resampling_fn_probabilities_kwargs": dict(_RS, order=1)}},
}
DATASET = {"channel_names": {"0": "MRI"},
           "labels": {"background": 0, "organ": 1, "tumor": 2},
           "file_ending": ".nii.gz"}
PROPS = {"spacing": [2.0, 1.0, 1.0]}


@pytest.fixture(scope="module")
def predictors():
    jmodel = JaxM2NetP(num_classes=3, deep_supervision=False,
                       stage_layers=STAGES)
    params = random_flax_params(jmodel, jnp.zeros((1, *PATCH, 1)), seed=3,
                                train=False)
    jpm = JaxPlans(PLANS)
    jp = JaxPredictor(tile_batch_size=3)
    jp.manual_initialization(jmodel, [params], jpm, jpm.get_configuration("2d"),
                             DATASET, "nnUNetTrainerM2NetP", (0, 1))
    tmodel = M2NetP(1, 3, deep_supervision=False, stage_layers=STAGES)
    pm = PlansManager(PLANS)
    tp = Predictor(tile_batch_size=3, device="cpu")
    tp.manual_initialization(tmodel, [convert_params(params, tmodel)], pm,
                             pm.get_configuration("2d"), DATASET,
                             "nnUNetTrainerM2NetP", (0, 1))
    return jp, tp


def _volume():
    # 3 slices of 40x36: each slice pads to nothing and takes 2x2 tiles, so
    # 12 tiles run as 4 batches of 3 (the last one full) with 4 mirror passes
    return (100 * np.random.RandomState(11).rand(1, 3, 40, 36)).astype(np.float32)


def test_logits_match_jax(predictors):
    jp, tp = predictors
    data, _ = JaxPreprocessor().run_case_npy(
        _volume(), None, dict(PROPS), jp.plans_manager, jp.configuration_manager,
        DATASET)
    want = jp.predict_logits_from_preprocessed_data(data)
    before = tp.forward_count
    got = tp.predict_logits_from_preprocessed_data(data)
    assert got.shape == want.shape == (3, 3, 40, 36)
    assert tp.forward_count - before == 4 * 4      # 4 tile batches x 4 mirrors
    span = float(want.max() - want.min())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * span)


def test_segmentation_identical_to_jax(predictors, tmp_path):
    """The segmentation is identical; the probabilities (softmax of logits
    that agree to 1e-3 of their range) agree to 1e-3. Written to a file
    through the plans' writer, the segmentation reads back the same."""
    jp, tp = predictors
    want, want_prob = jp.predict_single_npy_array(
        _volume(), dict(PROPS), save_or_return_probabilities=True)
    got, got_prob = tp.predict_single_npy_array(
        _volume(), dict(PROPS), save_or_return_probabilities=True)
    assert got.shape == want.shape == (3, 40, 36)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0, 1, 2}
    assert got_prob.shape == want_prob.shape == (3, 3, 40, 36)
    np.testing.assert_allclose(got_prob, want_prob, rtol=0, atol=1e-3)
    # without probabilities: the same segmentation through the other branch
    np.testing.assert_array_equal(
        tp.predict_single_npy_array(_volume(), dict(PROPS)), got)
    from nnuzoo_tpu_torch.imageio.nifti import NiftiIO
    out = str(tmp_path / "case")
    assert tp.predict_single_npy_array(_volume(), dict(PROPS),
                                       output_file_truncated=out) is None
    written, props = NiftiIO().read_seg(out + DATASET["file_ending"])
    np.testing.assert_array_equal(written[0], got)
    assert props["spacing"] == PROPS["spacing"]


def test_segmentation_with_the_fused_glue_identical_to_jax(predictors):
    """With the fused cross-scan glue in every SS2D of the port's model, the
    segmentation is the JAX package's (default glue: the two glues compute
    the same function) and the probabilities agree to 1e-3."""
    from nnuzoo_tpu_torch.models.ss2d import SS2D, set_ss2d_glue
    jp, tp = predictors
    want, want_prob = jp.predict_single_npy_array(
        _volume(), dict(PROPS), save_or_return_probabilities=True)
    set_ss2d_glue(tp.model, "fused")
    try:
        assert {m.glue for m in tp.model.modules() if isinstance(m, SS2D)} == \
            {"fused"}
        got, got_prob = tp.predict_single_npy_array(
            _volume(), dict(PROPS), save_or_return_probabilities=True)
    finally:
        set_ss2d_glue(tp.model, "default")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_prob, want_prob, rtol=0, atol=1e-3)


def test_single_slice_and_short_last_batch(predictors):
    """A volume whose tile count is not a multiple of the tile batch (the
    last batch runs short) and that needs padding (20x30 < patch)."""
    jp, tp = predictors
    data = np.random.RandomState(12).randn(1, 2, 20, 30).astype(np.float32)
    want = jp.predict_sliding_window_return_logits(data)
    got = tp.predict_sliding_window_return_logits(data)
    assert got.shape == want.shape == (3, 2, 20, 30)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * float(want.max() - want.min()))


def test_preprocessing_copy_matches_jax():
    vol = _volume()
    vol[:, :, :2] = 0                         # a border for crop-to-nonzero
    jpm, pm = JaxPlans(PLANS), PlansManager(PLANS)
    jprops, tprops = dict(PROPS), dict(PROPS)
    want, _ = JaxPreprocessor().run_case_npy(
        vol, None, jprops, jpm, jpm.get_configuration("2d"), DATASET)
    got, _ = DefaultPreprocessor().run_case_npy(
        vol, None, tprops, pm, pm.get_configuration("2d"), DATASET)
    np.testing.assert_array_equal(got, want)
    assert tprops["bbox_used_for_cropping"] == jprops["bbox_used_for_cropping"]


def test_preprocessing_copy_with_mask_for_norm_matches_jax():
    """``use_mask_for_norm`` normalizes inside the crop's nonzero mask only;
    with a segmentation, that is cropped and resampled alongside, and the
    foreground locations of training are sampled, as in the JAX package."""
    vol = _volume()
    vol[:, :, :2] = 0                         # cropped away
    vol[:, :, 2:8, :5] = 0                    # inside the crop, outside the mask
    plans = copy.deepcopy(PLANS)
    plans["configurations"]["2d"]["use_mask_for_norm"] = [True]
    jpm, pm = JaxPlans(plans), PlansManager(plans)
    want, _ = JaxPreprocessor().run_case_npy(
        vol, None, dict(PROPS), jpm, jpm.get_configuration("2d"), DATASET)
    got, _ = DefaultPreprocessor().run_case_npy(
        vol, None, dict(PROPS), pm, pm.get_configuration("2d"), DATASET)
    np.testing.assert_array_equal(got, want)
    assert (got[:, :, :6, :5] == 0).all()     # outside the mask stays 0
    seg = (vol > 60).astype(np.int8) + (vol > 90).astype(np.int8)
    want_props, got_props = dict(PROPS), dict(PROPS)
    want_d, want_s = JaxPreprocessor().run_case_npy(
        vol, seg, want_props, jpm, jpm.get_configuration("2d"), DATASET)
    got_d, got_s = DefaultPreprocessor().run_case_npy(
        vol, seg, got_props, pm, pm.get_configuration("2d"), DATASET)
    np.testing.assert_array_equal(got_d, want_d)
    assert got_s.dtype == want_s.dtype
    np.testing.assert_array_equal(got_s, want_s)
    assert set(np.unique(got_s)) == {-1, 0, 1, 2}
    assert sorted(got_props["class_locations"]) == \
        sorted(want_props["class_locations"]) == [1, 2]
    for k, locs in want_props["class_locations"].items():
        assert got_props["class_locations"][k].dtype == locs.dtype
        np.testing.assert_array_equal(got_props["class_locations"][k], locs)
    for k in ("shape_before_cropping", "bbox_used_for_cropping",
              "shape_after_cropping_and_before_resampling"):
        assert got_props[k] == want_props[k], k


def test_sliding_window_copy_matches_jax():
    np.testing.assert_array_equal(tsw.compute_gaussian(PATCH),
                                  jsw.compute_gaussian(PATCH))
    for shape in [(3, 40, 36), (64, 48)]:
        assert tsw.get_sliding_window_slicers(shape, PATCH, 0.5) == \
            jsw.get_sliding_window_slicers(shape, PATCH, 0.5)
