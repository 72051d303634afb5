"""The port's copy of the segmentation metrics against the JAX package's.

Seeded folders of reference and predicted segmentations (NIfTI, written by
the port's writer) are scored by both packages' ``compute_metrics_on_folder``
with labels, with regions, with an ignore label and with an empty reference:
the counts agree exactly and Dice/IoU to 1e-12.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nnuzoo_tpu.evaluation import metrics as jm  # noqa: E402
from nnuzoo_tpu.imageio.nifti import NiftiIO as JaxNiftiIO  # noqa: E402
from nnuzoo_tpu_torch.evaluation import metrics as tm  # noqa: E402
from nnuzoo_tpu_torch.imageio.nifti import NiftiIO  # noqa: E402

CASES = ("case_000", "case_001", "case_002", "empty_ref")
SETTINGS = {
    "labels": dict(labels=[1, 2, 3], ignore=None),
    "labels_with_background": dict(labels=[0, 1, 2, 3], ignore=None),
    "regions": dict(labels=[(1, 2, 3), (2, 3), 3], ignore=None),
    "ignore_label": dict(labels=[1, 2, 3], ignore=4),
    "regions_and_ignore": dict(labels=[(1, 2, 3), (2, 3), 3], ignore=4),
}


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics")
    ref, pred = str(root / "ref"), str(root / "pred")
    os.makedirs(ref)
    os.makedirs(pred)
    rng = np.random.RandomState(0)
    io = NiftiIO()
    for i, case in enumerate(CASES):
        shape = (3, 20, 17 + i)
        r = rng.randint(0, 5, size=shape).astype(np.uint8)
        p = np.where(rng.rand(*shape) < 0.7, r, rng.randint(0, 4, size=shape))
        if case == "empty_ref":
            r[:] = 0
        props = {"spacing": [2.0, 1.0, 0.5]}
        io.write_seg(r, os.path.join(ref, case + ".nii.gz"), props)
        io.write_seg(p.astype(np.uint8), os.path.join(pred, case + ".nii.gz"), props)
    # a prediction without a reference is left out of the summary
    io.write_seg(np.ones((3, 4, 4), np.uint8), os.path.join(pred, "extra.nii.gz"),
                 {"spacing": [1.0, 1.0, 1.0]})
    return ref, pred, root


def _assert_metrics_equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            _assert_metrics_equal(g, w, f"{what}.{k}")
        elif isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), (what, k, g)
        elif isinstance(w, int):
            assert type(g) is int and g == w, (what, k, g, w)
        elif isinstance(w, str):
            assert g == w, (what, k, g, w)
        else:
            assert abs(g - w) <= 1e-12, (what, k, g, w)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_folder_metrics_match_jax(folders, setting):
    ref, pred, root = folders
    labels, ignore = SETTINGS[setting]["labels"], SETTINGS[setting]["ignore"]
    out_t = str(root / f"port_{setting}.json")
    out_j = str(root / f"jax_{setting}.json")
    got = tm.compute_metrics_on_folder(ref, pred, out_t, NiftiIO(), ".nii.gz",
                                       labels, ignore, num_processes=2)
    want = jm.compute_metrics_on_folder(ref, pred, out_j, JaxNiftiIO(), ".nii.gz",
                                        labels, ignore, num_processes=1)
    _assert_metrics_equal(got["mean"], want["mean"], "mean")
    _assert_metrics_equal(got["foreground_mean"], want["foreground_mean"], "fg")
    assert len(got["metric_per_case"]) == len(CASES)
    for g, w in zip(got["metric_per_case"], want["metric_per_case"]):
        assert g["reference_file"] == w["reference_file"]
        assert g["prediction_file"] == w["prediction_file"]
        _assert_metrics_equal(g["metrics"], w["metrics"], g["reference_file"])
    # the empty reference holds no foreground voxel
    empty = got["metric_per_case"][-1]["metrics"]
    assert all(m["n_ref"] == 0 for k, m in empty.items() if k != 0)
    assert open(out_t).read() == open(out_j).read()
    _assert_metrics_equal(tm.load_summary_json(out_t)["mean"],
                          jm.load_summary_json(out_j)["mean"], "loaded")


def test_simple_folder_metrics_match_jax(folders):
    """The ending comes from ``os.path.splitext``, so both packages take
    ``.nii`` folders and refuse ``.nii.gz`` ones alike."""
    ref, pred, root = folders
    for pkg in (tm, jm):
        with pytest.raises(RuntimeError, match="'.gz'"):
            pkg.compute_metrics_on_folder_simple(ref, pred, [1, 2])
    io = NiftiIO()
    for src, name in ((ref, "ref_nii"), (pred, "pred_nii")):
        os.makedirs(root / name, exist_ok=True)
        for case in CASES:
            seg, props = io.read_seg(os.path.join(src, case + ".nii.gz"))
            io.write_seg(seg[0], str(root / name / (case + ".nii")), props)
    ref, pred = str(root / "ref_nii"), str(root / "pred_nii")
    got = tm.compute_metrics_on_folder_simple(ref, pred, [1, 2], num_processes=1,
                                              ignore_label=4)
    want = jm.compute_metrics_on_folder_simple(ref, pred, [1, 2], num_processes=1,
                                               ignore_label=4)
    _assert_metrics_equal(got["foreground_mean"], want["foreground_mean"], "fg")
    _assert_metrics_equal(got["mean"], want["mean"], "mean")


@pytest.mark.parametrize("key", [1, 0, (1, 2), (2, 3, 4), (7,)])
def test_key_codec_matches_jax(key):
    s = tm.label_or_region_to_key(key)
    assert s == jm.label_or_region_to_key(key)
    assert tm.key_to_label_or_region(s) == jm.key_to_label_or_region(s)


@pytest.mark.parametrize("use_ignore", [False, True])
def test_case_counts_match_jax(use_ignore):
    rng = np.random.RandomState(1)
    ref = rng.randint(0, 3, size=(4, 9, 9))
    pred = rng.randint(0, 3, size=(4, 9, 9))
    ignore = (ref == 2) if use_ignore else None
    for r in (1, (1, 2)):
        mr_t = tm.region_or_label_to_mask(ref, r)
        mp_t = tm.region_or_label_to_mask(pred, r)
        np.testing.assert_array_equal(mr_t, jm.region_or_label_to_mask(ref, r))
        assert tm.compute_tp_fp_fn_tn(mr_t, mp_t, ignore) == \
            jm.compute_tp_fp_fn_tn(mr_t, mp_t, ignore)
