"""Planning and preprocessing: the port's ``plan_and_preprocess`` against the
JAX package's on the same raw datasets.

The raw datasets come from the JAX package's integration-test generator:
999 (labels), 997 (regions) and 996 (regions and an ignore label), three
training cases each. Both command lines plan ``2d`` and ``3d_fullres`` and
preprocess them into preprocessed roots of their own: the JAX package with
one worker, the port with two threads. Every output must be the same:
``dataset_fingerprint.json``, the plans and ``dataset.json`` as parsed JSON;
every ``.npz`` array, every ``.pkl`` (``class_locations`` included, keys,
key types, arrays and dtypes) and every ``gt_segmentations`` file exactly.

The fingerprint samples 1e6 foreground intensities in all instead of the
default 1e8 on both sides, which takes 10 s a dataset on one CPU core;
the sampling code is the same at either count.
"""

import os
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

from nnuzoo_tpu.cli import entry_points as jax_cli  # noqa: E402
from nnuzoo_tpu.dataset_conversion import integration_test_datasets as gen  # noqa: E402
from nnuzoo_tpu.planning import api as jax_api  # noqa: E402
from nnuzoo_tpu.utilities.io import load_json, load_pickle  # noqa: E402
from nnuzoo_tpu_torch.cli import entry_points as torch_cli  # noqa: E402
from nnuzoo_tpu_torch.planning import api as torch_api  # noqa: E402

DATASETS = {
    "labels": (999, gen.create_dataset_999, "Dataset999_IntegrationTest"),
    "regions": (997, gen.create_dataset_997, "Dataset997_IntegrationTestRegions"),
    "regions_ignore": (996, gen.create_dataset_996,
                       "Dataset996_IntegrationTestRegionsIgnore"),
}
CONFIGURATIONS = ("2d", "3d_fullres")
FG_SAMPLES = 1e6


def _fewer_samples(extractor_class):
    class Extractor(extractor_class):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.num_foreground_voxels_for_intensitystats = FG_SAMPLES
    return Extractor


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """{regime: (raw dataset folder, JAX preprocessed folder, port's)}."""
    root = tmp_path_factory.mktemp("planning")
    raw = root / "raw"
    raw.mkdir()
    saved = {k: os.environ.get(k) for k in ("nnUNet_raw", "nnUNet_preprocessed")}
    os.environ["nnUNet_raw"] = str(raw)
    mp = pytest.MonkeyPatch()
    for api in (jax_api, torch_api):
        mp.setattr(api, "DatasetFingerprintExtractor",
                   _fewer_samples(api.DatasetFingerprintExtractor))
    out = {}
    try:
        for regime, (ds_id, create, name) in DATASETS.items():
            create(num_cases=3)
            folders = []
            for side, main, workers in (("jax", jax_cli.plan_and_preprocess_entry, "1"),
                                        ("torch", lambda a: torch_cli.main(
                                            ["plan_and_preprocess"] + a), "2")):
                pp = root / f"pp_{side}"
                os.environ["nnUNet_preprocessed"] = str(pp)
                main(["-d", str(ds_id), "-npfp", workers, "-np", workers,
                      "-c", *CONFIGURATIONS])
                folders.append(str(pp / name))
            out[regime] = (str(raw / name), *folders)
    finally:
        mp.undo()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def _files(folder, ending):
    return sorted(f for f in os.listdir(folder) if f.endswith(ending))


def _assert_same(got, want, where):
    """Equal values of equal types, arrays with equal dtypes and shapes."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), (where, list(got), list(want))
        for k in want:
            assert type(k) is type(next(g for g in got if g == k)), (where, k)
            _assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("regime", list(DATASETS))
def test_fingerprint_plans_and_dataset_json_are_equal(planned, regime):
    _, jax_pp, torch_pp = planned[regime]
    for name in ("dataset_fingerprint.json", "nnUNetPlans.json", "dataset.json"):
        assert load_json(os.path.join(torch_pp, name)) == \
            load_json(os.path.join(jax_pp, name)), name
    plans = load_json(os.path.join(torch_pp, "nnUNetPlans.json"))
    assert set(CONFIGURATIONS) <= set(plans["configurations"])


@pytest.mark.parametrize("regime", list(DATASETS))
def test_preprocessed_arrays_and_properties_are_identical(planned, regime):
    _, jax_pp, torch_pp = planned[regime]
    for cfg in CONFIGURATIONS:
        jdir = os.path.join(jax_pp, f"nnUNetPlans_{cfg}")
        tdir = os.path.join(torch_pp, f"nnUNetPlans_{cfg}")
        for ending in (".npz", ".npy", ".pkl"):
            assert _files(tdir, ending) == _files(jdir, ending), (cfg, ending)
        assert len(_files(tdir, ".npz")) == 3
        for f in _files(jdir, ".npz"):
            with np.load(os.path.join(jdir, f)) as j, \
                    np.load(os.path.join(tdir, f)) as t:
                assert sorted(t.files) == sorted(j.files) == ["data", "seg"]
                for k in j.files:
                    _assert_same(t[k], j[k], f"{cfg}/{f}/{k}")
        for f in _files(jdir, ".pkl"):
            want = load_pickle(os.path.join(jdir, f))
            got = load_pickle(os.path.join(tdir, f))
            assert want["class_locations"], f
            _assert_same(got, want, f"{cfg}/{f}")


@pytest.mark.parametrize("regime", list(DATASETS))
def test_class_locations_keys_are_the_samplers(planned, regime):
    """The keys are what the port's sampler looks up: an int for a label or a
    one-label region, a tuple for a region, and with an ignore label the
    sampler's annotated-classes key, the tuple of all labels."""
    from nnuzoo_tpu_torch.data.dataset import DatasetNumpy
    from nnuzoo_tpu_torch.data.patch_sampler import PatchSampler
    from nnuzoo_tpu_torch.plans.label_handling import LabelManager

    raw, _, torch_pp = planned[regime]
    folder = os.path.join(torch_pp, "nnUNetPlans_2d")
    props = load_pickle(os.path.join(folder, _files(folder, ".pkl")[0]))
    keys = list(props["class_locations"])
    want = {"labels": [1, 2], "regions": [(1, 2), 2],
            "regions_ignore": [(1, 2), 2, (0, 1, 2)]}[regime]
    assert keys == want and [type(k) for k in keys] == [type(k) for k in want]
    for k, locs in props["class_locations"].items():
        assert len(locs) > 0 and np.asarray(locs).shape[1] == 4, k
    dataset_json = load_json(os.path.join(raw, "dataset.json"))
    lm = LabelManager(dataset_json["labels"], dataset_json.get("regions_class_order"))
    sampler = PatchSampler(DatasetNumpy(folder), 6, (8, 8), (8, 8), lm,
                           oversample_foreground_percent=1.0, seed=0)
    if lm.has_ignore_label:
        assert keys[-1] == sampler.annotated_classes_key
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # a missing key warns and crops anywhere
        batch = next(sampler)
    # every patch is forced to foreground, centred on a stored location
    for seg in batch["target"]:
        assert np.isin(seg, [1, 2]).any()


@pytest.mark.parametrize("regime", list(DATASETS))
def test_gt_segmentations_are_identical(planned, regime):
    _, jax_pp, torch_pp = planned[regime]
    jdir = os.path.join(jax_pp, "gt_segmentations")
    tdir = os.path.join(torch_pp, "gt_segmentations")
    assert _files(tdir, ".nii.gz") == _files(jdir, ".nii.gz")
    assert len(_files(tdir, ".nii.gz")) == 3
    for f in _files(jdir, ".nii.gz"):
        with open(os.path.join(jdir, f), "rb") as a, \
                open(os.path.join(tdir, f), "rb") as b:
            assert a.read() == b.read(), f


def test_integrity_check_rejects_the_same_bad_label_file(tmp_path):
    """The bad label file of ``tests/test_planning.py``: a voxel of label 7
    where the dataset declares {0, 1}."""
    from nnuzoo_tpu.imageio.nifti import read_nifti, write_nifti
    from nnuzoo_tpu.planning.integrity import verify_dataset_integrity as jax_verify
    from nnuzoo_tpu_torch.planning.integrity import verify_dataset_integrity

    from .helpers import make_synthetic_dataset
    ds = make_synthetic_dataset(str(tmp_path), num_cases=2,
                                labels={"background": 0, "organ": 1})
    verify_dataset_integrity(ds, num_processes=1)
    f = os.path.join(ds, "labelsTr", "case_000.nii.gz")
    seg, _ = read_nifti(f)
    seg = seg.copy()
    seg[0, 0, 0] = 7
    write_nifti(f, seg.astype(np.uint8), spacing_xyz=(1, 1, 1))
    for verify in (jax_verify, verify_dataset_integrity):
        with pytest.raises(RuntimeError, match=r"Unexpected labels \[.*7.*\]"):
            verify(ds, num_processes=1)


def test_save_plans_keeps_configurations_a_user_added(planned, tmp_path,
                                                      monkeypatch):
    """Planning again keeps a configuration that is not the planner's."""
    import shutil

    from nnuzoo_tpu_torch.planning.planner import ExperimentPlanner
    from nnuzoo_tpu_torch.utilities.io import save_json

    raw, _, torch_pp = planned["labels"]
    pp = tmp_path / os.path.basename(torch_pp)
    shutil.copytree(torch_pp, pp)
    monkeypatch.setenv("nnUNet_raw", os.path.dirname(raw))
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path))
    plans_file = str(pp / "nnUNetPlans.json")
    plans = load_json(plans_file)
    plans["configurations"]["2d_mine"] = {"inherits_from": "2d", "batch_size": 3}
    save_json(plans, plans_file, sort_keys=False)
    ExperimentPlanner(999).plan_experiment()
    again = load_json(plans_file)
    assert again["configurations"]["2d_mine"] == {"inherits_from": "2d",
                                                  "batch_size": 3}
    assert again["configurations"]["2d"] == plans["configurations"]["2d"]


@pytest.mark.parametrize("step", ["ResEncUNetPlanner", "add_lowres_and_cascade",
                                  "move_plans_between_datasets"])
def test_other_planner_and_plans_editing_match_jax(planned, tmp_path, monkeypatch,
                                                   step):
    """On copies of both preprocessed roots: the residual-encoder planner,
    the lowres/cascade injection and the move of a plans file to another
    dataset write equal JSON in both packages."""
    import shutil

    from nnuzoo_tpu.planning import planner as jax_planner
    from nnuzoo_tpu.planning import plans_editing as jax_editing
    from nnuzoo_tpu_torch.planning import planner as torch_planner
    from nnuzoo_tpu_torch.planning import plans_editing as torch_editing

    raw, jax_pp, torch_pp = planned["labels"]
    monkeypatch.setenv("nnUNet_raw", os.path.dirname(raw))
    written = []
    for side, pp, planner, editing in (("jax", jax_pp, jax_planner, jax_editing),
                                       ("torch", torch_pp, torch_planner,
                                        torch_editing)):
        root = tmp_path / side
        for regime in ("labels", "regions"):
            src = planned[regime][1 if side == "jax" else 2]
            shutil.copytree(src, root / os.path.basename(src))
        monkeypatch.setenv("nnUNet_preprocessed", str(root))
        name = os.path.basename(pp)
        if step == "ResEncUNetPlanner":
            planner.get_planner_class_by_name(step)(999).plan_experiment()
            out = root / name / "nnUNetResEncUNetPlans.json"
        elif step == "add_lowres_and_cascade":
            editing.add_lowres_and_cascade(999)
            out = root / name / "nnUNetPlans.json"
        else:
            out = editing.move_plans_between_datasets(999, 997, "nnUNetPlans",
                                                      "nnUNetMovedPlans")
        written.append(load_json(str(out)))
    assert written[1] == written[0]
