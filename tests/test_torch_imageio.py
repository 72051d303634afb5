"""The port's image readers and writers against the JAX package's.

For each format, a file that one package writes is read by both packages'
readers into the same array and the same properties; a segmentation that the
other package writes with those properties reads back unchanged in the first.
Both directions run. The registries resolve the same class for every file
ending and every reader/writer name.
"""

import importlib
import math
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("nnuzoo_tpu", "nnuzoo_tpu_torch")
FORMATS = ("nii", "nii.gz", "reorient", "mha", "nrrd", "gipl", "npy", "png", "tif")
SPACING_ZYX = (2.5, 1.1, 0.8)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.imageio.{name}")


def _io_class(pkg, fmt):
    cls = {"nii": ("nifti", "NiftiIO"), "nii.gz": ("nifti", "NiftiIO"),
           "reorient": ("nifti", "NiftiIOWithReorient"),
           "mha": ("sitk_formats", "SitkFormatsIO"),
           "nrrd": ("sitk_formats", "SitkFormatsIO"),
           "gipl": ("sitk_formats", "SitkFormatsIO"),
           "npy": ("numpy_io", "NumpyIO"), "png": ("natural", "NaturalImage2DIO"),
           "tif": ("tiff", "Tiff3DIO")}[fmt]
    return getattr(_mod(pkg, cls[0]), cls[1])


def _oblique_header(pkg, shape_xyz):
    """A NIfTI header whose sform is rotated by 20 degrees in the x-y plane,
    with the axes permuted (world R from data axis 1, A from 0, S from 2) and
    A flipped: the reorienting reader has to permute and flip."""
    nifti = _mod(pkg, "nifti")
    hdr = bytearray(nifti._build_header(shape_xyz, (0.8, 1.1, 2.5), np.float32))
    c, s = math.cos(math.radians(20)), math.sin(math.radians(20))
    struct.pack_into("<4f", hdr, 280, -s * 0.8, c * 1.1, 0.0, 3.0)
    struct.pack_into("<4f", hdr, 296, -c * 0.8, -s * 1.1, 0.0, 7.0)
    struct.pack_into("<4f", hdr, 312, 0.0, 0.0, 2.5, -1.0)
    struct.pack_into("<h", hdr, 254, 1)              # sform_code
    return bytes(hdr)


def _write(pkg, fmt, path, vol, seg):
    """One image file in ``fmt`` written by ``pkg`` (a float volume where the
    format holds one, else the label volume); returns what was written."""
    if fmt in ("nii", "nii.gz"):
        _mod(pkg, "nifti").write_nifti(path, vol.transpose(2, 1, 0),
                                       spacing_xyz=SPACING_ZYX[::-1])
        return vol
    if fmt == "reorient":
        data_xyz = vol.transpose(2, 1, 0)
        _mod(pkg, "nifti").write_nifti(
            path, data_xyz, header_bytes=_oblique_header(pkg, data_xyz.shape))
        return None
    if fmt in ("mha", "nrrd", "gipl"):
        getattr(_mod(pkg, "sitk_formats"), f"write_{fmt}")(path, vol, SPACING_ZYX)
        return vol
    if fmt == "png":
        _io_class(pkg, fmt)().write_seg(seg[:1], path, {"spacing": [999, 1, 1]})
        return seg[:1]
    _io_class(pkg, fmt)().write_seg(seg, path, {"spacing": list(SPACING_ZYX)})
    return seg


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (what, a, b)
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (what, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


@pytest.mark.parametrize("direction", ["jax_writes", "port_writes"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_a_file_one_package_writes_reads_the_same_in_both(tmp_path, fmt, direction):
    writer, reader = PACKAGES if direction == "jax_writes" else PACKAGES[::-1]
    rng = np.random.RandomState(FORMATS.index(fmt))
    vol = (rng.rand(5, 12, 9) * 100).astype(np.float32)          # (z, y, x)
    seg = rng.randint(0, 4, size=vol.shape).astype(np.uint8)
    ending = {"reorient": "nii.gz", "tif": "tif"}.get(fmt, fmt)
    path = str(tmp_path / f"case_0000.{ending}")
    written = _write(writer, fmt, path, vol, seg)

    data_w, props_w = _io_class(writer, fmt)().read_images([path])
    data_r, props_r = _io_class(reader, fmt)().read_images([path])
    assert data_r.dtype == np.float32 and data_r.shape[0] == 1
    np.testing.assert_array_equal(data_r, data_w)
    _assert_same(props_r, props_w, "properties")
    if written is not None:
        np.testing.assert_allclose(data_r[0].reshape(written.shape), written,
                                   rtol=1e-6)
    else:  # the reorienting reader permuted and flipped the on-disk volume
        assert sorted(data_r.shape[1:]) == sorted(vol.shape)
        assert data_r.shape[1:] != vol.shape

    # a segmentation written by the reader's package with its properties
    labels = rng.randint(0, 3, size=data_r.shape[1:]).astype(np.uint8)
    out = str(tmp_path / f"seg.{ending}")
    _io_class(reader, fmt)().write_seg(labels, out, props_r)
    back_w, sprops_w = _io_class(writer, fmt)().read_seg(out)
    back_r, sprops_r = _io_class(reader, fmt)().read_seg(out)
    np.testing.assert_array_equal(back_w[0], labels)
    np.testing.assert_array_equal(back_r, back_w)
    _assert_same(sprops_r, sprops_w, "segmentation properties")


@pytest.mark.parametrize("ending", [".nii", ".nii.gz", ".mha", ".nrrd", ".gipl",
                                    ".gipl.gz", ".npy", ".png", ".bmp", ".jpg",
                                    ".jpeg", ".tif", ".tiff"])
def test_registry_resolves_the_same_class_for_each_ending(ending):
    from nnuzoo_tpu.imageio import registry as jreg
    from nnuzoo_tpu_torch.imageio import registry as treg
    want = jreg.determine_reader_writer_from_file_ending(ending)
    got = treg.determine_reader_writer_from_file_ending(ending)
    assert got.__module__.startswith("nnuzoo_tpu_torch.imageio.")
    assert got.__name__ == want.__name__
    assert got.supported_file_endings == want.supported_file_endings
    dj = {"file_ending": ending}
    assert treg.determine_reader_writer_from_dataset_json(dj).__name__ == \
        jreg.determine_reader_writer_from_dataset_json(dj).__name__


@pytest.mark.parametrize("name", ["NiftiIO", "NiftiIOWithReorient", "SimpleITKIO",
                                  "SitkFormatsIO", "NibabelIO",
                                  "NibabelIOWithReorient", "NaturalImage2DIO",
                                  "Tiff3DIO", "NumpyIO"])
def test_registry_resolves_the_same_class_for_each_name(name):
    from nnuzoo_tpu.imageio import registry as jreg
    from nnuzoo_tpu_torch.imageio import registry as treg
    from nnuzoo_tpu_torch.plans.plans_handler import PlansManager
    want = jreg.find_reader_writer_by_name(name).__name__
    assert treg.find_reader_writer_by_name(name).__name__ == want
    dj = {"file_ending": ".png", "overwrite_image_reader_writer": name}
    assert treg.determine_reader_writer_from_dataset_json(dj).__name__ == want
    pm = PlansManager({"image_reader_writer": name, "configurations": {}})
    assert pm.image_reader_writer_class.__name__ == want


def test_registry_refuses_what_the_jax_one_refuses():
    from nnuzoo_tpu_torch.imageio import registry as treg
    with pytest.raises(RuntimeError, match="Unknown reader/writer"):
        treg.find_reader_writer_by_name("NoSuchIO")
    with pytest.raises(RuntimeError, match="No reader/writer"):
        treg.determine_reader_writer_from_file_ending(".xyz")
