"""I/O round-trip tests: png, mat, and the self-contained NIfTI-1 codec
(validated against the bundled Shepp–Logan phantom whose header values are
known: 64³ float64, unit spacing)."""

import os

import numpy as np

from nsol_tpu.io import DataReader, DataWriter, read_nifti, write_nifti

from nsol_tpu.data import path as data_path

PHANTOM = data_path("3D_SheppLoganPhantom_64.nii.gz")


def test_read_shepp_logan_phantom():
    img = read_nifti(PHANTOM)
    assert img.data.shape == (64, 64, 64)
    assert img.data.dtype == np.float64
    np.testing.assert_array_equal(img.get_spacing(), (1.0, 1.0, 1.0))
    # Shepp–Logan: nonnegative, 0-255 scaled in this bundled file
    assert img.data.min() >= 0.0
    assert img.data.max() == 255.0


def test_nifti_roundtrip(tmp_path, rng):
    data = rng.rand(5, 6, 7)
    path = str(tmp_path / "vol.nii.gz")
    write_nifti(data, path, spacing=[1.5, 2.0, 0.5])
    img = read_nifti(path)
    np.testing.assert_array_almost_equal(img.data, data, decimal=12)
    np.testing.assert_array_equal(img.get_spacing(), (1.5, 2.0, 0.5))


def test_nifti_roundtrip_like_header(tmp_path, rng):
    src = read_nifti(PHANTOM)
    data = rng.rand(64, 64, 64)
    path = str(tmp_path / "vol.nii")
    write_nifti(data, path, like=src)
    img = read_nifti(path)
    np.testing.assert_array_almost_equal(img.data, data, decimal=12)
    np.testing.assert_array_equal(img.affine, src.affine)


def test_data_reader_png():
    r = DataReader(data_path("2D_Lena_256_noise.png"))
    r.read_data()
    d = r.get_data()
    assert d.shape == (256, 256)
    assert d.dtype == np.float64


def test_data_reader_nii_dispatch():
    r = DataReader(PHANTOM)
    r.read_data()
    assert r.get_data().shape == (64, 64, 64)
    assert r.get_image_nifti() is not None


def test_data_writer_roundtrips(tmp_path, rng):
    data = np.round(rng.rand(10, 12) * 255)
    png = str(tmp_path / "img.png")
    DataWriter(data, png).write_data()
    r = DataReader(png)
    r.read_data()
    np.testing.assert_array_equal(r.get_data(), data)

    mat = str(tmp_path / "arr.mat")
    DataWriter(data, mat).write_data()
    r = DataReader(mat)
    r.read_data()
    np.testing.assert_array_almost_equal(r.get_data(), data)

    txt = str(tmp_path / "arr.txt")
    DataWriter(data, txt).write_data()
    assert os.path.exists(txt)


def test_standalone_data_generation(tmp_path):
    """A checkout without the reference data dir can generate its full
    stand-in input set: every bundled-name file is
    produced deterministically and loads through the package's readers."""
    from nsol_tpu.data import _FILES, generate_standalone_data

    out = str(tmp_path / "gen")
    generate_standalone_data(out)
    for name in _FILES:
        assert os.path.isfile(os.path.join(out, name)), name

    r = DataReader(os.path.join(out, "2D_Lena_256_noise.png"))
    r.read_data()
    assert r.get_data().shape == (256, 256)

    img = read_nifti(os.path.join(out, "3D_SheppLoganPhantom_64.nii.gz"))
    assert img.data.shape == (64, 64, 64)
    assert 0.0 <= img.data.min() and img.data.max() == 255.0
    # phantom structure: bright skull shell, darker interior
    assert img.data[32, 32, 32] < img.data.max()

    # idempotent + deterministic
    d1 = np.asarray(read_nifti(
        os.path.join(out, "3D_SheppLoganPhantom_64.nii.gz")).data)
    generate_standalone_data(out)
    out2 = str(tmp_path / "gen2")
    generate_standalone_data(out2)
    d2 = np.asarray(read_nifti(
        os.path.join(out2, "3D_SheppLoganPhantom_64.nii.gz")).data)
    np.testing.assert_array_equal(d1, d2)


def test_standalone_data_frozen_hashes(tmp_path):
    """Regenerating the standalone stand-in inputs
    reproduces the frozen content hashes byte-for-byte (decoded pixel /
    volume content), so standalone-benchmark objectives anchor."""
    from nsol_tpu.data import (generate_standalone_data,
                               verify_standalone_data)

    d = generate_standalone_data(str(tmp_path / "gen"))
    verify_standalone_data(d)  # raises on any generator drift
