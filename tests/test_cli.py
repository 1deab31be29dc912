"""Tier-3 end-to-end CLI smoke tests (subprocess, exit-code + artifacts).

Ports the reference's strategy (tests/run_denoising_test.py etc.): run each
CLI on the bundled 2-D and 3-D data with few iterations and assert success.
Subprocesses pin the CPU backend via JAX_PLATFORMS=cpu.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from nsol_tpu.data import data_dir

DATA = data_dir()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable] + args, env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("rtype", ["TVL1", "TVL2", "HuberL1", "HuberL2"])
def test_run_denoising_2d(tmp_path, rtype):
    result = str(tmp_path / ("out_%s.png" % rtype))
    p = _run(["nsol_run_denoising.py",
              "--observation", os.path.join(DATA, "2D_Lena_256_noise.png"),
              "--reconstruction-type", rtype,
              "--iterations", "5",
              "--result", result])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(result)


def test_run_denoising_3d_nii(tmp_path):
    result = str(tmp_path / "out.nii.gz")
    p = _run(["nsol_run_denoising.py",
              "--observation",
              os.path.join(DATA, "3D_SheppLoganPhantom_64.nii.gz"),
              "--reconstruction-type", "TVL2",
              "--iterations", "5",
              "--result", result])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(result)


@pytest.mark.parametrize("rtype", ["TK0L2", "TK1L2", "TVL2", "HuberL2"])
def test_run_deconvolution_2d(tmp_path, rtype):
    result = str(tmp_path / ("out_%s.png" % rtype))
    p = _run(["nsol_run_deconvolution.py",
              "--observation",
              os.path.join(DATA, "2D_Lena_256_blur_noise.png"),
              "--reconstruction-type", rtype,
              "--iterations", "5",
              "--iter-max", "5",
              "--blur", "1",
              "--result", result])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(result)


def test_run_deconvolution_robust_irls(tmp_path):
    """Robust (huber) deconvolution through the CLI with the IRLS inner
    engine (the minimizer string flows through unchanged to
    tikhonov_solve's dispatch)."""
    result = str(tmp_path / "out_irls.png")
    p = _run(["nsol_run_deconvolution.py",
              "--observation",
              os.path.join(DATA, "2D_Lena_256_blur_noise.png"),
              "--reconstruction-type", "TVL2",
              "--iterations", "3",
              "--iter-max", "3",
              "--blur", "1",
              "--data-loss", "huber",
              "--minimizer", "irls",
              "--result", result])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(result)


def test_run_denoising_study_and_show(tmp_path):
    out = str(tmp_path / "study")
    p = _run(["nsol_run_denoising_study.py",
              "--observation", os.path.join(DATA, "2D_Lena_256_noise.png"),
              "--reference", os.path.join(DATA, "2D_Lena_256.png"),
              "--reconstruction-type", "TVL2",
              "--iterations", "5",
              "--measures", "RMSE", "PSNR",
              "--alpha-range", "0.01", "0.05", "2",
              "--dir-output", out])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(os.path.join(out, "TVL2_parameters.txt"))

    figs = str(tmp_path / "figs")
    p = _run(["nsol_show_parameter_study.py",
              "--dir-input", out,
              "--study-name", "TVL2",
              "--dir-output-figures", figs])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(os.path.join(figs, "TVL2_L-curve.pdf"))
    assert os.path.isfile(os.path.join(figs, "TVL2_reconstructions.pdf"))


def test_run_deconvolution_study(tmp_path):
    out = str(tmp_path / "study")
    p = _run(["nsol_run_deconvolution_study.py",
              "--observation",
              os.path.join(DATA, "2D_Lena_256_blur_noise.png"),
              "--reconstruction-type", "TVL2",
              "--iterations", "5",
              "--iter-max", "5",
              "--alpha-range", "0.01", "0.05", "2",
              "--dir-output", out])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(os.path.join(out, "TVL2_measure_Data.txt"))


def test_corrupt_data_roundtrip(tmp_path):
    result = str(tmp_path / "corrupted.png")
    p = _run(["nsol_corrupt_data.py",
              "--filename", os.path.join(DATA, "2D_Lena_256.png"),
              "--result", result,
              "--noise", "gaussian",
              "--noise-level", "0.05",
              "--blur", "1"])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(result)
    from PIL import Image

    orig = np.asarray(Image.open(
        os.path.join(DATA, "2D_Lena_256.png")).convert("L"), dtype=float)
    corr = np.asarray(Image.open(result), dtype=float)
    assert corr.shape == orig.shape
    assert np.mean((corr - orig) ** 2) > 1.0  # actually corrupted


def test_run_deconvolution_cg_fast_path(tmp_path):
    """CLI exposes the fused normal-equation CG inner solver."""
    result = str(tmp_path / "out_cg.png")
    p = _run(["nsol_run_deconvolution.py",
              "--observation",
              os.path.join(DATA, "2D_Lena_256_blur_noise.png"),
              "--reconstruction-type", "TVL2",
              "--solver", "ADMM",
              "--minimizer", "cg",
              "--iterations", "5",
              "--iter-max", "5",
              "--blur", "1",
              "--result", result])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(result)


def test_run_denoising_admm_solver(tmp_path):
    """ADMM denoising path (the reference leaves this commented out —
    implemented here, TVL2 only)."""
    result = str(tmp_path / "out_admm.png")
    p = _run(["nsol_run_denoising.py",
              "--observation", os.path.join(DATA, "2D_Lena_256_noise.png"),
              "--reconstruction-type", "TVL2",
              "--solver", "ADMM",
              "--iterations", "4",
              "--result", result])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(result)


def test_run_denoising_multiple_alphas_with_reference(tmp_path):
    figs = str(tmp_path / "figs")
    p = _run(["nsol_run_denoising.py",
              "--observation", os.path.join(DATA, "2D_Lena_256_noise.png"),
              "--reference", os.path.join(DATA, "2D_Lena_256.png"),
              "--reconstruction-type", "TVL2",
              "--iterations", "4",
              "--alpha", "0.1", "0.5",
              "--measures", "RMSE", "PSNR",
              "--verbose", "1",
              "--dir-output-figures", figs])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(os.path.join(figs, "TVL2_comparison.pdf"))
    assert os.path.isfile(os.path.join(figs, "TVL2_RMSE.pdf"))


def test_study_nii_metadata_roundtrip(tmp_path):
    """A 3-D nii study persists origin/spacing/direction in the npz
    (reference contract: show_parameter_study.py:279-291) and the viewer
    renders the spacing-correct 3-D galleries from it."""
    out = str(tmp_path / "study3d")
    p = _run(["nsol_run_deconvolution_study.py",
              "--observation",
              os.path.join(DATA, "3D_SheppLoganPhantom_64.nii.gz"),
              "--reconstruction-type", "TK1L2",
              "--iterations", "3",
              "--iter-max", "3",
              "--alpha-range", "0.01", "0.05", "2",
              "--study-name", "meta3d",
              "--dir-output", out])
    assert p.returncode == 0, p.stderr[-2000:]

    npz = np.load(os.path.join(out, "meta3d_reconstructions.npz"))
    assert set(npz.files) >= {"shape", "origin", "spacing", "direction"}
    assert tuple(npz["shape"]) == (64, 64, 64)
    assert npz["origin"].shape == (3,)
    assert npz["spacing"].shape == (3,)
    assert npz["direction"].shape == (9,)

    from nsol_tpu.io.nifti import read_nifti

    img = read_nifti(os.path.join(DATA, "3D_SheppLoganPhantom_64.nii.gz"))
    np.testing.assert_allclose(npz["spacing"], img.get_spacing())
    np.testing.assert_allclose(npz["origin"], img.get_origin())
    np.testing.assert_allclose(npz["direction"], img.get_direction())

    figs = str(tmp_path / "figs3d")
    p = _run(["nsol_show_parameter_study.py",
              "--dir-input", out,
              "--study-name", "meta3d",
              "--dir-output-figures", figs])
    assert p.returncode == 0, p.stderr[-2000:]
    galleries = [f for f in os.listdir(figs) if "recon" in f]
    assert len(galleries) == 2  # one per alpha


def test_interactive_viewer_fallback(tmp_path, monkeypatch):
    """try_interactive_3d: no itksnap/napari here -> returns False;
    with a fake itksnap on PATH it writes the volumes as NIfTI and
    launches the viewer command (reference -g/-o/-s contract)."""
    import numpy as np

    from nsol_tpu.viewer import try_interactive_3d

    vols = [np.random.RandomState(0).rand(4, 5, 6).astype(np.float32)]
    assert try_interactive_3d(vols, ["a"]) is False  # headless fallback

    fake = tmp_path / "bin"
    fake.mkdir()
    log = tmp_path / "cmd.txt"
    exe = fake / "itksnap"
    exe.write_text("#!/bin/sh\necho \"$@\" > %s\n" % log)
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake) + os.pathsep
                       + os.environ.get("PATH", ""))
    seg = (vols[0] > 0.5).astype(np.float32)
    assert try_interactive_3d(vols + [vols[0] * 2], ["a", "b"],
                              spacing=np.array([1.0, 1.5, 2.0]),
                              segmentation=seg, block=True)
    args = log.read_text().split()
    assert args[0] == "-g" and "-o" in args and "-s" in args
    for p in (args[1], args[args.index("-o") + 1],
              args[args.index("-s") + 1]):
        assert os.path.isfile(p) and p.endswith(".nii.gz")


def test_profiling_trace_cli(tmp_path):
    """profiling.py has real consumers: the
    run_denoising --trace flag wraps the solve in profiling.trace and a
    trace directory materializes with profiler artifacts."""
    result = str(tmp_path / "out.png")
    trace_dir = str(tmp_path / "trace")
    p = _run(["nsol_run_denoising.py",
              "--observation", os.path.join(DATA, "2D_Lena_256_noise.png"),
              "--reconstruction-type", "TVL2",
              "--iterations", "3",
              "--result", result,
              "--trace", trace_dir])
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.isfile(result)
    files = [os.path.join(r, f) for r, _, fs in os.walk(trace_dir)
             for f in fs]
    assert files, "trace directory %s is empty" % trace_dir


def test_profiling_annotate_smoke():
    """profiling.annotate is usable outside a trace (no-op context)."""
    from nsol_tpu import profiling

    with profiling.annotate("solve"):
        assert 1 + 1 == 2
