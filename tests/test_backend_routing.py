"""Backend routing, the compile helpers, and PIL-free data loading.

Every site that once chose an accelerator kernel when the backend was not
the CPU is run here with ``jax.default_backend`` reporting ``"gpu"``: each
must take the XLA path (the same result as on the CPU backend) and import
nothing from the removed kernel modules.
"""

import importlib.abc
import os
import sys

import numpy as np
import pytest
import scipy.ndimage as ndi

import jax

from nsol_tpu.ops import conv as C
from nsol_tpu.ops import grad as G
from nsol_tpu.ops import kernels as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)  # bench.py lives at the repo root
REMOVED = ("nsol_tpu.ops.pallas", "nsol_tpu.parallel.blocked_halo")


class _BlockRemoved(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.startswith(REMOVED):
            raise ImportError("kernel module %s was imported" % name)
        return None


@pytest.fixture
def no_compile_cache(monkeypatch, tmp_path):
    """Leave this process's compile-cache config alone in CLI calls."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))


def _volume(shape=(8, 10, 12), seed=0, outliers=False):
    rng = np.random.RandomState(seed)
    kern = K.gaussian_kernel(np.eye(len(shape)), alpha_cut=3)
    b = ndi.convolve((rng.rand(*shape) > 0.6) * 1.0, kern, mode="wrap")
    if outliers:
        b = b + 2.0 * (rng.rand(*shape) < 0.05)
    return b.astype(np.float32)


def _wrapper(kind, sweep):
    from nsol_tpu.ops import prox as P
    from nsol_tpu.solvers.wrappers import (
        ADMMLinearSolver, PrimalDualSolver, TikhonovLinearSolver)

    b = _volume(outliers=not sweep)
    cov = np.eye(3)
    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=b.shape)
    Bg, Bg_adj = G.make_gradient_operators()
    loss = "linear" if sweep else "huber"
    if kind == "pd":
        s = PrimalDualSolver(
            lambda x, t: P.prox_ell2_denoising(x, t, b / b.max()),
            P.prox_tv_conj, Bg, Bg_adj, L2=12, x0=b, iterations=4,
            x_scale=float(b.max()))
    elif kind == "admm":
        s = ADMMLinearSolver(
            A=A, A_adj=A_adj, b=b, B=Bg, B_adj=Bg_adj, x0=b, iterations=2,
            iter_max=3, irls_cg_iters=3, data_loss=loss, minimizer="auto",
            x_scale=float(b.max()), blur_cov=cov)
    else:
        s = TikhonovLinearSolver(
            A=A, A_adj=A_adj, b=b, B=Bg, B_adj=Bg_adj, x0=b, iter_max=3,
            irls_cg_iters=3, data_loss=loss, minimizer="auto",
            x_scale=float(b.max()), blur_cov=cov, reg_kind="TK1")
    if sweep:
        return s.run_sweep({"alpha": np.array([0.01, 0.2])})[0]
    s.run()
    return s.get_x()


def _cli(tool, tmp_path, *extra):
    from nsol_tpu.cli import run_deconvolution, run_denoising
    from nsol_tpu.io.nifti import read_nifti, write_nifti

    obs = str(tmp_path / "obs.nii.gz")
    write_nifti(_volume() * 100, obs, spacing=np.ones(3))
    out = str(tmp_path / "out.nii")
    argv = ["--observation", obs, "--result", out, "--iterations", "3"]
    if tool == "denoising":
        run_denoising.main(argv)
    else:
        run_deconvolution.main(argv + ["--solver", "ADMM", "--iter-max",
                                       "3", "--blur", "1"] + list(extra))
    return read_nifti(out).data


def _bench(tmp_path):
    import bench

    b = _volume()
    return bench.make_solve(b.astype(np.float64), np.eye(3))(b)


def _sharded(loss):
    from nsol_tpu.parallel import make_mesh, sharded_tv_admm_solve

    mesh = make_mesh((4,), ("space",), devices=jax.devices()[:4])
    b = _volume(outliers=loss != "linear")
    return sharded_tv_admm_solve(mesh, np.eye(3), b, b, 0.01, 0.5,
                                 iterations=2, iter_max=3, data_loss=loss)


SITES = {
    "tikhonov_run_sweep": lambda tmp: _wrapper("tk1", True),
    "admm_run_sweep": lambda tmp: _wrapper("admm", True),
    "pd_run_sweep": lambda tmp: _wrapper("pd", True),
    "admm_irls_run": lambda tmp: _wrapper("admm", False),
    "tikhonov_irls_run": lambda tmp: _wrapper("tk1", False),
    "cli_denoising": lambda tmp: _cli("denoising", tmp),
    "cli_deconvolution_cg": lambda tmp: _cli("deconvolution", tmp),
    "cli_deconvolution_irls": lambda tmp: _cli(
        "deconvolution", tmp, "--data-loss", "huber"),
    "bench_solve": _bench,
    "sharded_cg": lambda tmp: _sharded("linear"),
    "sharded_irls": lambda tmp: _sharded("huber"),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_gpu_backend_takes_xla_path(site, tmp_path, monkeypatch,
                                    no_compile_cache):
    want = np.asarray(SITES[site](tmp_path / "cpu"))
    finder = _BlockRemoved()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(sys, "meta_path", [finder] + sys.meta_path)
    got = np.asarray(SITES[site](tmp_path / "gpu"))
    assert not [m for m in sys.modules if m.startswith(REMOVED)]
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, want)


@pytest.fixture(autouse=True)
def _tmp_subdirs(tmp_path):
    (tmp_path / "cpu").mkdir()
    (tmp_path / "gpu").mkdir()


@pytest.mark.parametrize("env_dir", [True, False])
def test_setup_compile_cache(env_dir, monkeypatch, tmp_path):
    """With ``JAX_COMPILATION_CACHE_DIR`` set the helper leaves JAX's
    config alone; without it the cache goes to ``<checkout>/.jax_cache``."""
    from nsol_tpu.jitutil import DEFAULT_COMPILE_CACHE, setup_compile_cache

    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    before = {n: getattr(jax.config, n) for n in names}
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        setup_compile_cache()
        after = {n: getattr(jax.config, n) for n in names}
    finally:
        for n, v in before.items():
            jax.config.update(n, v)
    assert DEFAULT_COMPILE_CACHE == os.path.join(REPO, ".jax_cache")
    if env_dir:
        assert after == before
    else:
        assert after["jax_compilation_cache_dir"] == DEFAULT_COMPILE_CACHE
        assert after["jax_persistent_cache_min_compile_time_secs"] == 0


@pytest.mark.parametrize("kind", ["numpy", "jax"])
def test_jit_closed_hoists_captured_arrays(kind):
    """A captured array reaches the program as an argument, not as an HLO
    literal: the lowered text stays small and the result is unchanged."""
    import jax.numpy as jnp

    from nsol_tpu.jitutil import jit_closed

    big = np.arange(4096.0).reshape(64, 64) / 4096.0
    captured = big if kind == "numpy" else jnp.asarray(big)
    fn = lambda x, s: {"y": x @ captured + s}
    x = jnp.asarray(np.random.RandomState(0).rand(64, 64))
    f = jit_closed(fn, (x, 1.0))
    np.testing.assert_allclose(f(x, 2.0)["y"], np.asarray(x) @ big + 2.0,
                               rtol=1e-12)
    hoisted = len(f.lower(x, 2.0).as_text())
    embedded = len(jax.jit(fn).lower(x, 2.0).as_text())
    assert hoisted * 10 < embedded


@pytest.mark.parametrize("call", ["data_dir", "path_and_read"])
def test_data_dir_without_pil(call, monkeypatch):
    """Every stand-in input is tracked, so resolving the data directory
    and reading the 3-D phantom need no PIL."""
    from nsol_tpu import data
    from nsol_tpu.io import DataReader

    monkeypatch.delenv("NSOL_TPU_DATA_DIR", raising=False)
    monkeypatch.setattr(data, "_REFERENCE_DATA",
                        os.path.join(REPO, "no-such-directory"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    if call == "data_dir":
        assert data.data_dir() == os.path.join(REPO, ".generated_data")
    else:
        reader = DataReader(data.path("3D_SheppLoganPhantom_64.nii.gz"))
        reader.read_data()
        assert reader.get_data().shape == (64, 64, 64)
