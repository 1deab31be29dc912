"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases, at tiny sizes, agrees with its float64 reference."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY_DECONV = dict(n=16, iterations=3, iter_max=4, alpha=0.01, rho=0.5,
                   huber_iterations=2, huber_iter_max=2, irls_cg_iters=3,
                   noise=0.05)
TINY_DENOISE = dict(n=16, iterations=10, alpha=0.03, noise=0.08)
TINY_STUDIES = {
    "pd": dict(n=32, n_alpha=4, iterations=10, noise=0.08, points=(1, 3)),
    "admm": dict(n=12, grid=2, iterations=3, iter_max=4, points=(1, 3)),
    "tk1": dict(n=24, n_alpha=4, iter_max=5, noise=0.05, points=(0, 2)),
}


class InProcessReference(object):
    """Stands in for the CPU child: solves each queued job in this
    (float64, CPU) process."""

    def __init__(self, workdir):
        self._dir = str(workdir)
        self.jobs = []

    def add(self, name, **job):
        job.update(name=name, out=os.path.join(self._dir, name + ".npy"))
        self.jobs.append(job)
        return job["out"]

    def solve_all(self):
        for job in self.jobs:
            np.save(job["out"], cs.reference_solve(job))


@pytest.fixture(scope="module")
def clock():
    return cs.CompileClock()


@pytest.fixture
def no_compile_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_refuses_to_run_without_gpu(where, tmp_path):
    """No GPU (or no repo beside it): non-zero exit, a clear message, and
    no contract line."""
    if where == "repo":
        cwd = REPO
    else:
        cwd = str(tmp_path)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), cwd)
    p = _run_script(cwd, "chip_smoke.py")
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("loss", ["linear", "huber"])
def test_deconvolution_phase_parity(loss, tmp_path, clock,
                                    no_compile_cache):
    ref = InProcessReference(tmp_path)
    path, _ = cs.make_volume_inputs(str(tmp_path), TINY_DECONV["n"], 0)
    run = [r for r in cs.deconvolution_jobs(str(tmp_path), path,
                                            TINY_DECONV, (ref, ref))
           if r["loss"] == loss][0]
    rec = cs.deconvolution_run(clock, run, TINY_DECONV)
    assert rec["steady_s"] >= 0 and rec["outer_it_per_s"] > 0
    ref.solve_all()
    b = cs._load(path)
    par = cs.parity(cs._read_result(run["out"]), np.load(run["ref"]),
                    lambda x: cs.deconv_objective(
                        x, b, float(b.max()), TINY_DECONV["alpha"],
                        data_loss=loss))
    assert par["rel_rms"] < 1e-5


def test_denoising_phase_parity(tmp_path, clock, no_compile_cache):
    ref = InProcessReference(tmp_path)
    _, path = cs.make_volume_inputs(str(tmp_path), TINY_DENOISE["n"], 0)
    run = cs.denoising_job(str(tmp_path), path, TINY_DENOISE, ref)
    cs.denoising_run(clock, run, TINY_DENOISE)
    ref.solve_all()
    b = cs._load(path)
    par = cs.parity(cs._read_result(run["out"]), np.load(run["ref"]),
                    lambda x: cs.denoise_objective(
                        x, b, float(b.max()), TINY_DENOISE["alpha"]))
    assert par["rel_rms"] < 1e-5


@pytest.mark.parametrize("kind", sorted(TINY_STUDIES))
def test_study_phase_parity(kind, tmp_path, clock):
    cfg = TINY_STUDIES[kind]
    ref = InProcessReference(tmp_path)
    obs, grid = cs.study_problem(kind, cfg, 0)
    ref_path, obj = cs.study_job(str(tmp_path), kind, cfg, obs, grid, ref)
    rec, x = cs.study_run(clock, kind, cfg, obs, grid)
    assert rec["grid"] == len(next(iter(grid.values())))
    ref.solve_all()
    par = cs.parity(x, np.load(ref_path), obj)
    assert par["rel_rms"] < 1e-5


def test_blur_methods_phase_agree(clock):
    rec = cs.phase_blur_methods(clock, (16, 20))
    for n in (16, 20):
        assert rec["max_rel_dev_%d" % n] < 1e-6  # float32 applies
        for form in ("matmul", "separable", "fft"):
            assert rec["%s_%d" % (form, n)] > 0


def test_four_cards_phase_on_virtual_devices(clock):
    cfg = dict(n=16, iterations=2, iter_max=3, alpha=0.01, rho=0.5)
    rec = cs.phase_four_cards(clock, cfg, 0)
    assert rec["result_devices"] == [0, 1, 2, 3]
    assert rec["rel_rms"] < 1e-6  # both solves in float32


def test_north_star_phase_gate(clock):
    rec = cs.phase_north_star(clock)
    assert rec["rel_objective"] < 2e-3
