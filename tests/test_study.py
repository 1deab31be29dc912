"""Parameter-study engine tests: file schema, reader round-trip,
vmapped-vs-serial equivalence, append/resume semantics."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from nsol_tpu.ops import grad as G
from nsol_tpu.ops import prox as prox_ops
from nsol_tpu.observer import Observer
from nsol_tpu.solvers.wrappers import PrimalDualSolver, ADMMLinearSolver
from nsol_tpu.study import (
    PrimalDualSolverParameterStudy, ADMMLinearSolverParameterStudy,
    ReaderParameterStudy,
)


def _make_pd_solver(b, iterations=5):
    grad_j, grad_adj_j = G.make_gradient_operators()
    bj = jnp.asarray(b)
    return PrimalDualSolver(
        prox_f=lambda x, tau: prox_ops.prox_ell2_denoising(x, tau, bj),
        prox_g_conj=prox_ops.prox_tv_conj,
        B=grad_j, B_conj=grad_adj_j, L2=8.0, x0=np.array(b), alpha=0.1,
        iterations=iterations), grad_j, bj


def _measures(grad_j, bj):
    return {
        "Data": lambda x: 0.5 * jnp.sum((x - bj) ** 2),
        "Reg": lambda x: jnp.sum(
            jnp.sqrt(jnp.sum(grad_j(x) ** 2, axis=0))),
    }


def _run_study(tmp_path, rng, use_vmap, name="study", subdir=None,
               alphas=(0.1, 0.3, 0.6)):
    b = np.random.RandomState(7).rand(12, 14) * 10
    solver, grad_j, bj = _make_pd_solver(b)
    obs = Observer()
    obs.set_measures(_measures(grad_j, bj))
    out = str(tmp_path / (subdir or ("vmap" if use_vmap else "serial")))
    study = PrimalDualSolverParameterStudy(
        solver=solver, observer=obs, dir_output=out, name=name,
        parameters={"alpha": list(alphas)},
        reconstruction_info={"shape": np.array(b.shape)},
        use_vmap=use_vmap)
    study.run()
    return out, b


def test_study_files_written(tmp_path, rng):
    out, b = _run_study(tmp_path, rng, use_vmap=False)
    for suffix in ["_parameters.txt", "_measure_Data.txt",
                   "_measure_Reg.txt", "_computational_time.txt",
                   "_reconstructions.npz"]:
        assert os.path.isfile(os.path.join(out, "study" + suffix)), suffix


def test_reader_roundtrip(tmp_path, rng):
    out, b = _run_study(tmp_path, rng, use_vmap=False)
    reader = ReaderParameterStudy(directory=out, name="study")
    reader.read_study()
    assert sorted(reader.get_measures()) == ["Data", "Reg"]
    params = reader.get_parameters()
    np.testing.assert_allclose(params["alpha"], [0.1, 0.3, 0.6])
    res = reader.get_results("Data")
    assert res.shape == (3, 6)  # 3 configs × (init + 5 iterations)
    p2l = reader.get_parameters_to_line()
    assert len(p2l) == 3
    recon = reader.get_reconstructions()
    assert recon["0"].dtype == np.float16
    assert recon["0"].shape == b.shape
    np.testing.assert_array_equal(recon["shape"], b.shape)
    labels = reader.get_line_to_parameter_labels()
    assert labels[0].startswith("alpha=")


def test_vmapped_matches_serial(tmp_path, rng):
    out_s, _ = _run_study(tmp_path, rng, use_vmap=False, subdir="s")
    out_v, _ = _run_study(tmp_path, rng, use_vmap=True, subdir="v")

    rs = ReaderParameterStudy(directory=out_s, name="study")
    rs.read_study()
    rv = ReaderParameterStudy(directory=out_v, name="study")
    rv.read_study()
    for m in ["Data", "Reg"]:
        np.testing.assert_allclose(rs.get_results(m), rv.get_results(m),
                                   rtol=1e-10)
    np.testing.assert_array_equal(
        rs.get_reconstructions()["2"], rv.get_reconstructions()["2"])


def test_append_resume(tmp_path, rng):
    out, b = _run_study(tmp_path, rng, use_vmap=False, subdir="app",
                        alphas=(0.1, 0.3))
    # Append two more alphas to the same study
    solver, grad_j, bj = _make_pd_solver(b)
    # keep the same data (same b) so the study matches
    rng2 = np.random.RandomState(0)
    obs = Observer()
    obs.set_measures(_measures(grad_j, bj))
    study = PrimalDualSolverParameterStudy(
        solver=solver, observer=obs, dir_output=out, name="study",
        parameters={"alpha": [0.5, 0.9]}, append=True, use_vmap=False)
    study.run()

    reader = ReaderParameterStudy(directory=out, name="study")
    reader.read_study()
    assert reader.get_results("Data").shape[0] == 4
    recon = reader.get_reconstructions()
    assert "3" in recon
    params = reader.get_parameters()
    np.testing.assert_allclose(params["alpha"], [0.1, 0.3, 0.5, 0.9])


def test_append_mismatched_header_raises(tmp_path, rng):
    out, b = _run_study(tmp_path, rng, use_vmap=False, subdir="mm",
                        alphas=(0.1, 0.3))
    solver, grad_j, bj = _make_pd_solver(b, iterations=7)  # changed config
    obs = Observer()
    obs.set_measures(_measures(grad_j, bj))
    study = PrimalDualSolverParameterStudy(
        solver=solver, observer=obs, dir_output=out, name="study",
        parameters={"alpha": [0.5]}, append=True, use_vmap=False)
    with pytest.raises(RuntimeError, match="cannot be appended"):
        study.run()


def test_admm_study_vmapped_alpha_rho_grid(tmp_path, rng):
    import scipy.ndimage as ndi

    from nsol_tpu.ops import kernels as K
    from nsol_tpu.ops import conv as C

    shape = (12, 12)
    cov = np.diag([0.8, 0.8]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    b = ndi.convolve(rng.rand(*shape), kern, mode="wrap")

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    grad_j, grad_adj_j = G.make_gradient_operators()
    solver = ADMMLinearSolver(
        A=Aj, A_adj=Aj_adj, b=b, B=grad_j, B_adj=grad_adj_j,
        x0=np.array(b), dimension=2, iterations=3, iter_max=5)
    obs = Observer()
    bj = jnp.asarray(b)
    obs.set_measures(_measures(grad_j, bj))
    out = str(tmp_path / "admm")
    study = ADMMLinearSolverParameterStudy(
        solver=solver, observer=obs, dir_output=out, name="ADMM",
        parameters={"alpha": [0.01, 0.05], "rho": [0.1, 0.5]})
    study.run()

    reader = ReaderParameterStudy(directory=out, name="ADMM")
    reader.read_study()
    assert reader.get_results("Data").shape == (4, 4)  # 2×2 grid, 3 iters+1
    lines = reader.get_lines_to_parameters(
        {"alpha": [0.01, 0.05], "rho": 0.5})
    assert list(lines) == [1, 3]


def test_admm_study_robust_irls_sweep(tmp_path, rng):
    """Robust (huber) ADMM sweeps vmap the IRLS inner engine over the
    alpha×rho grid; one grid cell must equal the direct solve with the same
    parameters."""
    import scipy.ndimage as ndi

    from nsol_tpu.ops import kernels as K
    from nsol_tpu.ops import conv as C
    from nsol_tpu.solvers.admm import admm_solve

    shape = (12, 12)
    cov = np.diag([0.8, 0.8]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    b = ndi.convolve(rng.rand(*shape), kern, mode="wrap")

    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    grad_j, grad_adj_j = G.make_gradient_operators()
    solver = ADMMLinearSolver(
        A=Aj, A_adj=Aj_adj, b=b, B=grad_j, B_adj=grad_adj_j,
        x0=np.array(b), dimension=2, iterations=3, iter_max=4,
        data_loss="huber", data_loss_scale=0.7, minimizer="irls")
    obs = Observer()
    bj = jnp.asarray(b)
    obs.set_measures(_measures(grad_j, bj))
    out = str(tmp_path / "admm_irls")
    study = ADMMLinearSolverParameterStudy(
        solver=solver, observer=obs, dir_output=out, name="ADMM",
        parameters={"alpha": [0.01, 0.05], "rho": [0.1, 0.5]})
    study.run()

    reader = ReaderParameterStudy(directory=out, name="ADMM")
    reader.read_study()
    data = reader.get_results("Data")
    assert data.shape == (4, 4)
    assert np.isfinite(data).all()

    # Grid cell (alpha=0.05, rho=0.5) == direct solve with those params.
    recon = reader.get_reconstructions()
    line = reader.get_lines_to_parameters(
        {"alpha": [0.01, 0.05], "rho": 0.5})[1]
    x_direct, _ = admm_solve(
        Aj, Aj_adj, grad_j, grad_adj_j, bj, 0.0, bj, 0.05, 0.5,
        iterations=3, iter_max=4, data_loss="huber", data_loss_scale=0.7,
        minimizer="irls")
    np.testing.assert_allclose(
        np.asarray(recon[str(line)], dtype=np.float64).reshape(shape),
        np.asarray(x_direct, dtype=np.float64), atol=2e-3)  # f16 npz storage


def test_vmapped_sweep_sharded_over_batch_mesh(tmp_path, rng):
    """The vmapped alpha sweep sharded over a 4-device batch mesh equals the
    single-device sweep (BASELINE config 4 scale-out)."""
    import jax
    from nsol_tpu.parallel import make_mesh

    b = np.random.RandomState(11).rand(12, 14) * 10
    solver, grad_j, bj = _make_pd_solver(b)
    obs = Observer()
    obs.set_measures(_measures(grad_j, bj))
    out_plain = str(tmp_path / "plain")
    # 5 alphas over 4 devices exercises the padding path
    alphas = [0.1, 0.2, 0.4, 0.6, 0.8]
    study = PrimalDualSolverParameterStudy(
        solver=solver, observer=obs, dir_output=out_plain, name="study",
        parameters={"alpha": alphas}, use_vmap=True)
    study.run()

    solver2, grad_j2, bj2 = _make_pd_solver(b)
    obs2 = Observer()
    obs2.set_measures(_measures(grad_j2, bj2))
    out_mesh = str(tmp_path / "meshed")
    mesh = make_mesh((4,), ("batch",))
    study2 = PrimalDualSolverParameterStudy(
        solver=solver2, observer=obs2, dir_output=out_mesh, name="study",
        parameters={"alpha": alphas}, use_vmap=True, mesh=mesh)
    study2.run()

    r1 = ReaderParameterStudy(directory=out_plain, name="study")
    r1.read_study()
    r2 = ReaderParameterStudy(directory=out_mesh, name="study")
    r2.read_study()
    for m in ["Data", "Reg"]:
        np.testing.assert_allclose(r1.get_results(m), r2.get_results(m),
                                   rtol=1e-12)
    np.testing.assert_array_equal(
        r1.get_reconstructions()["4"], r2.get_reconstructions()["4"])


def test_mixed_string_and_scalar_sweep_serial(tmp_path, rng):
    """Sweeping a non-vmappable key (alg_type strings) falls back to the
    reflective serial loop and still writes a consistent study."""
    b = np.random.RandomState(5).rand(10, 12) * 8
    solver, grad_j, bj = _make_pd_solver(b)
    obs = Observer()
    obs.set_measures(_measures(grad_j, bj))
    out = str(tmp_path / "mixed")
    study = PrimalDualSolverParameterStudy(
        solver=solver, observer=obs, dir_output=out, name="mix",
        parameters={"alpha": [0.1, 0.5],
                    "alg_type": ["ALG2", "ALG3"]})
    study.run()

    reader = ReaderParameterStudy(directory=out, name="mix")
    reader.read_study()
    assert reader.get_results("Data").shape[0] == 4
    params = reader.get_parameters()
    assert params["alg_type"] == ["ALG2", "ALG3"]
    lines = reader.get_lines_to_parameters(
        {"alpha": [0.1, 0.5], "alg_type": "ALG3"})
    assert list(lines) == [1, 3]


def test_hybrid_sweep_matches_serial(tmp_path, rng):
    """alpha×data_loss grid: hybrid (vmap-within-static-groups) rows equal
    the fully serial sweep rows in the reference's cartesian order."""
    import scipy.ndimage as ndi

    from nsol_tpu.ops import kernels as K
    from nsol_tpu.ops import conv as C
    from nsol_tpu.solvers.wrappers import TikhonovLinearSolver
    from nsol_tpu.study import TikhonovLinearSolverParameterStudy

    shape = (12, 12)
    cov = np.diag([0.8, 0.8]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    b = ndi.convolve(np.random.RandomState(3).rand(*shape), kern,
                     mode="wrap")
    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    ident = lambda z: z
    grad_j, grad_adj_j = G.make_gradient_operators()
    bj = jnp.asarray(b)
    params = {"alpha": [0.01, 0.05, 0.2], "data_loss": ["linear", "arctan"]}

    outs = {}
    for mode, use_vmap in [("serial", False), ("hybrid", True)]:
        solver = TikhonovLinearSolver(
            A=Aj, A_adj=Aj_adj, b=b, B=ident, B_adj=ident,
            x0=np.array(b), iter_max=5, minimizer="L-BFGS-B")
        obs = Observer()
        obs.set_measures(_measures(grad_j, bj))
        out = str(tmp_path / mode)
        study = TikhonovLinearSolverParameterStudy(
            solver=solver, observer=obs, dir_output=out, name="tik",
            parameters=params, use_vmap=use_vmap)
        study.run()
        outs[mode] = out

    rs = ReaderParameterStudy(directory=outs["serial"], name="tik")
    rs.read_study()
    rh = ReaderParameterStudy(directory=outs["hybrid"], name="tik")
    rh.read_study()
    assert rs.get_parameters_to_line() == rh.get_parameters_to_line()
    for m in ["Data", "Reg"]:
        np.testing.assert_allclose(rs.get_results(m), rh.get_results(m),
                                   rtol=1e-8)


def test_computational_time_semantics_documented(tmp_path, rng):
    """The timing file's header states the vmapped-sweep amortization
    (batch wall-time / #configs), and vmapped rows are equal-valued (one
    batched program) while remaining parseable."""
    out, b = _run_study(tmp_path, rng, use_vmap=True, subdir="timing")
    path = os.path.join(out, "study_computational_time.txt")
    with open(path) as f:
        lines = f.readlines()
    assert "amortized" in lines[1]
    rows = [line.strip() for line in lines[2:]]
    assert len(rows) == 3
    assert len(set(rows)) == 1  # amortized: every row carries the same value


def test_append_resume_skips_completed_rows(tmp_path, rng):
    """Re-running a killed sweep with the SAME grid in
    append mode executes only the missing combinations; a fully-stored
    grid runs nothing and leaves the files untouched."""
    # "killed mid-grid": the first run covered only 2 of 4 alphas
    out, b = _run_study(tmp_path, rng, use_vmap=False, subdir="resume",
                        alphas=(0.1, 0.3))

    run_counter = {"n": 0}

    def make_counting_solver():
        solver, grad_j, bj = _make_pd_solver(b)
        orig = solver.run

        def counting_run():
            run_counter["n"] += 1
            return orig()

        solver.run = counting_run
        return solver, grad_j, bj

    # re-run with the FULL grid: only the 2 missing alphas execute
    solver, grad_j, bj = make_counting_solver()
    obs = Observer()
    obs.set_measures(_measures(grad_j, bj))
    study = PrimalDualSolverParameterStudy(
        solver=solver, observer=obs, dir_output=out, name="study",
        parameters={"alpha": [0.1, 0.3, 0.5, 0.9]}, append=True,
        use_vmap=False)
    study.run()
    assert run_counter["n"] == 2

    reader = ReaderParameterStudy(directory=out, name="study")
    reader.read_study()
    assert reader.get_results("Data").shape[0] == 4
    np.testing.assert_allclose(
        sorted(float(a) for a in reader.get_parameters()["alpha"]),
        [0.1, 0.3, 0.5, 0.9])
    assert set(reader.get_reconstructions()) >= {"0", "1", "2", "3"}

    # complete study: nothing runs, artifacts unchanged
    before = open(os.path.join(out, "study_parameters.txt")).read()
    solver2, grad_j, bj = make_counting_solver()
    run_counter["n"] = 0
    obs2 = Observer()
    obs2.set_measures(_measures(grad_j, bj))
    study2 = PrimalDualSolverParameterStudy(
        solver=solver2, observer=obs2, dir_output=out, name="study",
        parameters={"alpha": [0.1, 0.3, 0.5, 0.9]}, append=True,
        use_vmap=False)
    study2.run()
    assert run_counter["n"] == 0
    after = open(os.path.join(out, "study_parameters.txt")).read()
    assert after == before


def test_append_resume_vmapped_runs_only_missing(tmp_path, rng):
    """The vmapped fast path also resumes: only the missing combinations
    enter the batched program."""
    out, b = _run_study(tmp_path, rng, use_vmap=True, subdir="resumev",
                        alphas=(0.1, 0.3))
    solver, grad_j, bj = _make_pd_solver(b)
    obs = Observer()
    obs.set_measures(_measures(grad_j, bj))
    study = PrimalDualSolverParameterStudy(
        solver=solver, observer=obs, dir_output=out, name="study",
        parameters={"alpha": [0.1, 0.3, 0.5, 0.9]}, append=True,
        use_vmap=True)
    study.run()
    reader = ReaderParameterStudy(directory=out, name="study")
    reader.read_study()
    assert reader.get_results("Data").shape[0] == 4
    np.testing.assert_allclose(
        sorted(float(a) for a in reader.get_parameters()["alpha"]),
        [0.1, 0.3, 0.5, 0.9])


def test_study_data_loss_sweep_with_auto_minimizer(tmp_path, rng):
    """A data_loss-sweeping Tikhonov study with minimizer='auto' and the
    blur hint re-resolves per group (linear -> cg, huber -> irls) through
    the hybrid sweep path and persists sane artifacts."""
    import scipy.ndimage as ndi

    from nsol_tpu.ops import kernels as K
    from nsol_tpu.ops import conv as C
    from nsol_tpu.solvers.wrappers import TikhonovLinearSolver
    from nsol_tpu.study.engine import TikhonovLinearSolverParameterStudy

    shape = (12, 12)
    cov = np.diag([0.8, 0.8]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(2))
    b = ndi.convolve(rng.rand(*shape), kern, mode="wrap")
    Aj, Aj_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                       method="fft")
    ident = lambda x: x
    solver = TikhonovLinearSolver(
        A=Aj, A_adj=Aj_adj, b=b, B=ident, B_adj=ident, x0=np.array(b),
        minimizer="auto", iter_max=4, blur_cov=cov, reg_kind="TK0")
    assert solver._resolved_minimizer() == "cg"
    solver.set_data_loss("huber")
    assert solver._resolved_minimizer() == "irls"
    solver.set_data_loss("linear")

    obs = Observer()
    obs.set_measures({"Data": lambda x: 0.5 * jnp.sum(
        (x - jnp.asarray(b)) ** 2)})
    out = str(tmp_path / "auto")
    study = TikhonovLinearSolverParameterStudy(
        solver=solver, observer=obs, dir_output=out, name="auto",
        parameters={"alpha": [0.01, 0.05],
                    "data_loss": ["linear", "huber"]})
    study.run()

    reader = ReaderParameterStudy(directory=out, name="auto")
    reader.read_study()
    res = reader.get_results("Data")
    assert res.shape[0] == 4 and np.isfinite(res).all()
