"""Sharded-operator tests on the fake 8-device CPU mesh.

The critical guard (SURVEY.md §4): sharded stencils must equal their
single-device counterparts exactly, and the adjointness dot-product test
must hold under sharding with psum-reduced inner products — this validates
halo-exchange correctness including wrap at global edges.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from nsol_tpu.ops import grad as G
from nsol_tpu.ops import conv as C
from nsol_tpu.ops import kernels as K
from nsol_tpu.parallel import (
    make_mesh, make_sharded_gradient_operators,
    make_sharded_blur_operators, sharded_tv_admm_solve,
    make_sharded_matmul_blur_operators,
    make_sharded_matmul_normal_blur_operator,
    make_sharded_matmul_gradient_normal,
)
from nsol_tpu.solvers.cg import tree_vdot
from nsol_tpu.solvers.admm import admm_solve

N_DEV = 4


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= N_DEV
    return make_mesh((N_DEV,), ("space",))


@pytest.mark.parametrize("ndim", [2, 3])
def test_sharded_gradient_matches_local(mesh, ndim, rng):
    shape = (16, 24) if ndim == 2 else (16, 12, 10)
    spacing = [1.5, 0.8, 1.1][:ndim]
    x = rng.rand(*shape)

    grad_s, _ = make_sharded_gradient_operators(
        spacing, axis_name="space", n_shards=N_DEV)

    f = jax.jit(jax.shard_map(
        grad_s, mesh=mesh, in_specs=P("space"),
        out_specs=P(None, "space")))
    ours = np.asarray(f(jnp.asarray(x)))
    ref = np.asarray(G.gradient(jnp.asarray(x), spacing))
    np.testing.assert_array_almost_equal(ours, ref, decimal=12)


@pytest.mark.parametrize("ndim", [2, 3])
def test_sharded_gradient_adjoint_matches_local(mesh, ndim, rng):
    shape = (16, 24) if ndim == 2 else (16, 12, 10)
    spacing = [1.5, 0.8, 1.1][:ndim]
    g = rng.rand(ndim, *shape)

    _, grad_adj_s = make_sharded_gradient_operators(
        spacing, axis_name="space", n_shards=N_DEV)

    f = jax.jit(jax.shard_map(
        grad_adj_s, mesh=mesh, in_specs=P(None, "space"),
        out_specs=P("space")))
    ours = np.asarray(f(jnp.asarray(g)))
    ref = np.asarray(G.gradient_adjoint(jnp.asarray(g), spacing))
    np.testing.assert_array_almost_equal(ours, ref, decimal=12)


@pytest.mark.parametrize("ndim", [2, 3])
def test_sharded_blur_matches_local_wrap(mesh, ndim, rng):
    shape = (16, 24) if ndim == 2 else (16, 12, 10)
    cov = np.diag([1.5, 1.0, 0.8][:ndim]) ** 2
    x = rng.rand(*shape)
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(ndim))

    A_s, _ = make_sharded_blur_operators(
        cov, alpha_cut=3, spacing=np.ones(ndim), axis_name="space",
        n_shards=N_DEV)
    f = jax.jit(jax.shard_map(
        A_s, mesh=mesh, in_specs=P("space"), out_specs=P("space")))
    ours = np.asarray(f(jnp.asarray(x)))
    ref = np.asarray(C.convolve(jnp.asarray(x), kern, mode="wrap"))
    np.testing.assert_array_almost_equal(ours, ref, decimal=12)


@pytest.mark.parametrize("ndim", [2, 3])
def test_sharded_matmul_blur_matches_local_wrap(mesh, ndim, rng):
    """Matmul sharded blur (ring halo + band/circulant matmuls) equals the
    single-device wrap convolution."""
    shape = (16, 24) if ndim == 2 else (16, 12, 10)
    cov = np.diag([1.5, 1.0, 0.8][:ndim]) ** 2
    x = rng.rand(*shape)
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(ndim))
    local_shape = (shape[0] // N_DEV,) + shape[1:]

    A_s, _ = make_sharded_matmul_blur_operators(
        cov, alpha_cut=3, spacing=np.ones(ndim), local_shape=local_shape,
        axis_name="space", n_shards=N_DEV, dtype=x.dtype)
    f = jax.jit(jax.shard_map(
        A_s, mesh=mesh, in_specs=P("space"), out_specs=P("space")))
    ours = np.asarray(f(jnp.asarray(x)))
    ref = np.asarray(C.convolve(jnp.asarray(x), kern, mode="wrap"))
    np.testing.assert_array_almost_equal(ours, ref, decimal=12)


@pytest.mark.parametrize("ndim", [2, 3])
def test_sharded_matmul_normal_blur_matches_local(mesh, ndim, rng):
    """Sharded AᵀA (self-correlated separable pass as matmuls) equals the
    single-device fused normal operator."""
    shape = (16, 24) if ndim == 2 else (16, 12, 10)
    cov = np.diag([1.5, 1.0, 0.8][:ndim]) ** 2
    x = rng.rand(*shape)
    local_shape = (shape[0] // N_DEV,) + shape[1:]

    nA_s = make_sharded_matmul_normal_blur_operator(
        cov, alpha_cut=3, spacing=np.ones(ndim), local_shape=local_shape,
        axis_name="space", n_shards=N_DEV, dtype=x.dtype)
    f = jax.jit(jax.shard_map(
        nA_s, mesh=mesh, in_specs=P("space"), out_specs=P("space")))
    ours = np.asarray(f(jnp.asarray(x)))

    nA = C.make_normal_blur_operator(cov, alpha_cut=3,
                                     spacing=np.ones(ndim), shape=shape)
    ref = np.asarray(jax.jit(nA)(jnp.asarray(x)))
    np.testing.assert_array_almost_equal(ours, ref, decimal=12)


@pytest.mark.parametrize("ndim", [2, 3])
def test_sharded_matmul_gradient_normal_matches_local(mesh, ndim, rng):
    """Sharded DᵀD (band matmul + rank-0 boundary fixup) equals the fused
    single-device Laplacian, including the forward-difference boundary rows
    and anisotropic spacing."""
    shape = (16, 24) if ndim == 2 else (16, 12, 10)
    spacing = [1.5, 0.8, 1.1][:ndim]
    x = rng.rand(*shape)
    local_shape = (shape[0] // N_DEV,) + shape[1:]

    nB_s = make_sharded_matmul_gradient_normal(
        local_shape, spacing=spacing, axis_name="space", n_shards=N_DEV,
        dtype=x.dtype)
    f = jax.jit(jax.shard_map(
        nB_s, mesh=mesh, in_specs=P("space"), out_specs=P("space")))
    ours = np.asarray(f(jnp.asarray(x)))
    ref = np.asarray(G.gradient_normal(jnp.asarray(x), spacing))
    np.testing.assert_array_almost_equal(ours, ref, decimal=12)


def test_sharded_adjointness_with_psum(mesh, rng):
    """<Ax,y> == <x,Aᵀy> where the inner products themselves are computed
    distributed (psum over the mesh axis)."""
    shape = (16, 12, 10)
    x = rng.rand(*shape)
    y = rng.rand(3, *shape)
    spacing = [1.5, 0.8, 1.1]

    grad_s, grad_adj_s = make_sharded_gradient_operators(
        spacing, axis_name="space", n_shards=N_DEV)

    def both(x_loc, y_loc):
        lhs = tree_vdot(grad_s(x_loc), y_loc, axis_name="space")
        rhs = tree_vdot(x_loc, grad_adj_s(y_loc), axis_name="space")
        return lhs, rhs

    f = jax.jit(jax.shard_map(
        both, mesh=mesh, in_specs=(P("space"), P(None, "space")),
        out_specs=(P(), P())))
    lhs, rhs = f(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_almost_equal(float(lhs), float(rhs), decimal=10)


@pytest.mark.parametrize("minimizer", ["lsmr", "cg"])
def test_sharded_tv_admm_matches_single_device(mesh, minimizer, rng):
    """End-to-end: the full sharded ADMM (halo stencils + psum-reduced
    Krylov inner solve) equals the single-device solve on the assembled
    volume — for both the augmented-CGLS path and the fused
    normal-equation matmul path (the auto-selected default)."""
    shape = (16, 12, 10)
    cov = np.diag([0.8, 0.8, 0.8]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(3))
    import scipy.ndimage as ndi

    x_true = rng.rand(*shape)
    b = ndi.convolve(x_true, kern, mode="wrap")
    alpha, rho = 0.01, 0.5

    x_sharded = np.asarray(sharded_tv_admm_solve(
        mesh, cov, b, np.array(b), alpha, rho, iterations=5, iter_max=5,
        minimizer=minimizer))

    if minimizer == "cg":
        A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                         method="matmul", dtype=b.dtype)
        normal_A = C.make_normal_blur_operator(cov, alpha_cut=3, shape=shape,
                                               dtype=b.dtype)
        normal_B = G.gradient_normal
    else:
        A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                         method="fft")
        normal_A = normal_B = None
    Bg, Bg_adj = G.make_gradient_operators()
    x_single, _ = jax.jit(partial(
        admm_solve, A, A_adj, Bg, Bg_adj, iterations=5, iter_max=5,
        minimizer=minimizer, normal_A=normal_A, normal_B=normal_B))(
        jnp.asarray(b), 0.0, jnp.asarray(b), alpha, rho)

    np.testing.assert_allclose(x_sharded, np.asarray(x_single),
                               atol=1e-9)


def test_sharded_robust_admm_matches_single_device(mesh, rng):
    """Robust (huber) data loss under sharding with the explicit
    shard-aware box L-BFGS (psum-reduced global cost + curvature inner
    products), whose iterates are exact shards of the single-device
    trajectory."""
    shape = (16, 12, 10)
    cov = np.diag([0.8, 0.8, 0.8]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(3))
    import scipy.ndimage as ndi

    x_true = rng.rand(*shape)
    b = ndi.convolve(x_true, kern, mode="wrap")
    alpha, rho = 0.01, 0.5

    x_sharded = np.asarray(sharded_tv_admm_solve(
        mesh, cov, b, np.array(b), alpha, rho, iterations=3, iter_max=5,
        data_loss="huber", data_loss_scale=0.5, minimizer="L-BFGS-B"))

    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     method="direct")
    Bg, Bg_adj = G.make_gradient_operators()
    x_single, _ = jax.jit(partial(
        admm_solve, A, A_adj, Bg, Bg_adj, iterations=3, iter_max=5,
        data_loss="huber", data_loss_scale=0.5, minimizer="L-BFGS-B"))(
        jnp.asarray(b), 0.0, jnp.asarray(b), alpha, rho)

    np.testing.assert_allclose(x_sharded, np.asarray(x_single), atol=1e-8)


def test_sharded_robust_admm_autoselects_irls(mesh, rng):
    """Robust loss + separable blur auto-selects shard-aware IRLS
    (reweighted normal-equation CG on the sharded matmul operators); the
    sharded solve equals the single-device IRLS trajectory."""
    shape = (16, 12, 10)
    cov = np.diag([0.8, 0.8, 0.8]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(3))
    import scipy.ndimage as ndi

    x_true = rng.rand(*shape)
    b = ndi.convolve(x_true, kern, mode="wrap")
    alpha, rho = 0.01, 0.5

    x_sharded = np.asarray(sharded_tv_admm_solve(
        mesh, cov, b, np.array(b), alpha, rho, iterations=3, iter_max=4,
        data_loss="huber", data_loss_scale=0.5))

    A, A_adj = C.make_blur_operators(cov, alpha_cut=3, shape=shape,
                                     method="matmul", dtype=b.dtype)
    from nsol_tpu.ops.matmul_ops import matmul_gradient_normal_fn
    normal_B = matmul_gradient_normal_fn(shape, dtype=b.dtype)
    Bg, Bg_adj = G.make_gradient_operators()
    x_single, _ = jax.jit(partial(
        admm_solve, A, A_adj, Bg, Bg_adj, iterations=3, iter_max=4,
        data_loss="huber", data_loss_scale=0.5, minimizer="irls",
        normal_B=normal_B))(
        jnp.asarray(b), 0.0, jnp.asarray(b), alpha, rho)

    np.testing.assert_allclose(x_sharded, np.asarray(x_single), atol=1e-8)


@pytest.mark.parametrize("variant", ["TVL2", "HuberL1"])
def test_sharded_pd_denoise_matches_single_device(mesh, variant, rng):
    """Sharded Chambolle–Pock denoising equals the single-device solve."""
    from functools import partial as _partial

    from nsol_tpu.parallel import sharded_tv_denoise_solve
    from nsol_tpu.solvers.primal_dual import primal_dual_solve
    from nsol_tpu.ops import prox as prox_ops

    shape = (16, 12, 10)
    b = rng.rand(*shape)
    alpha = 0.4

    x_sharded = np.asarray(sharded_tv_denoise_solve(
        mesh, b, alpha, iterations=10, variant=variant))

    bj = jnp.asarray(b)
    prox_f = (prox_ops.prox_ell2_denoising if variant.endswith("L2")
              else prox_ops.prox_ell1_denoising)
    prox_g = (prox_ops.prox_tv_conj if variant.startswith("TV")
              else prox_ops.prox_huber_conj)
    Bg, Bg_adj = G.make_gradient_operators()
    x_single, _ = jax.jit(_partial(
        primal_dual_solve, lambda x, tau: prox_f(x, tau, bj), prox_g,
        Bg, Bg_adj, iterations=10))(bj, alpha, 8.0)
    np.testing.assert_allclose(x_sharded, np.asarray(x_single), atol=1e-11)


def test_process_local_slice_and_readback(mesh, rng):
    """The process-local I/O contract: on a single process the slice covers
    the whole volume, and process_local_data returns exactly this
    process's rows of a sharded result in global order."""
    from nsol_tpu.parallel import distributed as dist

    shape = (4 * N_DEV, 6, 5)
    start, stop = dist.process_local_slice(shape, mesh)
    assert (start, stop) == (0, shape[0])  # single process owns all rows

    b = rng.rand(*shape)
    g = dist.global_array_from_process_local(mesh, b[start:stop])
    assert g.shape == shape
    np.testing.assert_array_equal(dist.process_local_data(g), b)

    with pytest.raises(ValueError, match="not divisible"):
        dist.process_local_slice((4 * N_DEV + 1, 6, 5), mesh)


def test_sharded_admm_process_local_matches_global_input(mesh, rng):
    """sharded_tv_admm_solve(process_local=True) — the multi-host code path
    (jax.make_array_from_process_local_data construction) — must be
    bit-identical to the legacy full-volume device_put path."""
    from nsol_tpu.parallel import distributed as dist

    dist.initialize(num_processes=1)  # no-op, exercised for coverage
    shape = (4 * N_DEV, 12, 10)
    cov = np.diag([0.8, 0.8, 0.8]) ** 2
    kern = K.gaussian_kernel(cov, alpha_cut=3, spacing=np.ones(3))
    import scipy.ndimage as ndi
    b = ndi.convolve(rng.rand(*shape), kern, mode="wrap")

    x_global = np.asarray(sharded_tv_admm_solve(
        mesh, cov, b, np.array(b), alpha=0.01, rho=0.5,
        iterations=4, iter_max=4))
    start, stop = dist.process_local_slice(shape, mesh)
    x_pl = sharded_tv_admm_solve(
        mesh, cov, b[start:stop], np.array(b[start:stop]), alpha=0.01,
        rho=0.5, iterations=4, iter_max=4, process_local=True)
    np.testing.assert_array_equal(np.asarray(x_pl), x_global)
    np.testing.assert_array_equal(dist.process_local_data(x_pl),
                                  x_global[start:stop])
