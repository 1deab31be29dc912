"""Mesh construction helpers and sharded problem entry points.

Single source of truth for device meshes (SURVEY.md §7 "Distribution").
Two mesh axes cover the library's scale-out patterns:

* ``"space"`` — spatial domain decomposition of one large volume
  (halo-exchange stencils + psum-reduced CG; BASELINE config 5)
* ``"batch"`` — embarrassingly parallel sweep axis (alpha grids /
  image batches; BASELINE config 4)
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from nsol_tpu.parallel import halo
from nsol_tpu.parallel import matmul_halo
from nsol_tpu.parallel import distributed as dist
from nsol_tpu.jitutil import jit_closed
from nsol_tpu.solvers import admm as _admm
from nsol_tpu.solvers import primal_dual as _pd
from nsol_tpu.ops import prox as _prox

__all__ = ["make_mesh", "make_space_mesh", "sharded_tv_admm_solve",
           "sharded_tv_denoise_solve"]


def make_mesh(shape, axis_names, devices=None):
    devices = np.asarray(devices if devices is not None
                         else jax.devices()[: int(np.prod(shape))])
    return Mesh(devices.reshape(shape), axis_names)


def make_space_mesh(n=None):
    n = n if n is not None else len(jax.devices())
    return make_mesh((n,), ("space",))


def _shard_input(arr, mesh, process_local):
    """Place an input volume on the ``"space"``-sharded mesh.

    ``process_local=True`` treats ``arr`` as THIS process's rows only and
    assembles the logically-global array without any host materializing
    the whole volume (the multi-host path; on one process the local block
    IS the global volume, so the same call covers both).
    ``process_local=False`` keeps the legacy single-process convenience:
    ``arr`` is the full volume on this host.
    """
    if process_local:
        return dist.global_array_from_process_local(mesh, arr,
                                                    axis_name="space")
    if jax.process_count() > 1:
        raise ValueError(
            "a full-volume host array cannot be distributed from one "
            "process on a multi-host mesh; pass process-local rows with "
            "process_local=True (see nsol_tpu.parallel.distributed)")
    return jax.device_put(jnp.asarray(arr),
                          NamedSharding(mesh, P("space")))


def _global_rows(arr, mesh, process_local):
    """Global leading-axis length of an input placed via
    :func:`_shard_input`: with a process-local block, this process's rows
    cover only its share of the mesh axis."""
    if not process_local:
        return arr.shape[0]
    n_shards = mesh.shape["space"]
    axis_devices = mesh.devices.reshape(-1)
    mine = sum(d.process_index == jax.process_index()
               for d in axis_devices)
    if mine == 0 or arr.shape[0] % mine:
        raise ValueError(
            "process-local block of %d rows does not divide evenly over "
            "this process's %d mesh devices" % (arr.shape[0], mine))
    return arr.shape[0] // mine * n_shards


def sharded_tv_admm_solve(mesh, cov, b, x0, alpha, rho, spacing=None,
                          iterations=10, iter_max=10, alpha_cut=3,
                          data_loss="linear", data_loss_scale=1.0,
                          minimizer=None, process_local=False):
    """TV-L2/robust deconvolution of a volume sharded along array axis 0.

    The full ADMM loop (outer splitting + inner Krylov solve) runs inside one
    ``shard_map``: stencils halo-exchange over the ``"space"`` axis and all
    CG inner products / TV magnitudes psum-reduce over it — the answer to
    BASELINE config 5 ("sharded 512³ TV-deconvolution with
    psum-reduced CG").

    ``minimizer=None`` auto-selects: with a linear data loss and a separable
    (diagonal-covariance) blur the inner solve runs ``"cg"`` on the fused
    normal equations with the sharded matmul operators of
    :mod:`nsol_tpu.parallel.matmul_halo` (same optimization ladder as the
    single-chip path: AᵀA as one self-correlated separable pass, DᵀD as
    banded/tridiagonal matmuls); a non-separable blur falls back to
    augmented CGLS over the direct-conv halo stencils. A robust (non-linear)
    ``data_loss`` with a separable blur routes to shard-aware **IRLS**
    (reweighted normal-equation CG on the sharded matmul operators, psum-reduced
    inner products — see ``minimizer="irls"`` in
    :func:`nsol_tpu.solvers.tikhonov.tikhonov_solve`); a non-separable robust
    problem falls back to the shard-aware box L-BFGS (psum-reduced global
    cost and curvature inner products — every rank takes identical steps).

    ``b``/``x0`` are (z, y, x) arrays: the full volume with the default
    ``process_local=False`` (single-process convenience), or — on a
    multi-host slice — each process's OWN rows with ``process_local=True``
    (see :mod:`nsol_tpu.parallel.distributed` for the launch recipe and
    the per-process row ranges). Returns the globally-sharded solution
    `jax.Array`; under multi-host read back this host's rows with
    :func:`nsol_tpu.parallel.distributed.process_local_data`.
    """
    n_shards = mesh.shape["space"]
    axis_name = "space"
    if minimizer == "auto":  # same semantics as the CLI/interface flag
        minimizer = None
    n_rows = _global_rows(b, mesh, process_local)
    if n_rows % n_shards:
        raise ValueError("leading axis %d not divisible by %d shards"
                         % (n_rows, n_shards))

    # Probe separability only for the minimizers that can exploit it —
    # an explicit "lsmr"/"L-BFGS-B" request never reads the result.
    if minimizer in (None, "cg", "irls"):
        from nsol_tpu.ops.conv import separable_factors
        from nsol_tpu.ops.kernels import gaussian_kernel

        kernel64 = gaussian_kernel(cov, alpha_cut=alpha_cut,
                                   spacing=spacing, dtype=np.float64)
        separable = separable_factors(kernel64) is not None
        if minimizer == "irls" and not separable:
            import warnings
            warnings.warn(
                "minimizer='irls' with a non-separable blur runs on the "
                "direct-conv halo operators (no fused normal pass); "
                "expect the slower fallback path", stacklevel=2)
    else:
        separable = False

    normal_A = normal_B = None
    if minimizer is None or minimizer == "cg":
        if minimizer == "cg" and (data_loss != "linear" or not separable):
            raise ValueError("minimizer='cg' requires a linear data loss "
                             "and a separable (diagonal-covariance) blur")
        if data_loss == "linear" and separable:
            minimizer = "cg"
        elif data_loss == "linear":
            minimizer = "lsmr"
        elif separable:
            # Robust data loss, separable blur: MM reweighted CG on the
            # sharded matmul operators — the documented improvement over the
            # reference's scipy L-BFGS-B escape hatch
            # (nsol/tikhonov_linear_solver.py:197-220).
            minimizer = "irls"
        else:
            # Robust + non-separable: shard-aware box L-BFGS (psum-reduced
            # cost + curvature).
            minimizer = "L-BFGS-B"

    if minimizer in ("cg", "irls") and separable:
        local_shape = (n_rows // n_shards,) + tuple(b.shape[1:])
        A, A_adj = matmul_halo.make_sharded_matmul_blur_operators(
            cov, alpha_cut=alpha_cut, spacing=spacing,
            local_shape=local_shape, axis_name=axis_name,
            n_shards=n_shards, dtype=b.dtype)
        normal_A = matmul_halo.make_sharded_matmul_normal_blur_operator(
            cov, alpha_cut=alpha_cut, spacing=spacing,
            local_shape=local_shape, axis_name=axis_name,
            n_shards=n_shards, dtype=b.dtype)
        normal_B = matmul_halo.make_sharded_matmul_gradient_normal(
            local_shape, spacing=spacing, axis_name=axis_name,
            n_shards=n_shards, dtype=b.dtype)
    else:
        A, A_adj = halo.make_sharded_blur_operators(
            cov, alpha_cut=alpha_cut, spacing=spacing, axis_name=axis_name,
            n_shards=n_shards, dtype=b.dtype)
    Bg, Bg_adj = halo.make_sharded_gradient_operators(
        spacing, axis_name=axis_name, n_shards=n_shards)

    def local_solve(b_loc, x0_loc, alpha_v, rho_v):
        x, _ = _admm.admm_solve(
            A, A_adj, Bg, Bg_adj, b_loc, 0.0, x0_loc, alpha_v, rho_v,
            iterations=iterations, iter_max=iter_max, data_loss=data_loss,
            data_loss_scale=data_loss_scale, minimizer=minimizer,
            axis_name=axis_name, normal_A=normal_A, normal_B=normal_B)
        return x

    mapped = jax.shard_map(
        local_solve, mesh=mesh,
        in_specs=(P("space"), P("space"), P(), P()),
        out_specs=P("space"))

    b_d = _shard_input(b, mesh, process_local)
    x0_d = _shard_input(x0, mesh, process_local)
    args = (b_d, x0_d, jnp.asarray(alpha, b_d.dtype),
            jnp.asarray(rho, b_d.dtype))
    return jit_closed(mapped, args)(*args)


def sharded_tv_denoise_solve(mesh, b, alpha, spacing=None, iterations=50,
                             L2=8.0, alg_type="ALG2", variant="TVL2",
                             process_local=False):
    """TV/Huber-L1/L2 denoising of a volume sharded along array axis 0.

    Chambolle–Pock with halo-exchange gradient stencils inside one
    ``shard_map`` — the elementwise proxes are local, only the stencils
    communicate (1-plane ghost zones per iteration).
    ``variant`` ∈ {TVL1, TVL2, HuberL1, HuberL2}. ``process_local`` as in
    :func:`sharded_tv_admm_solve` (multi-host: ``b`` holds only this
    process's rows).
    """
    n_shards = mesh.shape["space"]
    n_rows = _global_rows(b, mesh, process_local)
    if n_rows % n_shards:
        raise ValueError("leading axis %d not divisible by %d shards"
                         % (n_rows, n_shards))

    Bg, Bg_adj = halo.make_sharded_gradient_operators(
        spacing, axis_name="space", n_shards=n_shards)

    if variant in ("TVL1", "HuberL1"):
        prox_f = _prox.prox_ell1_denoising
    elif variant in ("TVL2", "HuberL2"):
        prox_f = _prox.prox_ell2_denoising
    else:
        raise ValueError("variant '%s' not known" % variant)
    prox_g_conj = (_prox.prox_tv_conj if variant.startswith("TV")
                   else _prox.prox_huber_conj)

    def local_solve(b_loc, alpha_v):
        x, _ = _pd.primal_dual_solve(
            lambda x, tau: prox_f(x, tau, b_loc), prox_g_conj,
            Bg, Bg_adj, b_loc, alpha_v, L2, iterations=iterations,
            alg_type=alg_type)
        return x

    mapped = jax.shard_map(
        local_solve, mesh=mesh, in_specs=(P("space"), P()),
        out_specs=P("space"))

    b_d = _shard_input(b, mesh, process_local)
    args = (b_d, jnp.asarray(alpha, b_d.dtype))
    return jit_closed(mapped, args)(*args)
