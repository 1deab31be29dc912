"""Host-side stencil construction: Gaussian blur kernels and finite differences.

Kernel *construction* is tiny host-side setup work and stays in NumPy; kernel
*application* is the accelerator hot path and lives in
:mod:`nsol_tpu.ops.conv` / :mod:`nsol_tpu.ops.grad` (XLA conv / FFT /
matmul).

Conventions reproduced from the reference (nsol/kernels.py):

* ``gaussian_kernel``: anisotropic Gaussian from a covariance matrix with
  ``alpha_cut``-sigma support per axis, normalized to sum 1
  (reference: nsol/kernels.py:80-100 for 1D, :120-158 for 2D, :198-238 for 3D).
  The per-axis half width is ``ceil(sqrt(diag(cov)) * alpha_cut / spacing)``.
  The reference builds the quadratic form with the point vector in *array*
  (z,y,x) order but the scaling matrix in *spatial* (x,y,z) order, and then
  reshapes in meshgrid-'ij' order — behavior we reproduce exactly, including
  for anisotropic covariance (see the ``points = [Y, X]`` flip at
  nsol/kernels.py:139 and the reshape at :156).
* Finite differences (reference: nsol/kernels.py:102-112, 160-190, 240-286):
  forward difference along image axis ``a`` divided by the spacing of that
  *spatial* direction, where spacing is ordered (x, y, z) = reversed array
  axis order; i.e. the last array axis ("x") uses ``spacing[0]``.
"""

import numpy as np

__all__ = ["gaussian_kernel", "forward_difference_kernel",
           "backward_difference_kernel"]


def gaussian_kernel(cov, alpha_cut=3, spacing=None, dtype=np.float64):
    """Build the normalized Gaussian blur stencil for ``ndim`` dimensions.

    Parameters
    ----------
    cov : scalar (1D) or (d, d) array
        Variance-covariance matrix of the blur in spatial (x, y[, z]) order.
    alpha_cut : float
        Support cut-off in units of sigma per axis (reference default 3).
    spacing : scalar or (d,) array
        Voxel spacing in spatial (x, y[, z]) order; defaults to 1.
    dtype : numpy dtype
        Output dtype (construction always runs in float64).

    Returns
    -------
    kernel : ndarray with ``d`` dimensions, odd-sized per axis, sum == 1.
    """
    cov = np.atleast_2d(np.asarray(cov, dtype=np.float64))
    d = cov.shape[0]
    if cov.shape != (d, d):
        raise ValueError("cov must be square, got shape %s" % (cov.shape,))
    if spacing is None:
        spacing = np.ones(d)
    spacing = np.atleast_1d(np.asarray(spacing, dtype=np.float64))
    if spacing.size != d:
        raise ValueError("spacing must have %d entries" % d)

    # Per-axis half support: ceil(sigma_i * alpha_cut / spacing_i)
    # (reference: nsol/kernels.py:84, :128-129, :206-207).
    half = np.ceil(np.sqrt(cov.diagonal()) * alpha_cut / spacing).astype(int)
    intervals = [np.arange(-h, h + 1, dtype=np.float64) for h in half]

    if d == 1:
        # 1D: values = p^2 * spacing^2 / cov (reference: nsol/kernels.py:93-98)
        pts = intervals[0]
        vals = pts * (spacing[0] ** 2 / cov[0, 0]) * pts
        kernel = np.exp(-0.5 * vals)
        return (kernel / kernel.sum()).astype(dtype)

    # d >= 2: meshgrid in 'ij' order over (x, y[, z]) intervals, point vectors
    # assembled in *reversed* ((z,)y,x) order, quadratic form with
    # S cov^{-1} S where S = diag(spacing in (x,y,z) order) — reproducing the
    # reference's axis pairing exactly (nsol/kernels.py:137-156, :216-236).
    grids = np.meshgrid(*intervals, indexing="ij")
    pts = np.stack([g.reshape(-1) for g in reversed(grids)], axis=0)  # (d, n)
    S = np.diag(spacing)
    M = S @ np.linalg.inv(cov) @ S
    vals = np.sum(pts * (M @ pts), axis=0)
    kernel = np.exp(-0.5 * vals)
    kernel = kernel / kernel.sum()
    return kernel.reshape([iv.size for iv in intervals]).astype(dtype)


def forward_difference_kernel(axis, ndim, spacing=1.0, dtype=np.float64):
    """Forward-difference stencil ``[1, -1]`` along array ``axis``.

    With ndimage-convolve origin conventions this computes
    ``D(x)[i] = x[i+1] - x[i]`` (zero-padded on the right); divided by the
    spacing of the corresponding spatial direction
    (reference: nsol/kernels.py:102-106, :160-166, :240-246).
    """
    shape = [1] * ndim
    shape[axis] = 2
    k = np.array([1.0, -1.0], dtype=dtype) / float(spacing)
    return k.reshape(shape)


def backward_difference_kernel(axis, ndim, spacing=1.0, dtype=np.float64):
    """Backward-difference stencil ``[0, 1, -1]`` along array ``axis``.

    Computes ``D(x)[i] = x[i] - x[i-1]`` (zero-padded on the left)
    (reference: nsol/kernels.py:108-112, :168-174, :248-254).
    """
    shape = [1] * ndim
    shape[axis] = 3
    k = np.array([0.0, 1.0, -1.0], dtype=dtype) / float(spacing)
    return k.reshape(shape)
