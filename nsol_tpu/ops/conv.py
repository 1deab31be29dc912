"""Convolution operators: Gaussian blur A/Aᵀ and general stencils.

The reference applies blur via ``scipy.ndimage.convolve`` with
``mode="wrap"`` (nsol/linear_operators.py:60-68). Circular (wrap) boundary
conditions make the operator exactly diagonal in Fourier space, so one
implementation is an FFT product — O(n log n), exact adjoint, and a single
fused XLA computation. For small kernels a direct
(separable, when the covariance is diagonal) ``lax.conv_general_dilated``
path is provided; benchmarking picks the winner per problem size.

Semantics pinned to ``scipy.ndimage.convolve``:

``y[i] = Σ_j k[j] · x[i + c − j]`` per axis with origin ``c = L // 2``

verified numerically for odd and even kernels (e.g. forward difference
``[1,-1]`` yields ``y[i] = x[i+1] - x[i]``).
"""

import numpy as np
import jax.numpy as jnp
from jax import lax

__all__ = [
    "convolve", "fft_convolve_fn", "make_blur_operators",
    "embed_kernel_fft", "separable_factors", "separable_convolve_fn",
    "make_normal_blur_operator",
]


def _per_axis_pads(kshape):
    """Left/right pads so that valid correlation with the flipped kernel
    reproduces ndimage.convolve's centered-origin convolution."""
    pads = []
    for L in kshape:
        c = L // 2
        pads.append((L - 1 - c, c))
    return pads


def convolve(x, kernel, mode="wrap", prepadded_axes=()):
    """ndimage-semantics N-D convolution of ``x`` with ``kernel``.

    ``mode``: "wrap" (circular) or "constant" (zero padding), matching the
    two modes the reference uses (blur: wrap; derivatives: constant;
    nsol/linear_operators.py:60-68, 98-106).

    ``prepadded_axes``: axes the caller already padded (used by the sharded
    path, where the halo exchange supplies the sharded axis's boundary).
    """
    kernel = jnp.asarray(kernel, dtype=x.dtype)
    if kernel.ndim != x.ndim:
        raise ValueError("kernel ndim %d != input ndim %d"
                         % (kernel.ndim, x.ndim))
    pads = _per_axis_pads(kernel.shape)
    pads = [((0, 0) if ax in prepadded_axes else p)
            for ax, p in enumerate(pads)]
    pad_mode = {"wrap": "wrap", "constant": "constant"}[mode]
    xp = jnp.pad(x, pads, mode=pad_mode)
    # correlation with the flipped kernel == convolution
    kflip = jnp.flip(kernel)
    lhs = xp[jnp.newaxis, jnp.newaxis]          # NCHW-style
    rhs = kflip[jnp.newaxis, jnp.newaxis]       # OIHW-style
    dn = lax.conv_dimension_numbers(lhs.shape, rhs.shape,
                                    _conv_dim_strings(x.ndim))
    out = lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,) * x.ndim, padding="VALID",
        dimension_numbers=dn,
        precision=lax.Precision.HIGHEST,
        preferred_element_type=x.dtype,
    )
    return out[0, 0]


def _conv_dim_strings(ndim):
    sp = "0123456789"[:ndim]
    return ("NC" + sp, "OI" + sp, "NC" + sp)


def embed_kernel_fft(kernel, shape):
    """Embed a small stencil into a ``shape``-sized circular impulse response.

    Returns ``h`` such that circular convolution ``x ⊛ h`` equals
    ndimage.convolve(x, kernel, mode="wrap"): ``h[t] = k[t + c]`` with
    indices mod N per axis and origin ``c = L // 2``.
    Host-side NumPy (setup time only).
    """
    kernel = np.asarray(kernel)
    h = np.zeros(shape, dtype=kernel.dtype)
    sl = tuple(slice(0, L) for L in kernel.shape)
    h[sl] = kernel
    shifts = tuple(-(L // 2) for L in kernel.shape)
    return np.roll(h, shifts, axis=tuple(range(kernel.ndim)))


def fft_convolve_fn(kernel, shape, dtype=None):
    """Build a jittable circular-convolution closure via rFFT.

    The kernel's real spectrum is precomputed host-side; the returned
    function is a pure ``rfftn → multiply → irfftn`` chain that XLA compiles
    into one fused program. For the symmetric Gaussian stencils used by the
    blur operator the spectrum is real, so ``A = Aᵀ`` exactly
    (reference exploits the same symmetry: nsol/linear_operators.py:63).
    """
    h = embed_kernel_fft(np.asarray(kernel, dtype=np.float64), shape)
    khat = np.fft.rfftn(h)
    if dtype is None:
        dtype = kernel.dtype

    # For symmetric kernels the spectrum is real; dropping the ~0 imaginary
    # part keeps the multiply real-typed (half the bytes and flops).
    if np.abs(khat.imag).max() < 1e-12 * max(1.0, np.abs(khat.real).max()):
        khat = khat.real
    khat = jnp.asarray(khat, dtype=jnp.complex128 if np.iscomplexobj(khat)
                       else (np.float64 if dtype == np.float64 else np.float32))

    def apply(x):
        xhat = jnp.fft.rfftn(x)
        return jnp.fft.irfftn(xhat * khat, s=shape).astype(x.dtype)

    return apply


def separable_factors(kernel, tol=1e-12):
    """Decompose a rank-1 (separable) stencil into per-axis 1-D factors.

    The Gaussian stencil for *diagonal* covariance is an outer product of
    per-axis factors (including under the reference's axis-pairing quirk —
    a diagonal quadratic form separates). Returns a list of 1-D arrays each
    normalized to sum 1, or ``None`` if the kernel is not separable to
    ``tol`` (e.g. full covariance).
    """
    kernel = np.asarray(kernel)
    if kernel.ndim == 1:
        return [kernel / kernel.sum()]
    center = tuple(s // 2 for s in kernel.shape)
    factors = []
    for ax in range(kernel.ndim):
        idx = list(center)
        idx[ax] = slice(None)
        f = kernel[tuple(idx)].astype(np.float64)
        factors.append(f / f.sum())
    approx = factors[0]
    for f in factors[1:]:
        approx = np.multiply.outer(approx, f)
    approx *= kernel.sum()
    if np.max(np.abs(approx - kernel)) > tol * max(1.0, np.abs(kernel).max()):
        return None
    return [f.astype(kernel.dtype) for f in factors]


def separable_convolve_fn(factors):
    """Jittable circular (wrap) convolution by per-axis 1-D factors via
    roll-accumulate — shifted multiply-adds that XLA fuses into one
    elementwise pass per axis; no FFT, no im2col."""
    taps = [np.asarray(f) for f in factors]

    def apply(x):
        for ax, f in enumerate(taps):
            c = len(f) // 2
            # ndimage convolve semantics: y[i] = Σ_j f[j]·x[i + c − j],
            # i.e. roll by (j − c) per tap.
            acc = f[0] * jnp.roll(x, -c, axis=ax)
            for j in range(1, len(f)):
                acc = acc + f[j] * jnp.roll(x, j - c, axis=ax)
            x = acc
        return x

    return apply


def make_normal_blur_operator(cov, alpha_cut=3, spacing=None, shape=None,
                              dtype=np.float64):
    """Normal operator ``AᵀA`` of the wrap-boundary Gaussian blur as ONE
    convolution with the self-correlated kernel.

    For circular convolution, ``AᵀA`` is convolution with ``k ⋆ k`` (the
    autocorrelation). With a separable kernel the autocorrelation is
    separable too (per-axis ``f ⋆ f``), so the normal-equation CG applies
    one (2L−1)-tap separable pass instead of two L-tap passes — the key
    algebraic optimization of the inner quadratic solver. Falls back to an
    FFT with the squared spectrum for non-separable covariance (requires
    ``shape``).
    """
    from nsol_tpu.ops.kernels import gaussian_kernel

    kernel64 = gaussian_kernel(cov, alpha_cut=alpha_cut, spacing=spacing,
                               dtype=np.float64)
    factors = separable_factors(kernel64)
    if factors is not None:
        if shape is not None and len(shape) > 1:
            # per-axis circulant matmuls; whether the matmul, separable or
            # FFT form is fastest on the GPU at each shape awaits
            # measurement (chip_smoke.py prints all three)
            from nsol_tpu.ops.matmul_ops import \
                make_matmul_normal_blur_operator

            return make_matmul_normal_blur_operator(
                cov, alpha_cut=alpha_cut, spacing=spacing, shape=shape,
                dtype=dtype)
        auto = [np.convolve(f, f[::-1]).astype(dtype) for f in factors]
        return separable_convolve_fn(auto)
    if shape is None:
        raise ValueError("non-separable covariance requires a static shape")
    h = embed_kernel_fft(kernel64, shape)
    khat = np.fft.rfftn(h)
    power = (khat * np.conj(khat)).real
    power = jnp.asarray(power.astype(
        np.float64 if dtype == np.float64 else np.float32))

    def apply(x):
        return jnp.fft.irfftn(jnp.fft.rfftn(x) * power,
                              s=shape).astype(x.dtype)

    return apply


def make_blur_operators(cov, alpha_cut=3, spacing=None, shape=None,
                        method="auto", dtype=np.float64):
    """Gaussian blurring operator pair ``(A, A_adj)``.

    Analogue of the reference's
    ``LinearOperators.get_gaussian_blurring_operators``
    (nsol/linear_operators.py:82-86): builds the covariance-derived stencil
    (wrap boundary) and returns jittable closures. The Gaussian stencil is
    symmetric under per-axis flips, so ``A_adj = A`` — same as the reference's
    ``kernel_adj = kernel`` (nsol/linear_operators.py:63).

    method: "matmul" (per-axis circulant matmuls at HIGHEST precision;
    diagonal covariance + static shape), "separable" (per-axis
    roll-accumulate; shape-polymorphic), "fft" (circular spectrum
    product; requires ``shape``), "direct" (lax conv with wrap padding),
    or "auto" (matmul → separable → fft → direct by availability; which
    form is fastest on the GPU at each shape awaits measurement).
    """
    from nsol_tpu.ops.kernels import gaussian_kernel

    kernel = gaussian_kernel(cov, alpha_cut=alpha_cut, spacing=spacing,
                             dtype=dtype)
    # Separability analysis always in float64 (a float32 kernel never passes
    # the rank-1 check at float64 tolerance).
    kernel64 = gaussian_kernel(cov, alpha_cut=alpha_cut, spacing=spacing,
                               dtype=np.float64)
    factors = separable_factors(kernel64)
    if factors is not None:
        factors = [f.astype(dtype) for f in factors]
    if method == "auto":
        if factors is not None and shape is not None and len(shape) > 1:
            method = "matmul"
        elif factors is not None:
            method = "separable"
        else:
            method = "fft" if shape is not None else "direct"

    if method == "matmul":
        from nsol_tpu.ops.matmul_ops import make_matmul_blur_operators

        return make_matmul_blur_operators(cov, alpha_cut=alpha_cut,
                                          spacing=spacing, shape=shape,
                                          dtype=dtype)

    if method == "separable":
        if factors is None:
            raise ValueError("kernel is not separable (non-diagonal "
                             "covariance); use method='fft' or 'direct'")
        A = separable_convolve_fn(factors)
        return A, A

    if method == "fft":
        if shape is None:
            raise ValueError("method='fft' requires a static shape")
        A = fft_convolve_fn(kernel, shape, dtype=dtype)
        return A, A

    def A(x):
        return convolve(x, kernel, mode="wrap")

    return A, A
