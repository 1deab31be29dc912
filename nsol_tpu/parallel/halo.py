"""Halo exchange and sharded stencil operators over a device mesh.

The reference has no distribution of any kind (SURVEY.md §2: single-process
numpy); the scale-out for this problem class is *spatial domain
decomposition*: a (z, y, x) volume is sharded along its leading array axis
over a 1-D mesh axis, the 2-point finite-difference stencil exchanges a
1-plane ghost zone, the Gaussian blur stencil exchanges its half-width, and
all CG/solver inner products are ``psum``-reduced (SURVEY.md §5
"long-context analogue"). Collectives ride ``lax.ppermute`` (neighbor
exchanges) rather than all-to-alls.

All functions here run *inside* ``shard_map``: they see the local block and
communicate explicitly. Zero-boundary semantics for the derivative stencils
fall out of ``ppermute``'s convention that un-addressed destinations receive
zeros — exactly the reference's ``mode="constant"`` global edge.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from nsol_tpu.ops import conv as C
from nsol_tpu.ops import grad as G

__all__ = [
    "exchange_plane_up", "exchange_plane_down", "exchange_halo_wrap",
    "make_sharded_gradient_operators", "make_sharded_blur_operators",
]


def _take(x, axis, start, stop):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop)
    return x[tuple(idx)]


def exchange_plane_up(x, axis_name, n_shards, axis=0, width=1):
    """Receive the *first* ``width`` planes of the next-rank neighbor
    (rank+1). The last rank receives zeros (global zero boundary)."""
    planes = _take(x, axis, 0, width)
    perm = [(j, j - 1) for j in range(1, n_shards)]
    return lax.ppermute(planes, axis_name, perm)


def exchange_plane_down(x, axis_name, n_shards, axis=0, width=1):
    """Receive the *last* ``width`` planes of the previous-rank neighbor
    (rank-1). The first rank receives zeros."""
    planes = _take(x, axis, x.shape[axis] - width, x.shape[axis])
    perm = [(j, j + 1) for j in range(n_shards - 1)]
    return lax.ppermute(planes, axis_name, perm)


def _ring_recv(x, axis_name, n_shards, shift):
    """Receive ``x`` from rank ``(j - shift) mod n`` (ring collective)."""
    perm = [(j, (j + shift) % n_shards) for j in range(n_shards)]
    return lax.ppermute(x, axis_name, perm)


def exchange_halo_wrap(x, axis_name, n_shards, lo, hi, axis=0):
    """Circular halo: returns ``concat(prev[lo], x, next[hi])`` along
    ``axis`` with ring wrap-around — the sharded realization of the
    reference's ``mode="wrap"`` blur boundary.

    Supports halo widths exceeding the local extent via multi-hop ring
    permutes (hop ``h`` contributes the relevant slice of the block ``h``
    ranks away); each hop is a neighbor-distance-``h`` ``ppermute``.
    """
    local = x.shape[axis]
    parts_lo = []
    remaining = lo
    hop = 1
    while remaining > 0:
        take = min(remaining, local)
        tail = _take(x, axis, local - take, local)
        parts_lo.insert(0, _ring_recv(tail, axis_name, n_shards, hop))
        remaining -= take
        hop += 1

    parts_hi = []
    remaining = hi
    hop = 1
    while remaining > 0:
        take = min(remaining, local)
        head = _take(x, axis, 0, take)
        parts_hi.append(_ring_recv(head, axis_name, n_shards, -hop))
        remaining -= take
        hop += 1

    return jnp.concatenate(parts_lo + [x] + parts_hi, axis=axis)


def make_sharded_gradient_operators(spacing=None, axis_name="z",
                                    n_shards=1, ndim=None):
    """Gradient/divergence pair for blocks sharded along array axis 0.

    Matches :func:`nsol_tpu.ops.grad.gradient` exactly on the assembled
    global array (component ordering, spacing conventions, zero boundary) —
    the adjointness dot-product test transfers verbatim to the sharded pair
    when inner products are psum-reduced.
    """
    def grad(x):
        nd = x.ndim
        s = G._spacing_array(spacing, nd)
        comps = []
        for i in range(nd):
            axis = nd - 1 - i
            if axis == 0:
                # D(x)[k] = x[k+1] - x[k]; the last local entry needs the
                # neighbor's first plane (zeros at the global end).
                nxt = exchange_plane_up(x, axis_name, n_shards, axis=0)
                upper = jnp.concatenate([_take(x, 0, 1, None), nxt], axis=0)
                d = upper - x
            else:
                d = G.forward_difference(x, axis)
            comps.append(d / s[i].astype(x.dtype))
        return jnp.stack(comps, axis=0)

    def grad_adj(g):
        nd = g.ndim - 1
        s = G._spacing_array(spacing, nd)
        out = None
        for i in range(nd):
            axis = nd - 1 - i
            gi = g[i]
            if axis == 0:
                # Dᵀ(y)[k] = y[k-1] - y[k]; first local entry needs the
                # neighbor's last plane (zeros at the global start).
                prv = exchange_plane_down(gi, axis_name, n_shards, axis=0)
                lower = jnp.concatenate(
                    [prv, _take(gi, 0, 0, gi.shape[0] - 1)], axis=0)
                a = lower - gi
            else:
                a = G.forward_difference_adjoint(gi, axis)
            a = a / s[i].astype(g.dtype)
            out = a if out is None else out + a
        return out

    return grad, grad_adj


def make_sharded_blur_operators(cov, alpha_cut=3, spacing=None,
                                axis_name="z", n_shards=1,
                                dtype=np.float64):
    """Gaussian blur pair for blocks sharded along array axis 0.

    Wrap boundary globally: the sharded axis gets a ring halo exchange of
    the kernel's half-width; the local (complete) axes wrap-pad locally.
    The Gaussian stencil is flip-symmetric so ``A_adj = A``.
    """
    from nsol_tpu.ops.kernels import gaussian_kernel

    kernel = gaussian_kernel(cov, alpha_cut=alpha_cut, spacing=spacing,
                             dtype=dtype)
    L = kernel.shape[0]
    c = L // 2
    lo, hi = L - 1 - c, c  # matches conv._per_axis_pads for axis 0

    def A(x):
        xp = exchange_halo_wrap(x, axis_name, n_shards, lo=lo, hi=hi, axis=0)
        return C.convolve(xp, kernel, mode="wrap", prepadded_axes=(0,))

    return A, A
