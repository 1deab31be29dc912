"""jit helpers for operator-closure programs, and the compile-cache setup.

The library's operators are closures over their data (FFT spectra, stencil
kernels, circulant matrices, observations). Inside ``jax.jit`` those
captures become HLO *literal constants*, which bloat the program (a 256³
CLI solve embedded two volumes) and slow every compile. ``jit_closed``
traces the function once, hoists every captured array out of the program
and passes it as a runtime argument instead, keeping the closure-based
operator API. (``jax.closure_convert`` hoists only tracers, not concrete
arrays, so it cannot do this.)
"""

import os

import jax

__all__ = ["jit_closed", "setup_compile_cache", "DEFAULT_COMPILE_CACHE"]

#: Persistent compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is not
#: set: ``.jax_cache`` at the root of the checkout holding this package.
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def setup_compile_cache():
    """Turn on JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise every compiled program is cached in
    :data:`DEFAULT_COMPILE_CACHE`, so repeated runs of one configuration
    start warm.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


def jit_closed(fn, example_args, in_shardings=None, out_shardings=None):
    """Return a callable equivalent to ``jax.jit(fn)`` with all closure-
    captured arrays hoisted to arguments.

    ``example_args``: abstract or concrete example inputs used to trace
    ``fn`` once. The returned callable accepts the same arguments as ``fn``;
    its ``lower(*args)`` lowers the program as ``jax.jit(...).lower`` does.

    ``in_shardings``: optional shardings for the *user* arguments (hoisted
    constants are left unspecified → replicated by the partitioner).
    """
    closed, out_shape = jax.make_jaxpr(fn, return_shape=True)(
        *example_args)
    in_tree = jax.tree_util.tree_structure(tuple(example_args))
    out_tree = jax.tree_util.tree_structure(out_shape)
    # on the device once, so no call copies them from the host again
    consts = [jax.numpy.asarray(c) for c in closed.consts]
    n_args = len(example_args)

    def converted(*args_and_consts):
        args, const_args = args_and_consts[:n_args], args_and_consts[n_args:]
        flat, tree = jax.tree_util.tree_flatten(tuple(args))
        if tree != in_tree:
            raise TypeError("jit_closed: arguments %s do not match the "
                            "example arguments %s" % (tree, in_tree))
        out = jax.core.eval_jaxpr(closed.jaxpr, const_args, *flat)
        return jax.tree_util.tree_unflatten(out_tree, out)

    kwargs = {}
    if in_shardings is not None:
        kwargs["in_shardings"] = list(in_shardings) + [None] * len(consts)
    if out_shardings is not None:
        kwargs["out_shardings"] = out_shardings
    jitted = jax.jit(converted, **kwargs)

    def call(*args):
        return jitted(*args, *consts)

    call.lower = lambda *args: jitted.lower(*args, *consts)
    return call
