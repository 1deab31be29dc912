"""Tracing / profiling hooks.

The reference's only instrumentation is wall-clock timing around
``Solver._run`` (nsol/solver.py:152-166). This module adds
device-level tracing via ``jax.profiler`` (SURVEY.md §5 "Tracing /
profiling"): wrap any solve in :func:`trace` to capture an XLA trace
viewable in TensorBoard/Perfetto, or use :func:`annotate` to mark solver
phases inside a trace.
"""

import contextlib

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir, create_perfetto_link=False):
    """Capture a device trace for the enclosed computation.

    Example::

        with profiling.trace("/tmp/nsol_trace"):
            solver.run()
    """
    import jax

    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name):
    """Named region inside a trace (``jax.profiler.TraceAnnotation``)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
