"""Multi-host (multi-process) execution plumbing.

The reference has no distribution of any kind (SURVEY.md §2: no MPI/NCCL/
Gloo imports anywhere); this module is the capability mandated
by BASELINE config 5 ("sharded 512³ TV-deconvolution ... across N≥2 hosts
with psum-reduced CG"). Three pieces:

1. :func:`initialize` — `jax.distributed.initialize` wrapper, no-op on a
   single process so the same program runs unchanged on one host.
2. process-local array construction — on a real multi-host slice each
   process only holds (and can only address) its own slab of the volume;
   :func:`global_array_from_process_local` assembles the logically-global
   `jax.Array` from per-process blocks via
   `jax.make_array_from_process_local_data`, never materializing the full
   volume on any single host.
3. process-local I/O helpers — :func:`process_local_slice` tells each
   process which rows of the global volume to read/generate, and
   :func:`process_local_data` extracts this process's rows of a computed
   result (the inverse of 2).

The sharded solvers in :mod:`nsol_tpu.parallel.mesh` route every array
through these functions, so the single-process CPU-mesh dryrun
(`__graft_entry__.dryrun_multichip`) exercises exactly the code path a
real N-host launch uses.

Launch recipe for a real N-host slice (each host runs the same script)::

    from nsol_tpu.parallel import distributed as dist
    dist.initialize(coordinator_address="host0:1234",
                    num_processes=N, process_id=i)
    mesh = make_space_mesh()     # all devices across all hosts
    rows = dist.process_local_slice(GLOBAL_SHAPE, mesh)
    b_local = read_my_rows(path, rows)          # process-local I/O
    x = sharded_tv_admm_solve(mesh, cov, b_local, b_local.copy(),
                              alpha, rho, process_local=True)
    x_local = dist.process_local_data(x)        # this host's result rows
"""

import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = [
    "initialize", "is_multiprocess", "global_array_from_process_local",
    "process_local_slice", "process_local_data",
]


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, **kwargs):
    """Join the multi-process runtime; safe no-op when single-process.

    With no arguments, relies on the environment-based cluster detection
    of `jax.distributed.initialize` (e.g. under a cluster scheduler that
    JAX recognises); elsewhere pass the coordinator address, process
    count and process id explicitly. Calling this on an
    already-initialized or genuinely single-process setup is harmless.
    """
    if num_processes == 1 and coordinator_address is None:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kwargs)
    except RuntimeError as e:
        # Already initialized, or single-process with no cluster to detect.
        if "already initialized" not in str(e) and num_processes not in (
                None, 1):
            raise


def is_multiprocess():
    return jax.process_count() > 1


def global_array_from_process_local(mesh, local_block, axis_name="space",
                                    leading_axis=0):
    """Assemble a logically-global `jax.Array` sharded along
    ``leading_axis`` over ``axis_name`` from each process's local block.

    ``local_block`` holds only THIS process's rows (on a single process
    that is the whole volume — same call, degenerate case). No host ever
    materializes the global array; `jax.make_array_from_process_local_data`
    scatters the block onto this process's addressable devices and records
    the global shape/sharding so XLA collectives see one global operand.
    """
    spec = [None] * np.asarray(local_block).ndim
    spec[leading_axis] = axis_name
    sh = NamedSharding(mesh, P(*spec))
    return jax.make_array_from_process_local_data(
        sh, np.asarray(local_block))


def process_local_slice(global_shape, mesh, axis_name="space",
                        leading_axis=0):
    """Half-open row range ``(start, stop)`` of the global volume that THIS
    process must provide when the volume is sharded along ``leading_axis``
    over ``axis_name`` — the process-local I/O contract: each host reads or
    generates only these rows.

    Device order along the mesh axis defines the row order; a process's
    rows are the union of its addressable devices' shards (contiguous for
    the standard single-axis mesh layout).
    """
    n_shards = mesh.shape[axis_name]
    n_rows = global_shape[leading_axis]
    if n_rows % n_shards:
        raise ValueError("leading axis %d not divisible by %d shards"
                         % (n_rows, n_shards))
    rows_per_shard = n_rows // n_shards
    axis_devices = mesh.devices.reshape(-1)
    mine = [i for i, d in enumerate(axis_devices)
            if d.process_index == jax.process_index()]
    if not mine:
        return (0, 0)
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(
            "this process's devices are not contiguous along the %r mesh "
            "axis; pass an explicit device order to make_mesh" % axis_name)
    return (mine[0] * rows_per_shard, (mine[-1] + 1) * rows_per_shard)


def process_local_data(x, leading_axis=0):
    """This process's rows of a computed (globally sharded) result — the
    read-back half of the process-local I/O contract. Concatenates the
    addressable shards in global row order; never fetches remote shards.
    """
    shards = sorted(x.addressable_shards,
                    key=lambda s: s.index[leading_axis].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards],
                          axis=leading_axis)
