"""Multi-host distribution: process bring-up, global meshes, scaling harness.

The reference scales across nodes with a hand-rolled MPI master/worker block
scheduler (``libwurblpt/mpi.hpp:36-289``): rank 0 runs a coordinator thread
serving a dynamic 4096-pixel block queue over MPI point-to-point. The JAX
replacement (SURVEY.md section 2.2 / section 5.8) has NO custom transport at
all: ``jax.distributed.initialize`` brings up the processes, one global
``Mesh`` spans every device (NVLink within a host, the network across
hosts), the render step is jitted over that mesh with the ray/pixel axis sharded and the scene
replicated, and XLA inserts the collectives (framebuffer gather, gradient
psum). Dynamic block pulling is replaced by static equal shards: each chip owns
tens of thousands of wavefront lanes whose path-depth variance averages out, so
the load imbalance the reference's queue fights does not materialize.

Single-process multi-chip needs none of this — ``make_ray_mesh()`` over local
devices is enough. Call ``init_multihost()`` only when launching one process
per host (the analog of ``mpirun``; reference README.md:36-44).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Bring up the multi-host runtime (one call per process, before any
    device use). The analog of ``MPICoordinator``'s MPI_Init handshake
    (mpi.hpp:189-203) — except there is no protocol to speak afterwards.

    With no arguments, JAX auto-detects cluster environment variables
    (SLURM, Open MPI); on a machine without them, pass the coordinator
    address (e.g. ``localhost:<port>``), process count and id explicitly.
    Returns True if distributed mode is active. Safe to call in
    single-process runs: it no-ops when no cluster environment is present
    and no explicit coordinator was given.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return jax.process_count() > 1
    except (ValueError, RuntimeError):
        # No cluster env detected / already initialized -> single process.
        return False


def make_global_mesh(axis: str = "rays", devices=None) -> Mesh:
    """One 1-D mesh over ALL global devices (every chip on every host).

    Device order groups each host's devices contiguously, so a framebuffer
    row-sharded over this axis keeps each host's rows local and the final
    gather stays within a host before touching the network. With pure data
    parallelism over rays the 1-D form is sufficient: there is no
    cross-device traffic until the reduction.
    """
    if devices is None:
        devices = jax.devices()  # global across processes
    return Mesh(np.asarray(devices), (axis,))


def local_shard_rows(height: int, mesh: Mesh) -> tuple:
    """(row_start, row_count) of this process's slice of a height-`height`
    framebuffer row-sharded over `mesh` — what the reference's rank-0-only
    full frame (mpi.hpp:97-104) becomes: every host holds only its rows;
    use jax.experimental.multihost_utils to assemble on one host if needed.

    Derived from the mesh's ACTUAL device order (not process_index *
    local_device_count), so subset meshes (measure_scaling's all_devices[:n])
    and heterogeneous hosts get correct ranges; requires this process's
    devices to be contiguous in the mesh (make_global_mesh guarantees it)."""
    flat = mesh.devices.reshape(-1)
    n = flat.size
    per = -(-height // n)  # ceil rows per device
    pid = jax.process_index()
    mine = [i for i, dev in enumerate(flat) if dev.process_index == pid]
    if not mine:
        return 0, 0
    if mine != list(range(mine[0], mine[0] + len(mine))):
        raise ValueError(
            "local_shard_rows: this process's devices are not contiguous in "
            "the mesh; shard the framebuffer with explicit device order")
    start = min(per * mine[0], height)
    stop = min(per * (mine[-1] + 1), height)
    return start, max(0, stop - start)


def measure_scaling(
    render_fn,
    device_counts,
    *,
    warmup: int = 1,
    iters: int = 3,
):
    """Scaling-efficiency harness: run `render_fn(mesh) -> rays_traced` over
    meshes of increasing size and report rays/s + efficiency vs 1 device.

    BASELINE.md target: >=85% scaling 1 -> N. `render_fn` must build and
    execute its own jitted step over the mesh it is given and return the
    number of rays traced (so throughput is measured, not assumed).
    """
    all_devices = jax.devices()
    results = []
    for n in device_counts:
        if n > len(all_devices):
            continue
        mesh = make_global_mesh(devices=all_devices[:n])
        for _ in range(warmup):
            render_fn(mesh)
        t0 = time.perf_counter()
        rays = 0
        for _ in range(iters):
            rays += float(render_fn(mesh))
        dt = time.perf_counter() - t0
        results.append({"devices": n, "rays_per_s": rays / dt, "seconds": dt})
    if results:
        base = results[0]["rays_per_s"] / results[0]["devices"]
        for r in results:
            r["efficiency"] = r["rays_per_s"] / (r["devices"] * base)
    return results
