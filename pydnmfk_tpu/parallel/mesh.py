"""Device-mesh construction and canonical shardings for distributed NMF.

This module is the JAX replacement for the reference's communicator
layer (pyDNMFk/dist_comm.py: ``MPI_comm`` building a ``p_r x p_c``
``Create_cart`` grid plus row/column sub-communicators).  Here the grid is a
``jax.sharding.Mesh`` with axes ``('r', 'c')``; the row/column
sub-communicators become per-axis collectives that GSPMD inserts from the
sharding specs below.  There is no 1D-vs-2D code split (reference
pyDNMF.py:83-87): a 1D row layout is simply the mesh ``(p, 1)``.

Canonical shardings (for A (m,n), W (m,k), H (k,n)):

    A : P('r', 'c')     -- 2D block layout over the mesh
    W : P('r', None)    -- row-sharded, replicated along 'c'
    H : P(None, 'c')    -- column-sharded, replicated along 'r'

With these, XLA lowers

    W^T W   -> local (k,k) matmul + psum over 'r'        (reference global_gram)
    W^T A   -> local matmul + psum over 'r', out P(None,'c')  (reference ATW_glob:
               allgather over col-comm + Reduce_scatter over row-comm,
               dist_nmf.py:144-172)
    A  H^T  -> local matmul + psum over 'c', out P('r',None)  (reference AH_glob)

i.e. exactly the collective structure dist_nmf.py spells out by hand.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "r"
COL_AXIS = "c"
ENSEMBLE_AXIS = "e"


def on_accelerator() -> bool:
    """The one backend decision: True on an accelerator (the GPU), False
    on the CPU.  Policies that differ by hardware key on this or on the
    device's ``device_kind``, never on a backend name of their own."""
    return jax.default_backend() != "cpu"


def make_grid_mesh(p_r: int, p_c: int, p_e: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """Build the (e, r, c) mesh that replaces the MPI cartesian grid.

    ``p_e`` shards the perturbation-ensemble axis (the reference has no
    equivalent: its ensemble loop is serial, pyDNMFk.py:226-231).
    """
    if devices is None:
        devices = jax.devices()
    need = p_e * p_r * p_c
    if len(devices) < need:
        raise ValueError(
            f"mesh ({p_e}x{p_r}x{p_c}) needs {need} devices, have {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(p_e, p_r, p_c)
    return Mesh(dev, (ENSEMBLE_AXIS, ROW_AXIS, COL_AXIS))


def single_device_mesh() -> Mesh:
    return make_grid_mesh(1, 1)


class GridContext:
    """Holds the mesh plus the canonical shardings for A, W, H.

    The moral equivalent of the reference's ``params.comm/comm1/row_comm/
    col_comm`` bundle (main.py:62-67), but immutable and collective-free:
    everything is expressed as sharding metadata.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    # Hash/eq by the mesh (jax.sharding.Mesh compares devices + axis
    # names), so jit caches keyed on a GridContext — _jitted_solver,
    # _ensemble_program — hit across instances built for the same grid.
    def __hash__(self):
        return hash(self.mesh)

    def __eq__(self, other):
        return (isinstance(other, GridContext)
                and self.mesh == other.mesh)

    # ---- sharding specs -------------------------------------------------
    @property
    def spec_A(self) -> P:
        return P(ROW_AXIS, COL_AXIS)

    @property
    def spec_W(self) -> P:
        return P(ROW_AXIS, None)

    @property
    def spec_H(self) -> P:
        return P(None, COL_AXIS)

    @property
    def spec_replicated(self) -> P:
        return P()

    # batched (ensemble-leading-axis) variants
    @property
    def spec_A_batched(self) -> P:
        return P(ENSEMBLE_AXIS, ROW_AXIS, COL_AXIS)

    @property
    def spec_W_batched(self) -> P:
        return P(ENSEMBLE_AXIS, ROW_AXIS, None)

    @property
    def spec_H_batched(self) -> P:
        return P(ENSEMBLE_AXIS, None, COL_AXIS)

    # ---- NamedShardings -------------------------------------------------
    def sharding(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    @property
    def sharding_A(self) -> NamedSharding:
        return self.sharding(self.spec_A)

    @property
    def sharding_W(self) -> NamedSharding:
        return self.sharding(self.spec_W)

    @property
    def sharding_H(self) -> NamedSharding:
        return self.sharding(self.spec_H)

    def put_A(self, A) -> jax.Array:
        return jax.device_put(A, self.sharding_A)

    def put_W(self, W) -> jax.Array:
        return jax.device_put(W, self.sharding_W)

    def put_H(self, H) -> jax.Array:
        return jax.device_put(H, self.sharding_H)

    @property
    def shape(self) -> Tuple[int, int]:
        ax = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        return (ax.get(ROW_AXIS, 1), ax.get(COL_AXIS, 1))

    @property
    def p_e(self) -> int:
        ax = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        return ax.get(ENSEMBLE_AXIS, 1)

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.mesh.devices.shape))


@functools.lru_cache(maxsize=None)
def grid_context(p_r: int = 1, p_c: int = 1, p_e: int = 1) -> GridContext:
    """Construct (or return the cached) GridContext for a grid shape.

    Cached by (p_r, p_c, p_e): two NMF/NMFk instances on the same grid
    share one context object — and therefore every trace/compile cache
    keyed on it (the round-2 identity-cached version re-traced per
    instance).  The device list is process-stable, so caching is safe.
    """
    return GridContext(make_grid_mesh(p_r, p_c, p_e))


def host_local(x) -> np.ndarray:
    """np.ndarray of a possibly cross-process (non-addressable) jax.Array.

    Multi-host arrays sharded over processes are allgathered to every host
    (a collective — call in SPMD lockstep on all processes, like every
    other op on global arrays); anything else is a plain np.asarray.  The
    moral equivalent of the reference's gather-to-rank-0 before host-side
    stages (pyDNMF.py:196-202), except every host gets the copy."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def is_proc0() -> bool:
    """Whether this process plays the reference's rank-0 writer role."""
    return jax.process_index() == 0


def sync_processes(name: str) -> None:
    """Cross-process barrier (no-op single-process): order file writes by
    process 0 before reads by the others — the reference gets this ordering
    from its blocking collectives + shared-FS assumption."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         local_device_ids: Optional[Sequence[int]] = None
                         ) -> None:
    """Multi-host bootstrap: replaces ``mpirun`` process management.

    Without arguments ``jax.distributed.initialize()`` detects a managed
    cluster (e.g. SLURM); elsewhere pass the coordinator address, process
    count and id.  Several processes on ONE GPU host must each own their
    own cards (``local_device_ids``, e.g. ``[process_id]``): a JAX process
    reserves most of the memory of every card it opens, so a second
    process on the same card fails for want of memory.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
