"""Data and results IO.

Reference: pyDNMFk/data_io.py.  Formats kept: .mat (scipy, variable 'X'),
.npy, .csv/.txt, and 'folder' (pre-split per-rank ``<fname><i>.npy`` chunks,
reference data_io.py:44-47).  Results persistence (per-k factor chunks and
``results.h5`` statistics) keeps the reference's on-disk layout so existing
post-processing and the MLP k-predictor work unchanged.

Departures from the reference:
  * The reference has every rank load the FULL file then slice its block
    (data_io.py:92-105) — the documented IO hot spot.  Here sharded arrays
    are assembled with ``jax.make_array_from_callback``, so each host only
    materializes the blocks its devices own; .npy blocks go through the
    native C reader (touching only the block's bytes), and .mat/.csv/.txt
    are converted ONCE to a sibling ``.cache.npy`` (atomic write) so every
    subsequent run block-reads them the same way.
  * Uneven global shapes are zero-padded to the mesh tiling inside the
    block callbacks (``pad_to_mesh=True``), so no host ever assembles the
    full matrix; the true shape is reported via ``last_global_shape`` and
    threaded to the models as ``orig_shape``.
  * 'folder' chunk layout follows the same remainder-balanced block formula
    (parallel/partition.py) for file-level compatibility.
"""
from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import jax
import numpy as np

from ..parallel.mesh import GridContext
from ..parallel.partition import BlockPartition, partition_slices, rank_to_block_order_H


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------
def _read_full(path: str, ftype: str, mmap: bool = True) -> np.ndarray:
    if ftype == "npy":
        return np.load(path, mmap_mode="r" if mmap else None)
    if ftype in ("csv", "txt"):
        import pandas as pd
        return pd.read_csv(path, header=None).values
    if ftype == "mat":
        from scipy.io import loadmat
        return loadmat(path)["X"]
    raise ValueError(f"unknown ftype {ftype!r}")


class DataReader:
    """API mirror of reference ``data_read`` (data_io.py:12-105)."""

    def __init__(self, fpath: str, fname: str, ftype: str = "mat",
                 pgrid: Sequence[int] = (1, 1), precision: str = "float32"):
        self.fpath = fpath
        self.fname = fname
        self.ftype = ftype
        self.pgrid = tuple(pgrid)
        self.precision = precision
        # true (unpadded) global shape of the last read; differs from the
        # returned array's shape only for pad_to_mesh reads
        self.last_global_shape: Optional[tuple] = None
        self._warned_cache_fallback = False
        # locality telemetry (asserted by tests/_multihost_worker.py):
        # which pre-split 'folder' chunk files this process opened, and
        # which CSR row panels it materialized from an .npz
        self.folder_chunks_read: set = set()
        self.npz_rows_materialized: list = []

    # ------------------------------------------------------------------
    def _path(self) -> str:
        return os.path.join(self.fpath, self.fname + "." + self.ftype)

    def _block_readable_path(self) -> Optional[str]:
        """Path of an .npy file the block reader can serve: the file itself
        for ftype='npy', else a one-time sibling ``.cache.npy`` conversion
        (SURVEY hard-part (e): the reference re-reads the FULL .mat/.csv on
        every rank of every run, data_io.py:92-105 — here the full read
        happens once per file, ever, then all runs block-read)."""
        if self.ftype == "npy":
            return self._path()
        if self.ftype not in ("mat", "csv", "txt"):
            return None
        import hashlib
        src = self._path()
        root = os.environ.get("PYDNMFK_CACHE_DIR",
                              os.path.expanduser("~/.cache/pydnmfk_tpu"))
        key = hashlib.sha1(os.path.abspath(src).encode()).hexdigest()[:16]
        cache = os.path.join(root, f"{self.fname}.{key}.npy")
        try:
            if (os.path.exists(cache)
                    and os.path.getmtime(cache) >= os.path.getmtime(src)):
                return cache
            os.makedirs(root, exist_ok=True)
            data = np.ascontiguousarray(_read_full(src, self.ftype,
                                                   mmap=False))
            tmp = cache + f".tmp{os.getpid()}.npy"
            np.save(tmp, data)
            os.replace(tmp, cache)       # atomic: concurrent hosts race
            return cache                 # benignly (same content)
        except OSError:
            # unwritable cache dir: the block reader degrades to one FULL
            # file parse per requested block — correct but
            # O(blocks x full-read) slow, so say it once, loudly
            if not self._warned_cache_fallback:
                self._warned_cache_fallback = True
                import warnings
                warnings.warn(
                    f"cache dir {root!r} is not writable; every block read "
                    f"of {src!r} re-parses the full file (set "
                    f"PYDNMFK_CACHE_DIR to a writable path to block-read "
                    f"{self.ftype} files)")
            return None

    def _read_block(self, r0: int, r1: int, c0: int, c1: int) -> np.ndarray:
        """One [r0,r1) x [c0,c1) block, touching only the block's bytes
        when a block-readable file exists."""
        path = self._block_readable_path()
        if path is not None:
            from ..native import read_npy_block
            blk = read_npy_block(path, r0, r1, c0, c1)
            if blk is None:              # no C toolchain: numpy mmap slice
                blk = np.asarray(np.load(path, mmap_mode="r")[r0:r1, c0:c1])
            return blk.astype(self.precision)
        full = _read_full(self._path(), self.ftype)
        return np.asarray(full[r0:r1, c0:c1]).astype(self.precision)

    def read_global(self) -> np.ndarray:
        """Full matrix on host (single-host path).  ftype='npz' loads a
        scipy.sparse matrix (save_npz layout) as a canonical jax BCOO —
        sparse input is a capability beyond the dense-only reference."""
        if self.ftype == "npz":
            return self._read_sparse()
        if self.ftype == "folder":
            # reassemble the pre-split per-rank chunks
            p_r, p_c = self.pgrid
            chunks = [np.load(os.path.join(
                self.fpath, f"{self.fname}{i}.npy"))
                for i in range(p_r * p_c)]
            rows = [np.hstack(chunks[r * p_c:(r + 1) * p_c])
                    for r in range(p_r)]
            data = np.vstack(rows)
        else:
            path = os.path.join(self.fpath, self.fname + "." + self.ftype)
            data = np.asarray(_read_full(path, self.ftype, mmap=False))
        return data.astype(self.precision)

    def _read_sparse(self):
        import jax.numpy as jnp
        from jax.experimental import sparse as jsparse
        from scipy import sparse as sp
        path = os.path.join(self.fpath, self.fname + ".npz")
        M = sp.load_npz(path).tocoo()
        M.sum_duplicates()
        idx = np.stack([M.row, M.col], axis=1).astype(np.int32)
        bcoo = jsparse.BCOO(
            (jnp.asarray(M.data.astype(self.precision)), jnp.asarray(idx)),
            shape=M.shape, unique_indices=True)
        return bcoo.sort_indices()

    # -- npz sparse: per-host CSR panel streaming -----------------------
    @staticmethod
    def _npz_member_header(zf, name):
        """(dtype, shape, stream) positioned at the first data byte."""
        from numpy.lib import format as npfmt
        f = zf.open(name)
        version = npfmt.read_magic(f)
        if version == (1, 0):
            shape, _, dtype = npfmt.read_array_header_1_0(f)
        else:
            shape, _, dtype = npfmt.read_array_header_2_0(f)
        return dtype, shape, f

    @classmethod
    def _npz_member_read(cls, zf, name):
        """Full (small) member, e.g. format/shape/indptr."""
        from numpy.lib import format as npfmt
        with zf.open(name) as f:
            return npfmt.read_array(f)

    @classmethod
    def _npz_member_slice(cls, zf, name, start: int, count: int,
                          chunk_bytes: int = 1 << 24):
        """Elements [start, start+count) of a 1-D member.

        Zip members are DEFLATE streams with no random access, so the
        prefix is decompressed and DISCARDED in bounded chunks — memory
        stays O(chunk) and only the requested panel is materialized."""
        dtype, _, f = cls._npz_member_header(zf, name)
        with f:
            item = dtype.itemsize
            skip = start * item
            while skip > 0:
                b = f.read(min(skip, chunk_bytes))
                if not b:
                    raise EOFError(f"truncated npz member {name}")
                skip -= len(b)
            out = np.empty(count, dtype)
            view = out.view(np.uint8)
            got, need = 0, count * item
            while got < need:
                b = f.read(min(need - got, chunk_bytes))
                if not b:
                    raise EOFError(f"truncated npz member {name}")
                view[got:got + len(b)] = np.frombuffer(b, np.uint8)
                got += len(b)
        return out

    @classmethod
    def _npz_stream_foreach(cls, zf, name, fn, chunk_bytes: int = 1 << 24):
        """Stream a 1-D member through ``fn(chunk, elem_offset)`` without
        ever materializing it (used for the per-block count pass)."""
        dtype, _, f = cls._npz_member_header(zf, name)
        with f:
            item = dtype.itemsize
            off, carry = 0, b""
            while True:
                b = f.read(chunk_bytes)
                if not b:
                    break
                if carry:
                    b = carry + b
                usable = len(b) // item * item
                carry = b[usable:]
                arr = np.frombuffer(b[:usable], dtype)
                fn(arr, off)
                off += arr.shape[0]

    def read_sparse_grid(self, ctx: GridContext):
        """Grid-sharded sparse input with PER-HOST panel reads
        (VERDICT r3 item 4; reference analog: 'folder' per-rank locality,
        data_io.py:44-47).

        For a scipy-CSR ``.npz``: every host streams the (small) indptr,
        makes one O(1)-memory counting pass over the indices member to
        agree on the padded block width, then MATERIALIZES only the data/
        indices of the CSR row panels its own devices' grid blocks cover
        — plus the flat VALUES vector (one streamed pass), which stays
        replicated for the NMFk ensemble's positional noise streams.
        Returns a ``SparseGridInput`` bundle (ops/sparse.py) that
        NMF/NMFk consume directly in place of a host-global BCOO; its
        ``perm`` maps block slots to CSR storage order (padding = nnz),
        the same contract as shard_sparse_grid(return_perm=True).

        Non-CSR npz files fall back to the host-global read + block
        partition (exact, but without per-host locality)."""
        import zipfile
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..ops.sparse import (GridShardedSparse, SparseGridInput,
                                  shard_sparse_grid)
        from ..parallel.mesh import COL_AXIS, ROW_AXIS
        from ..parallel.partition import padded_dim

        import contextlib
        path = os.path.join(self.fpath, self.fname + ".npz")
        with contextlib.closing(zipfile.ZipFile(path)) as zf:
            return self._read_sparse_grid_zf(zf, ctx)

    def _read_sparse_grid_zf(self, zf, ctx: GridContext):
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..ops.sparse import (GridShardedSparse, SparseGridInput,
                                  shard_sparse_grid)
        from ..parallel.mesh import COL_AXIS, ROW_AXIS
        from ..parallel.partition import padded_dim

        names = set(zf.namelist())
        csr = ("format.npy" in names
               and bytes(self._npz_member_read(zf, "format.npy")) == b"csr")
        if not csr:
            A = self._read_sparse()
            self.last_global_shape = tuple(A.shape)
            gs, dims, perm = shard_sparse_grid(A, ctx, return_perm=True)
            return SparseGridInput(gs, dims, perm, A.data,
                                   tuple(A.shape))

        m, n = (int(v) for v in self._npz_member_read(zf, "shape.npy"))
        self.last_global_shape = (m, n)
        indptr = np.asarray(self._npz_member_read(zf, "indptr.npy"),
                            np.int64)
        nnz = int(indptr[-1])
        p_r, p_c = ctx.shape
        m_pad, n_pad = padded_dim(m, p_r), padded_dim(n, p_c)
        br, bc = m_pad // p_r, n_pad // p_c

        # pass 1 (O(chunk) memory, nothing kept): per-block nnz counts —
        # identical on every host, so the padded width e_max is agreed
        # without any cross-host exchange.  Rows come from searchsorted
        # on indptr, so no nnz-sized index array is ever built.
        counts = np.zeros((p_r, p_c), np.int64)

        def count_chunk(cols, off):
            pos = np.arange(off, off + cols.shape[0], dtype=np.int64)
            i = (np.searchsorted(indptr, pos, side="right") - 1) // br
            j = cols.astype(np.int64) // bc
            np.add.at(counts, (i, j), 1)

        self._npz_stream_foreach(zf, "indices.npy", count_chunk)
        e_max = max(int(counts.max()), 1)

        # which grid blocks live on THIS host's devices
        sharding = NamedSharding(ctx.mesh, P(ROW_AXIS, COL_AXIS, None))
        local = set()
        for idx in sharding.addressable_devices_indices_map(
                (p_r, p_c, e_max)).values():
            rs, cs = idx[0], idx[1]
            for i in range(rs.start or 0, rs.stop or p_r):
                for j in range(cs.start or 0, cs.stop or p_c):
                    local.add((i, j))
        need_rows = sorted({i for i, _ in local})

        # pass 2: materialize ONLY the local row panels
        blocks = {}
        for i in need_rows:
            r0, r1 = i * br, min((i + 1) * br, m)
            s, e = int(indptr[r0]), int(indptr[r1])
            self.npz_rows_materialized.append((r0, r1))
            cols = self._npz_member_slice(zf, "indices.npy", s, e - s)
            data = self._npz_member_slice(zf, "data.npy", s, e - s)
            rows = np.repeat(np.arange(r0, r1, dtype=np.int64),
                             np.diff(indptr[r0:r1 + 1]))
            j_of = cols.astype(np.int64) // bc
            for j in range(p_c):
                if (i, j) not in local:
                    continue
                sel = np.nonzero(j_of == j)[0]
                cnt = sel.shape[0]
                d_b = np.zeros((e_max,), self.precision)
                r_b = np.zeros((e_max,), np.int32)
                c_b = np.zeros((e_max,), np.int32)
                p_b = np.full((e_max,), nnz, np.int32)
                d_b[:cnt] = data[sel]
                r_b[:cnt] = rows[sel] - i * br
                c_b[:cnt] = cols[sel] - j * bc
                p_b[:cnt] = (s + sel).astype(np.int32)
                blocks[(i, j)] = (d_b, r_b, c_b, p_b)

        def make(which, dtype):
            def cb(index):
                i = index[0].start or 0
                j = index[1].start or 0
                return blocks[(i, j)][which][None, None, :]
            return jax.make_array_from_callback(
                (p_r, p_c, e_max), sharding, cb)

        gs = GridShardedSparse(make(0, self.precision), make(1, np.int32),
                               make(2, np.int32), (m_pad, n_pad),
                               (br, bc), ctx.mesh)
        # flat values vector in storage order (one streamed pass; kept
        # replicated — it feeds the positional member-noise streams)
        data_flat = jnp.asarray(self._npz_member_slice(
            zf, "data.npy", 0, nnz).astype(self.precision))
        return SparseGridInput(gs, (m_pad, n_pad), make(3, np.int32),
                               data_flat, (m, n))

    def _global_shape(self) -> tuple:
        """Global dims WITHOUT materializing data where possible."""
        path = self._block_readable_path()
        if path is not None:
            from ..native import _parse_npy_header
            info = _parse_npy_header(path)
            if info is not None:
                return tuple(info[1])
            return tuple(np.load(path, mmap_mode="r").shape)
        return tuple(np.asarray(
            _read_full(self._path(), self.ftype)).shape)

    # -- 'folder' format: pre-split per-rank chunks ---------------------
    def _folder_chunk_path(self, rank: int) -> str:
        return os.path.join(self.fpath, f"{self.fname}{rank}.npy")

    def _folder_shape(self) -> tuple:
        """Global dims from the chunk npy HEADERS only (no data read):
        m = sum of first-column chunk heights, n = sum of first-row
        widths — the remainder-balanced layout is row/col separable."""
        from ..native import _parse_npy_header
        p_r, p_c = self.pgrid

        def cshape(rank):
            path = self._folder_chunk_path(rank)
            info = _parse_npy_header(path)
            if info is not None:
                return tuple(info[1])
            return tuple(np.load(path, mmap_mode="r").shape)

        m = sum(cshape(i * p_c)[0] for i in range(p_r))
        n = sum(cshape(j)[1] for j in range(p_c))
        return m, n

    def _read_block_folder(self, r0, r1, c0, c1, shape) -> np.ndarray:
        """One [r0,r1) x [c0,c1) block assembled from ONLY the overlapping
        chunk files (mmap-sliced): on a mesh each host touches just the
        chunks its devices' blocks intersect — the locality the reference's
        'folder' format exists for (data_io.py:44-47,104-105), which the
        round-3 reader lost by reassembling the full matrix host-side."""
        from ..parallel.partition import block_range
        p_r, p_c = self.pgrid
        m, n = shape
        rows = []
        for i in range(p_r):
            rs, re = block_range(m, p_r, i)
            if re <= r0 or rs >= r1:
                continue
            cols = []
            for j in range(p_c):
                cs, ce = block_range(n, p_c, j)
                if ce <= c0 or cs >= c1:
                    continue
                self.folder_chunks_read.add(i * p_c + j)
                chunk = np.load(self._folder_chunk_path(i * p_c + j),
                                mmap_mode="r")
                cols.append(np.asarray(
                    chunk[max(r0, rs) - rs:min(r1, re) - rs,
                          max(c0, cs) - cs:min(c1, ce) - cs]))
            rows.append(cols[0] if len(cols) == 1 else np.hstack(cols))
        out = rows[0] if len(rows) == 1 else np.vstack(rows)
        return out.astype(self.precision)

    def read_chunk(self, rank: int) -> np.ndarray:
        """One grid block (reference data_partition, data_io.py:70-83),
        touching only the block's bytes for block-readable formats."""
        if self.ftype == "folder":
            return np.load(os.path.join(
                self.fpath, f"{self.fname}{rank}.npy")).astype(self.precision)
        sl = BlockPartition(rank, self.pgrid, self._global_shape()).slices()
        return self._read_block(sl[0].start, sl[0].stop,
                                sl[1].start, sl[1].stop)

    def read(self, ctx: Optional[GridContext] = None,
             pad_to_mesh: bool = False) -> jax.Array | np.ndarray:
        """Read and (if a mesh context is given) place as a sharded global
        array, loading only locally-addressable blocks.

        ``pad_to_mesh=True`` handles uneven global shapes by zero-padding
        INSIDE the per-block callbacks (no host ever assembles the full
        matrix); the returned array has the padded shape and the true dims
        land in ``self.last_global_shape`` — pass them to NMF/NMFk as
        ``orig_shape``."""
        from . import timing
        with timing.timed("read"):
            return self._read_impl(ctx, pad_to_mesh)

    def _read_impl(self, ctx, pad_to_mesh: bool = False):
        if self.ftype == "npz":
            if ctx is not None and ctx.shape != (1, 1):
                # grid context: per-host panel reads straight into the
                # sharded block layout (SparseGridInput) — the host-global
                # BCOO is never built
                return self.read_sparse_grid(ctx)
            # single-device / 'e'-only contexts: BCOO (NMFk's densify/ELL
            # policy and the 'e'-sharded ensemble operate on the triplet)
            A = self.read_global()
            self.last_global_shape = tuple(A.shape)
            return A
        if ctx is None or ctx.n_devices == 1:
            A = self.read_global()
            self.last_global_shape = tuple(A.shape)
            return A

        folder = self.ftype == "folder"
        shape = self._folder_shape() if folder else self._global_shape()
        self.last_global_shape = shape
        sharding = ctx.sharding_A
        p_r, p_c = ctx.shape
        uneven = shape[0] % p_r or shape[1] % p_c
        if uneven and not pad_to_mesh:
            # legacy path: hand the host array to NMF/NMFk, which
            # pad-and-mask before sharding (models/nmf.py _mesh_pad)
            return self.read_global()

        m, n = shape
        if uneven:
            from ..parallel.partition import padded_dim
            out_shape = (padded_dim(m, p_r), padded_dim(n, p_c))
        else:
            out_shape = shape
        if folder:
            read_block = lambda r0, r1, c0, c1: self._read_block_folder(
                r0, r1, c0, c1, shape)
        else:
            read_block = self._read_block

        def cb(index):
            rs, cs = index
            r0, r1 = rs.start or 0, rs.stop or out_shape[0]
            c0, c1 = cs.start or 0, cs.stop or out_shape[1]
            rr, cc = min(r1, m), min(c1, n)
            if rr <= r0 or cc <= c0:         # fully inside the padding
                return np.zeros((r1 - r0, c1 - c0), self.precision)
            blk = read_block(r0, rr, c0, cc)
            if rr < r1 or cc < c1:           # zero-pad the mesh remainder
                blk = np.pad(blk, ((0, r1 - rr), (0, c1 - cc)))
            return blk

        return jax.make_array_from_callback(out_shape, sharding, cb)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------
class DataWriter:
    """API mirror of reference ``data_write`` (data_io.py:143-209): per-grid
    factor chunks as .npy + rank-0-style per-k statistics."""

    def __init__(self, results_path: str, pgrid: Sequence[int] = (1, 1)):
        self.fpath = results_path
        self.pgrid = tuple(pgrid)
        os.makedirs(self.fpath, exist_ok=True)

    def save_factors(self, W, H, reg: bool = False):
        W = np.asarray(W)
        H = np.asarray(H)
        tag = "reg_" if reg else ""
        wdir = os.path.join(self.fpath, f"W_{tag}factors")
        hdir = os.path.join(self.fpath, f"H_{tag}factors")
        os.makedirs(wdir, exist_ok=True)
        os.makedirs(hdir, exist_ok=True)
        p_r, p_c = self.pgrid
        if p_r == 1 and p_c == 1:
            np.save(os.path.join(wdir, "W.npy"), W)
            np.save(os.path.join(hdir, "H.npy"), H)
        elif p_r == 1:
            np.save(os.path.join(wdir, "W.npy"), W)
            for j, (s, e) in enumerate(_splits(H.shape[1], p_c)):
                np.save(os.path.join(hdir, f"H_{j}.npy"), H[:, s:e])
        elif p_c == 1:
            np.save(os.path.join(hdir, "H.npy"), H)
            for i, (s, e) in enumerate(_splits(W.shape[0], p_r)):
                np.save(os.path.join(wdir, f"W_{i}.npy"), W[s:e])
        else:
            # 2D grid: reference layout splits W into m/p row-blocks in rank
            # order and H into n/p column-blocks placed column-major over the
            # grid (rank (i,j) holds column-block j*p_r+i; see
            # rank_to_block_order_H), matching reference pyNMF's 2D factor
            # distribution (utils.py:97-103) and read_factors' reorder.
            p = p_r * p_c
            order = rank_to_block_order_H(p_r, p_c)
            for b, (s, e) in enumerate(_splits(W.shape[0], p)):
                np.save(os.path.join(wdir, f"W_{b}.npy"), W[s:e])
            for b, (s, e) in enumerate(_splits(H.shape[1], p)):
                np.save(os.path.join(hdir, f"H_{order[b]}.npy"), H[:, s:e])

    def save_cluster_results(self, stats: dict, config: dict = None):
        """Per-k statistics under the reference's dataset names
        (data_io.py:198-209).  ``results.npz`` always holds them — the
        Wilcoxon walk reads it back (models/nmfk.py::pvalue_analysis) —
        and the reference-layout ``results.h5``, with the run
        configuration stamped as attrs, is written in addition wherever
        h5py is installed."""
        data = {
            "clusterSilhouetteCoefficients":
                np.asarray(stats["clusterSilhouetteCoefficients"]),
            "avgSilhouetteCoefficients":
                np.asarray(stats["avgSilhouetteCoefficients"]),
            "L_err": np.asarray(stats["L_err"]),
            "L_errDist": np.asarray(stats["L_errDist"]),
            "avgErr": np.asarray(stats["avgErr"]),
            "ErrTol": np.asarray(stats["recon_err"]),
            "AIC": np.asarray(stats["AIC"]),
        }
        tmp = os.path.join(self.fpath, "results.tmp.npz")
        np.savez(tmp, **data)
        os.replace(tmp, os.path.join(self.fpath, "results.npz"))
        try:
            import h5py
        except ImportError:
            return
        with h5py.File(os.path.join(self.fpath, "results.h5"), "w") as hf:
            for key, val in (config or {}).items():
                try:
                    hf.attrs[key] = val
                except TypeError:
                    hf.attrs[key] = str(val)
            for key, val in data.items():
                hf.create_dataset(key, data=val)


def read_cluster_results(kdir: str) -> dict:
    """One k's statistics from the ``results.npz`` that
    ``DataWriter.save_cluster_results`` always writes.  Every reader in the
    program (the Wilcoxon walk, the selection plot, the ML k-predictor)
    goes through here, so none needs h5py."""
    with np.load(os.path.join(kdir, "results.npz")) as f:
        return {key: np.array(f[key]) for key in f.files}


def _splits(dim, nblocks):
    from ..parallel.partition import block_range
    return [block_range(dim, nblocks, i) for i in range(nblocks)]


def read_factors(factors_path: str, pgrid: Sequence[int], reg: bool = True):
    """Reassemble saved factor chunks (reference read_factors,
    data_io.py:212-261) — with the corrected rank->block H ordering."""
    tag = "reg_" if reg else ""

    def numkey(p):
        stem = os.path.splitext(os.path.basename(p))[0]
        tail = stem.rsplit("_", 1)[-1]
        return (0, int(tail)) if tail.isdigit() else (1, 0)

    wfiles = sorted(glob.glob(os.path.join(factors_path, f"W_{tag}factors", "*")),
                    key=numkey)
    hfiles = sorted(glob.glob(os.path.join(factors_path, f"H_{tag}factors", "*")),
                    key=numkey)
    W_parts = [np.load(f) for f in wfiles]
    H_parts = [np.load(f) for f in hfiles]
    W = W_parts[0] if len(W_parts) == 1 else np.vstack(W_parts)
    if len(H_parts) == 1:
        H = H_parts[0]
    elif len(W_parts) > 1 and pgrid[0] > 1 and pgrid[1] > 1:
        order = rank_to_block_order_H(pgrid[0], pgrid[1])
        H = np.hstack([H_parts[i] for i in order])
    else:
        H = np.hstack(H_parts)
    return W, H
