"""Checkpoint/restart for the NMFk pipeline.

Reference: ``utils.Checkpoint`` (pyDNMFk/utils.py:486-536) pickles
``(flag, perturbation, k)`` and PyNMFk.fit resumes the k-loop at the saved k
(pyDNMFk.py:188-196) — per-perturbation state is recorded but never
replayed, so an interrupted k restarts from its first perturbation.

This implementation checkpoints at strictly finer granularity: alongside
(flag, perturbation, k) it stores the RNG seed, completed ensemble batches
persist to per-k ``ensemble_parts/`` files (config-stamped, replayed on
restart — models/nmfk.py, tested by tests/test_ensemble_memory.py), and
when a k completes the per-k results live in results.npz (results.h5 in
the reference layout where h5py is installed), as the reference keeps
them (which is what makes restart-at-k valid there too).  State is
JSON (human-readable, version-tagged) instead of pickled objects.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

# pipeline-stage flags (reference pyDNMFk.py:165):
FLAG_RUNNING = 0        # inside the perturbation loop
FLAG_PERTS_DONE = 1     # all perturbations factorized
FLAG_CLUSTERED = 2      # clustering finished
FLAG_SAVED = 3          # per-k results written


@dataclasses.dataclass
class CheckpointState:
    flag: int = FLAG_RUNNING
    perturbation: int = 0
    k: int = 0
    seed: int = 0
    version: int = 1


class Checkpoint:
    def __init__(self, results_path: str, enabled: bool = True):
        self.enabled = enabled
        self.path = os.path.join(results_path, "checkpoint.json")
        self.state: Optional[CheckpointState] = None

    def load(self) -> Optional[CheckpointState]:
        if not self.enabled or not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            d = json.load(f)
        self.state = CheckpointState(**{k: d[k] for k in
                                        CheckpointState.__dataclass_fields__
                                        if k in d})
        return self.state

    def save(self, flag: int, perturbation: int, k: int, seed: int = 0):
        if not self.enabled:
            return
        st = CheckpointState(flag=flag, perturbation=perturbation, k=k,
                             seed=seed)
        self.state = st              # in-memory state tracks on EVERY process
        import jax
        if jax.process_index() != 0:
            # rank-0-style writes (reference utils.py:522-531); multi-host
            # runs assume a shared results FS, as the reference's mpirun
            # jobs do
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(st), f)
        os.replace(tmp, self.path)   # atomic, unlike the reference's pickle

    def resume_k(self, start_k: int, step_k: int) -> int:
        """Starting k after a resume: a k whose results were fully saved
        (flag==FLAG_SAVED) is skipped; an interrupted k is recomputed."""
        st = self.load()
        if st is None or st.k == 0:
            return start_k
        if st.flag >= FLAG_SAVED:
            return st.k + step_k
        return st.k


# ---------------------------------------------------------------------------
# Mid-solve factor checkpointing backends (models/nmf.py
# _solve_checkpointed): persist (W, H, iteration) between chunks of one
# long factorization.  The reference has no recovery below whole-k
# granularity.  Two backends behind one load/save/cleanup contract:
#
#   * npz — single-device factors, one atomic host file.
#   * orbax — mesh-sharded factors saved via orbax/tensorstore WITHOUT a
#     host gather: every process writes only the shards it owns, so the
#     same code path covers multi-host pods (reference-world equivalent:
#     none; mpirun jobs restart the whole k).
#
# Any torn/mismatched state restarts the solve from iteration 0 — the
# checkpoint is an optimization, never a correctness dependency.
# ---------------------------------------------------------------------------
def solve_checkpointer(results_path: str, k: int, tag: str, sharded: bool):
    cls = _OrbaxSolveCheckpoint if sharded else _NpzSolveCheckpoint
    return cls(results_path, k, tag)


class _NpzSolveCheckpoint:
    def __init__(self, results_path: str, k: int, tag: str):
        self.path = os.path.join(results_path, f"solve_ckpt_k{k}.npz")
        self.tag = tag

    def load(self, W, H):
        import jax.numpy as jnp
        import numpy as np
        if os.path.exists(self.path):
            try:
                with np.load(self.path) as d:
                    if str(d["tag"]) == self.tag:
                        return (jnp.asarray(d["W"]), jnp.asarray(d["H"]),
                                int(d["i"]))
            except Exception:
                pass                      # torn write: restart from 0
        return W, H, 0

    def save(self, W, H, i: int):
        import numpy as np
        tmp = self.path + ".tmp.npz"
        np.savez(tmp, W=np.asarray(W), H=np.asarray(H), i=i, tag=self.tag)
        os.replace(tmp, self.path)

    def cleanup(self):
        try:
            os.remove(self.path)
        except OSError:
            pass


class _OrbaxSolveCheckpoint:
    """A/B alternating orbax dirs: each save writes the NON-live dir and
    atomically repoints the tag file afterwards, so a preemption mid-save
    can only tear the dir being written — the previous checkpoint (still
    referenced by the old tag file) survives intact.  (The round-2 version
    overwrote the single live dir in place; a crash there silently
    restarted the solve from iteration 0.)"""

    _SLOTS = (".a", ".b")

    def __init__(self, results_path: str, k: int, tag: str):
        try:
            import orbax.checkpoint  # noqa: F401
        except ImportError:
            raise ImportError(
                "solve_checkpoint_every on mesh-sharded factors persists "
                "them with orbax-checkpoint, which is not installed; "
                "install it or run the solve on one device (npz "
                "checkpoints)") from None
        self.base = os.path.abspath(
            os.path.join(results_path, f"solve_ckpt_k{k}.orbax"))
        self.tagfile = self.base + ".tag"
        self.tag = tag

    def _ckptr(self):
        import orbax.checkpoint as ocp
        return ocp.PyTreeCheckpointer()

    def _live_slot(self):
        """Slot named by the tag file, or None (missing/stale/torn tag)."""
        try:
            with open(self.tagfile) as f:
                content = f.read()
        except OSError:
            return None
        slot, _, tag = content.partition("\n")
        if tag != self.tag or slot not in self._SLOTS:
            return None
        return slot

    def load(self, W, H):
        import jax
        import jax.numpy as jnp
        slot = self._live_slot()
        if slot is None or not os.path.isdir(self.base + slot):
            return W, H, 0
        try:
            import orbax.checkpoint as ocp
            tpl = {"W": W, "H": H,
                   "i": jnp.zeros((), jnp.int32)}
            restore_args = jax.tree.map(
                lambda x: ocp.ArrayRestoreArgs(sharding=x.sharding), tpl)
            out = self._ckptr().restore(self.base + slot,
                                        restore_args=restore_args)
            return out["W"], out["H"], int(out["i"])
        except Exception:
            return W, H, 0               # partial/incompatible: restart

    def save(self, W, H, i: int):
        import shutil
        import jax.numpy as jnp
        live = self._live_slot()
        target = self._SLOTS[0] if live != self._SLOTS[0] else self._SLOTS[1]
        shutil.rmtree(self.base + target, ignore_errors=True)
        self._ckptr().save(self.base + target,
                           {"W": W, "H": H,
                            "i": jnp.asarray(i, jnp.int32)}, force=True)
        tmp = self.tagfile + ".tmp"
        with open(tmp, "w") as f:
            f.write(target + "\n" + self.tag)
        os.replace(tmp, self.tagfile)    # repoint last: the commit point

    def cleanup(self):
        import shutil
        for slot in self._SLOTS:
            shutil.rmtree(self.base + slot, ignore_errors=True)
        try:
            os.remove(self.tagfile)
        except OSError:
            pass
