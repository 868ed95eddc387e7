"""
Stage checkpoints of the samplers (copied from ``beat_tpu/backend.py``,
trimmed to what the port calls).

The files are those of the JAX package, byte for byte in layout, so
either package reads the other's runs:

    <homepath>/stage_<n>/trace.npz   q (n_rec, n_chains, dim) f32, llk f32
    <homepath>/stage_<n>/state.npz   the array entries of the stage state
    <homepath>/stage_<n>/meta.json   scalars, trace shapes, varnames

``stage_-1`` is the final (β = 1) stage.  A stage is valid iff its npz
files load and their shapes match ``meta.json``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile

import numpy as np

logger = logging.getLogger("beat_tpu_torch.backend")


def _atomic_save(path: str, **arrays) -> None:
    """Write an npz atomically (tmp file + rename) so crashes can't corrupt."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    # the suffix must be .npz: np.savez appends it otherwise, and the
    # rename would move an empty placeholder file
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class StageTrace:
    """In-memory view of one stage's sampled trace."""

    def __init__(self, q_trace: np.ndarray, llk_trace: np.ndarray, varnames=None,
                 ordering=None):
        # q_trace: (n_records, n_chains, dim); llk_trace: (n_records, n_chains)
        self.q_trace = q_trace
        self.llk_trace = llk_trace
        self.varnames = varnames or []
        self.ordering = ordering


class SampleStage:
    """Stage directory manager."""

    def __init__(self, homepath: str, ordering=None):
        self.homepath = homepath
        self.ordering = ordering
        os.makedirs(homepath, exist_ok=True)

    def stage_path(self, stage: int) -> str:
        return os.path.join(self.homepath, f"stage_{stage}")

    def _trace_file(self, stage: int) -> str:
        return os.path.join(self.stage_path(stage), "trace.npz")

    def _state_file(self, stage: int) -> str:
        return os.path.join(self.stage_path(stage), "state.npz")

    def _meta_file(self, stage: int) -> str:
        return os.path.join(self.stage_path(stage), "meta.json")

    def save_stage(self, stage: int, trace: dict, state: dict) -> None:
        """Persist one finished stage.

        trace: {"q": (n_rec, n_chains, dim), "llk": (n_rec, n_chains)}
        state: json-serialisable scalars + numpy arrays (split here)."""
        arrays = {k: np.asarray(v) for k, v in state.items() if isinstance(v, np.ndarray)}
        scalars = {k: v for k, v in state.items() if not isinstance(v, np.ndarray)}
        _atomic_save(self._trace_file(stage), q=np.asarray(trace["q"], dtype=np.float32),
                     llk=np.asarray(trace["llk"], dtype=np.float32))
        _atomic_save(self._state_file(stage), **arrays)
        meta = {
            "scalars": scalars,
            "shape_q": list(np.asarray(trace["q"]).shape),
            "shape_llk": list(np.asarray(trace["llk"]).shape),
            "varnames": list(self.ordering.names) if self.ordering is not None else [],
        }
        with open(self._meta_file(stage), "w") as f:
            json.dump(meta, f, indent=1)
        logger.info("Saved stage %i to %s", stage, self.stage_path(stage))

    def load_trace(self, stage: int) -> StageTrace:
        with np.load(self._trace_file(stage)) as z:
            q, llk = z["q"], z["llk"]
        meta = self._load_meta(stage)
        return StageTrace(q, llk, varnames=meta.get("varnames"), ordering=self.ordering)

    def load_state(self, stage: int) -> dict:
        meta = self._load_meta(stage)
        state = dict(meta.get("scalars", {}))
        with np.load(self._state_file(stage)) as z:
            for k in z.files:
                state[k] = z[k]
        return state

    def _load_meta(self, stage: int) -> dict:
        with open(self._meta_file(stage)) as f:
            return json.load(f)

    def check_stage(self, stage: int) -> bool:
        """Validate a stage checkpoint: files load, shapes match the meta."""
        try:
            meta = self._load_meta(stage)
            with np.load(self._trace_file(stage)) as z:
                ok = (list(z["q"].shape) == meta["shape_q"]
                      and list(z["llk"].shape) == meta["shape_llk"])
            with np.load(self._state_file(stage)):
                pass
            return bool(ok)
        except Exception as e:  # corrupt/missing files of any kind
            logger.warning("Stage %i invalid: %s", stage, e)
            return False

    def highest_sampled_stage(self) -> int:
        """Largest valid stage number on disk, -1 for a valid final stage,
        or -2 if none."""
        stages = []
        if not os.path.isdir(self.homepath):
            return -2
        for name in os.listdir(self.homepath):
            if name.startswith("stage_"):
                try:
                    stages.append(int(name.split("_", 1)[1]))
                except ValueError:
                    continue
        if -1 in stages and self.check_stage(-1):
            return -1
        valid = sorted(s for s in stages if s >= 0 and self.check_stage(s))
        return valid[-1] if valid else -2

    def rm_all(self) -> None:
        if os.path.isdir(self.homepath):
            shutil.rmtree(self.homepath)
        os.makedirs(self.homepath, exist_ok=True)
