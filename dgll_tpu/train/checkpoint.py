"""Checkpoint/resume — a first-class feature the reference lacks entirely
(its best-model save is commented out, ``CommGNN_train.py:156``; SURVEY.md §5).

Each checkpoint is one ``.npz`` file holding the pytree's leaves keyed by their
tree paths. It is written to a temporary name and renamed into place, so a
crash mid-save never leaves a partial checkpoint behind.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import jax
import numpy as np

_NAME = re.compile(r"^ckpt_(\d+)\.npz$")


class CheckpointManager:
    """Save/restore a pytree (params or a full train state) per step; keep the
    newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step):010d}.npz")

    def steps(self) -> list:
        """Saved steps, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Write ``state`` as step ``step``. Saves are synchronous; ``wait`` is
        accepted for callers written against asynchronous managers."""
        leaves = jax.tree_util.tree_flatten_with_path(state)[0]
        arrays = {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}
        final = self._path(step)
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Leaves of step ``step`` (default: latest) in ``state_template``'s tree
        structure, or ``None`` when nothing was saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        leaves, treedef = jax.tree_util.tree_flatten_with_path(state_template)
        with np.load(self._path(step), allow_pickle=False) as data:
            out = []
            for path, tmpl in leaves:
                key = jax.tree_util.keystr(path)
                if key not in data:
                    raise KeyError(f"checkpoint step {step} has no leaf {key}")
                arr = data[key]
                if arr.shape != np.shape(tmpl):
                    raise ValueError(f"leaf {key}: saved shape {arr.shape}, "
                                     f"template shape {np.shape(tmpl)}")
                out.append(arr)
        return jax.tree_util.tree_unflatten(treedef, out)

    def close(self) -> None:
        """Nothing stays open between calls; kept for interface symmetry."""
