"""Atomic, async checkpoints (the port of ``repro/checkpoint/manager.py``).

Layout::

    <dir>/step_00000123.tmp/      # written first
        manifest.json             # step, extra state, keys and dtypes
        arrays.npz                # one entry per leaf (its path key)
    <dir>/step_00000123/          # atomic rename on completion
    <dir>/LATEST                  # text file: last complete step

- **Atomic**: a checkpoint is visible only after the tmp → final rename,
  so a crash mid-write never corrupts the restore point.
- **Async**: :meth:`CheckpointManager.save_async` copies every tensor to
  host memory first (the caller may then change the device tensors) and
  writes from a background thread.
- The data stream's state and the step go into the manifest, so a resume
  continues the exact stream; retention keeps the newest ``keep``.
- :meth:`CheckpointManager.restore` puts every array on the device of the
  template's leaf, or on ``device``.

bf16 tensors are stored as their 16-bit patterns (numpy has no bf16)
and the manifest records each key's dtype.  Not ported yet: resharding
restore onto another mesh (ROADMAP A12) and the plan cache's snapshot
(ROADMAP A4).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.tree import paths, tree_map

__all__ = ["CheckpointManager"]


def _to_host(tree) -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` as a numpy array under its path key."""
    out = {}
    for key, leaf in paths(tree).items():
        t = leaf.detach().to("cpu", copy=True)
        out[key] = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                    else t.numpy())
    return out


def _dtypes(tree) -> Dict[str, str]:
    return {key: str(leaf.dtype).replace("torch.", "")
            for key, leaf in paths(tree).items()}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------
    def _snapshot(self, step: int, params, opt_state, extra):
        tree = {"params": params, "opt_state": opt_state}
        host = _to_host(tree)
        manifest = {"step": step, "extra": extra or {},
                    "keys": sorted(host), "dtypes": _dtypes(tree)}
        return host, manifest

    def save(self, step: int, params, opt_state,
             extra: Optional[dict] = None):
        self.wait()
        self._write(step, *self._snapshot(step, params, opt_state, extra))

    def save_async(self, step: int, params, opt_state,
                   extra: Optional[dict] = None):
        """Snapshot synchronously (device → host), write in the
        background."""
        self.wait()
        host, manifest = self._snapshot(step, params, opt_state, extra)
        self._thread = threading.Thread(
            target=self._write, args=(step, host, manifest), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, np.ndarray], manifest: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "LATEST"), "w") as f:
            f.write(str(step))
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self):
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            steps = self.all_steps()
            return steps[-1] if steps else None
        with open(path) as f:
            return int(f.read().strip())

    def restore(self, step: Optional[int], like, device=None):
        """Restore into the structure of ``like``, a (params, opt_state)
        template: → (params, opt_state, manifest).  Each array goes to
        ``device``, or to the device of its template leaf."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        tree = {"params": like[0], "opt_state": like[1]}
        keys = iter(paths(tree))
        with np.load(os.path.join(path, "arrays.npz")) as data:
            def load(leaf):
                key = next(keys)
                arr = torch.from_numpy(np.array(data[key]))
                if manifest["dtypes"][key] == "bfloat16":
                    arr = arr.view(torch.bfloat16)
                return arr.to(device if device is not None
                              else leaf.device)

            out = tree_map(load, tree)
        return out["params"], out["opt_state"], manifest
