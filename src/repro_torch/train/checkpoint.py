"""Atomic, asynchronous checkpoints of a tree of tensors; port of
`repro/train/checkpoint.py`, in its on-disk format.

  * two-phase commit: the leaves land in `step_N.tmp/` (one `.npy` a leaf,
    then `MANIFEST.json` with each leaf's file, shape and dtype), and one
    atomic rename makes `step_N/` visible; a crashed save is never taken
    for a complete one, and `keep` bounds the steps kept
  * async save: `save` takes a host copy of every leaf before it returns
    (the step loop writes some tensors in place, the pending blocks among
    them), and the files are written on a background thread
  * restore onto any device: each leaf goes to its template leaf's device,
    or to the one `shardings` names (one device, or a matching tree)
  * the walk engine's state saves through the same path: its frozen
    dataclasses (`EngineState`, `WalkStore`, `StreamingGraph`) and
    NamedTuples (`PendingBlocks`, `MaintainerState`) give stable
    attribute-named leaf paths, so the maintainer's (EngineState, SGNS
    tables, opt) carry saves and restores as one step

bf16 tensors are saved as the reference's are (numpy has no bf16: its
ml_dtypes arrays land as two-byte void items, `'<V2'`, with "bfloat16" in
the manifest) and restored bit for bit. Host integers are leaves too,
saved as 0-d int64 arrays and restored as ints. `HOST_COUNTERS` (the engine's `n_pending` and `epoch`, which the
reference keeps on the device) take the checkpoint's value; every other
int sizes a tensor (a store's `length`, `n_walks`, ...) and must equal
the template's, as a shape must.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.tree import leaf_paths, rebuild

HOST_COUNTERS = frozenset({"n_pending", "epoch"})
SCALARS = (bool, int, float)
BF16_ITEM = np.dtype("V2")    # a bf16 leaf's bits on disk, as ml_dtypes saves them


def _host_copy(leaf) -> np.ndarray:
    """A numpy array that shares no memory with `leaf` (a CPU tensor's
    `.numpy()` would: a later in-place write would reach the save)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.cpu() if t.is_cuda else t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_ITEM)
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int64)
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # each save's step, bytes and seconds: the host copy, and the file
        # write (set when the write ends)
        self.saves: List[Dict[str, float]] = []

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree, blocking: bool = False):
        """Two-phase atomic save; async unless blocking. Every leaf is
        copied to the host before this returns."""
        t0 = time.perf_counter()
        leaves = {k: _host_copy(v) for k, v in leaf_paths(tree).items()}
        stats = {"step": step, "bytes": sum(a.nbytes for a in leaves.values()),
                 "copy_s": time.perf_counter() - t0}
        self.wait()
        self.saves.append(stats)

        def _write():
            t1 = time.perf_counter()
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "time": time.time(), "leaves": {}}
            for key, arr in leaves.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": "bfloat16" if arr.dtype == BF16_ITEM else str(arr.dtype),
                }
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()
            stats["write_s"] = time.perf_counter() - t1

        def _write_async():
            try:
                _write()
            except Exception as e:  # re-raised by the next wait()
                self._error = e

        if blocking:
            _write()
        else:
            self._pending = threading.Thread(target=_write_async, daemon=True)
            self._pending.start()

    def wait(self):
        """Wait for the async write in flight; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "MANIFEST.json")):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, shardings=None):
        """Restore into `template`'s structure -> (tree, step). Each tensor
        takes its template leaf's dtype and goes to its device, or to the
        device `shardings` gives it: one device for every leaf, or a tree
        of devices matching the template's (the port's counterpart of the
        reference's elastic re-shard)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        if isinstance(shardings, (str, torch.device)):
            one = torch.device(shardings)
            sh_leaves = None
        else:
            one = None
            sh_leaves = leaf_paths(shardings) if shardings is not None else {}
        out = {}
        for key, tpl in leaf_paths(template).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(os.path.join(d, meta["file"]))
            if isinstance(tpl, SCALARS):
                out[key] = _restore_scalar(key, arr, tpl)
                continue
            if tuple(arr.shape) != tuple(tpl.shape):
                raise ValueError(
                    f"leaf {key}: ckpt {arr.shape} vs template {tpl.shape}")
            dev = one if one is not None else (
                sh_leaves[key] if key in sh_leaves else tpl.device)
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if arr.dtype == BF16_ITEM else torch.from_numpy(arr))
            out[key] = t.to(device=torch.device(dev), dtype=tpl.dtype)
        return rebuild(template, out), step


def _restore_scalar(key: str, arr: np.ndarray, tpl):
    if arr.shape != ():
        raise ValueError(f"leaf {key}: ckpt {arr.shape} vs a host scalar")
    value = type(tpl)(arr.item())
    if key.rsplit("/", 1)[-1] not in HOST_COUNTERS and value != tpl:
        raise ValueError(f"leaf {key}: ckpt {value!r} vs template {tpl!r}")
    return value
