"""Atomic checkpoints with asynchronous writes (counterpart of
``repro.checkpoint.ckpt``).

Format: one directory per step,

* ``manifest.json``: the step, the caller's ``extra``, and each leaf's
  tree path, file, shape and dtype;
* ``<i>.npy``: one file per leaf (bfloat16 saved as its 16-bit pattern);
* ``coverage.json``: an optional ``coverage_report()`` snapshot
  (``save(report=...)``), the accounting that produced the weights.

Writes land in ``step_k.tmp`` and are renamed into place, so a crash never
leaves a half-readable checkpoint, and ``latest_step`` sees committed
directories only.  ``save`` copies every leaf to host memory (one copy
per leaf, the device-to-host staging), then serialises on a worker
thread: the train loop waits only for the previous save (a staleness of
one).  ``keep`` bounds the committed steps kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.regions import synchronize

#: dtypes numpy cannot hold, saved as a same-width integer pattern
_VIEWED = {torch.bfloat16: torch.int16}


def _paths_and_leaves(tree):
    flat, spec = pytree.tree_flatten_with_path(tree)
    return [pytree.keystr(p) for p, _ in flat], [x for _, x in flat], spec


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype in _VIEWED:
        x = x.view(_VIEWED[x.dtype])
    return x.numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._worker: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             report: Optional[dict] = None) -> None:
        """Checkpoint ``tree`` (tensor leaves) as step ``step``;
        ``report`` (a ``coverage_report()``-style dict) is written beside
        the weights."""
        self.wait()
        synchronize()
        paths, leaves, _ = _paths_and_leaves(tree)
        host = [(p, str(x.dtype).removeprefix("torch."), _to_numpy(x))
                for p, x in zip(paths, leaves)]

        def work():
            self._write(step, host, extra or {}, report)

        if self.async_save:
            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()
        else:
            work()

    def _write(self, step: int, host, extra: dict,
               report: Optional[dict]) -> None:
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for i, (path, dtype, arr) in enumerate(host):
            np.save(tmp / f"{i}.npy", arr)
            manifest["leaves"].append({"path": path, "file": f"{i}.npy",
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if report is not None:
            (tmp / "coverage.json").write_text(
                json.dumps(report, indent=1, default=str))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Block until the last asynchronous save is committed."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore -------------------------------------------------------
    def all_steps(self):
        out = []
        for d in self.dir.iterdir():
            if d.is_dir() and d.name.startswith("step_") and \
                    not d.name.endswith(".tmp") and \
                    (d / "manifest.json").exists():
                out.append(int(d.name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree: Any, step: Optional[int] = None) -> tuple:
        """``(tree, manifest)``: step ``step`` (the latest by default) in
        the structure of ``like_tree``, each leaf on the device and in the
        dtype of its ``like_tree`` leaf."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = {rec["path"]: rec for rec in manifest["leaves"]}
        paths, leaves, spec = _paths_and_leaves(like_tree)
        out = []
        for p, like in zip(paths, leaves):
            rec = by_path[p]
            t = torch.from_numpy(np.load(d / rec["file"]))
            dtype = getattr(torch, rec["dtype"])
            if dtype in _VIEWED:
                t = t.view(dtype)
            out.append(t.to(device=like.device, dtype=like.dtype))
        return pytree.tree_unflatten(out, spec), manifest
