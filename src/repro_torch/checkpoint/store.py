"""Checkpointing: atomic, async and integrity-tagged, the port of
``repro.checkpoint.store`` with the same on-disk format:

    step_000000123/
      manifest.json     tree structure, shapes, dtypes and a crc32 per leaf
      arr_00000.npy ... one file per leaf, numbered in the JAX package's
                        leaf order (dict keys sorted, NamedTuple fields in
                        order, None no leaf: repro_torch/tree.py)
      _COMPLETE         commit marker, written last

So a checkpoint written by either package loads in the other.

  * a crash mid-save leaves no _COMPLETE marker, and ``latest_step`` skips
    the directory;
  * ``load_checkpoint`` checks every leaf's crc32 (torn or corrupt files
    raise);
  * ``AsyncCheckpointer`` snapshots to host (a numpy copy of every
    tensor, blocking only on the copy), then writes on a worker thread
    while training goes on.
"""

from __future__ import annotations

import json
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array that is written: a tensor's host copy (a
    copy on the CPU too, so an in-place update after a snapshot does not
    reach it), a Python or numpy scalar as ``np.asarray`` makes it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    """``zlib.crc32(arr.tobytes())`` without the copy."""
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))


def save_checkpoint(ckpt_dir: str | Path, step: int, tree) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, spec = T.flatten(tree)
    manifest = {"step": step, "treedef": T.spec_str(spec), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc32": _crc(arr),
        })
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "_COMPLETE").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _complete_steps(ckpt_dir: Path) -> list:
    return sorted(int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
                  if d.name.startswith("step_") and (d / "_COMPLETE").exists())


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str | Path, step: int, like_tree) -> Any:
    """The checkpoint of ``step`` in the structure of ``like_tree``. A leaf
    whose counterpart in ``like_tree`` is a tensor comes back as a tensor on
    that tensor's device, with the saved dtype; any other leaf as the saved
    numpy array. Raises ``IOError`` on a crc
    mismatch."""
    d = Path(ckpt_dir) / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    likes, spec = T.flatten(like_tree)
    assert len(likes) == len(manifest["leaves"]), (
        f"checkpoint has {len(manifest['leaves'])} leaves, tree expects {len(likes)}")
    out = []
    for meta, like in zip(manifest["leaves"], likes):
        arr = np.load(d / meta["file"])
        if _crc(arr) != meta["crc32"]:
            raise IOError(f"checkpoint corruption in {meta['file']} (crc mismatch)")
        if isinstance(like, torch.Tensor):
            out.append(torch.from_numpy(arr).to(like.device))
        else:
            out.append(arr)
    return T.unflatten(spec, out)


class AsyncCheckpointer:
    """Snapshot to host synchronously, write to disk on a background
    thread; keeps the newest ``keep_last`` complete checkpoints."""

    def __init__(self, ckpt_dir: str | Path, keep_last: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree) -> None:
        self.wait()  # one outstanding write at a time
        host_tree = T.tree_map(_host, tree)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _complete_steps(self.ckpt_dir)[:-self.keep_last]:
            shutil.rmtree(self.ckpt_dir / f"step_{s:09d}", ignore_errors=True)
