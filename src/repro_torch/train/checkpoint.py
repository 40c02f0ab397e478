"""Atomic, async checkpointing with restore onto any device (the
reference's ``train/checkpoint.py``, same files on disk).

Layout (the HDFS/GCS stand-in is a local directory):

    ckpt_root/
      step_00000100/
        MANIFEST.json        # leaf paths, shapes, dtypes, step, time
        <leaf-path>.npy      # one file per tree leaf

Leaf paths are ``utils.tree.flatten_with_paths``'s, the reference's
names letter for letter (``[<flat index 0>]/embedding``, ...), so either
package restores the other's float32 checkpoints.  Writes go to
``tmp_step_N`` then ``os.replace`` -> atomic commit: a crash mid-write
never corrupts the latest checkpoint (the supervisor restarts from the
last committed step).  ``AsyncCheckpointer`` moves the serialization off
the training thread (the device -> host copy happens at submit time, so
the step can keep updating the state in place).

bfloat16 leaves are written as the reference writes them: the raw two
bytes an element under a ``<V2`` header (numpy has no bfloat16), with
``bfloat16`` in the manifest.  The port restores them through an int16
view; the reference cannot restore them at all (``np.load`` gives void
bytes).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.utils.tree import flatten_with_paths, tree_map, tree_unflatten

_BF16_DESCR = "<V2"       # what np.save writes for ml_dtypes' bfloat16


def _leaf_file(name: str) -> str:
    return name.replace("/", "__") + ".npy"


def _host(leaf):
    """A leaf as a host copy that later updates of ``leaf`` leave alone
    (a CPU tensor is cloned, a CUDA tensor copied down)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _save_leaf(path: str, leaf) -> tuple[list, str]:
    """Write one leaf; returns its manifest entry (shape, dtype)."""
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        raw = leaf.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False,
                    "shape": tuple(raw.shape)})
            f.write(raw.tobytes())
        return list(raw.shape), "bfloat16"
    arr = leaf.numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(path: str, dtype: str, device) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save_checkpoint(root: str, step: int, state, keep: int = 3) -> str:
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = os.path.join(root, f"tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "time": time.time(), "leaves": {}}
    for name, leaf in flatten_with_paths(state):
        if torch.is_tensor(leaf) and leaf.device.type != "cpu":
            leaf = leaf.cpu()
        shape, dtype = _save_leaf(os.path.join(tmp, _leaf_file(name)), leaf)
        manifest["leaves"][name] = {"shape": shape, "dtype": dtype}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic commit
    _gc(root, keep)
    return final


def _gc(root: str, keep: int):
    steps = list_steps(root)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)


def list_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("step_") and os.path.exists(
                os.path.join(root, d, "MANIFEST.json")):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def restore_checkpoint(root: str, target, step: Optional[int] = None,
                       device=None):
    """``target``: a template tree (same structure; values ignored).
    Each leaf comes back in the checkpoint's dtype, on ``device`` or,
    without one, on the template leaf's device (with ``device`` given, a
    template of meta tensors will do).  Returns ``(tree, step)``."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    named = flatten_with_paths(target)
    missing = [n for n, _ in named if n not in manifest["leaves"]]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")
    leaves = [_load_leaf(os.path.join(d, _leaf_file(n)),
                         manifest["leaves"][n]["dtype"],
                         device if device is not None
                         else getattr(t, "device", "cpu"))
              for n, t in named]
    return tree_unflatten(target, leaves), step


class AsyncCheckpointer:
    """Background-thread writer with at-most-one in-flight checkpoint."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def submit(self, step: int, state):
        self.wait()
        # copy to the host NOW (blocking copies: each waits for the work
        # that writes its leaf) so the trainer may update the state
        host_state = tree_map(_host, state)

        def work():
            self.last_path = save_checkpoint(self.root, step, host_state,
                                             keep=self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
