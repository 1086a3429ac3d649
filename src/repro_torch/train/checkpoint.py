"""Checkpointing (``repro.train.checkpoint``): atomic, content-hashed and
layout-free.

Each named tree of a state is one ``.npz`` of logical (unsharded) host
arrays keyed by its path, ``/``-joined dict keys and list indices as the
JAX package spells them, beside a JSON manifest {step, sha256 per file,
complete: true}.  Writes go to a temp directory renamed into place only
after fsync, so a crash mid-save never corrupts the previous checkpoint,
and restore takes the newest manifest that verifies.  bfloat16 is
float32 on disk and is cast back to the prototype's dtype on restore, so
a checkpoint written by either package restores in the other.  The
atomic-write protocol is ``core/store.py``'s (``commit_dir``,
``write_manifest``, ``verify_manifest``).
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.store import commit_dir, sha256_file, verify_manifest, write_manifest


def _paths(tree, prefix: str = ""):
    """(key, leaf) pairs in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _paths(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: float32 on disk
            t = t.float()
        flat[key] = t.numpy()
    return flat


def _unflatten_into(tree_like, flat: dict[str, np.ndarray], prefix: str = ""):
    if isinstance(tree_like, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/") for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten_into(v, flat, f"{prefix}{i}/")
                               for i, v in enumerate(tree_like))
    key = prefix[:-1]
    arr = flat[key]
    if arr.shape != tuple(tree_like.shape):
        raise ValueError(f"shape mismatch at {key}: {arr.shape} != {tuple(tree_like.shape)}")
    return torch.from_numpy(np.array(arr)).to(device=tree_like.device, dtype=tree_like.dtype)


def save(ckpt_dir: str, step: int, state: dict[str, Any]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step{step}_")
    try:
        files = {}
        for name, tree in state.items():
            fname = f"{name}.npz"
            np.savez(os.path.join(tmp, fname), **_flatten(tree))
            files[fname] = sha256_file(os.path.join(tmp, fname))
        write_manifest(tmp, {"step": step, "files": files})
        return commit_dir(tmp, os.path.join(ckpt_dir, f"step_{step:08d}"))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and verify_manifest(os.path.join(ckpt_dir, d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, state_like: dict[str, Any], step: Optional[int] = None):
    """Returns (state, step) with each leaf a tensor of its prototype's
    shape, dtype and device (so the same checkpoint restores onto any
    device), or (None, None) if nothing valid exists."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if verify_manifest(path) is None:
        return None, None
    out = {}
    for name, tree in state_like.items():
        with np.load(os.path.join(path, f"{name}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        out[name] = _unflatten_into(tree, flat)
    return out, step
