"""Batched block-sparse semiring SpMV (one frontier step), hand-written
in CUDA C++ for Hopper: ``csrc/frontier.cu``.

It replaces the Pallas TPU kernel ``repro/kernels/frontier.py::
propagate_blocks``.  One CUDA block owns a (destination block, 8-lane
Q-tile) of the output and loops over its slots, skipping dead tiles
through the activity bitmap and applying the per-lane mask inside the
tiles it visits; the source says what bounds it on the card.

The kernel is built at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into ``build/repro_torch/`` at the repo
root, keyed on a hash of the source, and loaded with ``ctypes``.  Nothing
is built or imported at module import.  On CPU tensors the wrapper runs
:func:`propagate_blocks_plain`; on CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.graph import BlockSparse
from repro_torch.core.semiring import Semiring
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "frontier.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_SR_CODE = {"min_plus": 0, "min_right": 1, "max_right": 2, "max_plus": 3,
            "sum_times": 4}
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernel needs the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/frontier.cu`` (once per source hash) and return the
    shared library's path.  The file appears atomically, so a concurrent
    build never loads a half-written library."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"frontier-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.repro_propagate_blocks
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4 + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def propagate_blocks_plain(bs: BlockSparse, sr: Semiring, x: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's plain PyTorch version: the tile loop of ``ref.py`` on
    the same inputs, same padding and same gating."""
    return ref.propagate_blocks_ref(bs, sr, x, mask=mask, active=active)


def propagate_blocks(bs: BlockSparse, sr: Semiring, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One frontier step on the block-sparse layout. x: (Q, V) -> (Q, V).

    ``mask``   (Q, V) bool — per-lane frontier, applied inside visited tiles.
    ``active`` (nb, max_bpr) bool — per-tile activity; dead tiles are
               skipped.  None visits every tile (the dense baseline).

    CPU tensors take :func:`propagate_blocks_plain`; CUDA tensors launch
    the kernel (``propagate_blocks.launches`` counts the launches).
    """
    if x.device.type == "cpu":
        return propagate_blocks_plain(bs, sr, x, mask=mask, active=active)
    if x.device.type != "cuda":
        raise ValueError(f"propagate_blocks: unsupported device {x.device}")
    if sr.name not in _SR_CODE:
        raise ValueError(f"propagate_blocks: unknown semiring {sr.name!r}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"propagate_blocks: x must be int32 or float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"propagate_blocks: x must be (Q, V), got {tuple(x.shape)}")
    q, v = x.shape
    b, nb, m = bs.block, bs.num_dst_blocks, bs.max_bpr
    tiles, src_ids = bs.tiles, bs.src_ids
    if tiles.dtype != x.dtype:
        raise TypeError(f"propagate_blocks: tiles are {tiles.dtype}, x is {x.dtype}")
    if tuple(tiles.shape) != (nb, m, b, b) or not tiles.is_contiguous():
        raise ValueError("propagate_blocks: tiles must be contiguous (nb, max_bpr, B, B)")
    if src_ids.dtype != torch.int32 or not src_ids.is_contiguous():
        raise TypeError("propagate_blocks: src_ids must be contiguous int32")
    if not 1 <= b <= 1024:
        raise ValueError(f"propagate_blocks: block {b} outside [1, 1024]")
    vp = nb * b
    if v > vp:
        raise ValueError(f"propagate_blocks: V={v} exceeds nb*B={vp}")
    if active is not None:
        if active.dtype != torch.bool or tuple(active.shape) != (nb, m):
            raise ValueError("propagate_blocks: active must be (nb, max_bpr) bool")
        active = active.contiguous()
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (q, v)):
        raise ValueError("propagate_blocks: mask must be (Q, V) bool")
    if any(t is not None and t.device != x.device
           for t in (tiles, src_ids, active, mask)):
        raise ValueError("propagate_blocks: every operand must be on x's device")
    add_id = sr.identity(x.dtype)

    def padded(a, fill):
        # the kernel reads whole (Q, nb*B) rows; pad V with the given fill
        if v == vp:
            return a.contiguous()
        out = torch.full((q, vp), fill, dtype=a.dtype, device=a.device)
        out[:, :v] = a
        return out

    xpad = padded(x, add_id)
    mpad = None if mask is None else padded(mask, False)
    out = torch.empty_like(xpad)
    if q == 0:
        return out[:, :v]
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_propagate_blocks(
            _SR_CODE[sr.name], _DTYPE_CODE[x.dtype], xpad.data_ptr(),
            tiles.data_ptr(), src_ids.data_ptr(),
            None if active is None else active.data_ptr(),
            None if mpad is None else mpad.data_ptr(), out.data_ptr(),
            q, nb, m, b, float(add_id), stream,
        )
    if rc != 0:
        raise RuntimeError(f"propagate_blocks: CUDA launch failed with error {rc}")
    propagate_blocks.launches += 1
    return out[:, :v]


propagate_blocks.launches = 0
