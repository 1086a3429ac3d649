"""Batched block-sparse semiring SpMV (one frontier step), hand-written
in CUDA C++ for Hopper: ``csrc/frontier.cu``.

It replaces the Pallas TPU kernel ``repro/kernels/frontier.py::
propagate_blocks`` and reads the packed layout (``core/graph.py::
PackedBlocks``): only the entries of each tile that differ from the
add-identity.  The entries are cut into work items of at most
``repro_chunk()`` entries of one destination row (``PackedBlocks.
work_items``); one CUDA block takes an (item, 8-lane Q-tile), skips the
entries whose source block is dead through the per-source-block live
table (:func:`block_live`, one launch of the source's liveness kernel),
applies the per-lane mask, combines into a shared-memory accumulator and
folds it into the output with global atomics.  The source says what
bounds it on the card.

The kernel is built at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into ``build/repro_torch/`` at the repo
root, keyed on a hash of the source, and loaded with ``ctypes``.  Nothing
is built or imported at module import.  On CPU tensors the wrapper runs
:func:`propagate_blocks_plain`; on CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.graph import PackedBlocks
from repro_torch.core.semiring import Semiring
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "frontier.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    build never loads a half-written library.  What ``ptxas`` reports
    (registers, shared memory, spills per kernel) is kept beside it, in
    the same name with ``.log``."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"frontier-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              check=True, capture_output=True, text=True)
        out.with_suffix(".log").write_text(done.stdout + done.stderr)
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
        fn = lib.repro_propagate_packed
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5 + [ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_block_live.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.repro_block_live.restype = ctypes.c_int
        lib.repro_chunk.argtypes = []
        lib.repro_chunk.restype = ctypes.c_int
        _lib = lib
    return _lib


def block_live_plain(mask: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """The liveness kernel's plain version: ``mask`` (Q, V) reduced over the
    lanes, then over each source block's ``block`` columns."""
    live = torch.zeros(nb * block, dtype=torch.bool, device=mask.device)
    live[: mask.shape[1]] = mask.any(0)
    return live.reshape(nb, block).any(-1)


def block_live(mask: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """(nb,) bool — which source blocks hold an active vertex in some lane
    of ``mask`` (Q, V) bool, V <= nb * block (the tail block is cut at V).
    The table :func:`propagate_blocks` takes as ``live``.  CUDA tensors
    take one launch of the liveness kernel, counted per Q in
    ``block_live.shapes``; CPU tensors its plain version."""
    if mask.dtype != torch.bool or mask.dim() != 2:
        raise ValueError(f"block_live: mask must be (Q, V) bool, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    q, v = mask.shape
    if v > nb * block or not 1 <= block <= 1024 or nb < 1:
        raise ValueError(f"block_live: V={v} with nb={nb}, B={block}")
    if mask.device.type == "cpu":
        return block_live_plain(mask, nb, block)
    if mask.device.type != "cuda":
        raise ValueError(f"block_live: unsupported device {mask.device}")
    mask = mask.contiguous()
    live = torch.empty(nb, dtype=torch.bool, device=mask.device)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        rc = load().repro_block_live(mask.data_ptr(), live.data_ptr(), q, v, nb, block,
                                     stream)
    if rc != 0:
        raise RuntimeError(f"block_live: CUDA launch failed with error {rc}")
    block_live.shapes[q] += 1
    return live


block_live.shapes = collections.Counter()


def propagate_blocks_plain(pb: PackedBlocks, sr: Semiring, x: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           active: Optional[torch.Tensor] = None,
                           live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's plain PyTorch version on the same packed inputs: gather
    each entry's source lanes, gate them by ``active[i, k]`` or
    ``live[src_ids[i, k]]`` and the mask, apply the semiring's ``mul`` and
    combine by destination in one ``scatter_reduce`` that starts at the
    add-identity."""
    q, v = x.shape
    b, nb = pb.block, pb.num_dst_blocks
    vp = nb * b
    add_id = sr.identity(x.dtype)
    xb = torch.full((q, vp), add_id, dtype=x.dtype, device=x.device)
    xb[:, :v] = x
    if mask is not None:
        mb = torch.zeros((q, vp), dtype=torch.bool, device=x.device)
        mb[:, :v] = mask
        xb = torch.where(mb, xb, add_id)
    i = torch.repeat_interleave(torch.arange(nb, device=x.device),
                                pb.row_ptr.diff().long())
    k, r, c = pb.decode(i.numel())  # entries past row_ptr[-1] are padding
    slot = i * pb.max_bpr + k
    sb = pb.src_ids.reshape(-1)[slot].long()
    msgs = ref.apply_mul(sr, xb[:, sb * b + r], None if pb.w is None else pb.w[:i.numel()])
    if active is not None:
        msgs = torch.where(active.reshape(-1)[slot], msgs, add_id)
    if live is not None:
        msgs = torch.where(live[sb], msgs, add_id)
    return sr.segment_combine(msgs, i * b + c, vp)[:, :v]


def propagate_blocks(pb: PackedBlocks, sr: Semiring, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None,
                     live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One frontier step on the packed block-sparse layout. x: (Q, V) -> (Q, V).

    ``mask``   (Q, V) bool — per-lane frontier; a masked source sends the
               add-identity.
    ``live``   (nb,) bool — per-source-block liveness (:func:`block_live`
               of the mask); an entry whose source block is dead is
               skipped.  The gated path's form.
    ``active`` (nb, max_bpr) bool — per-slot activity, a bitmap the caller
               built (``ops.block_activity``); the entries of dead slots
               are skipped.  At most one of ``live`` and ``active``; with
               neither, every entry is visited.

    CPU tensors take :func:`propagate_blocks_plain`; CUDA tensors launch
    the kernel.  ``propagate_blocks.shapes`` counts the launches per
    (semiring, dtype, Q), and :func:`launches` is their total;
    ``propagate_blocks.gating`` counts the calls, on either device, by
    gating form: ``live``, ``slots`` (``active``) or ``none``.  A dense
    ``BlockSparse`` is refused: pack it once with
    ``core.graph.pack_blocks``.
    """
    if not isinstance(pb, PackedBlocks):
        raise TypeError(f"propagate_blocks takes PackedBlocks, got {type(pb).__name__}: "
                        "pack a dense table once with core.graph.pack_blocks(bs, sr)")
    if sr.reads_weight and pb.w is None:
        raise ValueError(f"propagate_blocks: {sr.name} reads weights, but the table "
                         "was packed for a semiring that reads none")
    if active is not None and live is not None:
        raise ValueError("propagate_blocks: pass active or live, not both")
    propagate_blocks.gating["live" if live is not None
                            else "slots" if active is not None else "none"] += 1
    if x.device.type == "cpu":
        return propagate_blocks_plain(pb, sr, x, mask=mask, active=active, live=live)
    if x.device.type != "cuda":
        raise ValueError(f"propagate_blocks: unsupported device {x.device}")
    if sr.name not in _SR_CODE:
        raise ValueError(f"propagate_blocks: unknown semiring {sr.name!r}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"propagate_blocks: x must be int32 or float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"propagate_blocks: x must be (Q, V), got {tuple(x.shape)}")
    q, v = x.shape
    b, nb, m = pb.block, pb.num_dst_blocks, pb.max_bpr
    if pb.dtype != x.dtype:
        raise TypeError(f"propagate_blocks: the table is {pb.dtype}, x is {x.dtype}")
    w = pb.w if sr.reads_weight else None
    for name, t, shape in (("src_ids", pb.src_ids, (nb, m)),
                           ("row_ptr", pb.row_ptr, (nb + 1,)),
                           ("entries", pb.entries, (pb.entries.numel(),))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise TypeError(f"propagate_blocks: {name} must be contiguous int32 {shape}")
    if w is not None and (w.dtype != x.dtype or w.shape != pb.entries.shape
                          or not w.is_contiguous()):
        raise TypeError("propagate_blocks: w must be contiguous, one value per entry")
    if not 1 <= b <= 1024:
        raise ValueError(f"propagate_blocks: block {b} outside [1, 1024]")
    vp = nb * b
    if v > vp:
        raise ValueError(f"propagate_blocks: V={v} exceeds nb*B={vp}")
    if active is not None:
        if active.dtype != torch.bool or tuple(active.shape) != (nb, m):
            raise ValueError("propagate_blocks: active must be (nb, max_bpr) bool")
        active = active.contiguous()
    if live is not None:
        if live.dtype != torch.bool or tuple(live.shape) != (nb,):
            raise ValueError("propagate_blocks: live must be (nb,) bool")
        live = live.contiguous()
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (q, v)):
        raise ValueError("propagate_blocks: mask must be (Q, V) bool")
    if any(t is not None and t.device != x.device
           for t in (pb.src_ids, pb.row_ptr, pb.entries, w, active, live, mask)):
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
    out = torch.full_like(xpad, add_id)  # the kernel folds items into it
    if q == 0:
        return out[:, :v]
    lib = load()
    items = pb.work_items(lib.repro_chunk())
    if items.shape[0] == 0:  # no entries: every output is add_id
        return out[:, :v]
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_propagate_packed(
            _SR_CODE[sr.name], _DTYPE_CODE[x.dtype], xpad.data_ptr(),
            pb.entries.data_ptr(), ptr(w), items.data_ptr(), items.shape[0],
            pb.src_ids.data_ptr(), ptr(active), ptr(live), ptr(mpad), out.data_ptr(),
            q, nb, m, b, pb.shift, float(add_id), stream,
        )
    if rc != 0:
        raise RuntimeError(f"propagate_blocks: CUDA launch failed with error {rc}")
    propagate_blocks.shapes[(sr.name, str(x.dtype).removeprefix("torch."), q)] += 1
    return out[:, :v]


propagate_blocks.shapes = collections.Counter()
propagate_blocks.gating = collections.Counter()


def work_chunk() -> int:
    """The entries per work item the built kernel takes (builds and loads
    it)."""
    return load().repro_chunk()


def launches() -> int:
    """The kernel's launches counted in ``propagate_blocks.shapes``."""
    return sum(propagate_blocks.shapes.values())
