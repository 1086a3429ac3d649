"""Durable graph/index store: atomic, content-hashed, self-describing
(``repro.core.store``).

Index construction (Hub²) and graph ingest dominate cold start, and the
paper's deployment is a long-lived server, so both must survive process
death.  Every entry is written to a temp directory, every file hashed,
the manifest fsynced, and the directory renamed into place:

* **Self-describing**: each entry's manifest records a recursive *spec*
  of the stored object — plain scalars, dicts/lists/tuples, and the
  port's dataclasses (``Graph``, ``BlockSparse``, ``PackedBlocks``,
  ``HubIndex``) — so ``get`` rebuilds the object with no template and no
  pickle (classes resolve by name, restricted to ``repro_torch.*``).
* **Arrays on disk are numpy**, under numpy dtype names (a ``bfloat16``
  tensor is stored as float32 and cast back), in the JAX package's file
  layout: an entry of plain dicts and arrays reads the same in both
  packages.  ``get(name, device=...)`` builds tensors on
  ``resolve_device(device)``.
* **Sharding**: ``put(..., shards=k, shard_dim=V)`` splits every leaf
  whose trailing axis is the vertex dimension into k per-shard files;
  ``get`` reassembles the full leaf whatever k was.
* **Crash-safe**: a ``put`` interrupted at any point leaves either the
  old complete entry or a dead temp dir; ``get`` refuses any entry whose
  manifest is missing, marked incomplete, or whose file hashes mismatch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import re
import shutil
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device


class StoreError(RuntimeError):
    """Entry missing, incomplete, corrupt, or unserializable."""


_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


# ------------------------------------------------------- atomic dir helpers
def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(dir_: str, manifest: dict) -> None:
    """Write manifest.json with ``complete`` asserted, flushed and fsynced —
    the commit record of the atomic-write protocol."""
    manifest = dict(manifest, complete=True)
    with open(os.path.join(dir_, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def verify_manifest(dir_: str) -> Optional[dict]:
    """The manifest if the entry is complete and every file hash checks out,
    else None.  Never raises — a torn entry reads as absent."""
    mpath = os.path.join(dir_, "manifest.json")
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            m = json.load(f)
        if not m.get("complete"):
            return None
        for fname, digest in m["files"].items():
            if sha256_file(os.path.join(dir_, fname)) != digest:
                return None
        return m
    except Exception:
        return None


def commit_dir(tmp: str, final: str) -> str:
    """Atomically replace ``final`` with ``tmp`` (rename is the commit
    point; an existing complete entry is removed first)."""
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


# --------------------------------------------------------- spec (de)coding
def _class_ref(cls: type) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _resolve_class(ref: str) -> type:
    mod, _, qual = ref.partition(":")
    if not (mod == "repro_torch" or mod.startswith("repro_torch.")):
        raise StoreError(f"refusing to resolve class outside repro_torch.*: {ref}")
    obj: Any = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    if not (isinstance(obj, type) and dataclasses.is_dataclass(obj)):
        raise StoreError(f"{ref} is not a dataclass")
    return obj


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _spec_of(obj, arrays: dict, prefix: str) -> dict:
    """Recursively describe ``obj``, collecting array leaves (as numpy)
    into ``arrays`` keyed by their path."""
    if obj is None:
        return {"t": "none"}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {f.name: _spec_of(getattr(obj, f.name), arrays, f"{prefix}.{f.name}")
                  for f in dataclasses.fields(obj)}
        return {"t": "dc", "cls": _class_ref(type(obj)), "static": {},
                "fields": fields}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise StoreError(f"dict at {prefix!r} has non-string keys")
        return {"t": "dict", "items": {
            k: _spec_of(v, arrays, f"{prefix}.{k}") for k, v in obj.items()
        }}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple", "items": [
            _spec_of(v, arrays, f"{prefix}[{i}]") for i, v in enumerate(obj)
        ]}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    if isinstance(obj, torch.dtype):  # PackedBlocks.dtype
        return {"t": "torch_dtype", "v": _dtype_name(obj)}
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        arrays[prefix] = arr
        return {"t": "arr", "key": prefix, "dtype": _dtype_name(t.dtype),
                "shape": list(arr.shape)}
    if isinstance(obj, np.ndarray) or np.isscalar(obj):
        arr = np.asarray(obj)
        arrays[prefix] = arr
        return {"t": "arr", "key": prefix, "dtype": str(arr.dtype),
                "shape": list(arr.shape)}
    raise StoreError(f"cannot serialize {type(obj).__name__} at {prefix!r}")


def _build_from_spec(spec: dict, flat: dict, device: torch.device):
    t = spec["t"]
    if t == "none":
        return None
    if t == "py":
        return spec["v"]
    if t == "torch_dtype":
        return getattr(torch, spec["v"])
    if t == "arr":
        arr = flat[spec["key"]]
        want = spec["dtype"]
        if want == "bfloat16":  # float32 on disk
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device, torch.bfloat16)
        if arr.dtype != np.dtype(want):
            arr = arr.astype(want)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if t == "dict":
        return {k: _build_from_spec(s, flat, device) for k, s in spec["items"].items()}
    if t == "list":
        return [_build_from_spec(s, flat, device) for s in spec["items"]]
    if t == "tuple":
        return tuple(_build_from_spec(s, flat, device) for s in spec["items"])
    if t == "dc":
        cls = _resolve_class(spec["cls"])
        kw = dict(spec["static"])
        kw.update({k: _build_from_spec(s, flat, device)
                   for k, s in spec["fields"].items()})
        return cls(**kw)
    raise StoreError(f"unknown spec node type {t!r}")


def _to_disk_dtype(arr: np.ndarray) -> np.ndarray:
    # dtypes numpy cannot save natively -> float32; the spec keeps the name
    if arr.dtype.kind not in "fiub":
        return arr.astype(np.float32)
    return arr


# ------------------------------------------------------------------- store
class Store:
    """A directory of named, atomically-written, content-hashed entries.

    Layout::

        root/<name>/manifest.json   spec + per-file sha256 + complete flag
        root/<name>/common.npz      unsharded array leaves
        root/<name>/shard_000.npz   per-shard slices of V-trailing leaves
    """

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def _dir(self, name: str) -> str:
        if not _NAME_RE.match(name):
            raise StoreError(f"bad entry name {name!r}")
        return os.path.join(self.root, name)

    # ------------------------------------------------------------- write
    def put(self, name: str, obj, *, shards: int = 1,
            shard_dim: Optional[int] = None, meta: Optional[dict] = None) -> str:
        """Serialize ``obj`` under ``name``; atomic against crashes.

        ``shards``/``shard_dim``: split every array leaf whose trailing axis
        equals ``shard_dim`` (the padded vertex count, which must divide by
        ``shards``) into per-shard files, reassembled by ``get``.
        """
        shards = int(shards)
        if shards > 1:
            if shard_dim is None:
                raise StoreError("shards > 1 needs shard_dim (the V axis)")
            if shard_dim % shards:
                raise StoreError(
                    f"shard_dim={shard_dim} not divisible by shards={shards}")
        arrays: dict[str, np.ndarray] = {}
        spec = _spec_of(obj, arrays, "$")
        final = self._dir(name)
        tmp = tempfile.mkdtemp(dir=self.root, prefix=f".tmp_{name}_")
        try:
            common, sharded = {}, {}
            for key, arr in arrays.items():
                arr = _to_disk_dtype(arr)
                if shards > 1 and arr.ndim >= 1 and arr.shape[-1] == shard_dim:
                    sharded[key] = arr
                else:
                    common[key] = arr
            files: dict[str, str] = {}

            def dump(fname: str, d: dict) -> None:
                fpath = os.path.join(tmp, fname)
                np.savez(fpath, **d)
                files[fname] = sha256_file(fpath)

            dump("common.npz", common)
            for i in range(shards if sharded else 0):
                dump(f"shard_{i:03d}.npz", {
                    k: a[..., i * (a.shape[-1] // shards):
                         (i + 1) * (a.shape[-1] // shards)]
                    for k, a in sharded.items()
                })
            write_manifest(tmp, {
                "name": name,
                "time": time.time(),
                "spec": spec,
                "files": files,
                "shards": shards if sharded else 1,
                "sharded_keys": sorted(sharded),
                "shard_dim": shard_dim if sharded else None,
                "meta": dict(meta or {}),
            })
            return commit_dir(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    # -------------------------------------------------------------- read
    def manifest(self, name: str) -> Optional[dict]:
        return verify_manifest(self._dir(name))

    def exists(self, name: str) -> bool:
        return self.manifest(name) is not None

    __contains__ = exists

    def names(self) -> list[str]:
        return [d for d in sorted(os.listdir(self.root))
                if not d.startswith(".") and self.exists(d)]

    def meta(self, name: str) -> dict:
        m = self.manifest(name)
        if m is None:
            raise StoreError(f"no valid entry {name!r} in {self.root}")
        return m.get("meta", {})

    def get(self, name: str, device=None):
        """Rebuild the stored object (template-free) with its tensors on
        ``resolve_device(device)``; raises ``StoreError`` on a
        missing/incomplete/corrupt entry."""
        dev = resolve_device(device)
        path = self._dir(name)
        m = verify_manifest(path)
        if m is None:
            raise StoreError(
                f"no valid entry {name!r} in {self.root} (missing, "
                "incomplete, or hash mismatch)")
        flat: dict[str, np.ndarray] = {}
        with np.load(os.path.join(path, "common.npz")) as z:
            flat.update({k: z[k] for k in z.files})
        sharded_keys = m.get("sharded_keys", [])
        if sharded_keys:
            parts: dict[str, list] = {k: [] for k in sharded_keys}
            for i in range(m["shards"]):
                with np.load(os.path.join(path, f"shard_{i:03d}.npz")) as z:
                    for k in sharded_keys:
                        parts[k].append(z[k])
            for k, ps in parts.items():
                flat[k] = np.concatenate(ps, axis=-1)
        return _build_from_spec(m["spec"], flat, dev)

    def delete(self, name: str) -> None:
        path = self._dir(name)
        if os.path.exists(path):
            shutil.rmtree(path)


# ----------------------------------------------- engine boot-state helpers
def save_engine_store(store: Store, graph, *, index=None, aux_graphs=None,
                      tables=None, shards: int = 1) -> dict:
    """Persist everything a serving engine needs to boot without rebuild:
    the graph, an optional prebuilt index (e.g. ``HubIndex``), named aux
    propagation views, and prebuilt per-semiring tile tables (from
    ``QuegelEngine.export_tables()``; ``PackedBlocks`` for ``cuda``).
    Entries are bound to the graph by its content hash so a restored index
    is never applied to a different graph.  Returns {entry name: meta}."""
    # version + parent hash make the stored snapshot a point on the
    # mutation chain: recovery boots from it and replays the journal's
    # mutation records, which verify parentage against this
    meta = {
        "graph_hash": graph.content_hash(),
        "graph_version": int(graph.version),
        "parent_hash": graph.parent_hash,
    }
    written = {}
    store.put("graph", graph, shards=shards, shard_dim=graph.n, meta=meta)
    written["graph"] = meta
    if index is not None:
        store.put("index", index, shards=shards, shard_dim=graph.n, meta=meta)
        written["index"] = meta
    if aux_graphs:
        store.put("aux_graphs", dict(aux_graphs), shards=shards,
                  shard_dim=graph.n, meta=meta)
        written["aux_graphs"] = meta
    if tables:
        store.put("tables", dict(tables), meta=meta)
        written["tables"] = meta
    return written


def load_engine_store(store: Store, device=None) -> dict:
    """Inverse of :func:`save_engine_store`, on ``resolve_device(device)``:
    {'graph', 'index', 'aux_graphs', 'tables'} with None/{} for absent
    entries.  Refuses entries whose recorded graph hash does not match the
    stored graph."""
    dev = resolve_device(device)
    graph = store.get("graph", device=dev)
    ghash = graph.content_hash()
    out = {"graph": graph, "index": None, "aux_graphs": {}, "tables": {}}
    for name in ("index", "aux_graphs", "tables"):
        m = store.manifest(name)
        if m is not None:
            rec = m.get("meta", {}).get("graph_hash")
            if rec is not None and rec != ghash:
                raise StoreError(
                    f"store entry '{name}' was built against graph "
                    f"{rec[:12]}, not {ghash[:12]}: rebuild or clear it")
            out[name] = store.get(name, device=dev)
    return out
