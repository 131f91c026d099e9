"""Fault-tolerant checkpointing (``repro/training/checkpoint.py``):
atomic, manifest-versioned, the reference's layout::

    <dir>/step_000123.tmp-<nonce>/   (written fully, then atomically renamed)
    <dir>/step_000123/
        manifest.json   {step, leaf names/shapes/dtypes, checksums, extras}
        arr_000.npy ... (one file per tree leaf)

Leaves are the port's tree (nested dicts and lists of tensors) in
``optimizer.tree_leaves`` order (dict keys sorted, as ``jax.tree``
orders them).  A bf16 leaf is written as its raw 2 bytes (a ``<V2``
``.npy``) under the dtype name ``bfloat16``, byte for byte the file the
reference writes, so either package restores the other's snapshot.  Each leaf's
sha256 prefix covers its whole ``.npy`` file; it is computed as the file
is written, and leaves are written and checked by a few threads at once
(file I/O and hashing release the interpreter lock).

``restore`` picks the newest *complete* snapshot (half-written ones are
never visible under their final name: the rename is the commit point),
skipping corrupt or torn ones, and puts each leaf on the device and in
the dtype of the ``like`` tree's leaf.

A train state sharded over a mesh (``distributed/tp.py``: each rank's
blocks of the parameters and AdamW moments) is saved whole, as the
reference saves its global arrays: every rank gathers each tree with
``distributed/sharding.py::gather_params`` and one rank writes it; a
restore at any mesh cuts its blocks with ``shard_params``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import tree_leaves, tree_unflatten

_WORKERS = 8
_BLOCK = 1 << 24


class _HashingWriter:
    """A binary file that hashes what is written to it."""

    def __init__(self, f):
        self.f = f
        self.sha = hashlib.sha256()

    def write(self, data) -> int:
        self.sha.update(data)
        return self.f.write(data)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str, str]:
    """A leaf as the array written to its file, its ``.npy`` descr and
    its dtype name."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # the bytes and the header ml_dtypes' bfloat16 gives the reference
        return t.view(torch.int16).numpy(), "<V2", "bfloat16"
    arr = t.numpy()
    return arr, np.lib.format.dtype_to_descr(arr.dtype), str(arr.dtype)


def _write_leaf(directory: str, i: int, leaf) -> Dict[str, Any]:
    """One leaf as an ``.npy`` file (format 1.0, as ``np.save`` writes
    it), hashed as it is written."""
    arr, descr, dtype = _to_numpy(leaf)
    name = f"arr_{i:05d}.npy"
    with open(os.path.join(directory, name), "wb") as f:
        w = _HashingWriter(f)
        np.lib.format.write_array_header_1_0(
            w, {"descr": descr, "fortran_order": False, "shape": arr.shape})
        flat = arr.reshape(-1).view(np.uint8)
        for lo in range(0, flat.size, _BLOCK):
            w.write(flat[lo:lo + _BLOCK].data)
    return {"name": name, "shape": list(arr.shape), "dtype": dtype,
            "sha": w.sha.hexdigest()[:16]}


def _tree_desc(tree) -> str:
    """The tree's structure (the reference stores ``str(treedef)``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_tree_desc(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_tree_desc(v) for v in tree) + "]"
    return "*"


def save(directory: str, step: int, tree: Any,
         extras: Optional[Dict[str, Any]] = None) -> str:
    """Write an atomic snapshot; returns the committed path.  A snapshot
    already committed under this step is kept (the reference writes the
    new one and discards it)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    if os.path.exists(final):
        return final
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    leaves = tree_leaves(tree)
    with ThreadPoolExecutor(_WORKERS) as ex:
        metas = list(ex.map(lambda il: _write_leaf(tmp, *il),
                            enumerate(leaves)))
    manifest = {"step": step, "treedef": _tree_desc(tree),
                "extras": extras or {}, "leaves": metas}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final) if not os.path.exists(final) else shutil.rmtree(tmp)
    return final


def _sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(_BLOCK), b""):
            h.update(block)
    return h.hexdigest()[:16]


def _validate(path: str) -> Optional[Dict]:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    try:
        with open(mf) as f:
            manifest = json.load(f)
        with ThreadPoolExecutor(_WORKERS) as ex:
            shas = list(ex.map(
                lambda leaf: _sha(os.path.join(path, leaf["name"])),
                manifest["leaves"]))
    except (OSError, ValueError, KeyError, TypeError):
        return None
    if shas != [leaf["sha"] for leaf in manifest["leaves"]]:
        return None
    return manifest


def _steps(directory: str):
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and ".tmp" not in d)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _to_tensor(arr: np.ndarray, dtype: str, like: torch.Tensor
               ) -> torch.Tensor:
    if arr.dtype.kind == "V":      # bf16 round-trips as raw 2-byte voids
        if dtype != "bfloat16":
            raise ValueError(f"unknown raw dtype {dtype!r}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore(directory: str, like: Any, *, step: Optional[int] = None
            ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``like`` (each leaf on its device
    and in its dtype).

    Walks snapshots newest-first, skipping corrupt ones (torn writes /
    failed nodes): a restart always finds the newest *consistent* state.
    """
    candidates = [step] if step is not None else _steps(directory)[::-1]
    for s in candidates:
        path = os.path.join(directory, f"step_{s:09d}")
        manifest = _validate(path)
        if manifest is None:
            continue
        leaves = tree_leaves(like)
        if len(manifest["leaves"]) != len(leaves):
            continue
        out = []
        for leaf, meta in zip(leaves, manifest["leaves"]):
            arr = np.load(os.path.join(path, meta["name"]))
            if list(arr.shape) != list(leaf.shape):
                break
            out.append(_to_tensor(arr, meta["dtype"], leaf))
        if len(out) != len(leaves):
            continue
        return tree_unflatten(like, out), s, manifest.get("extras", {})
    raise FileNotFoundError(f"no valid checkpoint in {directory}")


def prune(directory: str, keep: int = 3):
    """Keep the newest ``keep`` snapshots (never the one being written)."""
    if not os.path.isdir(directory):
        return
    steps = sorted((d for d in os.listdir(directory)
                    if d.startswith("step_") and ".tmp" not in d))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
