"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, bound with ``ctypes``.  The build runs at the
first launch of any kernel (never at import: a machine without ``nvcc``
must still import the package), one ``nvcc`` process per source, all
started together, then one link.  The library lands in ``build/kernels``
under the repository root, named by a digest of the sources and flags,
so an edited source rebuilds and an unchanged one is reused.

A failed build raises, and so does a launch whose C function returns a
CUDA error: there is no fallback to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", ARCH)

_VP, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)


class GatherSeg(ctypes.Structure):
    """``sac_gather_seg`` (csrc/gather_kv.cu): kv [B, S, row_bytes], idx
    [B, k] int32, out [B, k, row_bytes]; ``shard`` != 0: kv is the slice
    [base, base + S) of a pool, and an index outside it gives zeros."""
    _fields_ = [("kv", _VP), ("idx", _VP), ("out", _VP), ("B", _LL),
                ("S", _LL), ("k", _LL), ("row_bytes", _LL), ("base", _LL),
                ("shard", _LL)]


class WriteSeg(ctypes.Structure):
    """``sac_write_seg`` (csrc/scatter_kv.cu): pool [L, B, S, row_bytes],
    the slice [base, base + S) of S_glob positions; src [L, B,
    row_bytes]."""
    _fields_ = [("pool", _VP), ("src", _VP), ("L", _LL), ("B", _LL),
                ("S", _LL), ("row_bytes", _LL), ("base", _LL),
                ("S_glob", _LL)]


class SpliceSeg(ctypes.Structure):
    """``sac_splice_seg`` (csrc/scatter_kv.cu): pool [L, B, S, row_bytes],
    src [L, n_lanes, src_rows, row_bytes], whose rows [src_row0, src_row0
    + T) go into lanes [lane0, lane0 + n_lanes), rows [offset, offset +
    T); zero_tail zeroes rows [offset + T, S)."""
    _fields_ = [("pool", _VP), ("src", _VP), ("L", _LL), ("B", _LL),
                ("S", _LL), ("lane0", _LL), ("n_lanes", _LL), ("T", _LL),
                ("offset", _LL), ("zero_tail", _LL), ("row_bytes", _LL),
                ("src_rows", _LL), ("src_row0", _LL)]


_SIGNATURES = {
    "sac_gather_kv": [ctypes.POINTER(GatherSeg), _I, _VP],
    "sac_gather_kv_pages": [_VP, _VP, _VP, _LL, _LL, _LL, _VP],
    "sac_scatter_kv": [_VP, _VP, _VP, _LL, _LL, _LL, _LL, _VP],
    "sac_write_rows_at": [ctypes.POINTER(WriteSeg), _I, _VP, _VP],
    "sac_splice_kv": [ctypes.POINTER(SpliceSeg), _I, _VP],
    "sac_indexer_scores": [_VP] * 4 + [_I] * 5 + [_F, _VP],
    "sac_indexer_blocks_per_sm": [_I, _I, _IP, _IP],
    "sac_sparse_attn": [_VP] * 5 + [_I] * 11 + [_LL, _LL, _F, _I, _VP],
    "sac_sparse_attn_gqa": [_VP] * 5 + [_I] * 7 + [_LL, _LL, _F, _I, _VP],
    "sac_sparse_attn_blocks_per_sm": [_I, _I, _I, _IP],
    "sac_sparse_attn_gqa_blocks_per_sm": [_I, _I, _I, _IP],
}

#: the code a C entry returns for a shape its kernel does not take
#: (cudaErrorInvalidValue)
INVALID_VALUE = 1

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (sm_90a)")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source under csrc/ (in parallel) and link them into
    one library; returns its path.  ``verbose`` adds ``-Xptxas -v`` and
    prints the compilers' output (registers, shared memory, spills)."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib_path = BUILD_DIR / f"libsac_kernels_{_digest(sources + headers)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs, failed = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            if verbose and out:
                print(f"[nvcc {src.name}]\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
            objs.append(str(obj))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run([nvcc, *FLAGS, "-shared", *objs, "-o",
                               str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(tmp_lib, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.sac_error_string.argtypes = [ctypes.c_int]
        handle.sac_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    """Raise when a kernel's C function reported a CUDA error."""
    if code != 0:
        msg = lib().sac_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


@functools.lru_cache(maxsize=None)
def card_slots(index: int, entry: str, *shape: int,
               outs: int = 1) -> Tuple[int, ...]:
    """What the C entry ``entry`` reports of its kernel at ``shape`` on
    card ``index``: first the blocks of it the card holds at once (its SMs
    times the blocks one SM holds, which the entry reads from the CUDA
    occupancy calculator at the kernel's registers and shared memory),
    then the ``outs - 1`` further ints the entry writes.  All 0 for a
    shape the kernel does not take."""
    vals = [ctypes.c_int(0) for _ in range(outs)]
    with torch.cuda.device(index):
        rc = getattr(lib(), entry)(*shape, *map(ctypes.byref, vals))
    if rc == INVALID_VALUE:
        return (0,) * outs
    check(rc, entry)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return (sms * vals[0].value,) + tuple(v.value for v in vals[1:])


#: blocks the split plans take on ``meta``, where no card answers the
#: occupancy query: the H100 SXM's 132 SMs at one block each (the plan
#: sizes only a scratch buffer, never a count)
META_SLOTS = 132


def stream() -> int:
    """PyTorch's current CUDA stream, as the pointer the kernels take."""
    return torch.cuda.current_stream().cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device, or every one on ``meta`` (the
    dry-run: the wrapper checks the shapes and makes its outputs, and
    launches nothing), contiguous; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if not (t.is_cuda or t.is_meta) or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device (or on meta), got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def require_dtype(name: str, t: torch.Tensor, dtype: torch.dtype,
                  what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
