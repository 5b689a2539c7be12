"""Device resolution and the CUDA kernel library.

Counterpart of ``repro/utils.py::pallas_interpret_default``, without its
override variable. Two rules hold everywhere in the port:

  * entry points take ``device=None``, which means the CUDA card; with no
    card present they raise instead of running somewhere else. The CPU is
    used only when the caller asks for it (``device="cpu"``, as the tests
    do);
  * a kernel wrapper decides by the device of the tensors it is handed: a
    CPU tensor goes to the kernel's plain PyTorch version, a CUDA tensor
    goes to the kernel or the wrapper raises. Nothing falls back.

The kernels are CUDA C++ for ``sm_90a`` under ``kernels/csrc/``. They are
compiled at first use on the machine with the card: one ``nvcc`` per
source, all started together, then one link into a shared library with a
plain C interface that is loaded with ``ctypes``. The library lands in
``build/`` beside this file (ignored by git), named by a hash of the
sources and flags so a changed source rebuilds and an unchanged one loads
the existing library. Nothing here runs at import time: this module
imports on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "kernels" / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# shared memory one block may use on the H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# C signature of every entry point in csrc/ (all return cudaError_t as int)
_SIGNATURES = {
    # table, term ids, term weights, term counts, q_pad, scale, out,
    # S, Q, V, queries a block, rows a block, row buffer bytes, stream
    "segment_bound_gemm": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P],
    # keep, idx, count, rows, n, stream
    "compact_front": [_P, _P, _P, _I, _I, _P],
    # tids, tid_bytes, tw, bitmap, prefix, term_ptr, ent_q, ent_w,
    # n_words, max entries, tile_cids, tile_pos, n_tiles, qblock, n_qblock,
    # dblock, n_dblock, admit, seg_admit, n_seg, doc_seg_mod, doc_mask,
    # scale, out, n_q, G, n_qb, n_db, d_pad, t_pad, block_q, block_d,
    # docs a chunk, stream
    "score_queue": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                    _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # tids, tid_bytes, tw, qmap, scale, out, D, T, V + 1, stream
    "score_docs": [_P, _I, _P, _P, _P, _P, _I64, _I, _I, _P],
    # tids, tid_bytes, tw, doc_seg_mod, doc_mask, cids, cid_bytes,
    # seg_admit, n_seg, query tids, query tw, query count, scale, out, G,
    # d_pad, t_pad, bitmap words, q_pad, stream
    "score_clusters": [_P, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
                       _P, _I, _I, _I, _I, _I, _P],
    # cids, live, admit, seg_admit, doc_seg_mod, doc_mask, seg_offsets,
    # its row width, sorted_upto, scratch, then the outputs tile_cids,
    # tile_pos, n_tiles, qblock, n_qblock, n_blocks, drun_start, drun_len,
    # n_drun, dblock, n_dblock, dmask_union; n_q, G, n_seg, d_pad,
    # block_q, n_qb, block_d, n_db, run slots, batch scope, stream
    "plan_wave": [_P] * 7 + [_I] + [_P] * 14 + [_I] * 10 + [_P],
    # scores, theta, its stride, top scores, top ids, ids_flat, out scores,
    # out ids, workspace, n_q, L, k, blocks a row, workspace keys a block,
    # 16-byte loads, stream
    "merge_topk": [_P, _P, _I64] + [_P] * 6 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def check_on(tensor: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless ``tensor`` lives on ``device`` (index placement is the
    caller's decision, never silently copied)."""
    if tensor.device.type != device.type:
        raise ValueError(f"{what} lives on {tensor.device}, but the call "
                         f"runs on {device}; build or convert it with "
                         f"device={device.type!r}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "kernels/csrc/ on first use and need the CUDA toolkit")


def _digest() -> str:
    """Hash of every source and header under csrc/ and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` (one nvcc each, in parallel) and link them into
    one shared library; returns its path. Reuses a library built from the
    same sources and flags."""
    sources = sorted(CSRC.glob("*.cu"))
    lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = {}
        for src, proc in procs:
            out, _ = proc.communicate()
            logs[src.name] = out
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    build_info.update(
        path=str(lib_path), seconds=time.perf_counter() - t0, cached=False,
        ptxas=[line.strip() for log in logs.values()
               for line in log.splitlines()
               if "registers" in line or "spill" in line
               or "Compiling entry" in line])
    return lib_path


def kernel_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernels()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a CUDA
    error (a refused launch never runs, and a later synchronize would not
    report it)."""
    lib = kernel_lib()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({rc})")


def require(tensor: torch.Tensor, name: str, dtypes: tuple,
            shape: tuple | None = None) -> None:
    """Kernel-input check: CUDA, one of ``dtypes``, contiguous, and
    (optionally) an exact shape."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {tensor.device}")
    if tensor.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(tensor.shape)}")
