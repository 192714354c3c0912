"""Build and load the port's CUDA kernels.

The kernel sources (``kernels/*/csrc/*.cu``) have plain C entry points.
At first use on a CUDA device they are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, then
linked into ``build/kernels/libreprotorch.so`` at the repository root and
loaded with ``ctypes``.  A content hash of the sources and flags decides
whether a library already built is current.  Nothing is compiled when a
module is imported, and a build or load failure raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

KERNELS = Path(__file__).resolve().parent
ROOT = KERNELS.parents[2]
BUILD_DIR = ROOT / "build" / "kernels"
LIB_NAME = "libreprotorch.so"
SOURCES = (
    KERNELS / "flash_attention" / "csrc" / "flash_attention.cu",
    KERNELS / "decode_attention" / "csrc" / "decode_attention.cu",
    KERNELS / "moe_gmm" / "csrc" / "moe_gmm.cu",
)
HEADERS = (KERNELS / "csrc" / "tile_attention.cuh",)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                 "-I", str(KERNELS / "csrc")]

#: dtype codes of the C entry points (``rt::DType`` in tile_attention.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 3}

# ctypes argument codes: P pointer / stream, L int64 stride, I int
_CTYPE = {"P": ctypes.c_void_p, "L": ctypes.c_int64, "I": ctypes.c_int}

_lib: Optional[ctypes.CDLL] = None   # the process's loaded library
_bound: Dict[str, object] = {}
build_seconds: Optional[float] = None  # wall time of this process's build


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then PATH, then /usr/local/cuda."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha1(" ".join(CFLAGS).encode())
    for path in SOURCES + HEADERS:
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the sources into ``build/kernels/libreprotorch.so`` unless a
    library built from the same sources and flags is already there.
    ``nvcc``'s ptxas report (registers, shared memory, spills) is kept in
    ``build/kernels/ptxas.log``.  Raises on any compiler failure."""
    global build_seconds
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "libreprotorch.sha1"
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    exe = nvcc()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [exe, *CFLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [exe, *ARCH, "-shared", "-o", str(tmp),
         *(str(BUILD_DIR / (s.stem + ".o")) for s in SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    build_seconds = time.monotonic() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def kernel(name: str, signature: str):
    """C entry point ``name`` with ctypes argument types from
    ``signature`` (one letter per argument, spaces ignored: P pointer or
    stream, L int64, I int) and an int return code."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = [_CTYPE[c] for c in signature.replace(" ", "")]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def check(rc: int, name: str):
    """Raise when a launch returned a CUDA error code."""
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
