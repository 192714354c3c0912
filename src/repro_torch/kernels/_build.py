"""Build and load the port's CUDA kernels; count their launches.

The kernel sources (``kernels/*/csrc/*.cu``) have plain C entry points.
At first use on a CUDA device they are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, then
linked into ``build/kernels/libreprotorch.so`` at the repository root and
loaded with ``ctypes``.  A content hash of the sources and flags decides
whether a library already built is current.  Nothing is compiled when a
module is imported, and a build or load failure raises.  Binding the
library sets up every kernel instantiation once for the process (each
source's ``rt_prepare_*`` entry: its module loaded, its shared-memory
limit raised to the device's opt-in maximum), so no launch, and no CUDA
graph capture, meets a first-use setup; a second card is set up at its
first launch (mesh positions on distinct cards run eagerly).

Each wrapper counts its launches in attributes of its own (``launches``,
and on some ``launches_tc`` or ``launches_by_capacity``, a dict by
capacity) and registers them here with :func:`count_launches`.  A CUDA
graph replay launches its kernels without running a wrapper, so a step's
graph (``serve/step_graph.py``) reads the registry before and after its
capture, puts the counts back, and adds the difference on each replay.

A tensor on a device of :data:`PLAIN_DEVICES` takes each kernel's plain
version: the CPU's, and ``meta``'s (a dry run traces shapes, and no
kernel launches); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

KERNELS = Path(__file__).resolve().parent
ROOT = KERNELS.parents[2]
BUILD_DIR = ROOT / "build" / "kernels"
LIB_NAME = "libreprotorch.so"
SOURCES = (
    KERNELS / "flash_attention" / "csrc" / "flash_attention.cu",
    KERNELS / "flash_attention" / "csrc" / "flash_attention_bwd.cu",
    KERNELS / "decode_attention" / "csrc" / "decode_attention.cu",
    KERNELS / "moe_gmm" / "csrc" / "moe_gmm.cu",
    KERNELS / "ssd_scan" / "csrc" / "ssd_scan.cu",
    KERNELS / "ssd_scan" / "csrc" / "ssd_scan_bwd.cu",
)
HEADERS = (KERNELS / "csrc" / "tile_attention.cuh",
           KERNELS / "csrc" / "tensor_core.cuh",
           KERNELS / "csrc" / "hopper.cuh")
#: each source's once-per-process setup entry (``prepare_kernels``)
PREPARE = ("rt_prepare_flash", "rt_prepare_flash_bwd", "rt_prepare_decode",
           "rt_prepare_gmm", "rt_prepare_ssd", "rt_prepare_ssd_bwd")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                 "-I", str(KERNELS / "csrc")]

#: the device types whose tensors take the kernels' plain versions
PLAIN_DEVICES = ("cpu", "meta")

#: dtype codes of the C entry points (``rt::DType`` in tile_attention.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 3}

# ctypes argument codes: P pointer / stream, L int64 stride, I int
_CTYPE = {"P": ctypes.c_void_p, "L": ctypes.c_int64, "I": ctypes.c_int}

_lib: Optional[ctypes.CDLL] = None   # the process's loaded library
_prepared: set = set()               # device indices the library set up
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
    """The loaded kernel library, built at first call and set up for the
    current device (``PREPARE``)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _prepare(lib)
        _lib = lib
    return _lib


def _prepare(lib: ctypes.CDLL):
    """Run every source's setup entry on the current device (its modules
    and shared-memory limits are the device's own)."""
    for name in PREPARE:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        check(fn(), name)
    _prepared.add(torch.cuda.current_device())


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
    """The current stream of ``device``, which must be the current device
    (a launch goes to the current device's context); the library is set
    up on it at its first launch there.  While one card has had launches,
    nothing is checked (the one-card path pays nothing)."""
    if len(_prepared) > 1 or device.index not in _prepared:
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        if index != torch.cuda.current_device():
            raise RuntimeError(f"a kernel for cuda:{index} launched while "
                               f"cuda:{torch.cuda.current_device()} is "
                               "current")
        if index not in _prepared:
            _prepare(library())
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# -- launch counters -------------------------------------------------------
#: (wrapper, counter attribute names) of every wrapper that launches a kernel
COUNTED: list = []

Counts = Dict[Tuple[object, str], object]


def count_launches(fn, *names: str):
    """Register the launch counters ``names`` of wrapper ``fn``: ints, or
    dicts of ints (``launches_by_capacity``)."""
    COUNTED.append((fn, names))


def launch_counts() -> Counts:
    """Every registered counter's value (a copy of a dict counter)."""
    out = {}
    for fn, names in COUNTED:
        for name in names:
            v = getattr(fn, name)
            out[fn, name] = dict(v) if isinstance(v, dict) else v
    return out


def set_launch_counts(counts: Counts):
    """Put the registered counters back to ``counts``; a dict counter
    keeps its identity."""
    for (fn, name), v in counts.items():
        if isinstance(v, dict):
            d = getattr(fn, name)
            d.clear()
            d.update(v)
        else:
            setattr(fn, name, v)


def launch_delta(before: Counts, after: Counts) -> Counts:
    """What each counter gained from ``before`` to ``after`` (the nonzero
    entries only; a dict counter by key)."""
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            d = {c: n - before[k].get(c, 0) for c, n in v.items()}
            d = {c: n for c, n in d.items() if n}
            if d:
                out[k] = d
        elif v != before[k]:
            out[k] = v - before[k]
    return out


def add_launch_counts(delta: Counts):
    """Add ``delta`` (from :func:`launch_delta`) to the counters."""
    for (fn, name), v in delta.items():
        if isinstance(v, dict):
            d = getattr(fn, name)
            for c, n in v.items():
                d[c] = d.get(c, 0) + n
        else:
            setattr(fn, name, getattr(fn, name) + v)
