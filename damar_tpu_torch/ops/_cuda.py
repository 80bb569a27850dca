"""Build and load the port's CUDA kernels (damar_tpu_torch/csrc/*.cu).

The sources are compiled by hand with nvcc, one process per source, all
started together, then linked into one shared library with a plain C
interface and loaded through ctypes: no PyTorch headers, so a build
takes seconds.  The library lands in damar_tpu_torch/_build/ under a
name that carries a hash of the sources and flags, and is built at first
use (never at import: the CPU tests import every module).  ptxas reports
each kernel's registers, spills and shared memory; `build_log` keeps
those lines of the last build.

Each C entry point takes device pointers and the CUDA stream as void
pointers, launches on that stream, and returns cudaGetLastError(); the
wrapper raises when it is not 0 (a refused launch never runs, and a
later synchronize would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
# C entry point -> argument types (the return type is int everywhere)
SIGNATURES = {
    "bp_extend_launch": [P, I, P, I, P, P, P, P, P, P, I, I, I, I, I,
                         P, P, P, P, P, P],
    "bp_trace_launch": [P, I, P, I, P, P, P, P, P, P, I, I, I,
                        P, P, P, P, P],
    "wide_trace_launch": [P, I, P, I, P, P, P, P, P, P, I, I, I,
                          P, P, P, P, P],
    "dp_rows_launch": [P, P, I, P, I, P, P, P, P, P, P,
                       P, P, P, P,
                       P, P, P, P, P, P, P,
                       I, I, I, I, I, I, I, P],
    "band_align_launch": [P, P, P, P, P, P, P, P, I, I, I, I, I,
                          P, P, P, P, P],
    "revcomp_launch": [P, P, P, P, L, L, P],
}

_lock = threading.Lock()
_lib = None
last_build_seconds: float | None = None
build_log: list[str] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdamar_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with the output of the first
    that fails; return each one's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{so}\n{se}")
    return [se for _, se in outs]


def build() -> Path:
    """Compile csrc/*.cu into the hashed shared library (if absent)."""
    global last_build_seconds, build_log
    import time
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in _sources()]
    t0 = time.time()
    logs = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                     for s, o in zip(_sources(), objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[_nvcc(), *ARCH, "-shared", "-o", str(tmp),
               *[str(o) for o in objs]]])
    os.replace(tmp, out)
    for o in objs:
        o.unlink()
    last_build_seconds = time.time() - t0
    build_log = [ln.strip() for log in logs for ln in log.splitlines()
                 if "ptxas info" in ln or "bytes stack frame" in ln]
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: error {err}")


def count_launch(wrapper, items: int) -> None:
    """Add one to wrapper.launches for a launch over `items` work items
    (none: the C side launched nothing).  Under the lock: the sweep's
    emit thread launches the trace kernels while the caller's thread
    launches the extension."""
    if items > 0:
        with _lock:
            wrapper.launches += 1


def stream_ptr(t) -> int:
    """The current stream of t's card, for a launch.  The C side
    launches on the host thread's current device, so a tensor on
    another card raises (torch.cuda.set_device chooses the card)."""
    import torch
    if t.device.index != torch.cuda.current_device():
        raise RuntimeError(
            f"a kernel launch on {t.device} while cuda:"
            f"{torch.cuda.current_device()} is current: call "
            f"torch.cuda.set_device({t.device.index}) first")
    return torch.cuda.current_stream(t.device).cuda_stream
