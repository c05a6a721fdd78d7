"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together) and linked into one
shared library with a plain C interface, loaded through ``ctypes``.  The
library lands in ``build/repro_torch_kernels/`` at the repository root,
named by a hash of the sources, so a changed source rebuilds and an
unchanged one loads in milliseconds.  Nothing is built at import time:
:func:`library` builds at the first kernel launch.

Each C entry point takes device pointers and the CUDA stream as
``void*`` (``ctypes.c_void_p``), launches on that stream, and returns
``cudaGetLastError()``; the Python wrappers raise when it is not 0.

The wrappers count their launches in :data:`LAUNCHES` (kernel name ->
launches since the last :func:`reset_launches`), so a caller can show
that a run really went through the kernels.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
#: C signature of every entry point: name -> argtypes (restype is int)
SIGNATURES = {
    "searchsorted_segments_launch": (
        _P, _I64, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64,
        ctypes.c_int, _P, _P, _P),
    "bitset_member_mask_launch": (
        _P, _I64, _I64, _P, _P, _I64, _I64, _P, _P),
    "bitset_member_count_launch": (
        _P, _I64, _P, _I64, _I64, _P, _P, _P),
}

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"searchsorted_segments": 0, "bitset_member_mask": 0,
            "bitset_member_count": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build did: seconds, library path, nvcc's -Xptxas -v output
build_info: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return path


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path.  A library already built from the same sources is
    reused."""
    srcs = sources()
    target = BUILD_DIR / f"librepro_torch_kernels_{_digest(srcs)}.so"
    if target.exists():
        build_info.update(seconds=0.0, path=str(target), ptxas="(cached)")
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            logs = list(pool.map(
                _run, [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(s),
                        "-o", str(o)] for s, o in zip(srcs, objs)]))
        tmp_lib = Path(tmp) / target.name
        _run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
              *map(str, objs)])
        os.replace(tmp_lib, target)
    build_info.update(seconds=time.perf_counter() - t0, path=str(target),
                      ptxas="".join(logs))
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
