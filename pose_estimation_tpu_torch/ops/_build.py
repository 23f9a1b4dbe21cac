"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source in csrc/ into one shared library with a plain
C interface for sm_90a; ctypes loads it. The library goes to
<checkout>/build/kernels/<hash of the sources and flags>/, so an edit to a
source triggers a rebuild and a stale build is never loaded. Nothing is
built when this module is imported: only `library()` builds, and only the
wrappers in ops.pointops / ops.gcn call it, for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

_lib = None
build_seconds: float | None = None     # wall time of this process's build
build_log: str = ""                    # nvcc's output (-Xptxas -v report)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "pose_knn": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pose_gcn_surface": [_P, _P, _P, _L, _I, _I, _I, _I, _P],
    "pose_gcn_linear": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(p for p in SRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    build yet."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / "libpose_kernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = ([_nvcc()] + ARCH_FLAGS + NVCC_FLAGS + ["-o", tmp]
               + [str(p) for p in _sources() if p.suffix == ".cu"])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        (out_dir / "build.log").write_text(build_log)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               + build_log)
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a refused configuration (-1) or a CUDA launch error."""
    if rc == -1:
        raise ValueError(f"{name}: configuration not supported by the kernel")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
