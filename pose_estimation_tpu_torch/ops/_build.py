"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source in csrc/ for sm_90a, one process per source
started together, and links the objects into one shared library with a
plain C interface; ctypes loads it. The library goes to
<checkout>/build/kernels/<hash of the sources and flags>/, so an edit to a
source triggers a rebuild and a stale build is never loaded. Nothing is
built when this module is imported: only `library()` builds, and only the
wrappers in ops.pointops / ops.gcn / ops.resize / ops.optim call it, for CUDA
tensors.
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

import torch

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_lib = None
build_seconds: float | None = None     # wall time of this process's build
build_log: str = ""                    # nvcc's output (-Xptxas -v report)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "pose_knn": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pose_min_dists": [_P] * 5 + [_I] * 5 + [_P, _P, _I, _I, _F, _P],
    "pose_gcn_surface": [_P] * 8 + [_I, _P, _L, _I, _I, _I, _I, _P],
    "pose_gcn_linear": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P],
    "pose_gcn_aggregate": [_P, _P, _P, _I, _P, _L, _L, _P, _I, _I, _I, _I,
                           _I, _I, _I, _P],
    "pose_resize_bilinear": [_P, _P, _L] + [_I] * 9 + [_P],
    "pose_ranger_apply": [_P] * 7 + [_I] * 5 + [_F, _I] + [_F] * 8
                         + [_I, _F, _F, _F, _I, _F, _P],
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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or raise if any
    failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    if any(p.returncode for p in procs):
        raise RuntimeError("nvcc failed:\n" + log)
    return log


def _compile(tmp: Path, so: Path) -> str:
    """One nvcc per source, all started together, then one link; the .so
    is moved into place only once it is whole."""
    nvcc = _nvcc()
    objs, cmds = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = tmp / (src.stem + ".o")
        objs.append(str(obj))
        cmds.append([nvcc] + ARCH_FLAGS + NVCC_FLAGS
                    + ["-c", str(src), "-o", str(obj)])
    log = _run_all(cmds)
    log += _run_all([[nvcc] + ARCH_FLAGS + ["-shared", "-o",
                                            str(tmp / so.name)] + objs])
    os.replace(tmp / so.name, so)
    return log


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
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            build_log = _compile(Path(tmp), so)
        (out_dir / "build.log").write_text(build_log)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def launch(fn, dev: torch.device, *args) -> int:
    """fn(*args, stream): a kernel entry called on `dev`'s current stream,
    with `dev` the current device for the call; returns its code. The raw
    stream query builds no Python object, unlike torch.cuda.device() and
    current_stream(), whose cost is a large share of a small kernel's
    call, so the context is entered only when `dev` is not current."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def check(rc: int, name: str) -> None:
    """Raise on a refused configuration (-1) or a CUDA launch error."""
    if rc == -1:
        raise ValueError(f"{name}: configuration not supported by the kernel")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
