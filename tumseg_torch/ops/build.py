"""Build the CUDA kernels of ``tumseg_torch/csrc`` at first use and load them.

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles the sources
to objects in parallel; one more links them into a shared library with a
plain C interface, which ``ctypes`` loads: no PyTorch headers are compiled,
so the build takes seconds. The library lands in ``build/tumseg_torch/`` at the root
of the checkout, named by a hash of the sources and flags, so an edited
kernel is never served from a stale build. Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tumseg_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# launcher name -> argument types; every launcher returns a cudaError_t
SIGNATURES = {
    "tumseg_fps": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tumseg_ball_query": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                          _P),
    "tumseg_ball_query_multi": (_P, _P, _P) + (_I,) * 7 + (_P,),
    "tumseg_group": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "tumseg_three_nn_interpolate": (_P,) * 6 + (_I,) * 7 + (_P,),
    "tumseg_group_backward": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P),
    "tumseg_interpolate_backward": (_P,) * 4 + (_I,) * 8 + (_P,),
    "tumseg_three_nn_window": (_P,) * 6 + (_I,) * 7 + (_P,),
    "tumseg_fused_ball_group": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F)
    + (_I,) * 6 + (_P,),
}

_lock = threading.Lock()
_library = None
build_seconds = None  # wall time of the build that loaded the library


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the tumseg_torch CUDA kernels "
                           "need the CUDA toolkit (set CUDA_HOME)")
    return found


def _build() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"libtumseg_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    objdir = BUILD_DIR / f"obj_{digest.hexdigest()[:16]}_{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(objdir / f"{src.stem}.o"),
               str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    failed = []
    for cmd, proc in jobs:  # wait for every compile, then report them all
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *(str(objdir / f"{src.stem}.o") for src in sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _library, build_seconds
    with _lock:
        if _library is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            build_seconds = time.perf_counter() - t0
            _library = lib
    return _library
