"""Build and load the CUDA kernels of ``tfhe_tpu_torch/csrc``.

``nvcc`` compiles the sources into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), under
``build/tfhe_tpu_torch/``, at first use. The file name carries a hash of the
sources and flags, so an edit rebuilds and concurrent builders never clash:
each writes a temporary file and renames it into place. ``ctypes`` loads the
library; every entry point returns ``cudaGetLastError()`` after its launches
and :func:`check` raises on a nonzero code.

Nothing here runs at import: the CPU-only test runs import every module.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tfhe_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtfhe_cuda-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists.

    One ``nvcc -c`` per source, all started together, then one link. The
    compilers' report (registers, shared memory, spills) is kept beside the
    library as ``<library>.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    cus = [s for s in _sources() if s.endswith(".cu")]
    try:
        objs = [os.path.join(work, os.path.basename(s) + ".o") for s in cus]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cus, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(cus, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"({p.returncode}):\n{log[-8000:]}")
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-8000:]}")
        with open(so + ".log", "w") as f:
            f.write("".join(logs) + link.stdout + link.stderr)
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def build_log() -> str:
    """The compiler's report for the current library ('' if not built here)."""
    log = library_path() + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.tfhe_cmux_delta.argtypes = [P, P, P, P, P, I, I, I, P]
    lib.tfhe_blind_rotate.argtypes = [P, P, P, P, P, I, I, I, I, U, P]
    lib.tfhe_blind_rotate_ks.argtypes = [P, P, P, P, P, P, P, P,
                                         I, I, I, I, U, I, I, I, U, P]
    lib.tfhe_blind_rotate_small.argtypes = lib.tfhe_blind_rotate.argtypes
    lib.tfhe_blind_rotate_small_ks.argtypes = lib.tfhe_blind_rotate_ks.argtypes
    for fn in (lib.tfhe_cmux_delta, lib.tfhe_blind_rotate, lib.tfhe_blind_rotate_ks,
               lib.tfhe_blind_rotate_small, lib.tfhe_blind_rotate_small_ks):
        fn.restype = ctypes.c_int
    lib.tfhe_error_string.argtypes = [I]
    lib.tfhe_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().tfhe_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {err} ({msg})")
