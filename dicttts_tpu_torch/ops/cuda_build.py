"""Build the port's CUDA kernels with plain ``nvcc`` and bind them with ctypes.

The sources in ``dicttts_tpu_torch/csrc/`` have a plain ``extern "C"``
interface and include no PyTorch header, so each compiles in seconds. At
first use every source is compiled to an object file by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library under ``dicttts_tpu_torch/_build/`` (listed in ``.gitignore``). The
library's name carries a hash of the sources and flags, so an edited source
is rebuilt; the library is written under a temporary name and renamed into
place, so no lock file is ever left behind.

Nothing here runs at import time: ``library()`` builds on first call, which
the kernel wrappers make only for CUDA tensors.
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

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("s2pa_bank_fwd.cu", "s2pa_bank_bwd.cu", "s2pa_fused.cu")
HEADERS = ("s2pa_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of the C entry points (the kernels return a cudaError_t
# as int; s2pa_bank_plan and s2pa_fused_plan 1 or 0; s2pa_bank_chunks nothing)
SIGNATURES = {
    "s2pa_bank_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "s2pa_bank_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "s2pa_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "s2pa_bank_plan": [_I, _I, _I, _P, _P],
    "s2pa_bank_chunks": [_P, _I, _P],
    "s2pa_fused_plan": [_I, _I, _I, _I, _P, _P],
}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdicttts_kernels_{source_digest()}.so"


def build() -> tuple[Path, str]:
    """Compile and link the kernels if the library for these sources is
    missing. Returns (library path, compiler log; empty if it existed)."""
    so = library_path()
    if so.exists():
        return so, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", str(CSRC_DIR / name), "-o", obj]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, proc in procs:
            out, _ = proc.communicate()
            log.append(f"[{name}]\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_so],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"[link]\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        os.replace(tmp_so, so)
    return so, "\n".join(log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process, with argtypes set."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None if name == "s2pa_bank_chunks" else ctypes.c_int
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a C entry point reported a launch error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
