"""Build and load the port's CUDA kernels (route (b): nvcc by hand into one
shared library with a plain C interface, loaded with ctypes).

The library is built at first use from `csrc/*.cu`, one nvcc process per
source started together, into `_build/` beside this file (listed in
.gitignore). Its name carries a hash of the sources, so an edited source
is rebuilt and a matching library is reused. Nothing is built or imported
when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ["-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signature of each kernel entry point (all return cudaGetLastError())
SIGNATURES = {
    "repro_szudzik_pair": [_P, _P, _P, _LL, _P],
    "repro_szudzik_unpair": [_P, _P, _P, _LL, _P],
    "repro_delta_decode": [_P, _P, _P, _P, _P, _P, _LL, _P],
    "repro_find_next_packed": [_P, _P, _P, _P, _P, _P, _P, _P, _LL,
                               ctypes.c_int, _P],
    "repro_intersect_next": [_P, _P, _P, _P, _P, _F, _F, _P, _P, _LL,
                             ctypes.c_int, _P],
    "repro_fused_rewalk_step": [_P, _P, _P, _P, _P, _LL, ctypes.c_int,
                                _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, _F, _F, _P, _P, _LL, _P],
    "repro_sgns_step": [_P, _P, _P, _P, _P, _P, _P, _LL, ctypes.c_int,
                        ctypes.c_int, _P],
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    found = shutil.which("nvcc")
    cand += [Path(found)] if found else []
    for c in cand:
        if c.exists():
            return str(c)
    raise RuntimeError("repro_torch kernels: nvcc not found (CUDA_HOME unset "
                       "and no nvcc on PATH)")


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel, link one .so; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (f.stem + ".o") for f in cu]
        procs = [subprocess.Popen(
            [nvcc, *FLAGS, "-c", str(f), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for f, o in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        for f, p, log in zip(cu, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {f.name}:\n{log}")
        tmp_so = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", ARCH, *map(str, objs),
                               "-o", str(tmp_so)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)   # atomic: a concurrent build never sees half a file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
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
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
