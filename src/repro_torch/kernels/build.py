"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface, loaded with ctypes: no PyTorch headers, so a build takes
seconds. All sources start compiling together at first use, into
`build/repro_torch_kernels/<hash of the sources>/` under the checkout, so
an edited source never loads a stale library.

Flags: sm_90a, C++17, -O3 and -fmad=false (the quantizers need unfused
IEEE multiply/divide/subtract to match the reference bit for bit; never
--use_fast_math). `-Xptxas -v` reports registers and spills; the output
is kept in `BUILD_LOG`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("qsgd.cu", "terngrad.cu", "sign.cu", "pack.cu", "bits.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: every pointer and the stream as void*, ints (sizes and the
# CUDA device index) as int
SIGNATURES = {
    "qsgd_pack": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "qsgd_unpack": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "terngrad_pack": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "terngrad_unpack": [_P, _P, _P, _I, _I, _I, _I, _P],
    "sign_pack": [_P, _P, _I, _I, _I, _I, _P],
    "sign_unpack": [_P, _P, _I, _I, _I, _I, _P],
    "fields_pack": [_P, _P, _I, _I, _I, _I, _I, _P],
    "fields_unpack": [_P, _P, _I, _I, _I, _I, _I, _P],
    "bits_pack": [_P, _P, _I, _I, _I, _I, _P],
    "bits_unpack": [_P, _P, _I, _I, _I, _I, _P],
    "majority": [_P, _P, _I, _I, _I, _P],
}

#: nvcc output of the last build in this process, by source
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    root = Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch_kernels" / _source_hash()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return found


def build_all() -> float:
    """Compile every missing library, all sources in parallel. Returns the
    wall seconds spent compiling (0.0 when everything was built)."""
    out = build_dir()
    todo = [s for s in SOURCES if not (out / (Path(s).stem + ".so")).exists()]
    if not todo:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for src in todo:
        tmp = out / f"{Path(src).stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    failed = []
    for src, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[src] = log
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out / (Path(src).stem + ".so"))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, building at first use."""
    lib = _LIBS.get(stem)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(build_dir() / f"{stem}.so"))
        for name, argtypes in SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIBS[stem] = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{status}")
