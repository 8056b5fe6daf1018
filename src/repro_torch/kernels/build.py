"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc
into its own shared library ``build/repro_torch/lib<name>.so`` under the
repository root (``build/`` is git-ignored), then loaded with ctypes. The
build runs at first use, from the sources alone, and again whenever a
source, or a header under ``csrc/`` that the sources share, is newer than
its library. ``build_all`` starts one nvcc per stale
source at once, so a fresh checkout builds in the time of the slowest
file. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("paged_decode_attention", "flash_prefill", "decode_attention",
           "ssd_scan", "ssd_decode", "moe_grouped_ffn")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_log(name: str) -> Path:
    """nvcc's output of the last build of ``name`` (ptxas register and
    shared-memory report included)."""
    return BUILD_DIR / f"lib{name}.log"


def _stale(name: str) -> bool:
    """No library, or one older than its source or than any header under
    csrc/ (the sources share them)."""
    lib = library(name)
    if not lib.is_file():
        return True
    inputs = [source(name), *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build_all(names: Optional[Iterable[str]] = None,
              force: bool = False) -> Dict[str, float]:
    """Compile every stale kernel library, one nvcc process per source,
    all started together. Returns {name: seconds} for the sources built;
    raises RuntimeError with nvcc's output if any build fails."""
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library(n).with_suffix(f".so.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(source(n))]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    took, failed = {}, []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        took[n] = time.perf_counter() - t0
        build_log(n).write_text(log)
        if p.returncode != 0:
            failed.append(f"{n} (nvcc exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library(n))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if name not in KERNELS:
            raise KeyError(f"unknown kernel {name!r}; known: {KERNELS}")
        build_all([name])
        lib = ctypes.CDLL(str(library(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
