"""Build the port's CUDA kernels from the repo's sources at first use.

Each `ops/csrc/*.cu` file is compiled by `nvcc` into a shared library with a
plain C interface under `deeplearning4j_tpu_torch/_build/` (listed in
.gitignore) and loaded with ctypes. The library name carries a hash of the
source, of every `csrc/*.cuh` header and of the flags, so an edited source
or header rebuilds and an unchanged one is reused. Several sources build in parallel (`build`: one nvcc per source,
all started together). A failed build raises with the compiler's output.

Only the machine with the card has nvcc; nothing here runs on import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "deeplearning4j_tpu_torch build on a machine with "
                           "the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    """Where the library built from `source` (a file name in csrc/) lives:
    named by a hash of the source, the headers beside it and the flags."""
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"


def build(sources: Sequence[str]) -> Dict[str, dict]:
    """Compile every source not yet built, one nvcc process each, all
    started together. Returns {source: {"path", "seconds", "log"}} (the
    compiler's output, kept beside the library); raises RuntimeError when
    any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[source] = {"path": str(lib), "seconds": 0.0,
                           "log": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs.append((source, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for source, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
        out[source] = {"path": str(lib),
                       "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(source: str) -> ctypes.CDLL:
    """The ctypes handle of `source`'s library, building it on first use."""
    lib = _LOADED.get(source)
    if lib is None:
        lib = ctypes.CDLL(build([source])[source]["path"])
        _LOADED[source] = lib
    return lib
