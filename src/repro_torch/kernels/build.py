"""Build and load the CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. The
libraries go to ``kernels/build/`` (listed in ``.gitignore``) under a name
that carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt and a built one is
reused. ``build()`` starts one ``nvcc`` per missing
source, all at once; ``library(name)`` builds on first use. ``defines``
(``-D`` macros) build a variant beside the default library, for timing
variants of a kernel (``tools/core_variants.py``). Nothing here runs when
the module is imported.
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
from typing import Dict, Iterable, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("gar_matmul", "lowrank_matmul", "paged_attention", "sampling",
           "ssd", "wkv6")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()
# name (and -D macros) -> (seconds, ptxas report) of the builds this
# process ran
build_log: Dict[str, Tuple[float, str]] = {}


def nvcc() -> str:
    """The CUDA compiler: on PATH, or in the toolkit's default prefix."""
    found = shutil.which("nvcc") or shutil.which(
        "nvcc", path="/usr/local/cuda/bin")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def flags(defines: Sequence[str] = ()) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def target(name: str, defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES,
          defines: Sequence[str] = ()) -> Dict[str, float]:
    """Compile every named source whose library is missing, in parallel.
    Returns seconds per source built (0.0 for one already built)."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, float] = {}
    for name in names:
        dst = target(name, defines)
        if dst.exists():
            out[name] = 0.0
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst, time.perf_counter())
    failed = []
    for name, (proc, tmp, dst, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, dst)
        out[name] = secs
        build_log[" ".join((name, *flags(defines)[len(NVCC_FLAGS):]))] = (
            secs, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def library(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = target(name, defines)
            if not path.exists():
                build([name], defines)
            lib = ctypes.CDLL(str(path))
            _libs[key] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
