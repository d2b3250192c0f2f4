"""Build and load the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; all
sources compile in parallel, one ``nvcc`` each, at first use.  Libraries
land in ``build/repro_torch_kernels/<hash>/`` at the repository root,
keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the last build.

``--use_fast_math`` is deliberately absent: ``quant_bitflip`` needs the
IEEE division and subnormals (its scale floor ``FLT_MIN / qmax`` is
subnormal).  A missing ``nvcc`` or a failed build raises; there is no
fallback.
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

__all__ = ["CSRC", "BUILD_ROOT", "SOURCES", "NVCC_FLAGS", "library",
           "build_all"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("bitflip", "quant_bitflip", "fault_matmul", "glue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels of repro_torch cannot be built")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every kernel library not yet built (in parallel) and load
    them all.  Returns where they were built, which were compiled in this
    process, the build's wall seconds and nvcc's ``-Xptxas -v`` output."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _info
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = {}
        for name in SOURCES:
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, lib)
        logs, failed = {}, []
        for name, (proc, tmp, lib) in procs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        _info.update(dir=str(out_dir), built=sorted(procs),
                     seconds=time.perf_counter() - t0, ptxas=logs)
        return _info


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building on first use."""
    if name not in _libs:
        build_all()
    return _libs[name]
