"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``bachelors_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` per source and all started together,
then linked into ONE shared library with a plain C interface, loaded with
``ctypes``.  The build happens at first use, never at import,
and lands in ``bachelors_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources, the headers and the flags, so a changed source rebuilds and an
unchanged one loads in milliseconds.  No PyTorch headers are compiled: the
library takes raw device pointers and a stream, which keeps the build to
seconds.  ``--use_fast_math`` is deliberately absent: the physics needs the
accurate ``atan2f``/``cosf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libbt_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return nvcc


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this exact source set has not been; returns
    the library's path.  The compiler's output, including ``-Xptxas -v``'s
    registers and shared memory per kernel, is kept in ``build.log`` beside
    it."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    out_dir = BUILD_DIR / _source_hash(sources + headers)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    cmds.append([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)])
    log = []
    for batch in (cmds[:-1], cmds[-1:]):  # the sources together, then the link
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in batch]
        outs = [proc.communicate()[0] for proc in procs]
        log += [" ".join(cmd) + "\n" + out for cmd, out in zip(batch, outs)]
        (out_dir / "build.log").write_text("\n".join(log))
        for cmd, proc, out in zip(batch, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    for obj in objs:
        obj.unlink()
    return lib


def build_log() -> str:
    """The compiler output of the current library's build ('' if it was
    built by an earlier process that kept no log)."""
    log = build().parent / "build.log"
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """The kernels' library, built first if needed (once per process)."""
    global _LOADED
    if _LOADED is None:
        _LOADED = ctypes.CDLL(str(build()))
    return _LOADED
