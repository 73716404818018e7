"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together), linked into one shared library with a
plain C interface, and cached under ``build/repro_torch/<hash>/`` at the
root of the checkout, keyed by a hash of the sources and flags.  Nothing
here runs at import time: the CPU tests import every module of the port
on machines without ``nvcc``.

A failed build raises with ``nvcc``'s output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Build", "build", "library", "SOURCES", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

SOURCES = ("decode_attention.cu", "rmsnorm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Build:
    """Where the library is and what ``ptxas`` reported for it."""

    path: str
    cached: bool
    ptxas: tuple[str, ...]  # register / shared-memory / spill lines


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source on the machine with the card")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _ptxas_lines(log: str) -> tuple[str, ...]:
    """One line per kernel instance: its (mangled, shortened) name, then
    ``ptxas``'s register / shared-memory and spill figures."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            short = re.search(r"\d+([a-z][a-z_]*_kernel)(I\w*?)(?:EEEv|$)",
                              m.group(1))
            name = short.group(1) + short.group(2) if short else m.group(1)
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return tuple(out)


@functools.cache
def build() -> Build:
    """Compile (or find cached) ``libkernels.so``; raise on any failure."""
    out_dir = _BUILD_ROOT / _key()
    lib = out_dir / "libkernels.so"
    log_path = out_dir / "ptxas.log"
    if lib.exists() and log_path.exists():
        return Build(str(lib), True, _ptxas_lines(log_path.read_text()))
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = out_dir / f"{name}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
        if p.returncode != 0:
            failed.append(f"nvcc failed on {name} (exit {p.returncode}):\n"
                          f"{out}")
    objs = [str(obj) for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out_dir / f"libkernels.{os.getpid()}.so"
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        log = "\n".join(logs)
        tmp_log = out_dir / f"ptxas.{os.getpid()}.log"
        tmp_log.write_text(log)
        os.replace(tmp, lib)            # atomic publish: concurrent builds
        os.replace(tmp_log, log_path)   # each write their own temporaries
    finally:
        for o in objs:
            Path(o).unlink(missing_ok=True)
    return Build(str(lib), False, _ptxas_lines(log))


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every C entry point typed."""
    lib = ctypes.CDLL(build().path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rmsnorm_launch.argtypes = [p, p, p, p, ctypes.c_int64, i, f, i, i, p]
    lib.rmsnorm_launch.restype = i
    lib.decode_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, f,
                                            i, i, p]
    lib.decode_attention_launch.restype = i
    return lib
