"""Build the CUDA sources under ``cppf_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface under ``cppf_tpu_torch/_build/`` (listed in .gitignore),
named by the hash of the source and flags, so an edited source rebuilds and
an unchanged one is reused.  The compiler's output (``-Xptxas -v``: each
kernel's registers, shared memory and spills) is kept beside the library as
``<library>.log``.  Libraries load through ``ctypes``.  Nothing
builds at import: the first launch (or :func:`build`) does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD, f"{name}-{digest}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns name → path."""
    os.makedirs(BUILD, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        with open(paths[name] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _libs[name] = lib
    return lib


def resource_usage(name: str) -> Dict[str, str]:
    """Kernel (mangled name) → ptxas's line of registers, shared memory and
    spills, from the build log of ``csrc/<name>.cu``."""
    with open(build([name])[name] + ".log") as f:
        lines = f.read().splitlines()
    usage, kernel, spills = {}, None, ""
    for line in lines:
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "bytes spill stores" in line:
            spills = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and kernel:
            usage[kernel] = f"{line.split(':', 1)[-1].strip()}; {spills}"
            kernel = None
    return usage
