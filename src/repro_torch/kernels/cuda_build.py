"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
the checkout's ``build/`` directory and loaded with ``ctypes``.  The library
name carries a digest of the source and of the shared ``csrc/*.cuh``
headers, so an edited kernel or header is rebuilt and a stale library is
never loaded.  Nothing here runs at import time: the CPU
tests import every module on a host with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from repro_torch.core import errors

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# what a kernel's ``*_attributes`` C entry point reports, in its order
ATTRIBUTES = ("registers", "static_smem", "dynamic_smem", "local_bytes",
              "threads", "ctas_per_sm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> "str | None":
    """nvcc on PATH, else under CUDA_HOME, else the default toolkit path."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library goes: its name carries a digest
    of the source and of every ``csrc/*.cuh`` header, so an edited header
    rebuilds each library that may include it."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def nvcc_command(nvcc: str, src, out) -> list:
    """The nvcc command that builds ``src`` into the library ``out``, with
    ``csrc/`` on the include path (the shared ``*.cuh`` headers)."""
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(errors.ERR_KERNEL_BUILD.format(
            name=name, reason="nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)"
        ))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = nvcc_command(nvcc, CSRC / f"{name}.cu", tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(errors.ERR_KERNEL_BUILD.format(
                name=name, reason=proc.stderr.strip() or proc.stdout.strip()
            ))
        os.replace(tmp, out)    # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))


def read_attributes(fn, *args) -> dict:
    """A built kernel's registers per thread, shared and local (spill)
    bytes, CTA size and CTAs per SM, from its library's ``*_attributes``
    entry point (``cudaFuncGetAttributes`` and the occupancy calculator),
    which takes ``args`` and fills six ints."""
    out = (ctypes.c_int * len(ATTRIBUTES))()
    status = fn(*args, out)
    if status != 0:
        raise RuntimeError(f"kernel attributes: CUDA error {status}")
    return dict(zip(ATTRIBUTES, out))
