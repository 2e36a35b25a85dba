"""Build and load the package's CUDA kernels, and check what is handed
to them.

Every kernel source `csrc/<name>.cu` has a plain C interface. It is
compiled by `nvcc` for sm_90a into `_build/lib<name>.so` at first use
and loaded with ctypes; nothing is built when a module is imported, so
the package imports on a machine without a CUDA toolkit. `-fmad=false`
is part of the contract between each kernel and its plain PyTorch
version (products are rounded before they are added, on both sides);
`--use_fast_math` is never passed. A kernel takes raw pointers, so its
wrapper validates every tensor with `check_tensor` first.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_pkg, "csrc")
BUILD_DIR = os.path.join(_pkg, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def source_path(name: str) -> str:
    return os.path.join(SOURCE_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_libraries(names, verbose: bool = False) -> dict[str, str]:
    """Compile csrc/<name>.cu into _build/lib<name>.so for every name
    whose library is missing or older than its source; one nvcc process
    per source, all started together. Returns {name: library path}.
    Raises when nvcc is missing or refuses a source. With `verbose`,
    ptxas' report (registers, stack, spills) is printed."""
    procs = []
    for name in names:
        so, src = library_path(name), source_path(name)
        if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, src]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                          f"{out}\n{err}")
            continue
        if verbose:
            print(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of lib<name>.so, built first if need be. The
    caller sets argtypes and restype of the functions it uses."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build_libraries([name])[name])
        return _libs[name]


def check_tensor(name: str, a, device, dtype, shape) -> None:
    """Raise ValueError unless tensor `a` lies on `device`, has `dtype`
    and `shape`, and is contiguous: what a kernel that is handed
    `a.data_ptr()` relies on."""
    if a.device != device:
        raise ValueError(f"{name}: on {a.device}, the scene is on {device}")
    if a.dtype != dtype:
        raise ValueError(f"{name}: dtype {a.dtype}, expected {dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {shape}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
