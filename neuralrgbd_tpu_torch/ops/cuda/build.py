"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C entry ``<name>_launch`` and is
compiled by ``nvcc`` for sm_90a into its own shared library, loaded with
``ctypes``. Nothing is built at import: ``build`` runs at first use (or
up front, from ``chip_smoke.py``), one ``nvcc`` per source, all started
together. Libraries land in ``neuralrgbd_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that hashes the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("sweep_fused", "resample", "conv3d", "conv2d_bn", "conv3d_f32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_functions: dict[str, ctypes._CFuncPtr] = {}
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel that is not built yet, all in parallel.

    Returns {name: nvcc's output (ptxas register and spill report)} for the
    kernels compiled by this call. Raises if any compile fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for "
                           + ", ".join(f"{n}:\n{logs[n]}" for n in failed))
    return logs


def kernel_function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``<name>_launch`` of a built kernel (built on first use),
    with ``argtypes`` declared and an int (cudaError_t) result."""
    fn = _functions.get(name)
    if fn is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_str = getattr(lib, f"{name}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _libs[name] = lib
        _functions[name] = fn
    return fn


def library(name: str) -> ctypes.CDLL:
    """The loaded library of a kernel whose entry was taken before."""
    return _libs[name]


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = getattr(_libs[name], f"{name}_error_string")(err)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg.decode()})")
