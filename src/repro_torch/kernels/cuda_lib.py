"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a``
(Hopper) into an object file, all sources at once in parallel, and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library lands in ``build/repro_torch/`` at
the root of the checkout, named by a hash of the sources and flags, so
an unchanged tree reuses it and a changed one rebuilds. Nothing is
built when a module is imported: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
        "kernels of repro_torch are built from source on first use"
    )


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources (one ``nvcc`` per file, all started together)
    and link them into the shared library; returns its path. The
    compiler's output (``-Xptxas=-v``: registers, shared memory and
    spills of every kernel) is kept beside the library as ``.log``."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log)
            )
        staged = pathlib.Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(staged),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking {target.name} failed:\n{link.stdout}")
        target.with_suffix(".log").write_text("\n".join(log))
        os.replace(staged, target)
    return target


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the library (built on first use),
    with its argument types declared; every entry point returns the
    ``cudaGetLastError()`` code of its launch as an int."""
    global _lib
    if name not in _functions:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        fn = getattr(_lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return _functions[name]


def check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {code})")


def require(
    kernel: str, arg: str, x, dtype: torch.dtype, shape: tuple,
    device: torch.device,
) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``: the kernels take nothing else."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{kernel}: {arg} must be a tensor, got {type(x)}")
    if x.device != device:
        raise ValueError(f"{kernel}: {arg} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel}: {arg} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{kernel}: {arg} has shape {tuple(x.shape)}, expected {tuple(shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {arg} must be contiguous")


def stream_args(device: torch.device) -> tuple[int, int]:
    """``(stream, device index)`` for a launch on ``device``'s current
    stream."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch.cuda.current_stream(device).cuda_stream, index


__all__ = [
    "build",
    "function",
    "check_launch",
    "library_path",
    "require",
    "sources",
    "stream_args",
]
