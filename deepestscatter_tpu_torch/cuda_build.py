"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``.  Libraries are built at first use into ``_build/`` beside this
file (listed in ``.gitignore``), named by a digest of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the build.
``build()`` compiles several sources at once, one ``nvcc`` process each.

Float rules: no fast math, ``-fmad=false`` (no FMA contraction, so the
kernels round like their plain PyTorch versions).
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
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("march", "descriptor", "inscatter", "pathtrace", "probes", "samples",
           "assemble", "gather_probe", "diff", "path_adjoint", "spatial")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: Toolkit location tried after ``$CUDA_HOME``.
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``DEFAULT_CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):  # a source may include another
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, all at once.
    Returns the wall seconds of each build (0.0 when already built); the
    ptxas report of each goes to ``_build/<name>.log``.  Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).is_file()]
    seconds = {n: 0.0 for n in names}
    procs = {}
    t0 = time.time()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.time() - t0
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.is_file():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def require_vec3(**tensors) -> None:
    """Raise unless every named tensor is a contiguous float32 [N, 3], all
    of one N (the per-ray / per-point inputs the kernels take)."""
    shapes = set()
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be float32 [N, 3], got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shapes.add(t.shape[0])
    if len(shapes) > 1:
        raise ValueError(f"row counts differ: {sorted(shapes)}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None → NULL)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_handle() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for the launch."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
