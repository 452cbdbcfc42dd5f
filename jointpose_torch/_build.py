"""Build the CUDA kernels under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, which ``ctypes`` loads: no PyTorch headers, so a
build takes seconds.  Libraries land in ``build/jointpose_torch/`` at
the repository root, named by the source's content hash, so an edited
source rebuilds and an unchanged one is reused.  A failed build raises
with the compiler's output.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/jointpose_torch/<name>-<hash>.so csrc/<name>.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "jointpose_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start_build(name: str) -> subprocess.Popen | None:
    """Start ``nvcc`` for one source unless its library is current."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish_build(name: str, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name))


def build(names: list[str]) -> None:
    """Build every named kernel library, all ``nvcc`` runs at once."""
    with _lock:
        procs = {n: _start_build(n) for n in names}
        errors = []
        for n, proc in procs.items():
            try:
                _finish_build(n, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed.

    ``signatures`` maps each C entry point to ``(argtypes, restype)``;
    a launching entry returns the ``cudaError_t`` of its launch as an int.
    """
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err} at launch")
