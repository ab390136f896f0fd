"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` functions and includes
no PyTorch header, so nvcc compiles it in seconds. The shared library goes
to ``lirec_tpu_torch/_build/lib<name>-<hash>.so``, keyed by a hash of the
source and the flags, at first use; a later process reuses it. A missing
nvcc or a failed build raises: there is no fallback for a CUDA tensor.

    python -m lirec_tpu_torch.ops.build     # build every kernel, print logs
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load", "launcher", "nvcc_path",
           "source_path"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOGS: dict = {}  # name -> {"path", "cmd", "seconds", "log"} of builds run here


def source_path(name: str) -> Path:
    return _SRC_DIR / ("%s.cu" % name)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of lirec_tpu_torch cannot be built"
    )


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same source hash is
    already built; return the library's path."""
    import time

    src = source_path(name)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = _BUILD_DIR / ("lib%s-%s.so" % (name, digest))
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            "nvcc failed (%d) building %s:\n%s%s"
            % (proc.returncode, src, proc.stdout, proc.stderr)
        )
    os.replace(tmp, out)  # atomic: concurrent builders race harmlessly
    BUILD_LOGS[name] = {
        "path": str(out), "cmd": " ".join(cmd), "seconds": seconds,
        "log": proc.stdout + proc.stderr,
    }
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


def launcher(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C launcher `symbol` of csrc/<name>.cu: n_ptrs device pointers,
    n_ints ints, then the stream; it returns a cudaError_t."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


if __name__ == "__main__":
    for cu in sorted(_SRC_DIR.glob("*.cu")):
        path = build(cu.stem)
        info = BUILD_LOGS.get(cu.stem)
        print(path if info is None else "%s (%.1f s)\n%s" % (
            path, info["seconds"], info["log"]))
