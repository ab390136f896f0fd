"""Compile the native libraries (g++ -O3 -shared) with mtime caching, into
``lirec_tpu_torch/_build/`` at first use."""

from __future__ import annotations

import os
import os.path as ops
import subprocess
import sys

_OUT = ops.join(ops.dirname(ops.dirname(ops.abspath(__file__))), "_build")
SRC = ops.join(ops.dirname(__file__), "ingest.cpp")
LIB = ops.join(_OUT, "libingest.so")
ASM_SRC = ops.join(ops.dirname(__file__), "assembly.cpp")
ASM_LIB = ops.join(_OUT, "libassembly.so")
ZSTD_SRC = ops.join(ops.dirname(__file__), "zstd.cpp")
ZSTD_LIB = ops.join(_OUT, "libzstd_port.so")


def _build_one(src: str, lib: str, force: bool) -> str:
    if (
        not force
        and ops.exists(lib)
        and os.stat(lib).st_mtime >= os.stat(src).st_mtime
    ):
        return lib
    os.makedirs(ops.dirname(lib), exist_ok=True)
    # build under a private name, then rename: concurrent builders (test
    # workers) never load a half-written library
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        "-o", tmp, src,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib)
    return lib


def build(force: bool = False) -> str:
    return _build_one(SRC, LIB, force)


def build_assembly(force: bool = False) -> str:
    return _build_one(ASM_SRC, ASM_LIB, force)


def build_zstd(force: bool = False) -> str:
    return _build_one(ZSTD_SRC, ZSTD_LIB, force)


if __name__ == "__main__":
    force = "--force" in sys.argv
    print("built", build(force=force))
    print("built", build_assembly(force=force))
    print("built", build_zstd(force=force))
