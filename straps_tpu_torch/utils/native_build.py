"""Builds the port's compiled sources (`csrc/`) into shared libraries at
first use, into `straps_tpu_torch/_build/` (gitignored).

A library's file name carries a hash of its source, of every header of
its directory that it includes (directly or through another) and of the
compiler flags, so an edited source is rebuilt and an unchanged one is
built once.  The CUDA kernels build with nvcc (`render/cuda_raster.py`);
the host C++ (the JPEG decoder, the npy reader) with `g++`, or `$CXX`.
"""

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
import threading
from typing import Dict, List, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")


def local_includes(source: str) -> List[str]:
    """`source` and every file of its directory that it includes with
    `#include "..."`, directly or through another such file."""
    found, todo = [], [os.path.abspath(source)]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        with open(path) as f:
            names = re.findall(r'^\s*#\s*include\s*"([^"]+)"', f.read(), re.MULTILINE)
        todo += [os.path.join(os.path.dirname(path), n) for n in names]
    return found


def source_digest(source: str, flags: Sequence[str]) -> str:
    """Hash of `source`, the headers it includes and `flags`: the key of a
    built library."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in local_includes(source):
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def build_library(source: str, compiler: str, flags: Sequence[str],
                  extra: Sequence[str] = ()) -> str:
    """Compile `source` with `compiler` and `flags` (plus `extra`, which
    the key leaves out) into `_build/<stem>_<key>.so` unless that file is
    there; the compiler's output is kept beside it as `<library>.log`.
    Returns the library's path; raises RuntimeError when the compiler
    fails."""
    stem = os.path.splitext(os.path.basename(source))[0]
    lib_path = os.path.join(BUILD_DIR, f"{stem}_{source_digest(source, flags)}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, *extra, "-o", tmp_path, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp_path)
        raise RuntimeError(f"{os.path.basename(compiler)} failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(lib_path + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp_path, lib_path)
    return lib_path


_HOST_LIBS: Dict[str, ctypes.CDLL] = {}
_HOST_LOCK = threading.Lock()


def host_library(name: str) -> ctypes.CDLL:
    """`csrc/<name>.cpp` built with `$CXX` (default `g++`) and loaded, once
    a process; raises RuntimeError when it does not build."""
    with _HOST_LOCK:
        if name not in _HOST_LIBS:
            source = os.path.join(CSRC_DIR, f"{name}.cpp")
            _HOST_LIBS[name] = ctypes.CDLL(
                build_library(source, os.environ.get("CXX", "g++"), HOST_FLAGS))
        return _HOST_LIBS[name]
