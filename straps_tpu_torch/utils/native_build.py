"""Builds the port's compiled sources (`csrc/`) into shared libraries at
first use, into `straps_tpu_torch/_build/` (gitignored), and loads each
once a process, its entry points typed.

A library's file name carries a hash of its source, of every header of
its directory that it includes (directly or through another) and of the
compiler flags, so an edited source is rebuilt and an unchanged one is
built once.  The CUDA kernels build with nvcc and launch through a
`CudaKernels` each (`KERNEL_LIBRARIES`: the rasterisers, BatchNorm),
counted, a `KernelGraph`'s replays included; `KeyedGraphs` keeps one
graph a key and counts its calls.  The host C++ builds with `g++`, or
`$CXX`, and loads through `host_library`.
"""

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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


# Loaded libraries by source path, each with its entry points typed.
_LIBRARIES: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _load(source: str, build: Callable[[str], str], signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """`source`'s library, built by `build` and loaded once a process, each
    entry point of `signatures` typed."""
    with _LOCK:
        if source not in _LIBRARIES:
            lib = ctypes.CDLL(build(source))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _LIBRARIES[source] = lib
        return _LIBRARIES[source]


def cxx_library(source: str) -> str:
    """Compile host C++ `source` with `$CXX` (default `g++`) into `_build/`."""
    return build_library(source, os.environ.get("CXX", "g++"), HOST_FLAGS)


def host_library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """`csrc/<name>.cpp` built and loaded once a process, typed by `signatures`
    ({name: (argtypes, restype)}); RuntimeError when it does not build."""
    return _load(os.path.join(CSRC_DIR, f"{name}.cpp"), cxx_library, signatures)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                           f"the CUDA kernels are built from {CSRC_DIR} at first use")
    return found


def cuda_library(source: str) -> str:
    """Compile one `.cu` file of `csrc/` with nvcc into `_build/` unless a
    library built from the same source, headers and flags is there; nvcc's
    report (registers, shared memory, spills) is kept beside it as
    `<library>.log`.  Returns the library's path; raises RuntimeError when
    nvcc fails."""
    return build_library(source, find_nvcc(), NVCC_FLAGS, ("-Xptxas", "-v"))


KERNEL_LIBRARIES: List["CudaKernels"] = []      # those of the imported modules
# The graph being captured: launches of any thread, autograd's too, count toward it.
_capturing: Optional["KernelGraph"] = None


class CudaKernels:
    """The entry points of one `.cu` of `csrc/`, built with nvcc and loaded
    at the first launch: `signatures` gives each one's argument types, the
    stream follows them, and each returns a CUDA error code.  `launches`
    counts the calls, a `KernelGraph`'s replays included."""

    def __init__(self, source: str, signatures: Dict[str, Sequence]):
        self.source = os.path.join(CSRC_DIR, source)
        self.name = os.path.splitext(source)[0]
        self.signatures = {name: (list(argtypes) + [ctypes.c_void_p], ctypes.c_int)
                           for name, argtypes in signatures.items()}
        self.launches = 0
        KERNEL_LIBRARIES.append(self)

    def library(self) -> ctypes.CDLL:
        """The loaded library, built at first use."""
        return _load(self.source, cuda_library, self.signatures)

    def launch(self, name: str, device: torch.device, *args) -> None:
        """Call entry point `name` with `args`, a tensor passed as its data
        pointer, on the current stream of `device`, and count the launch;
        raise RuntimeError naming `name` on a CUDA error."""
        fn = getattr(self.library(), name)
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        if _capturing is None:
            self.launches += 1
        else:
            _capturing.counts[self] = _capturing.counts.get(self, 0) + 1


def reset_launches() -> None:
    """Zero every kernel library's `launches`."""
    for lib in KERNEL_LIBRARIES:
        lib.launches = 0


class KernelGraph:
    """A `torch.cuda.CUDAGraph` that counts its kernels: a launch made
    while `capture()` runs counts not in its library's `launches`, since
    nothing ran, but at each `replay()`."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.counts: Dict[CudaKernels, int] = {}

    @contextlib.contextmanager
    def capture(self):
        """`torch.cuda.graph(self.graph)`: capture the block on a side stream."""
        global _capturing
        _capturing = self
        try:
            with torch.cuda.graph(self.graph):
                yield
        finally:
            _capturing = None

    def replay(self) -> None:
        self.graph.replay()
        for lib, n in self.counts.items():
            lib.launches += n


# A key whose first call ran eagerly and whose second is captured.
_FIRST_SEEN = object()


class KeyedGraphs(dict):
    """The counts of a function that keeps what it captured (one or more
    CUDA graphs) a key: its calls since the last `reset()`, each counted
    once, as captured (and replayed), replayed, or eager by reason
    (`{"captures": n, "replays": n, "eager": {reason: n}}`).  `call` runs a
    key's first call eagerly (reason `first`), captures its second and
    replays every later one."""

    def __init__(self, first: str, *reasons: str):
        super().__init__(captures=0, replays=0, eager={r: 0 for r in (*reasons, first)})
        self.first = first

    def reset(self) -> None:
        """Zero every count."""
        self["captures"] = self["replays"] = 0
        for k in self["eager"]:
            self["eager"][k] = 0

    def run_eager(self, reason: str, eager: Callable[[], Any]) -> Any:
        """`eager()`, counted under `reason`."""
        self["eager"][reason] += 1
        return eager()

    def call(self, graphs: dict, key, capture: Callable[[], Any],
             replay: Callable[[Any], Any], eager: Callable[[], Any]) -> Any:
        """The call of `key` in `graphs` (the caller's map of key to
        graph): `eager()` if it is the key's first, else `replay(graph)`,
        the graph made by `capture()` at the key's second call."""
        graph = graphs.get(key)
        if graph is None:
            graphs[key] = _FIRST_SEEN
            return self.run_eager(self.first, eager)
        if graph is _FIRST_SEEN:
            graph = graphs[key] = capture()
            self["captures"] += 1
        else:
            self["replays"] += 1
        return replay(graph)
