"""Build ``csrc/*.cu`` with nvcc at first use and load it with ctypes.

Each source compiles to an object file in its own ``nvcc`` process, all
started together; the objects link into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library lands
in ``build/torch_kernels/`` at the repository root (git-ignored), named by a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the library.

``host_library`` builds a C++ source of ``csrc/`` for the host (the window
prefetcher, ``data/host_prefetch.py``) with ``g++`` (or ``$CXX``) the same
way; it needs no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path, sources: list[Path]) -> None:
    work = out.with_suffix(".d")
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = work / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode:
            failed.append(src.name)
    (work / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    subprocess.run([nvcc, "-shared", "-o", str(tmp),
                    *[str(work / (s.stem + ".o")) for s in sources]],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, out)


HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")


def host_library_path(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode() + src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def host_library(source: str) -> ctypes.CDLL:
    """``csrc/<source>`` built for the host at first use and loaded; a
    failed build raises with the compiler's message."""
    out = host_library_path(source)
    if not out.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if not cxx:
            raise RuntimeError(f"no C++ compiler to build {source}")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run([cxx, *HOST_FLAGS, str(CSRC / source), "-o",
                               str(tmp)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{cxx} failed on {source}:\n{proc.stderr}")
        os.replace(tmp, out)
    return _load(str(out))


@functools.cache
def _load(path: str) -> ctypes.CDLL:
    return ctypes.CDLL(path)


def build_log() -> str:
    """The compiler's output of the last build (registers, shared memory and
    spills per kernel from ``-Xptxas -v``)."""
    lib = library_path()
    log = lib.with_suffix(".d") / "build.log"
    return log.read_text() if log.exists() else ""


def library_path() -> Path:
    return BUILD_DIR / f"libldp_kernels_{_digest()}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    out = library_path()
    if not out.exists():
        _build(out, sorted(CSRC.glob("*.cu")))
    lib = ctypes.CDLL(str(out))
    lib.ldp_error_string.argtypes = [ctypes.c_int]
    lib.ldp_error_string.restype = ctypes.c_char_p
    return lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    fn = getattr(library(), name)
    if fn.argtypes != argtypes:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    if err:
        msg = library().ldp_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: {msg} ({err})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
LL = ctypes.c_longlong
