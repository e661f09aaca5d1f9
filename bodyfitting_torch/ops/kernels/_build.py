"""Build the sources in ``ops/csrc`` and bind them with ctypes.

Each ``.cu`` file is a plain-C shared library (no PyTorch headers, so
``nvcc`` takes seconds), built for ``sm_90a`` at first use into
``ops/_build/`` (git-ignored).  Each ``.cpp`` file is host code (the PNG
unfilter, the JPEG decoder, the OBJ parser), built the same way with the
system C++ compiler, the one ``nvcc`` uses for host code; it needs no
CUDA toolkit.  The library name
carries a hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt, never loaded stale.  All sources are compiled in parallel, one compiler
process each.

Nothing here runs at import time: CPU-only machines import the kernel
modules and never reach the CUDA builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.normpath(os.path.join(_HERE, "..", "csrc"))
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))

# -fmad=false: every kernel rounds each multiply and add separately, like
# the plain PyTorch versions, so argmin ties and sums agree bit for bit.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

SOURCES = ("bilinear", "contour_match", "mask_terms", "nearest", "raster",
           "rows_scatter", "skinning")
HOST_SOURCES = ("png_unfilter", "jpeg_decode", "obj_parse")

_LIBS: dict = {}
_LOCK = threading.Lock()
build_log: dict = {}      # name -> compiler output (ptxas register/smem report)


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler found: the PNG, JPEG and OBJ readers "
                       "need one (set CXX or put c++ on PATH)")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> tuple[str, str]:
    host = name in HOST_SOURCES
    src = os.path.join(CSRC, f"{name}.cpp" if host else f"{name}.cu")
    flags = CXX_FLAGS if host else NVCC_FLAGS
    digest = hashlib.sha1(" ".join(flags).encode())
    headers = () if host else sorted(
        n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for path in (src, *(os.path.join(CSRC, n) for n in headers)):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def _compile(names) -> float:
    """Compile each of ``names`` that has no current library, in parallel;
    returns the wall seconds spent.  Raises with the compiler's output if
    a build fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, out = _lib_path(name)
        if os.path.exists(out):
            continue
        cmd = ([_cxx(), *CXX_FLAGS] if name in HOST_SOURCES
               else [_nvcc(), *NVCC_FLAGS])
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (out, tmp, subprocess.Popen(
            [*cmd, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_all() -> float:
    """Compile every source (CUDA and host) that has no current library;
    returns the wall seconds spent."""
    with _LOCK:
        return _compile(SOURCES + HOST_SOURCES)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), building it
    if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _, path = _lib_path(name)
        if not os.path.exists(path):
            if name in HOST_SOURCES:
                with _LOCK:
                    _compile((name,))
            else:
                build_all()
        lib = ctypes.CDLL(path)
        _LIBS[name] = lib
    return lib


_FNS: dict = {}


def _bind(name: str, symbol: str, n_ptrs: int, n_ints: int,
          n_floats: int = 0):
    key = (name, symbol)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on one CUDA device (the kernel runs).  Raises on
    any other mix of devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def require(what: str, t, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions (what the kernels take)."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{what}: {t.numel()} elements exceed int32 indexing")


def geometry(name: str, symbol: str, ints,
             keys=("blocks", "threads", "smem_bytes")) -> dict:
    """The launch geometry that ``symbol`` of ``csrc/<name>.cu`` reports
    for the sizes ``ints``, one int for each of ``keys`` (by default
    ``{"blocks", "threads", "smem_bytes"}``, the last the dynamic shared
    bytes a block).  Builds the library if needed."""
    key = (name, symbol)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = [ctypes.c_int] * len(ints) + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = None
        _FNS[key] = fn
    out = (ctypes.c_int * len(keys))()
    fn(*[int(i) for i in ints], out)
    return dict(zip(keys, out))


def launch(name: str, symbol: str, device, ptrs, ints, floats=()) -> None:
    """Call ``symbol(*ptrs, *ints, *floats, stream)`` of
    ``csrc/<name>.cu`` on ``device``'s current stream (``floats`` pass as
    C floats, rounded to f32 as PyTorch rounds a Python float); raises if
    the launch was refused."""
    import torch

    fn = _bind(name, symbol, len(ptrs), len(ints), len(floats))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, *[int(i) for i in ints],
                 *[float(x) for x in floats], stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed (cudaError {err})")
