"""Build and load the port's hand-written CUDA kernels.

Every `datr_torch/csrc/*.cu` is compiled for sm_90a by its own `nvcc`
process, all started together, and the objects are linked into one shared
library with a plain C interface, `build/datr_torch/libdatr_torch_kernels.so`,
which is loaded with ctypes.
Nothing is built at import: the first CUDA call builds, and a build or load
failure raises — there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "datr_torch"
LIB_NAME = "libdatr_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point; pointers and the stream as c_void_p so
# ctypes never truncates them to 32-bit ints
_L = ctypes.c_longlong
_SIGNATURES = {
    "msda_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                  ctypes.POINTER(_I), _I, _I, _P], _I),
    "msda_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _I, ctypes.POINTER(_I), _I, _I, _P], _I),
    "row_gather": ([_P, _P, _P, _I, _L, _I, _I, _I, _P], _I),
    "gather_fma": ([_P, _P, _P, _P, _I, _L, _I, _I, _I, _P], _I),
    "datr_cuda_error_string": ([_I], ctypes.c_char_p),
    "datr_msda_bwd_routes": ([_P], None),
    "datr_msda_fwd_routes": ([_P], None),
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "datr_torch cannot be built"
    )


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build(srcs=None, out_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """Compile `srcs` (default: every csrc/*.cu), one nvcc process per
    source, all running at once, and link the objects into the library.

    Returns (library path, compiler log — ptxas register and spill counts).
    Raises RuntimeError with nvcc's output when a compile or the link
    fails."""
    srcs = [Path(s) for s in (srcs if srcs is not None else sources())]
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # the library is built in a private directory and renamed into place, so
    # concurrent builders (test workers) never see a partial file
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed linking {[s.name for s in srcs]}"
                               f":\n{proc.stdout}")
        lib_path = out_dir / LIB_NAME
        os.replace(tmp_lib, lib_path)
    return lib_path, "\n".join(logs)


def _stale(lib_path: Path) -> bool:
    if not lib_path.exists():
        return True
    built = lib_path.stat().st_mtime
    return any(src.stat().st_mtime > built
               for src in [*sources(), *CSRC_DIR.glob("*.cuh")])


def open_library(lib_path: Path):
    """Load a built library and declare its C entry points (another
    commit's library may lack newer ones: calling one raises
    AttributeError)."""
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


@contextlib.contextmanager
def use_library(lib):
    """Inside the block the wrappers launch from `lib` (a library from
    `open_library`, e.g. another commit's sources built beside the port's
    own) instead of the port's."""
    global _lib
    with _lock:
        old, _lib = _lib, lib
    try:
        yield
    finally:
        with _lock:
            _lib = old


def load_library():
    """The loaded kernel library, built first if missing or older than its
    sources."""
    global _lib
    with _lock:
        if _lib is None:
            lib_path = BUILD_DIR / LIB_NAME
            if _stale(lib_path):
                build()
            _lib = open_library(lib_path)
    return _lib


def check(lib, rc: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.datr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
