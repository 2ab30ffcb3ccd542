"""Kernel builds from the package's own sources, at first use.

* CUDA C++ (``csrc/*.cu``): ``nvcc`` builds one shared library per entry
  of ``LIBRARIES``, each with a plain C interface, loaded with ``ctypes``.
  The library's file name carries a hash of the sources and flags, so an
  edited source rebuilds and an unchanged one is loaded from
  ``config.build_dir``.  ``build_cuda_libraries`` starts every missing
  build at once (one ``nvcc`` per library) and waits for all of them.
* Triton: the expression emitter's generated sources are written as
  modules under ``<build_dir>/triton/`` and imported from there
  (``@triton.jit`` reads a kernel's source with ``inspect``, so the text
  must live in a file).  ``TRITON_CACHE_DIR`` points at
  ``<build_dir>/triton_cache`` unless the caller has set it.
* User CUDA C++ (``backend.cuda_kernel``): ``nvcc -cubin`` builds each
  source into ``<build_dir>/user/``, keyed by a hash of the source.

``triton`` and ``nvcc`` exist only where there is a card: nothing here
runs at import time.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

from .config import config

__all__ = ["cuda_library", "build_cuda_libraries", "cuda_cubin",
           "triton_module", "import_triton", "NVCC_FLAGS", "CUBIN_FLAGS",
           "LIBRARIES"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: library name -> its sources under ``csrc/`` (the ``.cu`` files are
#: compiled; headers are listed so that an edit to one rebuilds)
LIBRARIES: Dict[str, Tuple[str, ...]] = {
    "vexcl_dia": ("dia_spmv.cu",),
    "vexcl_sell": ("spmv_sell.cu",),
    "vexcl_stencil": ("stencil.cu",),
    "vexcl_scan": ("scan.cu",),
    "vexcl_compact": ("compact.cu",),
    "vexcl_philox": ("philox.cu",),
}

#: nvcc flags of a user kernel (``backend.cuda_kernel``): a cubin, which
#: the port loads with libcuda's ``cuModuleLoad``
CUBIN_FLAGS = ("-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_modules: Dict[str, object] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME as home
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def _write_atomic(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _library_path(name: str) -> Tuple[str, List[str]]:
    """(built library path, source paths) of ``LIBRARIES[name]``."""
    paths = [os.path.join(CSRC_DIR, s) for s in LIBRARIES[name]]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return (os.path.join(config.build_dir,
                         f"lib{name}-{h.hexdigest()[:16]}.so"), paths)


def build_cuda_libraries(names: Sequence[str] = tuple(LIBRARIES)) -> None:
    """Build the named libraries that are not built yet, one ``nvcc``
    process each, all started together; raise if any build fails."""
    os.makedirs(config.build_dir, exist_ok=True)
    jobs = []
    with _lock:
        for name in names:
            out, paths = _library_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *(p for p in paths if p.endswith(".cu"))]
            jobs.append((cmd, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, tmp, out, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{log}")
            else:
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def cuda_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``lib<name>`` (an entry of ``LIBRARIES``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    build_cuda_libraries([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_library_path(name)[0])
            _libs[name] = lib
        return lib


def cuda_cubin(source: str) -> str:
    """Build (once) a user CUDA C++ source into a cubin under
    ``<build_dir>/user/``, keyed by a hash of the source and flags; return
    its path.  A failed build raises with nvcc's log."""
    h = hashlib.sha256(" ".join(CUBIN_FLAGS).encode())
    h.update(source.encode())
    d = os.path.join(config.build_dir, "user")
    base = os.path.join(d, h.hexdigest()[:16])
    out = base + ".cubin"
    with _lock:
        if os.path.exists(out):
            return out
        os.makedirs(d, exist_ok=True)
        _write_atomic(base + ".cu", source.encode())
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *CUBIN_FLAGS, "-o", tmp, base + ".cu"]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)
    return out


def import_triton():
    """Import Triton with its cache under the build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(config.build_dir, "triton_cache"))
    import triton

    return triton


def triton_module(src: str):
    """Write a generated Triton source to a file and import it."""
    name = "vexk_" + hashlib.sha1(src.encode()).hexdigest()[:20]
    with _lock:
        mod = _modules.get(name)
        if mod is not None:
            return mod
        import_triton()
        d = os.path.join(config.build_dir, "triton")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name + ".py")
        if not os.path.exists(path):
            _write_atomic(path, src.encode())
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[name] = mod
        return mod
