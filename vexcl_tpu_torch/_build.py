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
* ``TritonLauncher`` launches a generated Triton kernel: through
  ``fn[grid]`` the first time for each argument class, directly through
  the compiled kernel's launcher after that.

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

import torch

from .config import config

__all__ = ["cuda_library", "build_cuda_libraries", "cuda_cubin",
           "triton_module", "import_triton", "TritonLauncher",
           "arg_classes", "Pointer", "written", "NVCC_FLAGS", "CUBIN_FLAGS",
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
    "vexcl_scan": ("scan.cu", "scan_common.cuh"),
    "vexcl_by_key": ("by_key.cu", "by_key.cuh", "scan_common.cuh"),
    "vexcl_by_key_wide": ("by_key_wide.cu", "by_key.cuh", "scan_common.cuh"),
    "vexcl_by_key_bf16": ("by_key_bf16.cu", "by_key.cuh", "scan_common.cuh"),
    "vexcl_compact": ("compact.cu",),
    "vexcl_philox": ("philox.cu",),
    "vexcl_scatter": ("scatter.cu", "ranges_common.cuh"),
    "vexcl_gather": ("gather.cu", "ranges_common.cuh"),
    "vexcl_mba": ("mba.cu",),
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


def written(*tensors: torch.Tensor) -> None:
    """Move the ``_version`` of tensors that a kernel wrote in place, as
    PyTorch's in-place operations move it (a write through ``data_ptr``
    does not): what keys on the version, such as an image's patch table
    (``ops/image.py``) and autograd's saved tensors, then sees the port's
    own writes.  Each wrapper that writes into a tensor it was given calls
    this on it after the launch."""
    torch.autograd.graph.increment_version(tensors)


class Pointer:
    """A tensor's memory passed to a Triton kernel as a pointer to
    ``dtype`` (the tensor's own by default): a 0-d leaf crosses as this,
    since Triton takes a tensor of one element for a Python number (it
    converts), and so does a buffer the kernel reads through another
    type.  It has a ``data_ptr`` and a ``dtype`` and no number
    protocol."""

    __slots__ = ("dtype", "_ptr")

    def __init__(self, t: torch.Tensor, dtype: torch.dtype = None):
        self.dtype = t.dtype if dtype is None else dtype
        self._ptr = t.data_ptr()

    def data_ptr(self) -> int:
        return self._ptr


#: what a launcher passes as a pointer
_POINTERS = (torch.Tensor, Pointer)


def arg_classes(args: Sequence, specialized: Sequence[bool]) -> tuple:
    """The specialisation classes of the non-constexpr arguments ``args``
    of a Triton kernel.

    Triton compiles a kernel for the class of each argument it is given
    (``JITFunction.run``'s binder): a tensor's dtype and whether its data
    pointer is 16-byte aligned; an integer's width (i32 where it fits,
    u64 from 2^63, i64 else) and, where the parameter is specialised
    (``specialized``: not in ``do_not_specialize``), whether it is 1 and
    whether it is a multiple of 16; a float is f32.  A class here is at
    least that fine, so one record never serves two compiled kernels (a
    card test holds it against the installed Triton's binder)."""
    cls = []
    for a, sp in zip(args, specialized):
        if isinstance(a, _POINTERS):
            cls.append((a.dtype, a.data_ptr() & 15 == 0))
        elif isinstance(a, float):
            cls.append(0.0)
        elif a is True or a is False:
            cls.append(a)           # Triton's u1
        else:
            w = 0 if -0x80000000 <= a <= 0x7FFFFFFF else (
                2 if a > 0x7FFFFFFFFFFFFFFF else 1)
            cls.append((w, a == 1, a & 15 == 0) if sp else w)
    return tuple(cls)


def _record(kernel) -> tuple:
    """(the launch function, the arguments between the stream and the
    kernel's own) of a ``CompiledKernel``: its launcher's C entry point
    where the kernel needs no global or profile scratch (the launcher's
    Python ``__call__`` only allocates those: ~1.4 us a call on the H100's
    host), else the launcher itself; no launch hooks either way."""
    run = kernel.run
    if not run.global_scratch_size and not run.profile_scratch_size:
        return run.launch, (kernel.function, run.launch_cooperative_grid,
                            run.launch_pdl, None, None,
                            kernel.packed_metadata, None, None, None)
    return run, (kernel.function, kernel.packed_metadata, None, None, None)


class TritonLauncher:
    """Launches one generated ``@triton.jit`` kernel with as little host
    work as the installed Triton allows.

    ``fn[grid](*args)`` (``JITFunction.run``) binds the arguments,
    computes their specialisation, builds its cache key and looks the
    compiled kernel up on every call, about 14-17 µs of host a call of
    the ~20 µs it takes on the H100's host (PERF.md §5).  Here a launch
    record per (device, constexpr values, argument classes) holds the
    ``CompiledKernel`` that the first ``fn[grid]`` call of the class
    returns (that call compiles and launches as Triton always does).
    Every later call of the class calls the compiled kernel's launcher
    (``CompiledKernel.run``, which ``CompiledKernel.__getitem__`` calls, or
    its C entry point: ``_record``) with the grid, the current stream's
    raw handle, the kernel handle, its packed metadata and the arguments,
    pointers as integers, no launch hooks.  Nothing falls back: a launch
    that raises, raises."""

    def __init__(self, fn, num_warps: int):
        self.fn = fn
        self.num_warps = num_warps
        #: (device index, constexpr values, argument classes) -> the
        #: compiled kernel's ``_record``
        self.records: Dict[tuple, tuple] = {}
        params = fn.params
        self.specialized = tuple(not p.do_not_specialize for p in params
                                 if not p.is_constexpr)
        self.constexprs = tuple(p.name for p in params if p.is_constexpr)
        #: the scalar and trailing integer arguments' values -> their
        #: classes
        self._scalar_classes: Dict[tuple, tuple] = {}

    def __call__(self, grid: Tuple[int, ...], args: Sequence,
                 ints: Tuple[int, ...], consts: tuple,
                 device: torch.device) -> None:
        """Launch over ``grid`` (one to three counts) with the
        non-constexpr arguments ``args`` followed by ``ints`` (integers
        such as counts) and the constexpr values ``consts`` (in parameter
        order) on ``device``, on its current stream.  A pointer's class
        (``arg_classes``) is taken on every call, and the pointer goes to
        the launcher as an integer, which it takes as it is; the scalars'
        and ``ints``' classes are kept per tuple of their values (a
        recorded kernel's constants, a schedule's counts repeat from call
        to call)."""
        idx = device.index
        vals, ptrs, scal = [], [], []
        for a in args:
            if isinstance(a, _POINTERS):
                p = a.data_ptr()
                vals.append(p)
                ptrs.append((a.dtype, p & 15 == 0))
            else:
                vals.append(a)
                scal.append(a)
        scal = (*scal, *ints)
        cls = self._scalar_classes.get(scal)
        if cls is None:
            if len(self._scalar_classes) >= 256:
                self._scalar_classes.clear()
            spec = [sp for a, sp in zip(args, self.specialized)
                    if not isinstance(a, _POINTERS)]
            cls = arg_classes(scal, spec + list(
                self.specialized[len(args):]))
            self._scalar_classes[scal] = cls
        key = (idx, consts, tuple(ptrs), cls)
        rec = self.records.get(key)
        if rec is None:
            self.records[key] = _record(self.jit_launch(grid, args, ints,
                                                        consts, device))
            return
        launch, mid = rec
        g = tuple(grid) + (1, 1)
        stream = torch._C._cuda_getCurrentRawStream(idx)
        # the raw calls, as Triton's launcher reads them: ~0.1 us where
        # torch.cuda.current_device() and current_stream() cost several
        if torch._C._cuda_getDevice() == idx:
            launch(g[0], g[1], g[2], stream, *mid, *vals, *ints, *consts)
        else:
            with torch.cuda.device(device):
                launch(g[0], g[1], g[2], stream, *mid, *vals, *ints,
                       *consts)

    def jit_launch(self, grid: Tuple[int, ...], args: Sequence,
                   ints: Tuple[int, ...], consts: tuple,
                   device: torch.device):
        """The same launch through ``fn[grid]`` (Triton's own path);
        returns the ``CompiledKernel``."""
        kw = dict(zip(self.constexprs, consts), num_warps=self.num_warps)
        if torch._C._cuda_getDevice() == device.index:
            return self.fn[tuple(grid)](*args, *ints, **kw)
        with torch.cuda.device(device):
            return self.fn[tuple(grid)](*args, *ints, **kw)
