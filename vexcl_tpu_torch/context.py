"""Device selection, composable filters, and the Context.

Port of ``vexcl_tpu/context.py`` (vexcl/devlist.hpp: Context :273-391,
Filter::* :53-225).  The filter algebra (``&``, ``|``, ``~``, Count,
Position, Env, Name, Platform, Type) is kept, over ``torch.device``
objects: every CUDA device in index order, then the CPU.  A ``Context``
holds ONE ``torch.device``; every container and kernel of the context
lives there.

Dropped, with the TPU: the ``jax.sharding.Mesh`` and its shardings (a
context spanning several devices is a later slice of the port), and the
XLA compilation-cache setup.  ``Filter.Exclusive`` keeps the JAX
package's cross-process device locks: ``flock`` files in
``$VEXTPU_LOCK_DIR`` (or the temporary directory), one a device, keyed by
its torch device type and index.  Nothing here falls back to another
device: a
filter that selects no device raises, and the default (``Context()``,
``current_context()``) selects CUDA devices only, so a host without a
card runs on the CPU only where the caller asks for it.
"""

from __future__ import annotations

import atexit
import os
import re
from typing import Callable, List, Optional, Sequence

import torch

__all__ = ["Filter", "Context", "current_context", "make_context",
           "release_exclusive_locks"]


def _devices() -> List[torch.device]:
    """Every device PyTorch can reach: the CUDA devices, then the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] + [torch.device("cpu")]


def _dev_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _dev_platform(dev: torch.device) -> str:
    return dev.type


class DeviceFilter:
    """Composable device predicate (devlist.hpp:145-181): element-wise
    filters implement ``match``; list-wise ones override ``select``."""

    def match(self, dev) -> bool:  # pragma: no cover - overridden
        return True

    def select(self, devices: Sequence) -> List:
        return [d for d in devices if self.match(d)]

    def __and__(self, other: "DeviceFilter") -> "DeviceFilter":
        return _And(self, other)

    def __or__(self, other: "DeviceFilter") -> "DeviceFilter":
        return _Or(self, other)

    def __invert__(self) -> "DeviceFilter":
        return _Not(self)

    def __call__(self, devices: Sequence) -> List:
        return self.select(devices)


class _And(DeviceFilter):
    def __init__(self, a: DeviceFilter, b: DeviceFilter) -> None:
        self.a, self.b = a, b

    def select(self, devices: Sequence) -> List:
        return self.b.select(self.a.select(devices))


class _Or(DeviceFilter):
    def __init__(self, a: DeviceFilter, b: DeviceFilter) -> None:
        self.a, self.b = a, b

    def select(self, devices: Sequence) -> List:
        sa = self.a.select(devices)
        return sa + [d for d in self.b.select(devices) if d not in sa]


class _Not(DeviceFilter):
    def __init__(self, a: DeviceFilter) -> None:
        self.a = a

    def select(self, devices: Sequence) -> List:
        inner = self.a.select(devices)
        return [d for d in devices if d not in inner]


class _Pred(DeviceFilter):
    def __init__(self, fn: Callable, name: str = "pred") -> None:
        self.fn = fn
        self.name = name

    def match(self, dev) -> bool:
        return bool(self.fn(dev))


class _All(DeviceFilter):
    pass


class _Count(DeviceFilter):
    """Keep at most n devices (Filter::Count, devlist.hpp:145-156)."""

    def __init__(self, n: int) -> None:
        self.n = int(n)

    def select(self, devices: Sequence) -> List:
        return list(devices)[: self.n]


class _Position(DeviceFilter):
    """Keep only the device at position n (Filter::Position, :158-170)."""

    def __init__(self, n: int) -> None:
        self.n = int(n)

    def select(self, devices: Sequence) -> List:
        devices = list(devices)
        return [devices[self.n]] if 0 <= self.n < len(devices) else []


class _Env(DeviceFilter):
    """Environment-driven filter (Filter::Env, devlist.hpp:185-223):
    VEXTPU_DEVICE (substring of the device name), VEXTPU_PLATFORM
    ("cuda" or "cpu"), VEXTPU_POSITION, VEXTPU_MAX_DEVICES.  With neither
    VEXTPU_DEVICE nor VEXTPU_PLATFORM set it keeps the CUDA devices only:
    the CPU is used when it is asked for."""

    def select(self, devices: Sequence) -> List:
        out = list(devices)
        name = os.environ.get("VEXTPU_DEVICE")
        if name:
            out = [d for d in out if name.lower() in _dev_name(d).lower()]
        plat = os.environ.get("VEXTPU_PLATFORM")
        if plat:
            out = [d for d in out if plat.lower() in _dev_platform(d)]
        if not name and not plat:
            out = [d for d in out if d.type == "cuda"]
        pos = os.environ.get("VEXTPU_POSITION")
        if pos is not None:
            out = _Position(int(pos)).select(out)
        maxd = os.environ.get("VEXTPU_MAX_DEVICES")
        if maxd is not None:
            out = out[: int(maxd)]
        return out


class _Exclusive(DeviceFilter):
    """Cross-process exclusive device ownership through lock files
    (opencl/filter.hpp:214-330, the VEXCL_LOCK_DIR analog).

    A device passes only where this process takes (or already holds) an
    exclusive ``flock`` on ``$VEXTPU_LOCK_DIR/vextpu_device_<type>_<index>
    .lock``, so two processes that share a lock directory never select one
    device.  The locks are held until ``release_exclusive_locks`` or the
    process's exit; the kernel drops a ``flock`` when its holder dies, so
    a stale lock file is harmless."""

    def __init__(self, inner: DeviceFilter) -> None:
        self.inner = inner

    @staticmethod
    def _lock_dir() -> str:
        import tempfile

        d = os.environ.get("VEXTPU_LOCK_DIR") or tempfile.gettempdir()
        os.makedirs(d, exist_ok=True)
        return d

    @staticmethod
    def _dev_key(dev: torch.device) -> str:
        return f"{dev.type}_{dev.index or 0}"

    def select(self, devices: Sequence) -> List:
        import fcntl

        out = []
        lock_dir = self._lock_dir()
        for dev in self.inner.select(devices):
            key = self._dev_key(dev)
            if key in _exclusive_locks:       # already this process's
                out.append(dev)
                continue
            path = os.path.join(lock_dir, f"vextpu_device_{key}.lock")
            try:
                fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o666)
            except OSError:
                continue                      # an unwritable lock directory
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)
                continue                      # held by another process
            _exclusive_locks[key] = fd
            out.append(dev)
        return out


#: the device keys this process holds, and their lock files' descriptors
_exclusive_locks: dict = {}


def release_exclusive_locks() -> None:
    """Release every ``Filter.Exclusive`` lock this process holds (the
    reference frees them with their Context)."""
    for key, fd in list(_exclusive_locks.items()):
        try:
            os.close(fd)                      # closing drops the flock
        except OSError:
            pass
        del _exclusive_locks[key]


atexit.register(release_exclusive_locks)


class _FilterNamespace:
    """vex::Filter::* namespace object."""

    All = _All()
    Any = _All()
    Env = _Env()

    @staticmethod
    def Name(pattern: str) -> DeviceFilter:
        return _Pred(
            lambda d: re.search(pattern, _dev_name(d), re.IGNORECASE)
            is not None, f"Name({pattern})")

    @staticmethod
    def Platform(pattern: str) -> DeviceFilter:
        return _Pred(
            lambda d: re.search(pattern, _dev_platform(d), re.IGNORECASE)
            is not None, f"Platform({pattern})")

    Vendor = Platform

    @staticmethod
    def Type(kind: str) -> DeviceFilter:
        """Device class: 'gpu' (or 'cuda') and 'cpu'."""
        want = "cuda" if kind.lower() in ("gpu", "cuda") else kind.lower()
        return _Pred(lambda d: d.type == want, f"Type({kind})")

    GPU = _Pred(lambda d: d.type == "cuda", "GPU")
    CPU = _Pred(lambda d: d.type == "cpu", "CPU")
    Accelerator = GPU
    #: every device PyTorch reaches computes in f64
    DoublePrecision = _All()

    Count = staticmethod(_Count)
    Position = staticmethod(_Position)
    Exclusive = staticmethod(_Exclusive)


Filter = _FilterNamespace()


_current_context: Optional["Context"] = None


class Context:
    """One selected device: ``Context(Filter.GPU)`` or
    ``Context(device="cuda:0")``.  The first device that passes the filter
    is used; none passing raises.  With no filter and no device (and so
    ``current_context()``), ``Filter.Env`` decides: a CUDA device unless
    the environment names another."""

    def __init__(self, filter: Optional[DeviceFilter] = None, *,
                 device=None, set_current: bool = True) -> None:
        if device is not None:
            if filter is not None:
                raise ValueError("pass a filter or a device, not both")
            self.device = torch.device(device)
        else:
            devices = (filter or Filter.Env).select(_devices())
            if not devices:
                if filter is None or filter is Filter.Env:
                    raise RuntimeError(
                        "Context: no CUDA device is visible; ask for the "
                        "CPU with Context(Filter.CPU), "
                        "Context(device=\"cpu\") or VEXTPU_PLATFORM=cpu")
                raise RuntimeError("Context: no devices pass the filter")
            self.device = devices[0]
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if set_current:
            _set_current(self)

    @property
    def size(self) -> int:
        """Number of devices (Context::size, devlist.hpp:330): one."""
        return 1

    def __len__(self) -> int:
        return self.size

    @property
    def devices(self) -> List[torch.device]:
        return [self.device]

    def __repr__(self) -> str:
        return (f"Context(1 device)\n  0: {_dev_name(self.device)} "
                f"[{_dev_platform(self.device)}]")

    def finish(self) -> None:
        """Block until all enqueued work completes (queue.finish analog)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _set_current(ctx: Context) -> None:
    global _current_context
    _current_context = ctx


def current_context(required: bool = True) -> Optional[Context]:
    """StaticContext::get analog: the most recently created context, or a
    new ``Context(Filter.Env)`` when none exists yet (which raises where
    no CUDA device is visible and the CPU was not asked for)."""
    global _current_context
    if _current_context is None and required:
        _current_context = Context(Filter.Env)
    return _current_context


def make_context(*args, **kwargs) -> Context:
    return Context(*args, **kwargs)
