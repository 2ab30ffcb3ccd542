"""Thread-safe object/kernel caches with a global purge registry.

Port of ``vexcl_tpu/cache.py`` (vexcl/cache.hpp:49-183: ``object_cache``,
``kernel_cache``, ``purge_caches``) and its ``fn_token``.  The cached
objects are built expression kernels keyed by (structural signature,
leaf dtypes, scalar types, assignment op, output dtype); Triton keeps its
own compiled-binary cache below that (``TRITON_CACHE_DIR``, see
``_build.py``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Hashable, List

__all__ = ["ObjectCache", "kernel_cache", "purge_caches", "fn_token"]


class ObjectCache:
    """Thread-safe key->object cache (cache.hpp:119-162)."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._store: Dict[Hashable, Any] = {}
        _register(self)

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            return self._store.get(key, default)

    def get_or_create(self, key: Hashable, factory: Callable[[], Any]) -> Any:
        # a hit needs no lock: one dict read is atomic in CPython, and a
        # stored object is never replaced
        hit = self._store.get(key)
        if hit is not None:
            return hit
        with self._lock:
            if key in self._store:
                return self._store[key]
        # Build outside the lock: factories may compile (slow) or re-enter.
        value = factory()
        with self._lock:
            return self._store.setdefault(key, value)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._store

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def purge(self) -> None:
        with self._lock:
            self._store.clear()


_registry_lock = threading.Lock()
_registry: List[ObjectCache] = []


def _register(cache: ObjectCache) -> None:
    with _registry_lock:
        _registry.append(cache)


def purge_caches() -> None:
    """Drop every cached kernel and scratch object (cache.hpp
    purge_caches :170-183)."""
    with _registry_lock:
        caches = list(_registry)
    for c in caches:
        c.purge()
    with _fn_token_lock:
        _fn_tokens.clear()


#: The expression-kernel cache (kernel_cache analog, cache.hpp:165).
kernel_cache = ObjectCache("kernels")


# A user callable (a StencilOperator body) never appears in a structural
# signature, so the signature carries a token of its identity: two
# callables sharing a name must not share a kernel.  Tokens hold a strong
# reference, so a collected function's id is never recycled onto a live
# token; purge_caches drops them with the kernels.
_fn_token_lock = threading.Lock()
_fn_tokens: Dict[int, Any] = {}  # id(fn) -> (token, fn)
_fn_next = [0]


def fn_token(fn: Any) -> int:
    """Per-process stable token identifying a callable for signature use."""
    with _fn_token_lock:
        hit = _fn_tokens.get(id(fn))
        if hit is not None:
            return hit[0]
        _fn_next[0] += 1
        _fn_tokens[id(fn)] = (_fn_next[0], fn)
        return _fn_next[0]
