"""Global configuration flags.

Port of ``vexcl_tpu/config.py`` (the VEXCL_SHOW_KERNELS / VEXCL_CHECK_SIZES
/ VEXCL_CACHE_KERNELS layer, vexcl/backend/common.hpp:60-96).  The three
flags keep their names and environment variables.  The TPU-only knobs
(Pallas interpret mode, buffer donation, XLA's persistent cache) have no
counterpart here: a CPU tensor takes each kernel's plain PyTorch version,
and an assignment writes into the destination tensor in place.

``build_dir`` replaces the XLA cache directory: the CUDA libraries built
by ``_build.py`` and the generated Triton sources live there.
``ccsr_cache_mb`` is the JAX package's ``VEXTPU_CCSR_CACHE_MB`` budget,
``img_patch_mb`` its ``VEXTPU_IMG_PATCH_MB``.
"""

from __future__ import annotations

import os

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


def _env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "off", "no")


class _Config:
    def __init__(self) -> None:
        #: Print the generated source of each new expression kernel
        #: (VEXCL_SHOW_KERNELS, backend/opencl/compiler.hpp:114-119).
        self.show_kernels: bool = _env_flag("VEXTPU_SHOW_KERNELS")

        #: Size-consistency checking level for expressions
        #: (VEXCL_CHECK_SIZES, operations.hpp:1442-1458): 0 = off,
        #: 2 = every elementwise vector must match the assignment size.
        self.check_sizes: int = int(os.environ.get("VEXTPU_CHECK_SIZES", "2"))

        #: Cache built expression kernels in memory (VEXCL_CACHE_KERNELS).
        self.cache_kernels: bool = _env_flag("VEXTPU_CACHE_KERNELS", True)

        #: Where kernels are built: the nvcc library and the generated
        #: Triton modules (the $HOME/.vexcl binary cache analog,
        #: backend/common.hpp:215-232).  Defaults to ``_build/`` inside
        #: the package, which .gitignore lists.
        self.build_dir: str = os.environ.get(
            "VEXTPU_TORCH_BUILD_DIR", os.path.join(_PKG_DIR, "_build"))

        #: Device memory (MiB) up to which ``SpMatCCSR`` keeps its DIA
        #: expansion (VEXTPU_CCSR_CACHE_MB, the JAX package's budget): 256
        #: admits the 256^3 Poisson matrix (7 bf16 planes, 224 MiB).
        self.ccsr_cache_mb: int = int(
            os.environ.get("VEXTPU_CCSR_CACHE_MB", "256"))

        #: Device memory (MiB) up to which a linearly sampled ``image2d``
        #: keeps its bilinear patch table, four texels a row
        #: (VEXTPU_IMG_PATCH_MB, the JAX package's budget): 1024 admits
        #: 4 x 4096^2 f64 texels (512 MiB); the default is the sweep's
        #: (``scripts/torch_image_turns.py --sweep``, PERF.md §6).
        self.img_patch_mb: int = int(
            os.environ.get("VEXTPU_IMG_PATCH_MB", "1024"))


config = _Config()
