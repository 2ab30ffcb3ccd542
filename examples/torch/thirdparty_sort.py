#!/usr/bin/env python
"""A third-party sort beside ``vex.sort`` (examples/thirdparty_sort.py's
counterpart), through the PyTorch/CUDA port::

    python examples/torch/thirdparty_sort.py            # the cards, 2^22
    python examples/torch/thirdparty_sort.py --device cpu --log2 12

The reference hands a vector's device buffer to Thrust; the JAX package
exchanges it with torch through its interop layer.  In the port a
vector's storage is a torch tensor on its device, so the exchange is the
tensor itself: ``torch.sort`` runs on the same device over the same
memory, and the two are timed by CUDA events on the card (the host clock
on the CPU), each on a fresh copy of the keys.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import vexcl_tpu_torch as vex  # noqa: E402
from _common import context, device_name, ms_per_call  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the cards)")
    ap.add_argument("--log2", type=int, default=22,
                    help="the number of keys, a power of two")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    ctx = context(args.device)
    print(ctx)
    n = 1 << args.log2
    x = vex.vector(n, dtype=np.int32, context=ctx)
    x[:] = vex.cast(np.int32, vex.Random()(vex.element_index(), 42)
                    * (1 << 30))
    keys = x.storage.clone()        # the unsorted keys, a tensor

    y = vex.vector(data=keys.clone(), context=ctx)
    vex.sort(y)
    t = torch.sort(keys).values     # the same device, the same tensor type
    assert bool((y.storage[1:] >= y.storage[:-1]).all()), "vex.sort"
    assert torch.equal(y.storage, t), "vex.sort differs from torch.sort"
    print("check vex.sort and torch.sort give the same keys: ok")

    def vex_sort():
        v = vex.vector(data=keys.clone(), context=ctx)
        vex.sort(v)
        return v

    name = device_name(ctx)
    for who, fn in (("vex.sort", vex_sort),
                    ("torch.sort", lambda: torch.sort(keys.clone()).values),
                    ("the copy alone", keys.clone)):
        ms = ms_per_call(fn, ctx, args.reps)
        print(f"{who:>14}: {ms:.4f} ms ({n / ms / 1e3:.1f} Mkeys/s) on "
              f"{name}")


if __name__ == "__main__":
    main()
