#!/usr/bin/env python3
"""The scatter's form A (``ops/cuda_scatter.scatter_ranges``) at other
cuts, for choosing ``TILES``, ``STAGE_BYTES`` and ``RANGE_BYTES``:

    python3 scripts/torch_scatter_variants.py [--json FILE]

scatters 2^24 f32 and f64 values through a random permutation (the
sizes of ``chip_smoke.py``'s phase 13) under each cut of ``GRID`` and
prints one JSON line: for each dtype and cut, the plan and the
profiler's device µs a call of each of the four kernels and their sum.
Each result is checked against ``index_copy_`` first (bitwise).
"""

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 24
#: (TILES, STAGE_BYTES, RANGE_BYTES) to time
GRID = [(512, 192 << 10, 1 << 17), (1024, 192 << 10, 1 << 17),
        (1024, 96 << 10, 1 << 17), (2048, 48 << 10, 1 << 17),
        (4096, 24 << 10, 1 << 17), (1024, 96 << 10, 1 << 16)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from chip_smoke import profile_call, smi_line
    from vexcl_tpu_torch.ops import cuda_scatter as cs

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    out = {"card": smi_line(), "runs": []}
    kept = (cs.TILES, cs.STAGE_BYTES, cs.RANGE_BYTES)
    try:
        for dt in (torch.float32, torch.float64):
            x = torch.rand(N, generator=gen, device=dev, dtype=dt)
            want = torch.zeros_like(x).index_copy_(0, perm.long(), x)
            y = torch.zeros_like(x)
            for cut in GRID:
                cs.TILES, cs.STAGE_BYTES, cs.RANGE_BYTES = cut
                y.zero_()
                cs.scatter_ranges(y, perm, x, "store")
                assert torch.equal(y, want), (dt, cut)
                per_kernel, _ = profile_call(
                    lambda: cs.scatter_ranges(y, perm, x, "store"), 20)
                out["runs"].append({
                    "dtype": str(dt), "tiles": cut[0], "stage_bytes": cut[1],
                    "range_bytes": cut[2],
                    "plan": cs.range_plan(N, N, x.element_size())._asdict(),
                    "kernels": per_kernel,
                    "device_us": sum(per_kernel.values())})
                print(json.dumps(out["runs"][-1]), file=sys.stderr)
    finally:
        cs.TILES, cs.STAGE_BYTES, cs.RANGE_BYTES = kept
    line = json.dumps(out)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
