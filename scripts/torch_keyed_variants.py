#!/usr/bin/env python3
"""Variants of the keyed kernel's source (``csrc/by_key.cuh``), built and
timed in one process on the card:

    python3 scripts/torch_keyed_variants.py [BATCH ...]

builds, all at once, the 4-byte library (``by_key.cu``: f32, i32) with
``kKeyBatch`` (the 16-byte key loads a thread keeps in flight) set to
each BATCH (default 2 4 8), and the whole kernel as one library of 15
kernels (every value type, as the first design built it), each with
``nvcc --time`` and ``-Xptxas -v``.  Prints one JSON line: per variant the
wall seconds of its build, nvcc's cicc and ptxas seconds, the most spill
bytes ptxas reports for a function, and, for the batch variants, the
profiler's device µs a call of ``inclusive_scan_by_key`` and
``reduce_by_key`` at 2^24 f32 values, i32 keys in runs of 64, the
variants in turns (forwards, then backwards), after a check that each
gives the shipped library's bits.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, RUN = 1 << 24, 64


def main() -> None:
    sys.path.insert(0, HERE)
    from chip_smoke import profile_call
    from vexcl_tpu_torch import _build
    from vexcl_tpu_torch.config import config
    from vexcl_tpu_torch.ops.cuda_by_key import (reduce_by_key_apply,
                                                 scan_by_key_apply)

    batches = [int(b) for b in sys.argv[1:]] or [2, 4, 8]
    header = open(os.path.join(_build.CSRC_DIR, "by_key.cuh")).read()
    stub = open(os.path.join(_build.CSRC_DIR, "by_key.cu")).read()
    os.makedirs(config.build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="by_key_variants_", dir=config.build_dir)
    with open(os.path.join(_build.CSRC_DIR, "scan_common.cuh")) as f:
        common = f.read()
    open(os.path.join(tmp, "scan_common.cuh"), "w").write(common)
    assert "constexpr int kKeyBatch = " in header
    sources = {}
    for b in batches:
        sources[f"batch{b}"] = (re.sub(r"constexpr int kKeyBatch = \d+;",
                                       f"constexpr int kKeyBatch = {b};",
                                       header), stub)
    sources["one_library"] = (header, stub.replace(
        "by_key_entry<float, int32_t>",
        "by_key_entry<float, double, int32_t, int64_t, __nv_bfloat16>"))
    jobs = {}
    for name, (hdr, cu) in sources.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        open(os.path.join(d, "by_key.cuh"), "w").write(
            hdr.replace('#include "scan_common.cuh"',
                        '#include "../scan_common.cuh"'))
        open(os.path.join(d, "by_key.cu"), "w").write(cu)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "--time",
               os.path.join(d, "time.csv"), "-Xptxas", "-v", "-o",
               os.path.join(d, "lib.so"), os.path.join(d, "by_key.cu")]
        jobs[name] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {"card": torch.cuda.get_device_name(0)}
    for name, (t0, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        phases = {}
        for row in open(os.path.join(tmp, name, "time.csv")).readlines()[1:]:
            cols = [c.strip() for c in row.split(",")]
            if len(cols) > 6 and cols[1] in ("cicc", "ptxas"):
                phases[cols[1] + "_s"] = float(cols[6]) / 1e3
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        out[name] = {"build_s": time.perf_counter() - t0, **phases,
                     "max_spill_bytes": max(spills, default=0)}

    dev = torch.device("cuda")
    keys = (torch.arange(N, device=dev, dtype=torch.int32) // RUN,)
    x = torch.rand(N, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    y = torch.empty_like(x)
    shipped = _build.cuda_library("vexcl_by_key")
    want = (scan_by_key_apply(keys, x).clone(),
            reduce_by_key_apply(keys, x)[1].clone())
    libs = {f"batch{b}": ctypes.CDLL(os.path.join(tmp, f"batch{b}",
                                                  "lib.so"))
            for b in batches}
    order = list(libs)
    for turn in range(2):
        for name in order if turn == 0 else order[::-1]:
            _build._libs["vexcl_by_key"] = libs[name]
            got = (scan_by_key_apply(keys, x),
                   reduce_by_key_apply(keys, x)[1])
            assert all(torch.equal(a, b) for a, b in zip(got, want)), name
            row = out[name].setdefault("device_us", {"scan_by_key": [],
                                                     "reduce_by_key": []})
            for call, fn in (
                    ("scan_by_key",
                     lambda: scan_by_key_apply(keys, x, out=y)),
                    ("reduce_by_key", lambda: reduce_by_key_apply(keys, x))):
                per_kernel, _ = profile_call(fn, 20)
                row[call].append(sum(v for k, v in per_kernel.items()
                                     if "by_key" in k))
    _build._libs["vexcl_by_key"] = shipped
    print(json.dumps(out))


if __name__ == "__main__":
    main()
