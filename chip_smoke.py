#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vexcl_tpu_torch``) on one GPU.

Drives the port's main path through its public API and holds each of its
hand-written kernels against its plain PyTorch version on the same
inputs:

    python3 chip_smoke.py [--seed 0] [--json results.json] [--profile]
                          [--spills 32 256 ...]

Phases: (1) the card and the kernel builds (one nvcc per CUDA source, all
at once); (2) expressions and reductions at N = 2^24 (and 2^24 + 12345
for the reduction tail) in f32 and f64, MIN and MAX with a NaN too; (3)
the DIA SpMV on Poisson 256^3 (bf16 planes with f32 x, f64 planes with
f64 x); (4) ``PoissonSolver(256).solve(f, maxiter=100)`` in f32 against
the same CG in plain PyTorch f64 on the card; (5) the 1-D stencil at the
bench's 2^26 f32 configuration (width 5), in place too, an asymmetric
255-tap stencil, f64, a ``StencilOperator`` and n < width; (6) the
irregular SpMV on the bench's lognormal matrix (2^20 rows, ~16.3M
entries) through ``SpMat``, which picks CSR on the card (the policy of
``sparse.default_format``), and through ``fmt="sellr"``, in f32 and f64:
the SELL kernel and cuSPARSE on the same rows (those SELLR keeps in its
slices), SELLR's product (SELL and its CSR tail), the CSR kernel and
cuSPARSE on the whole matrix, timed in turns (with ``--spills``, the
SELL kernel and SELLR's product at other spill lengths too); then the
ell and hyb formats; (7)
``SpMatCCSR`` on Poisson 64^3 and 256^3 against the DIA ``SpMat``; (8)
``interop.cg`` in f32 on the shifted graph Laplacian of the phase-6
matrix (~33M entries, the default format) against the same CG in plain
PyTorch f64 on the card; (9) the scan family at the bench's sizes
(bench.py:474-660): ``inclusive_scan`` of 2^24 f32 (and 2^24 + 12345, in
place, f64), running MAX and MIN with a NaN, ``inclusive_scan_by_key``
and ``exclusive_scan_by_key`` over i32 keys in runs of 64 (each call one
launch of the keyed kernel, bit for bit the route it replaced: flags by
tensor compares, ``segscan``, the epilogue), ``reduce_by_key`` of 2^24
(runs of 64: one launch, bit for bit the ``segscan`` + ``compact``
route; the same call with a Python ``key_eq``, which takes that route)
and 2^25 + 7 (lognormal runs) values, ``sort_by_key`` of 2^24 (i32 key,
f32 value) pairs, and COO -> CSR of the phase-6 matrix from shuffled
triples (sort_by_key, then reduce_by_key, then exclusive_scan) against
the host CSR, exactly; the keyed kernel's two rows time it in turns with
the route it replaced, called directly; (10)
random numbers at the bench's 2^24 (bench.py:524): ``x[:] =
rnd(element_index(), seed)`` for the philox, threefry and hw generators,
uniform and normal, f32 and f64, against their plain versions, hw against
philox bit for bit, Random123's six known answers through the Philox
kernel and the fused rounds, ``philox_bits`` timed beside ``torch.rand``
(the Philox4x32-10 family, not the same stream), ``estimate_pi`` (2^24
throws) and ``gbm_terminal_mean`` (2^20 paths, 64 steps) against their
plain versions and the analytic answers; (11) the runtime: user CUDA
kernels (``y = 3*x``, a two-input axpy) and a user Triton kernel through
``CustomKernel`` and ``launch`` at 2^24 f32, events, ``enqueue`` onto the
card, a dlpack round trip, the profiler around the gbm run, and
``interop.bicgstab`` in f32 on the phase-6 matrix made non-symmetric and
diagonally dominant, against the same BiCGStab in plain PyTorch f64 on
the card; (12) fused multi-assignment: ``LorenzEnsemble(2^22)`` as
bench.py:721 builds it, in f32 and f64, 1 and then 99 steps (one launch
of the k-output kernel a step, by the counter and the profiler) against
the plain version of the same recorded tree and a hand-written CUDA RK4
kernel launched through ``CustomKernel``, then the step and the raw
kernel timed in turns (``lorenz_rk4_Gsteps_s``,
``lorenz_overhead_vs_raw_cuda``: the median of the turns' ratios);
``tie(x, y) = (x + y, x - y)`` and the swap at 2^24 f32, a 3-component
multivector with ``+=`` and a builtin, ``make_temp`` over it, a
``vex.function`` body, ``Reductor(MIN_MAX)`` (exact; with a NaN; timed
in turns with ``torch.aminmax``), ``SUM_Kahan`` of 1.0 followed by 2^24
values of 1e-8 (within 2 f32 ulp of the f64 sum, and closer than
``torch.sum``), ``Reductor(SUM)`` over the multivector,
``CombineReductors(SUM, MIN, MAX)``, the phase-6 matrix times a
3-component multivector and its values as an (nnz, 2) vector-valued
matrix, and ``enqueue`` onto a ``tie`` of CPU vectors; (13) views on
the 4096 x 4096 grid (2^24 elements): the grid interior ``2 *
slc[r(1, n-1), r(1, n-1)](x)`` in f32 and f64, a transpose through
``reshape`` in f32 and f64 and a 3-D ``reshape`` of order (2, 0, 1) at
2^24 f32 (the tiled kernel, ``assign_tiled_kernel``), a permutation and
a ``raw_pointer`` gather at 2^24 f32 (the assignment kernel's indexed
loads, V1, each bitwise against its plain version and over two calls,
in one launch, timed in turns with ``torch.mul``, ``.t().contiguous()``,
``permute(...).contiguous()`` and ``index_select``; the permutation
with the gather's route turned off), the gather through the permutation
in f32 and f64 (the gather form, ``csrc/gather.cu``: one call of its
three kernels an API call and no V1 launch, bitwise against its plain
version and ``index_select``, in turns with ``index_select``, with the
device µs of each kernel), ``reduce_view``
row sums in f32 and f64, column sums in f32 and f64 (the reduced range
split across programs) and column maxima with a NaN in f32 and f64 (V2,
the same bits over two calls, in turns with ``sum`` and ``amax``), a
``multi_array`` of 256^3 f64 with slabs written through
``indices[i][_][_]`` (the view-assignment kernel, V3) and summed over its
last axis (V2), a scatter through a permutation in f32 and f64 (form A of
the scatter kernels, ``csrc/scatter.cu``, in turns with
``index_copy_``), the histogram ``eval(atomic_add(permutation(k)(h),
1))`` of 2^24 i32 keys into 2^16 bins (form B, in turns with
``bincount``) and an f32 atomic add of values (form B, in turns with
``index_add_``), each API call launching its form and neither V3's
Triton kernel nor K1, and V3's Triton kernel on the same scatter and
histogram with the route turned off, ``any_of``/``all_of`` (the
map-reduce), and
``tensordot`` of two 4096^2 f32 views; (14) the FFT at the bench's
sizes (``FFT_CASES``: 1-D c64 at 2^10, 2^16, 2^20 and 2^24, 2-D 1024^2,
4096 x 2^10 batched over ``dims=(1,)``, the prime 999983, f64 at 2^20)
through the API (cuFFT, straight into the target) against
``torch.fft.fftn`` in c128 on the same input and back through the
inverse, timed in turns with a raw ``torch.fft.fftn`` call (GFLOP/s as
5 N log2 N under the bench's names), the ``"ct"`` engine at 2^20 and
2^24; ``p[:] = fx * conj(fx)`` and ``Reductor(SUM)(fx)`` at 2^24 c64 and
c128 (one generated launch each by the counters and the profiler,
against their plain forms, in turns with ``torch.mul(fx, fx.conj())``
and ``torch.sum``); the FFT API's host µs a call beside the raw call's,
and at 2^24 its device µs with no copy after cuFFT (the profiler); and
MBA (bench.py's fit: 4096 samples, grid 8 x 8, 6 levels, a 259^2
lattice) at 2^24 f32 and f64 points: ``z[:] = interp(X, Y)`` one launch
of the CUDA kernel (``csrc/mba.cu``) and no V1 launch, the kernel
against its plain version and the f64 host evaluation, in turns with
V1's tree (``mba_Mpts_s``), and in f32 the tree through the API and the
patch form on V1; (15) every catalog builtin's kernel form once at 2^20
(f32 operands, i32 for the integer helpers) against its plain form
element by element, and
boolean ``+``, ``*``, ``//``, ``%``, ``**``, orders and ``select`` in
the generated kernel; ``select`` and integer ``**`` at 2^24 (one launch
each through the API) in turns with ``torch.where`` and ``torch.pow``;
five advanced slicer keys (an index array beside an integer, two arrays
adjacent and separated, a broadcast array of one element; one V1 launch
each, bitwise against the plain form) and ``slicer((4096, 4096))[i,
j](x)`` at 2^24 alone (one call of the fused variant of the gather form
of ``csrc/gather.cu``, no V1 launch; bitwise against the plain form, V1
forced and PyTorch's advanced indexing, in turns with both; the
``advanced_index`` row is V1's, the fused variant's is under
``gather_coords``); ``z[:] = img(X, Y)`` of a 4096^2 f32 ``image2d`` at
2^24 points drawn uniformly over it: bilinear through the patch table
(one V1 launch, the table's build timed, in turns with the four taps,
the parent's form), nearest through the fused variant (in turns with
V1), each in turns with its plain form and ``grid_sample`` on the
normalised grid (the library column), its bound the image, X, Y and z
moved once at the card's memory rate (``stream_bound_ms``: at the rate
of a 2^26 f32 copy measured in the same process); ``svm_vector``'s
map/unmap
and ``Filter.Exclusive`` on the card; (16) gradients through the
generator's kernels: ``LorenzEnsemble(2^22)`` as phase 12 builds it, in
f32 and f64, ``torch.autograd.grad`` of sum(w (x_T + y_T + z_T)) after
4 steps of ``_step.as_function()`` in x0, y0, z0 and R (one backward
launch a step, by the counter; one kernel a backward call, by the
profiler) against the same adjoint trees' plain forms stepped back from
the plain forward and against PyTorch's autograd over the forward's
plain forms; the backward kernel of one step alone (events on prepared
arguments and through the API, device and host µs, its plain version,
PyTorch's autograd over one step's plain forms for scale); a second
derivative (x and a 0-d a, f64, 2^20) against the second backward
kernel's plain forms; ``torch.func.vmap`` over a (4, 2^20) batch (one
launch, the four unbatched calls' bits); every float and complex type
cast into every integer type at 2^20 values with NaN, the infinities,
the limits and their neighbours (one K1 launch a source type, bitwise
against the plain forms); and ``z_i32[:] = x_f32`` at 2^24 in turns
with the unsaturated store and ``Tensor.to``; (17) contexts of several
parts: ``Context(devices=[dev] * 4)``, four parts of the one card (and,
where the host has several cards, one part a card; else a line says the
phase did not repeat), each against one part on the same inputs:
``PoissonSolver(256).solve(f, maxiter=100)`` in f32 (DIA with halos, the
halo'd form of ``csrc/dia_spmv.cu``, and the per-part expressions and
Reductor dots; the same iteration count within one, x within 1e-3 of
the plain f64 CG), ``y[:] = A * x`` of its matrix, the 2^26 f32
width-5 and the 2^24 255-tap stencils, the lognormal matrix through
``SpMat`` over the parts (the JAX package's choice: more than 2^22
entries take the gathered x) and with ghost sets forced,
``inclusive_scan`` of 2^24 f32 (0/1 values and MAX bit for bit, normal
values within 1e-5), ``x[:] = rnd(element_index(), seed)`` at 2^24 and
the Reductor's SUM/MIN/MAX over it (launches a call: one a part; the
stencil's block and fix-up two; the scan one a part, one over the tails
and a carry pass a part after the first); then, one part against four in
turns, CG ms an iteration, the DIA and lognormal SpMV, the stencil and
the scan through the API, and host µs a call; (18) sort, the FFT, the
keyed scans, reduce_by_key and any_of/all_of over the four parts of the
one card, each against one part on the same inputs: ``sort_by_key`` of
2^24 uniform i32 keys in [0, 2^30) with f32 values and a descending f32
``sort`` (bit for bit; six merges), the 1-D FFT of 2^24 c64 forward and
inverse and the 2-D FFT of 4096^2 c64 (the four-step route: two cuFFT
executions and three, or two, tiled transposes a part, no gathered
transform; within FFT_PART_TOL of one part's cuFFT relative to its
largest magnitude), ``inclusive_scan_by_key`` of 2^24 f32 (within
PART_SCAN_TOL), exclusive with ``init`` over integer-valued values and
MAX (bit for bit), ``reduce_by_key`` likewise (counts and keys bit for
bit), over i32 keys in runs of 63 that straddle the parts and one run
longer than a part (a keyed launch, a map-reduce and a fix-up a part, one
segmented scan over the tails), ``any_of``/``all_of`` of a 2^24
expression (one map-reduce a part); then one part against four in turns
(events ms, three timings each) and host µs a call, and the device µs of
the four-step transform by the profiler; (19) views, gathers, scatters,
atomic updates, images and MBA over the four parts (``views_parts_phase``);
(20) the runtime over the four parts (``runtime_parts_phase``):
``enqueue`` of ``2*x + sin(x)``, the 5-tap stencil, the 1-D FFT of 2^24
c64 and a bilinear sample of the 4096^2 image at 2^24 points from four
parts onto one and from one onto four (no table copied on one card), the
user CUDA and Triton kernels and the halo kernel over ``with_halo`` at
2^24 (one launch a part), the Lorenz step's ``as_function`` at 2^22 in
f32 and f64 (one K1 launch a part), ``reinterpret`` to u16 and f64 and
``resize`` of 2^24 + 6 elements over unequal parts, a custom-op scan at
2^24, the lognormal 2^20 CSR matrix of one part times a four-part x,
``dryrun_multichip(4)`` at 2^24 and ``Context()``'s parts; each bit for
bit one part's (the four-step FFT within FFT_PART_TOL, the custom op's
carries within PART_SCAN_TOL), then one part against four in turns
(events ms), host µs a call and device µs by kernel; (21) gradients
through ``as_function`` of trees that read a view or a partial
reduction (``view_gradients_phase``): sum(w (permutation(p)(u + c) *
2)) over a 2^24 random permutation and over an index with duplicates
and keys out of range, f32 and f64, sum(w slicer[:, 1:4095](u + c)) and
reduce_view sum and max over the 4096^2 grid; each backward step's
launches by kernel (the scatter, V2, K1, V3: none of the plain
versions), its gradient against the same stages' plain versions (bit
for bit where no sum reorders: the permutation, the slice, the sum's
spread; the duplicates' adds SUM_TOL, the chooser rule TOL) and
against PyTorch's autograd over the forward's plain forms (GRAD_TOL),
the forward and the backward by events, device and host µs; then the
thirteen examples of ``examples/torch/`` in this process at the tier-1
test's sizes (``tests/test_torch_examples.CASES``), each printing its
verification lines.  Last, after
every solver phase (so that no solver follows
these timings' profiler session or cuSPARSE call), the device time per
call by the profiler of the map-reduce, the compaction (one and two
payloads, and ``x[flags]``), the irregular SpMV's SELL, CSR and
cuSPARSE products (cuSPARSE on the SELL kernel's rows and on the whole
matrix; f32 and f64), the scans (``scan`` and ``torch.cumsum`` in f32
and f64, ``segscan``; each scan call checked to be one kernel) and the
keyed kernel (``scan_by_key``, exclusive with ``init``, the
``reduce_by_key`` launch, each checked to be one kernel, and the routes
they replaced), and the DIA row's library call,
cuSPARSE's CSR product of the Poisson 256^3 matrix in f32 on phase 3's
x.  Each phase's launch counters are set to 0 just before its API
run and read just after.  Times come from CUDA events (kernels) or the host clock
around synchronised work (solves, construction).  The kernels line gives
each kernel's bound, the larger of its bytes over the card's 3.35 TB/s
and its operations over 67 TFLOP/s (f32, NVIDIA's H100 SXM data sheet;
for the integer Philox kernel, its SASS instructions per counter, read
with cuobjdump, over 132 SMs x 128 scheduler lanes x the card's maximum
SM clock; the SM's 4 schedulers x 32 thread instructions a clock are the
ceiling of integer work, which the INT32 and FMA pipes share), counted
from this run's inputs, and the time of one PyTorch call that
computes the same function where there is one (``library_ms``; the port
never calls it).  The map-reduce (``Sum(p*Ap)``, 256^3 f32), SELL, CSR,
compaction and scan rows time the kernel and its library call in turns
(kernel, library, library, kernel, ...: TURNS timings of 100 launches
each; the SELL row's library call is cuSPARSE on the rows SELLR keeps in
its slices, the same work; the scan's ``torch.cumsum``, in f32 and f64;
the segmented scan, which no PyTorch call computes, goes in turns with
the plain scan of the same values, ``scan_ms``) and give medians with
their ranges (``ms_range``, ``library_ms_range``), the device time per
call by the profiler (``device_us``) and the host's time per call on the
host clock without a sync (``host_us``; ``library_host_us`` for
``torch.dot``).  The
compaction row times one payload, as ``x[flags]`` moves one; its
``two_payload_*`` keys give the two-payload call that reduce_by_key
makes.

Tolerances, relative to the largest magnitude of the plain result:
f32 elementwise 1e-5 and f64 1e-12 (a few ulp: FMA contraction,
libdevice against PyTorch's math); sums 1e-5 (f32, another summation
order over 2^24 terms) and 1e-10 (f64); MIN and MAX exact, NaN where a
NaN is; the DIA kernel 1e-6 (f32) and 1e-12 (f64); the stencil 1e-5
(f32; 1e-4 for 255 taps) and 1e-12 (f64); the SELL and CSR kernels 1e-5
(f32, rows summed in another order) and 1e-12 (f64); f32 scans 1e-5
and f64 scans 1e-12, MAX/MIN scans and integer results exact, sums of
runs against f64 sums 1e-5.  The f32 CGs against the f64 CGs: 1e-3
(Poisson) and 1e-4 (Laplacian) in the 2-norm of x, by rounding alone.  The right-hand sides are zero-mean noise; the true
residual |b - A x| must fall at least 20-fold (Poisson, 100 iterations)
and 10^4-fold (Laplacian, to 1e-6 |b| or 100 iterations).  Random
numbers: uniforms and Philox words bitwise, normals 1e-5 (f32) and 1e-12
(f64); normal mean and spread within 5 sigma; pi-hat within 2e-3 of pi (5
sigma at 2^24), its count exact in f64 and within 16 points of the plain
count in f32 (FMA contraction of x*x + y*y moves points that lie on the
circle); the gbm mean within 1e-4 of the plain f64 recursion and 0.11 (5
sigma) of 100 e^0.05.  User kernels within 1e-6 of the tensor result.
BiCGStab: x within 1e-4 of the f64 solve, true residual below 1e-5 |b|.
The Lorenz ensemble against its plain version and the raw CUDA kernel:
f32 1e-5 after one step and 1e-4 after 100 (FMA contraction differs; the
system is chaotic), f64 1e-12 and 1e-10; moves, swaps, ``x + y`` and
MIN/MAX exact; multivector arithmetic 1e-5 (f32).  The k-output
kernel's row gives its device time by the profiler (``ms``; the events
of back-to-back calls read the host's launch, ``events_ms``).  Views:
gathers and stores with unique indices bitwise against their plain
versions, integer atomics exact, the f32 atomic add of values 1e-5
(another order), ``reduce_view`` sums 1e-5 (f32) and 1e-12 (f64), min
and max exact with the NaN, ``tensordot`` 1e-4 against the f64 product.
Each view assignment is one launch by its counter.  Phase 14: each FFT
within a relative L2 error of 1e-5 (c64) or 1e-12 (c128) of the c128
transform, the round trip within twice that; complex products 1e-6 (c64)
and 1e-13 (c128) of the largest magnitude (FMA contraction; no division
on the path), complex sums as the real sums; MBA's kernel (the tree's
operations in its order, uncontracted) and V1's tree 1e-5 (f32) and
1e-12 (f64) of the largest magnitude of the plain form, and 1e-4 (f32)
and 1e-10 (f64) absolute of the f64 host evaluation on 4096 points.
Phase 2 holds the generated kernel's integer ``//``, ``%`` and ``fmod``
with zero divisors bitwise against their plain forms.  Phase 15: each
builtin's kernel form within 8e-6 of the largest magnitude of its plain
form (f32; integer and boolean results, nearest samples and advanced
keys bitwise), non-finite values equal.  Phase 16: the Lorenz
gradients within 1e-5 (f32) and 1e-12 (f64) of the largest magnitude of
both oracles (FMA contraction; 4 steps), the second derivative 1e-12
(1e-10 for the 0-d sum), vmap and the casts bitwise.

Any failed check raises, and the script exits non-zero without the
result line; it also fails when no CUDA device is visible and when the
package is not next to it.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_VEC = 1 << 24
TAIL = 12345
POISSON_N = 256
CG_ITERS = 100
CG_X_TOL = 1e-3
CG_RESIDUAL_DROP = 20.0
TOL = {"f32": 1e-5, "f64": 1e-12}
MBA_HOST_TOL = {"f32": 1e-4, "f64": 1e-10}   # of the f64 host evaluation
#: the kernel of each form of ``cuda_mba.mba_eval`` (the profiler's name)
MBA_KERNEL = {"taps": "mba_kernel", "cluster": "mba_cluster_kernel",
              "band": "mba_cluster_kernel"}
SUM_TOL = {"f32": 1e-5, "f64": 1e-10}
DIA_TOL = {"f32": 1e-6, "f64": 1e-12}
STENCIL_N = 1 << 26
STENCIL_N_SMALL = 1 << 24
STENCIL_TOL = {"f32": 1e-5, "f32_wide": 1e-4, "f64": 1e-12}
RANDOM_N = 1 << 20
SPMV_TOL = {"f32": 1e-5, "f64": 1e-12}
BUILTIN_N = 1 << 20           # phase 15's size for every builtin
BUILTIN_TOL = 8e-6            # 4 x the card tests' f32 RTOL of 2e-6
IMG_GRID = 4096               # phase 15's image: 4096^2 f32
#: the builtins' operands, here and in the tests: each float operand
#: drawn over its builtin's domain, (-3, 3) where none is listed; the
#: integer helpers take integer operands (the arity is the catalog's)
BUILTIN_DOMAIN = {"acosh": (1.0, 3.0), "asin": (-1, 1), "acos": (-1, 1),
                  "atanh": (-0.99, 0.99), "log": (0.01, 3),
                  "log2": (0.01, 3), "log10": (0.01, 3), "log1p": (0, 3),
                  "sqrt": (0, 4), "rsqrt": (0.01, 4), "lgamma": (0.1, 5),
                  "pow": (0.1, 2), "powr": (0.1, 2), "pown": (0.1, 2),
                  "asinpi": (-1, 1), "acospi": (-1, 1), "rootn": (1, 3)}
BUILTIN_INTEGER = ("hadd", "rhadd", "bitselect", "select", "mad_hi",
                   "popcount", "clz", "rotate", "add_sat", "sub_sat",
                   "mad_sat", "mul_hi", "upsample", "__popc", "__popcll")
VIEW_GRID = 4096              # the views' 2-D grid: 2^24 elements
VIEW_N = VIEW_GRID * VIEW_GRID
VIEW_3D = (512, 256, 128)     # a 3-D reshape's output dims: 2^24 elements
MULTI_EXT = 256               # multi_array extents[256][256][256]
HIST_BINS = 1 << 16
VIEW_SUM_TOL = {"f32": 1e-5, "f64": 1e-12}
LAPLACE_CG_TOL = 1e-6         # stop at |r| <= 1e-6 |b| ...
LAPLACE_X_TOL = 1e-4          # ... and hold x within 1e-4 of the f64 CG
LAPLACE_RESIDUAL_DROP = 1e4
SCAN_TOL = {"f32": 1e-5, "f64": 1e-12}
RUN = 64                      # the bench's key runs (bench.py:584-609)
RBK_N_LARGE = (1 << 25) + 7
KERNEL_REPS = 100             # launches per timing of the kernels line
TURNS = 5                     # timings each of a kernel and its library call
STEP_REPS = 20                # backward steps per timing of phase 21
PROFILE_LEAD = 256            # spin kernels a trace launches first
PROFILE_TRIES = 4             # traces of one call, 4x the lead-in each
SPIN_KERNEL = "spin_kernel"   # torch.cuda._sleep's kernel
#: the lead-in records each trace of profile_call lost, in order
PROFILE_LOST: list = []
HOST_CALLS = 200              # calls timed on the host clock, no sync
HBM_BYTES_S = 3.35e12         # H100 SXM: NVIDIA's data sheet
F32_OPS_S = 67e12
F64_OPS_S = 34e12             # FP64 outside the tensor cores, the same sheet
# H100 SXM: 132 SMs, each issuing at most 4 warp instructions (128 thread
# instructions) a clock.  Integer work spreads over the 64-lane INT32 pipe
# and the FMA pipe (IMAD), so 64 lanes a clock is no ceiling for it
# (philox_bits ran below that figure); the schedulers' rate is.
SCHEDULER_LANES = 132 * 4 * 32
RNG_N = 1 << 24               # the bench's RNG size (bench.py:524)
RNG_TOL = {"f32": 1e-5, "f64": 1e-12}
PI_N = 1 << 24                # estimate_pi's default
PI_TOL = 2e-3                 # 5 sigma of pi-hat at 2^24 throws
PI_F32_FLIPS = 16             # f32 points FMA contraction may move across
GBM_PATHS, GBM_STEPS = 1 << 20, 64     # gbm_terminal_mean's defaults
GBM_PLAIN_TOL = 1e-4          # the f32 paths against the f64 recursion
GBM_MEAN = 100.0 * 2.718281828459045 ** 0.05   # s0 e^(mu T), T = 1
GBM_MEAN_TOL = 0.11           # 5 sigma of the mean over 2^20 paths
RUNTIME_N = 1 << 24
BICGSTAB_TOL = 1e-6           # stop at |r| <= 1e-6 |b| ...
BICGSTAB_X_TOL = 1e-4         # ... and hold x within 1e-4 of the f64 solve
BICGSTAB_MAXITER = 300        # ~75 iterations suffice at 2^16 rows
LORENZ_N = 1 << 22            # the bench's ensemble (bench.py:721)
LORENZ_STEPS = 100
LORENZ_TOL = {"f32": (1e-5, 1e-4), "f64": (1e-12, 1e-10)}  # 1, 100 steps
MULTI_N = 1 << 24
PARTS = 4                     # phase 17: the parts of one card's context
PART_TURN_ITERS = 20          # CG iterations a timed solve, one part and four
PART_SCAN_TOL = 1e-5          # an f32 add scan over parts: another association
FFT_PART_TOL = 1e-5           # the four-step c64 FFT against one part's cuFFT
KEY_RUN = 63                  # phase 18's key runs: they straddle the parts
FFT2D_SIDE = 4096             # phase 18's 2-D FFT: 4096^2 c64 (2^24 points)
VIEW_PART_REPS = 10           # phase 19: calls a timing, one part and four
RUNTIME_PART_REPS = 5         # phase 20: calls a timing, one part and four
SORT_REPS, FFT_REPS, KEYED_REPS = 3, 10, 20   # phase 18's calls a timing
GRAD_STEPS = 4                # phase 16: steps of the Lorenz gradient
GRAD_TOL = {"f32": 1e-5, "f64": 1e-12}   # of the largest magnitude
GRAD_N = 1 << 20              # the second derivative's and vmap's size
CAST_N = 1 << 20              # the saturating casts' bitwise check
#: phase 14's transforms at the bench's sizes (bench.py:793-875): name,
#: shape, transformed axes (None: all), type; the ct engine runs on FFT_CT
FFT_CASES = [("fft_2^10", (1 << 10,), None, "c64"),
             ("fft_2^16", (1 << 16,), None, "c64"),
             ("fft_2^20", (1 << 20,), None, "c64"),
             ("fft_2^24", (1 << 24,), None, "c64"),
             ("fft2d_1024", (1024, 1024), None, "c64"),
             ("fft_batched_2^10", (4096, 1 << 10), (1,), "c64"),
             ("fft_bluestein_999983", (999983,), None, "c64"),
             ("fft_2^20_f64", (1 << 20,), None, "c128")]
FFT_CT = ("fft_2^20", "fft_2^24")
#: phase 12's numbers before the launch records and the per-binding
#: analysis, as PERF.md records them (H100 80GB HBM3, 700.00 W), printed
#: beside this run's
PARENT_LORENZ = {
    "f32": {"host_us": "532.48-549.17 (scripts/torch_host_breakdown.py)",
            "step_ms": "0.541-0.632", "overhead": "10.97-14.59"},
    "f64": {"host_us": "not measured", "step_ms": "not measured",
            "overhead": "6.45-7.30"}}
MV_TOL = {"f32": 1e-5, "f64": 1e-12}
PHILOX_KATS = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
THREEFRY_KATS = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
    ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344),
     (0xC4923A9C, 0x483DF7A0))]
USER_CUDA = r"""
extern "C" __global__ void triple(const float* x, float* y, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) y[i] = 3.0f * x[i];
}
extern "C" __global__ void axpy(const float* x, const float* y, float* out,
                                long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = 2.0f * x[i] + y[i];
}
"""
# the "raw" comparator of the reference's published claim: one RK4 step
# of the Lorenz system written by hand, the operations in the order of
# LorenzEnsemble's recorded tree; x is read and the new x written to the
# output (CustomKernel's), y and z updated in place
RAW_LORENZ = r"""
template <typename T>
__device__ void rk4(const T* x, T* y, T* z, const T* R, T* xo, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const T s = T(10.0), b = T(8.0 / 3.0), h = T(0.01), h2 = T(0.5 * 0.01),
            h6 = T(0.01 / 6.0);
    T X = x[i], Y = y[i], Z = z[i], r = R[i];
    T ax = s * (Y - X), ay = r * X - Y - X * Z, az = X * Y - b * Z;
    T x2 = X + h2 * ax, y2 = Y + h2 * ay, z2 = Z + h2 * az;
    T bx = s * (y2 - x2), by = r * x2 - y2 - x2 * z2, bz = x2 * y2 - b * z2;
    T x3 = X + h2 * bx, y3 = Y + h2 * by, z3 = Z + h2 * bz;
    T cx = s * (y3 - x3), cy = r * x3 - y3 - x3 * z3, cz = x3 * y3 - b * z3;
    T x4 = X + h * cx, y4 = Y + h * cy, z4 = Z + h * cz;
    T dx = s * (y4 - x4), dy = r * x4 - y4 - x4 * z4, dz = x4 * y4 - b * z4;
    xo[i] = X + h6 * (ax + T(2) * bx + T(2) * cx + dx);
    y[i] = Y + h6 * (ay + T(2) * by + T(2) * cy + dy);
    z[i] = Z + h6 * (az + T(2) * bz + T(2) * cz + dz);
}
extern "C" __global__ void lorenz_f32(const float* x, float* y, float* z,
                                      const float* R, float* xo,
                                      long long n) {
    rk4(x, y, z, R, xo, n);
}
extern "C" __global__ void lorenz_f64(const double* x, double* y, double* z,
                                      const double* R, double* xo,
                                      long long n) {
    rk4(x, y, z, R, xo, n);
}
"""
USER_TRITON = """import triton
import triton.language as tl


@triton.jit
def axpy(x_ptr, y_ptr, out_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    x = tl.load(x_ptr + offs, mask=m)
    tl.store(out_ptr + offs, 2.0 * x + tl.load(y_ptr + offs, mask=m), mask=m)
"""


# the unsaturated f32 -> i32 store, for the cost of the saturating one:
# the assignment kernel's shape (BLOCK 1024, 4 warps) with a plain .to()
RAW_CAST = """import triton
import triton.language as tl


@triton.jit
def cast_f32_i32(x_ptr, out_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    tl.store(out_ptr + offs, tl.load(x_ptr + offs, mask=m).to(tl.int32),
             mask=m)
"""


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean time of fn() over reps launches, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns, reps: int = KERNEL_REPS):
    """Functions timed in turns (in the given order, then reversed, ...),
    TURNS timings of ``reps`` launches each: name -> {"ms": median,
    "ms_range": [min, max], "times": [each timing, in turn order]}."""
    got = {name: [] for name in fns}
    order = list(fns)
    for r in range(TURNS):
        for name in (order if r % 2 == 0 else order[::-1]):
            got[name].append(cuda_ms(fns[name], reps))
    return {name: {"ms": statistics.median(v), "ms_range": [min(v), max(v)],
                   "times": v}
            for name, v in got.items()}


def turns_row(turns, kernel, library):
    """The kernels line's timing keys from ``in_turns``: the kernel's and
    its library call's medians and ranges."""
    return {"ms": turns[kernel]["ms"], "ms_range": turns[kernel]["ms_range"],
            "library_ms": turns[library]["ms"],
            "library_ms_range": turns[library]["ms_range"]}


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host clock per call over ``calls`` calls without a sync, after one:
    fewer launches than the launch queue holds, so it reads what the host
    spends to enqueue a call, not the device's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def bound(nbytes, nops=0, ops_s=F32_OPS_S):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over their peak rate (f32 unless
    another is given)."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, nops / ops_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_row(abs_err, ms, plain_ms, nbytes, nops, library_ms,
               ops_s=F32_OPS_S):
    b, by = bound(nbytes, nops, ops_s)
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms}


def scheduler_ops_s() -> float:
    """The card's thread-instruction rate: 132 SMs x 4 schedulers x 32
    lanes x its maximum SM clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return SCHEDULER_LANES * float(out.stdout.split()[0]) * 1e6


def sass_instructions(library: str, function: str) -> int:
    """Per-thread instructions of a straight-line kernel in its SASS
    (cuobjdump -sass): without the NOP padding, the closing self-branch
    and the uniform datapath's instructions (U*), which run once per
    warp."""
    import re
    import shutil

    from vexcl_tpu_torch._build import _nvcc

    exe = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([exe, "-sass", "-fun", function, library],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                     out, re.MULTILINE)
    n = sum(op not in ("NOP", "BRA") and not op.startswith("U")
            for op in ops)
    check(n > 0, f"no SASS for {function} in {library}")
    return n


def plain_bicgstab(mv, b, tol, maxiter):
    """BiCGStab in plain PyTorch with the port's recurrences and stopping
    rule (the JAX package's, interop.py:142-198)."""
    import torch

    eps = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    r = b - mv(x)
    rhat = r.clone()
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = 1.0
    rr = torch.dot(r, r).item()
    it = 0
    while rr > tol * tol and it < maxiter:
        rho_new = torch.dot(rhat, r).item()
        beta = (rho_new / (rho + eps)) * (alpha / (omega + eps))
        p = r + beta * (p - omega * v)
        v = mv(p)
        alpha = rho_new / (torch.dot(rhat, v).item() + eps)
        s = r - alpha * v
        t = mv(s)
        omega = torch.dot(t, s).item() / (torch.dot(t, t).item() + eps)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        rr = torch.dot(r, r).item()
        it += 1
    return x, it


def dag_ops(exprs):
    """Operations an element of a fused assignment does: the nodes of
    its expressions' DAG that are not leaves, each counted once."""
    seen, stack = set(), list(exprs)
    while stack:
        e = stack.pop()
        if id(e) not in seen and e.children:
            seen.add(id(e))
            stack.extend(e.children)
    return len(seen)


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def random_lognormal_csr(n, mean=16.0, sigma=0.8, seed=0):
    """The bench's irregular matrix (bench.py ``_random_lognormal_csr``):
    lognormal row lengths (mean ~16), uniform random columns, f32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mu = np.log(mean) - sigma * sigma / 2
    lens = np.maximum(1, rng.lognormal(mu, sigma, n).astype(np.int64))
    ptr = np.concatenate([[0], np.cumsum(lens)])
    nnz = int(ptr[-1])
    col = rng.integers(0, n, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    return ptr, col, val, nnz


def shifted_laplacian(n, ptr, col, val):
    """CSR of the shifted graph Laplacian of S: off-diagonal entries
    -(|S| + |S|^T), diagonal the absolute off-diagonal row sum + 1
    (symmetric and strictly diagonally dominant, hence SPD)."""
    import numpy as np

    rows = np.repeat(np.arange(n), np.diff(ptr))
    off = rows != col
    a = np.abs(val[off]).astype(np.float64)
    r = np.concatenate([rows[off], col[off], np.arange(n)])
    c = np.concatenate([col[off], rows[off], np.arange(n)])
    diag = np.bincount(r[:-n], weights=np.concatenate([a, a]), minlength=n)
    v = np.concatenate([-a, -a, diag + 1])
    order = np.argsort(r, kind="stable")
    lap_ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return lap_ptr, c[order], v[order]


def plain_cg(mv, b, tol, maxiter):
    """CG in plain PyTorch with the port's stopping rule."""
    import torch

    x = torch.zeros_like(b)
    r = b - mv(x)
    p = r.clone()
    rs = torch.dot(r, r).item()
    it = 0
    while rs > tol * tol and it < maxiter:
        Ap = mv(p)
        alpha = rs / torch.dot(p, Ap).item()
        x += alpha * p
        r -= alpha * Ap
        rs_new = torch.dot(r, r).item()
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return x, it


def errors(k, p):
    """(max abs error, max abs error / max |plain|) in f64."""
    import torch

    k, p = k.double(), p.double()
    check(torch.isfinite(k).all().item(), "kernel result is not finite")
    abs_err = (k - p).abs().max().item()
    return abs_err, abs_err / max(p.abs().max().item(), 1e-300)


def profile_call(fn, reps: int = 10):
    """Device time per call by kernel name (µs), and the device's busy
    share of the wall time, over reps calls traced by torch.profiler.

    On the H100's host the profiler drops the first device records of a
    trace, more of them the longer the process has run (one more every
    ~14 s in one run, all 100 of a loop in another): so each trace first
    launches ``lead`` spin kernels (``torch.cuda._sleep``, not counted),
    which take the loss.  A trace in which none of them is left may have
    lost the loop's records too, and one that kept no record of the loop
    did (a trace can keep spin records and lose all of the loop's):
    either is taken again with four times as many, up to PROFILE_TRIES
    traces; then the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    lead = PROFILE_LEAD
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        spins = sum(e.count for e in seen if SPIN_KERNEL in e.key)
        PROFILE_LOST.append(lead - spins)
        # a trace that kept none of the calls' records lost them too
        if spins and any(SPIN_KERNEL not in e.key for e in seen):
            break
        lead *= 4
    else:
        raise SmokeFailure(f"the profiler lost every one of {lead // 4} "
                           "lead-in records, or every record of the "
                           "calls, in each of its traces")
    kernels = {e.key[:60]: e.self_device_time_total / reps for e in seen
               if SPIN_KERNEL not in e.key}
    busy = sum(kernels.values()) * reps * 1e-6 / wall
    return dict(sorted(kernels.items(), key=lambda kv: -kv[1])), busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", help="also write every result to this file")
    ap.add_argument("--profile", action="store_true",
                    help="also trace ten Laplacian CG iterations, phase 9's "
                         "API calls and the Monte-Carlo models with "
                         "torch.profiler and print the device time of each "
                         "kernel")
    ap.add_argument("--spills", type=int, nargs="*", default=[],
                    help="also time, in phase 6's turns, the SELL kernel and "
                         "SELLR's product with rows spilled over each of "
                         "these lengths instead of LONG_ROW")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA GPU")
    sys.path.insert(0, HERE)
    import vexcl_tpu_torch as vex

    check(os.path.dirname(os.path.abspath(vex.__file__)).startswith(HERE),
          "vexcl_tpu_torch does not come from this checkout")
    check("jax" not in sys.modules and "vexcl_tpu" not in sys.modules,
          "the port imported jax or vexcl_tpu")
    from vexcl_tpu_torch._build import build_cuda_libraries
    from vexcl_tpu_torch.expr.compile import prepare, prepare_multi
    from vexcl_tpu_torch.expr.compile import prepare_view_assign
    from vexcl_tpu_torch.expr.triton_emit import (assign, assign_indexed,
                                                  assign_multi,
                                                  assign_multi_plain,
                                                  assign_plain)
    from vexcl_tpu_torch.expr.triton_emit import (
        assign_to_view as assign_to_view_kernel)
    from vexcl_tpu_torch.expr.triton_emit import (_gather_operands,
                                                  _scatter_operands)
    from vexcl_tpu_torch.ops import cuda_gather, cuda_scatter
    from vexcl_tpu_torch.ops.cuda_gather import gather_plain, gather_ranges
    from vexcl_tpu_torch.ops.cuda_scatter import (scatter_plain,
                                                  scatter_privatized,
                                                  scatter_ranges)
    from vexcl_tpu_torch.ops.triton_reduce_view import (prepare_reduce_view,
                                                        reduce_view_apply,
                                                        reduce_view_plain)
    from vexcl_tpu_torch.models import LorenzEnsemble, PoissonSolver
    from vexcl_tpu_torch.ops.cuda_by_key import (reduce_by_key_launch,
                                                 reduce_by_key_plain,
                                                 scan_by_key_apply,
                                                 scan_by_key_epilogue,
                                                 scan_by_key_plain,
                                                 segment_heads)
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply, compact_plain
    from vexcl_tpu_torch.ops.cuda_scan import (scan_apply, scan_plain,
                                               segscan_apply, segscan_plain)
    from vexcl_tpu_torch.ops.cuda_stencil import stencil_apply, stencil_plain
    from vexcl_tpu_torch.ops.triton_reduce import (kahan_sum_plain,
                                                   map_reduce,
                                                   map_reduce_multi,
                                                   map_reduce_multi_plain,
                                                   map_reduce_plain)
    from vexcl_tpu_torch.sparse.cuda_dia import dia_matvec, dia_matvec_plain
    from vexcl_tpu_torch.sparse import SELLR, default_format, sell
    from vexcl_tpu_torch.sparse.cuda_sell import (csr_spmv, csr_spmv_plain,
                                                  sell_spmv, sell_spmv_plain)
    from vexcl_tpu_torch.sparse.sell import LONG_ROW
    from vexcl_tpu_torch.utils.poisson import poisson_7pt, poisson_7pt_ccsr
    from vexcl_tpu_torch._build import _library_path, triton_module
    from vexcl_tpu_torch.models import estimate_pi, gbm_terminal_mean
    from vexcl_tpu_torch.ops.cuda_philox import philox_bits, philox_bits_plain
    from vexcl_tpu_torch.ops.random import generator_rounds
    from vexcl_tpu_torch.expr.triton_emit import assign_complex
    from vexcl_tpu_torch.ops.mba import _eval_level_host as mba_host
    from vexcl_tpu_torch.ops.mba import mba_device_eval
    from vexcl_tpu_torch.ops import cuda_mba
    from vexcl_tpu_torch.ops.cuda_mba import mba_eval, mba_plain
    from vexcl_tpu_torch.ops.cufft import execute as cufft_execute
    from vexcl_tpu_torch.ops.triton_reduce import map_reduce_complex
    from vexcl_tpu_torch import generator as tgen
    from vexcl_tpu_torch.generator import backward as generator_backward
    from vexcl_tpu_torch.sparse.cuda_dia import (dia_matvec_halo,
                                                 dia_matvec_halo_plain)
    from vexcl_tpu_torch.sparse.distributed import distributed
    from vexcl_tpu_torch.parallel.halo import exchange_halos

    results = {"seed": args.seed}
    start_s = time.perf_counter()
    counters = {"expr": assign, "reduce": map_reduce, "dia": dia_matvec,
                "stencil": stencil_apply, "sell": sell_spmv,
                "csr": csr_spmv, "scan": scan_apply,
                "segscan": segscan_apply, "compact": compact_apply,
                "scan_by_key": scan_by_key_apply,
                "reduce_by_key": reduce_by_key_launch,
                "philox": philox_bits, "custom": vex.CustomKernel,
                "multi": assign_multi, "reduce_multi": map_reduce_multi,
                "indexed": assign_indexed, "reduce_view": reduce_view_apply,
                "to_view": assign_to_view_kernel,
                "scatter_ranges": scatter_ranges,
                "scatter_privatized": scatter_privatized,
                "gather_ranges": gather_ranges,
                "complex": assign_complex,
                "reduce_complex": map_reduce_complex,
                "mba": mba_eval, "mba_tree": assign_indexed,
                "mba_taps": cuda_mba.FORMS["taps"],
                "mba_band": cuda_mba.FORMS["band"],
                "mba_cluster": cuda_mba.FORMS["cluster"],
                "cufft": cufft_execute, "builtins": assign, "ipow": assign,
                "advanced_index": assign_indexed, "image": assign_indexed,
                "gather_coords": cuda_gather.gather_coords,
                "backward": generator_backward, "dia_halo": dia_matvec_halo}
    main_launches = {}

    def counted(keys, fn):
        """Run fn (a main path) with the counters of ``keys`` at 0 before
        it; return its result and the launches, each checked > 0."""
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: counters[k].launches for k in keys}
        check(all(v > 0 for v in got.values()),
              f"a kernel of the path never launched: {got}")
        return out, got
    smi = smi_line()
    print(smi)
    results["card"] = smi
    ctx = vex.Context(vex.Filter.GPU & vex.Filter.Count(1))
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def rand(n, dt):
        return vex.vector(data=torch.rand(n, generator=gen, device=dev,
                                          dtype=dt), context=ctx)

    # -- phase 1: builds ----------------------------------------------------
    t = time.perf_counter()
    build_cuda_libraries()
    nvcc_s = time.perf_counter() - t
    t = time.perf_counter()
    for dt in (torch.float32, torch.float64):
        a, b, c = (rand(4096, dt) for _ in range(3))
        a[:] = 2 * b + vex.sin(c)
        a += b + c * b
        for kind in (vex.SUM, vex.MIN, vex.MAX):
            vex.Reductor(kind)(a * b)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t
    print(f"build: nvcc {nvcc_s:.2f} s, triton (first kernels) "
          f"{triton_s:.2f} s")
    results["build_s"] = {"nvcc": nvcc_s, "triton_first": triton_s}

    def time_assign(expr, out):
        e, an, ty, lv = prepare(expr, out.numel(), dev)
        plain = torch.empty_like(out)
        kern = torch.empty_like(out)
        assign(e, an, ty, lv, kern)
        assign_plain(e, an, ty, lv, plain)
        ms = cuda_ms(lambda: assign(e, an, ty, lv, kern))
        plain_ms = cuda_ms(lambda: assign_plain(e, an, ty, lv, plain))
        return kern, plain, ms, plain_ms

    def report(tag, rec):
        print(f"{tag}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items()))
        results[tag] = rec

    # -- phase 2: expressions and reductions at 2^24 ------------------------
    for dname, dt in (("f32", torch.float32), ("f64", torch.float64)):
        x, y, z = (rand(N_VEC, dt) for _ in range(3))
        x[:] = 2 * y + vex.sin(z)
        kern, plain, ms, plain_ms = time_assign(2 * y + vex.sin(z),
                                                x.storage)
        _, rel = errors(x.storage, plain)
        check(rel <= TOL[dname], f"{dname} 2*y+sin(z): rel err {rel}")
        api_ms = cuda_ms(lambda: x.assign(2 * y + vex.sin(z)))
        report(f"expr_saxpy_sin_{dname}", {"max_rel_err": rel, "ms": ms,
                                           "plain_ms": plain_ms,
                                           "api_ms": api_ms})

        a, b, c, d = (rand(N_VEC, dt) for _ in range(4))
        a0 = vex.vector(data=a.storage, context=ctx)  # the old value
        a += b + c * d
        e, an, ty, lv = prepare(a0 + (b + c * d), N_VEC, dev)
        ref = torch.empty_like(a0.storage)
        assign_plain(e, an, ty, lv, ref)
        _, rel = errors(a.storage, ref)
        check(rel <= TOL[dname], f"{dname} a += b + c*d: rel err {rel}")
        kern, plain, ms, plain_ms = time_assign(a + (b + c * d), a.storage)
        report(f"expr_a_plus_bcd_{dname}", {"max_rel_err": rel, "ms": ms,
                                            "plain_ms": plain_ms})
        del a, b, c, d, a0, ref, kern, plain

        for n in (N_VEC, N_VEC + TAIL):
            u, v = rand(n, dt), rand(n, dt)
            v[:] = v - 0.5
            e, an, ty, lv = prepare(u * v, n, dev)
            for kind in ("SUM", "MIN", "MAX"):
                api = vex.Reductor(getattr(vex, kind))(u * v)
                k = map_reduce(e, an, ty, lv, n, kind, dev).item()
                p = map_reduce_plain(e, an, ty, lv, n, kind, dev).item()
                check(api == k, f"Reductor({kind}) differs from its kernel")
                err = abs(k - p)
                tol = SUM_TOL[dname] * max(1.0, abs(p)) if kind == "SUM" else 0
                check(err <= tol, f"{dname} {kind}(x*y) n={n}: {k} vs {p}")
                ms = cuda_ms(lambda: map_reduce(e, an, ty, lv, n, kind, dev))
                plain_ms = cuda_ms(lambda: map_reduce_plain(e, an, ty, lv, n,
                                                            kind, dev))
                report(f"reduce_{kind}_{dname}_n{n}", {
                    "kernel": k, "plain": p, "abs_err": err, "ms": ms,
                    "plain_ms": plain_ms})
        # MIN and MAX propagate NaN (one in the last, partial block)
        v.storage[N_VEC + TAIL - 3] = float("nan")
        e, an, ty, lv = prepare(u * v, n, dev)
        for kind in ("MIN", "MAX"):
            k = map_reduce(e, an, ty, lv, n, kind, dev).item()
            p = map_reduce_plain(e, an, ty, lv, n, kind, dev).item()
            check(k != k and p != p, f"{dname} {kind} with a NaN: {k}, {p}")
            report(f"reduce_{kind}_{dname}_nan", {"kernel": k, "plain": p})
        del x, y, z, u, v
        torch.cuda.empty_cache()

    # integer //, % and fmod with zeros in the divisor (and the least
    # signed integer by -1): the generated kernel bitwise against its plain
    # form, which gives XLA's values as the JAX package does
    zrng = np.random.default_rng(args.seed)
    zdiv = {}
    for dname, npdt in (("i32", np.int32), ("i64", np.int64),
                        ("u32", np.uint32), ("bool", np.bool_)):
        if npdt is np.bool_:
            a_np, b_np = zrng.random(N_VEC) < 0.5, zrng.random(N_VEC) < 0.5
        else:
            info = np.iinfo(npdt)
            a_np = zrng.integers(max(info.min, -(1 << 30)), 1 << 30,
                                 N_VEC).astype(npdt)
            b_np = zrng.integers(-3 if info.min else 0, 4,
                                 N_VEC).astype(npdt)
            a_np[:3] = [info.min, info.max, 0]
            b_np[:3] = [-1 if info.min else 0, 0, 0]
        A, B = (vex.vector(data=t_, context=ctx) for t_ in (a_np, b_np))
        for op, fn in (("floordiv", lambda: A // B), ("mod", lambda: A % B),
                       ("fmod", lambda: vex.fmod(A, B))):
            expr = fn()
            e, an, ty, lv = prepare(expr, N_VEC, dev)
            k = vex.eval(expr)
            pl = torch.empty_like(k)
            assign_plain(e, an, ty, lv, pl)
            check(torch.equal(k, pl), f"{dname} {op} by zero divisors: the "
                  "kernel differs from its plain form")
        zdiv[f"{dname}_zero_divisors"] = int((b_np == 0).sum())
        del A, B
    report("integer_division_by_zero", dict(zdiv, bitwise=True))

    # -- phase 3: the SpMV on Poisson 256^3 ---------------------------------
    nrows = POISSON_N ** 3
    kernels = {}
    for dname, npdt, dt in (("f32", np.float32, torch.float32),
                            ("f64", np.float64, torch.float64)):
        t = time.perf_counter()
        ptr, col, val = poisson_7pt(POISSON_N, dtype=npdt)
        A = vex.SpMat(nrows, nrows, ptr, col, val, context=ctx)
        del ptr, col, val
        build_s = time.perf_counter() - t
        D = A.device
        want = torch.bfloat16 if dname == "f32" else torch.float64
        check(D.format == "dia" and D.vals.dtype == want,
              f"Poisson {dname}: SpMat picked {D.format}/{D.vals.dtype}")
        x, y = rand(nrows, dt), rand(nrows, dt)
        y0 = y.storage.clone()
        y[:] = 0.5 * (A * x) + y
        ref = 0.5 * dia_matvec_plain(D.n, D.m, D.offsets, D.vals,
                                     x.storage) + y0
        _, rel_expr = errors(y.storage, ref)
        check(rel_expr <= DIA_TOL[dname] * 4,
              f"{dname} y = 0.5*(A*x) + y: rel err {rel_expr}")
        k = dia_matvec(D.n, D.m, D.offsets, D.offsets_dev, D.vals, x.storage)
        p = dia_matvec_plain(D.n, D.m, D.offsets, D.vals, x.storage)
        abs_err, rel = errors(k, p)
        check(rel <= DIA_TOL[dname], f"{dname} DIA kernel: rel err {rel}")
        ms = cuda_ms(lambda: dia_matvec(D.n, D.m, D.offsets, D.offsets_dev,
                                        D.vals, x.storage))
        plain_ms = cuda_ms(lambda: dia_matvec_plain(D.n, D.m, D.offsets,
                                                    D.vals, x.storage))
        api_ms = cuda_ms(lambda: y.assign(0.5 * (A * x) + y))
        rec = {"planes": str(D.vals.dtype), "host_build_s": build_s,
               "max_abs_err": abs_err, "max_rel_err": rel,
               "expr_max_rel_err": rel_expr, "ms": ms, "plain_ms": plain_ms,
               "expr_api_ms": api_ms,
               "gflops": 2 * A.nnz / (ms * 1e-3) / 1e9}
        report(f"spmv_poisson256_{dname}", rec)
        if dname == "f32":
            kernels["dia"] = kernel_row(
                abs_err, cuda_ms(lambda: dia_matvec(
                    D.n, D.m, D.offsets, D.offsets_dev, D.vals, x.storage),
                    KERNEL_REPS),
                plain_ms, tensor_bytes(D.vals, x.storage, k), 2 * A.nnz,
                None)             # cuSPARSE's time: at the end
            dia_xy = (x.storage, k)
            A_poisson256 = A      # the DIA SpMat that phase 7 compares with
        del A, D, x, y, y0, ref, k, p
        torch.cuda.empty_cache()

    # -- phase 4: PoissonSolver(256).solve(f, maxiter=100) in f32 -----------
    t = time.perf_counter()
    solver = PoissonSolver(POISSON_N, context=ctx)
    construct_s = time.perf_counter() - t
    D = solver.A.device
    check(D.format == "dia" and D.vals.dtype == torch.bfloat16,
          "PoissonSolver's SpMat is not DIA with bf16 planes")
    # zero-mean noise: on a smooth right-hand side (say U[0,1)) CG's
    # residual first GROWS for many iterations at this size (A-norm error
    # falls, the 2-norm residual need not), so no residual drop could be
    # asked of 100 iterations
    f = (np.random.default_rng(args.seed).random(nrows) - 0.5).astype(
        np.float32)
    # a 3-iteration solve first compiles the solver's Triton kernels, so
    # the timed solve measures the iterations alone
    t = time.perf_counter()
    solver.solve(f, maxiter=3)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    (u, iters), launches = counted(("expr", "reduce", "dia"),
                                   lambda: solver.solve(f, maxiter=CG_ITERS))
    solve_s = time.perf_counter() - t
    main_launches.update(launches)
    check(iters == CG_ITERS, f"CG stopped after {iters} iterations")

    # the same CG in plain PyTorch f64 on the card
    vals64 = D.vals.to(torch.float64)
    b64 = torch.from_numpy(f).to(dev, torch.float64)

    def mv(v):
        return dia_matvec_plain(D.n, D.m, D.offsets, vals64, v)

    torch.cuda.synchronize()
    t = time.perf_counter()
    xr, it = plain_cg(mv, b64, 1e-6, CG_ITERS)
    torch.cuda.synchronize()
    plain_solve_s = time.perf_counter() - t
    x64 = u.storage.to(torch.float64)
    check(torch.isfinite(x64).all().item(), "CG solution is not finite")
    x_rel = (torch.linalg.vector_norm(x64 - xr)
             / torch.linalg.vector_norm(xr)).item()
    res_rel = (torch.linalg.vector_norm(b64 - mv(x64))
               / torch.linalg.vector_norm(b64)).item()
    check(x_rel <= CG_X_TOL, f"CG x differs from the f64 CG by {x_rel}")
    check(res_rel <= 1 / CG_RESIDUAL_DROP,
          f"CG residual fell only to {res_rel} of |b|")
    report("cg_poisson256_f32", {
        "iterations": iters, "ms_per_iter": solve_s / iters * 1e3,
        "plain_f64_ms_per_iter": plain_solve_s / it * 1e3,
        "host_construct_s": construct_s, "first_3_iters_s": warm_s,
        "x_rel_err_vs_f64": x_rel,
        "residual_over_b": res_rel, "launches": launches})

    # kernel times at the main path's shapes (256^3, f32)
    pv, rv, Apv = (rand(nrows, torch.float32) for _ in range(3))
    kern, plain, ms, plain_ms = time_assign(rv + 0.7 * pv, pv.storage)
    e, an, ty, lv = prepare(rv + 0.7 * pv, nrows, dev)
    kernels["expr"] = kernel_row(
        errors(kern, plain)[0],
        cuda_ms(lambda: assign(e, an, ty, lv, kern), KERNEL_REPS), plain_ms,
        3 * nrows * 4, 2 * nrows,
        cuda_ms(lambda: torch.add(rv.storage, pv.storage, alpha=0.7),
                KERNEL_REPS))

    def api_assign():
        Apv[:] = rv + 0.7 * pv
    # the host's time per call: the prepared kernel, the whole assignment
    # through the API (tree, analysis, launch) and torch.add
    kernels["expr"].update(
        host_us=host_us(lambda: assign(e, an, ty, lv, kern)),
        api_host_us=host_us(api_assign),
        library_host_us=host_us(lambda: torch.add(rv.storage, pv.storage,
                                                  alpha=0.7)))
    pap = prepare(pv * Apv, nrows, dev)      # kept for the profiler, last
    e, an, ty, lv = pap
    pap_k = map_reduce(e, an, ty, lv, nrows, "SUM", dev).item()
    p_ = map_reduce_plain(e, an, ty, lv, nrows, "SUM", dev).item()

    def sum_pap():
        return map_reduce(*pap, nrows, "SUM", dev)

    def dot_pap():
        return torch.dot(pv.storage, Apv.storage)
    turns = turns_row(in_turns({"kernel": sum_pap, "library": dot_pap}),
                      "kernel", "library")
    kernels["reduce"] = kernel_row(
        abs(pap_k - p_), turns["ms"],
        cuda_ms(lambda: map_reduce_plain(e, an, ty, lv, nrows, "SUM", dev),
                KERNEL_REPS),
        2 * nrows * 4, 2 * nrows, turns["library_ms"])
    # the host's time per call (host clock; the device's comes from the
    # profiler at the end): back to back, the events above read the
    # larger of the two
    kernels["reduce"].update(
        ms_range=turns["ms_range"],
        library_ms_range=turns["library_ms_range"],
        host_us=host_us(sum_pap), library_host_us=host_us(dot_pap))

    del solver, u, rv, xr, b64, vals64, x64
    torch.cuda.empty_cache()

    # -- phase 5: the 1-D stencil -------------------------------------------
    # the bench's configuration (bench.py:174-183): 2^26 f32, 5 taps
    c = np.linspace(0.1, 0.5, 5)
    taps = (c / c.sum()).astype(np.float32)
    st = vex.stencil(taps, center=2)
    x = rand(STENCIL_N, torch.float32)
    y = vex.vector(STENCIL_N, dtype=torch.float32, context=ctx)
    x0 = x.storage.clone()

    def stencil_api():
        y[:] = x * st
        x[:] = x * st                 # in place: reads the old x
    _, launches = counted(("stencil", "expr"), stencil_api)
    main_launches["stencil"] = launches["stencil"]
    cdev = st.coeff_on(dev)
    ref = stencil_plain(x0, cdev, 2)
    for name, got in (("y = x*s", y.storage), ("x = x*s", x.storage)):
        _, rel = errors(got, ref)
        check(rel <= STENCIL_TOL["f32"], f"stencil {name}: rel err {rel}")
    k = stencil_apply(x0, cdev, 2)
    abs_err, rel = errors(k, ref)
    check(rel <= STENCIL_TOL["f32"], f"stencil kernel: rel err {rel}")
    ms = cuda_ms(lambda: stencil_apply(x0, cdev, 2))
    plain_ms = cuda_ms(lambda: stencil_plain(x0, cdev, 2))
    api_ms = cuda_ms(lambda: y.assign(x * st))
    # the library's form: a replicate pad and a convolution (cuDNN), in
    # full f32 (cuDNN's default would round through TF32)
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    w = cdev.view(1, 1, -1)

    def conv_stencil():
        return F.conv1d(F.pad(x0.view(1, 1, -1), (2, 2), mode="replicate"),
                        w).view(-1)
    _, lib_rel = errors(conv_stencil(), ref)
    check(lib_rel <= STENCIL_TOL["f32"], f"conv1d stencil: rel {lib_rel}")
    kernels["stencil"] = dict(kernel_row(
        abs_err, cuda_ms(lambda: stencil_apply(x0, cdev, 2), KERNEL_REPS),
        plain_ms, tensor_bytes(x0, k), 2 * 5 * STENCIL_N,
        cuda_ms(conv_stencil, KERNEL_REPS)),
        host_us=host_us(lambda: stencil_apply(x0, cdev, 2)),
        api_host_us=host_us(lambda: y.assign(x * st), 20))
    nbytes = 2 * STENCIL_N * 4
    report("stencil_2^26_w5_f32", {
        "max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
        "plain_ms": plain_ms, "api_ms": api_ms, "launches": launches,
        "GBs": nbytes / (ms * 1e-3) / 1e9,
        "plain_GBs": nbytes / (plain_ms * 1e-3) / 1e9})
    del x, y, x0, ref, k
    torch.cuda.empty_cache()

    ns = STENCIL_N_SMALL
    g = np.random.default_rng(args.seed + 5)
    for tag, n, tp, center, dt, tol in (
            ("w255_c40_f32", ns, (g.random(255) - 0.5).astype(np.float32),
             40, torch.float32, STENCIL_TOL["f32_wide"]),
            ("w5_f64", ns, c / c.sum(), 2, torch.float64, STENCIL_TOL["f64"]),
            ("n3_w5_f32", 3, taps, 2, torch.float32, STENCIL_TOL["f32"])):
        s_ = vex.stencil(tp, center=center)
        x = rand(n, dt)
        y = vex.vector(n, dtype=dt, context=ctx)
        y[:] = x * s_
        cd = s_.coeff_on(dev)
        ref = stencil_plain(x.storage, cd, center)
        abs_err, rel = errors(y.storage, ref)
        check(rel <= tol, f"stencil {tag}: rel err {rel}")
        rec = {"max_abs_err": abs_err, "max_rel_err": rel}
        if n > 1000:
            rec["ms"] = cuda_ms(lambda: stencil_apply(x.storage, cd, center))
            rec["plain_ms"] = cuda_ms(lambda: stencil_plain(x.storage, cd,
                                                            center))
            rec["GBs"] = 2 * n * x.storage.element_size() / (
                rec["ms"] * 1e-3) / 1e9
        report(f"stencil_{tag}", rec)

    op = vex.StencilOperator(3, 1, lambda X: X[0] + (X[-1] + X[1]) ** 3)
    x = rand(ns, torch.float32)
    y = vex.vector(ns, dtype=torch.float32, context=ctx)
    _, launches = counted(("expr",), lambda: y.assign(op(x)))
    xs = x.storage
    tp_ = torch.cat([xs[:1], xs, xs[-1:]])
    ref = tp_[1:-1] + (tp_[:-2] + tp_[2:]) ** 3
    abs_err, rel = errors(y.storage, ref)
    check(rel <= STENCIL_TOL["f32"], f"StencilOperator: rel err {rel}")
    report("stencil_operator_f32", {
        "max_abs_err": abs_err, "max_rel_err": rel, "launches": launches,
        "api_ms": cuda_ms(lambda: y.assign(op(x)))})
    del x, y, xs, tp_, ref
    torch.cuda.empty_cache()

    # -- phase 6: the irregular SpMV on the bench's lognormal matrix ---------
    t = time.perf_counter()
    ptr, col, val, nnz = random_lognormal_csr(RANDOM_N, seed=args.seed)
    results["random_matrix"] = {"n": RANDOM_N, "nnz": nnz,
                                "generate_s": time.perf_counter() - t}

    def spmv_keys(D):
        """The counters a format's product launches."""
        if D.format == "csr":
            return ("csr",)
        return ("sell",) + (("csr",) if D.tail is not None else ())

    def add_launches(got):
        for key, v in got.items():
            main_launches[key] = main_launches.get(key, 0) + v

    def spmv_calls(S, Cr, lib, lib_sell, xt):
        """The timed products on one x: the SELL kernel and cuSPARSE on
        the same rows, SELLR's product (the SELL kernel and its CSR
        tail), the CSR kernel and cuSPARSE on the whole matrix."""
        return {"sell_spmv": lambda: sell_spmv(S.n, S.slice_ptr, S.col,
                                               S.val, S.perm, xt),
                "cusparse_sell_part": lambda: lib_sell @ xt,
                "sellr_apply": lambda: S.apply(xt),
                "csr_spmv": lambda: csr_spmv(Cr.n, Cr.ptr, Cr.col, Cr.val,
                                             xt, blocks=Cr.blocks),
                "cusparse": lambda: lib @ xt}

    def cusparse(p_, c_, v_):
        """cuSPARSE's CSR product through torch.sparse."""
        return torch.sparse_csr_tensor(
            torch.from_numpy(p_).to(dev, torch.int32),
            torch.from_numpy(c_).to(dev, torch.int32),
            torch.from_numpy(v_).to(dev), size=(RANDOM_N, RANDOM_N),
            check_invariants=False)

    # the SELL kernel's own share of the product: the rows SELLR keeps in
    # its slices (the longer ones go to its CSR tail), so that its library
    # call does the same work
    lens = np.diff(ptr)
    kept = lens <= LONG_ROW
    sell_ptr = np.concatenate([[0], np.cumsum(np.where(kept, lens, 0))])
    sell_entries = np.repeat(kept, lens)
    irregular = default_format("cuda")   # what SpMat picks on the card
    spmv_timed = {}      # dtype -> timed calls, for the profiler at the end
    for dname, npdt, dt in (("f32", np.float32, torch.float32),
                            ("f64", np.float64, torch.float64)):
        t = time.perf_counter()
        A = vex.SpMat(RANDOM_N, RANDOM_N, ptr, col, val.astype(npdt),
                      context=ctx)
        build_s = time.perf_counter() - t
        check(A.device.format == irregular == "csr", f"{dname} lognormal: "
              f"SpMat picked {A.device.format}, the policy {irregular}, "
              f"not csr")
        B = vex.SpMat(RANDOM_N, RANDOM_N, ptr, col, val.astype(npdt),
                      fmt="sellr", context=ctx)
        S, Cr = B.device, A.device
        x, y = rand(RANDOM_N, dt), rand(RANDOM_N, dt)
        ref = csr_spmv_plain(Cr.n, Cr.ptr, Cr.col, Cr.val, x.storage)
        for M in (A, B):
            sums = {}

            def spmv_api():
                y[:] = M * x
                sums["first"] = y.storage.clone()
                y[:] = 2 * (M * x) + y
            _, launches = counted(spmv_keys(M.device), spmv_api)
            if dname == "f32":
                add_launches(launches)
            _, rel1 = errors(sums["first"], ref)
            _, rel2 = errors(y.storage, 3 * ref)
            check(max(rel1, rel2) <= 4 * SPMV_TOL[dname],
                  f"{dname} {M.device.format} y = A*x / 2*(A*x)+y: rel err "
                  f"{rel1}, {rel2}")
        sell_rec = {"expr_max_rel_err": max(rel1, rel2), "launches": launches}
        k = sell_spmv(S.n, S.slice_ptr, S.col, S.val, S.perm, x.storage)
        p = sell_spmv_plain(S.n, S.slice_ptr, S.col, S.val, S.perm, x.storage)
        abs_err, rel = errors(k, p)
        check(rel <= SPMV_TOL[dname], f"{dname} SELL kernel: rel err {rel}")
        _, sellr_rel = errors(S.apply(x.storage), ref)
        check(sellr_rel <= SPMV_TOL[dname], f"{dname} SELLR product: rel "
              f"err {sellr_rel}")
        lib = cusparse(ptr, col, val.astype(npdt))
        lib_sell = cusparse(sell_ptr, col[sell_entries],
                            val[sell_entries].astype(npdt))
        kc = csr_spmv(Cr.n, Cr.ptr, Cr.col, Cr.val, x.storage,
                      blocks=Cr.blocks)
        csr_abs, csr_rel = errors(kc, ref)
        check(csr_rel <= SPMV_TOL[dname], f"{dname} CSR kernel: rel err "
              f"{csr_rel}")
        check(torch.equal(csr_spmv(Cr.n, Cr.ptr, Cr.col, Cr.val, x.storage,
                                   blocks=Cr.blocks), kc),
              "CSR kernel differs between two runs")
        _, lib_rel = errors(lib @ x.storage, ref)
        check(lib_rel <= SPMV_TOL[dname], f"{dname} cuSPARSE CSR: rel "
              f"{lib_rel}")
        _, lib_sell_rel = errors(lib_sell @ x.storage, p)
        check(lib_sell_rel <= SPMV_TOL[dname], f"{dname} cuSPARSE on the "
              f"SELL part: rel {lib_sell_rel}")
        xt = x.storage
        fns = spmv_calls(S, Cr, lib, lib_sell, xt)
        spills = {}
        for spill in args.spills:
            sell.LONG_ROW = spill
            try:
                M = SELLR(RANDOM_N, RANDOM_N, ptr, col, val.astype(npdt),
                          device=dev)
            finally:
                sell.LONG_ROW = LONG_ROW
            _, spill_rel = errors(M.apply(xt), ref)
            check(spill_rel <= SPMV_TOL[dname], f"{dname} SELLR spilling "
                  f"over {spill}: rel err {spill_rel}")
            fns[f"sell_spmv_spill_{spill}"] = lambda M=M, xt=xt: sell_spmv(
                M.n, M.slice_ptr, M.col, M.val, M.perm, xt)
            fns[f"sellr_apply_spill_{spill}"] = (
                lambda M=M, xt=xt: M.apply(xt))
            spills[spill] = {"slots_over_nnz": M.slots / nnz,
                             "tail_nnz": 0 if M.tail is None else M.tail.nnz}
        turns = in_turns(fns)
        spmv_timed[dname] = {name: fns[name] for name in (
            "sell_spmv", "cusparse_sell_part", "csr_spmv", "cusparse")}
        plain_ms = cuda_ms(lambda: sell_spmv_plain(
            S.n, S.slice_ptr, S.col, S.val, S.perm, xt))
        csr_plain_ms = cuda_ms(lambda: csr_spmv_plain(Cr.n, Cr.ptr, Cr.col,
                                                      Cr.val, xt))
        rec = {"host_build_s": build_s, "format": irregular,
               "slots_over_nnz": S.slots / nnz,
               "tail_rows": 0 if S.tail is None else int(S.tail.rows.numel()),
               "tail_nnz": 0 if S.tail is None else S.tail.nnz,
               "max_abs_err": abs_err, "max_rel_err": rel,
               "sellr_max_rel_err": sellr_rel,
               "csr_max_rel_err": csr_rel, "cusparse_max_rel_err": lib_rel,
               "cusparse_sell_part_max_rel_err": lib_sell_rel,
               **{f"sellr_{key}": v for key, v in sell_rec.items()},
               "row_blocks": int(Cr.blocks.numel()) - 1,
               "sell_plain_ms": plain_ms, "csr_plain_ms": csr_plain_ms,
               "turns": turns, "spills": spills,
               "gflops": 2 * nnz / (turns["csr_spmv"]["ms"] * 1e-3) / 1e9,
               "api_ms": cuda_ms(lambda: y.assign(A * x))}
        report(f"spmv_random_{dname}", rec)
        if dname == "f32":
            kernels["sell"] = kernel_row(
                abs_err, turns["sell_spmv"]["ms"], plain_ms,
                tensor_bytes(S.slice_ptr, S.col, S.val, S.perm, xt, k),
                2 * int(sell_entries.sum()), None)
            kernels["sell"].update(
                turns_row(turns, "sell_spmv", "cusparse_sell_part"),
                host_us=host_us(fns["sell_spmv"]))
            kernels["csr"] = kernel_row(
                csr_abs, turns["csr_spmv"]["ms"], csr_plain_ms,
                tensor_bytes(Cr.ptr, Cr.col, Cr.val, xt, kc),
                2 * nnz, None)
            kernels["csr"].update(turns_row(turns, "csr_spmv", "cusparse"),
                                  host_us=host_us(fns["csr_spmv"]))
            x32, csr_ref = x, ref
        del A, B, M, S, Cr, fns, spills, y, ref, k, p, kc, lib, lib_sell
        del xt
        torch.cuda.empty_cache()
    del lens, kept, sell_ptr, sell_entries

    # the other formats, f32, against the plain CSR result
    for fmt in ("hyb", "ell"):
        t = time.perf_counter()
        A = vex.SpMat(RANDOM_N, RANDOM_N, ptr, col, val, fmt=fmt,
                      context=ctx)
        build_s = time.perf_counter() - t
        D = A.device
        y = vex.vector(RANDOM_N, dtype=torch.float32, context=ctx)
        _, launches = counted(spmv_keys(D), lambda: y.assign(A * x32))
        add_launches(launches)
        rec = {"host_build_s": build_s, "launches": launches,
               "slots_over_nnz": D.slots / nnz}
        if fmt == "hyb":
            T = D.tail
            rec.update(ell_width=D.width, tail_rows=int(T.rows.numel()),
                       tail_nnz=T.nnz)
            base = sell_spmv(D.n, D.slice_ptr, D.col, D.val, D.perm,
                             x32.storage)
            k = csr_spmv(D.n, T.ptr, T.col, T.val, x32.storage, T.rows,
                         out=base.clone(), blocks=T.blocks)
            p = csr_spmv_plain(D.n, T.ptr, T.col, T.val, x32.storage,
                               T.rows, out=base.clone())
            _, rel = errors(k, p)
            check(rel <= SPMV_TOL["f32"], f"hyb tail CSR: rel err {rel}")
            rec["tail_max_rel_err"] = rel
        ms = cuda_ms(lambda: D.apply(x32.storage))
        rec.update(ms=ms, gflops=2 * nnz / (ms * 1e-3) / 1e9)
        _, rel = errors(y.storage, csr_ref)
        check(rel <= SPMV_TOL["f32"], f"{fmt} vs plain CSR: rel err {rel}")
        rec["vs_plain_csr_max_rel_err"] = rel
        report(f"spmv_random_{fmt}_f32", rec)
        del A, D, y
        torch.cuda.empty_cache()
    del x32, csr_ref

    # -- phase 7: SpMatCCSR on Poisson 64^3 and 256^3 ------------------------
    for m in (64, POISSON_N):
        nr = m ** 3
        t = time.perf_counter()
        C = vex.SpMatCCSR(nr, nr, *poisson_7pt_ccsr(m, dtype=np.float32),
                          context=ctx)
        build_s = time.perf_counter() - t
        P = (A_poisson256 if m == POISSON_N else
             vex.SpMat(nr, nr, *poisson_7pt(m, dtype=np.float32),
                       context=ctx))
        if m == POISSON_N:
            check(C.cached_coeffs is not None
                  and C.cached_coeffs.dtype == torch.bfloat16,
                  "CCSR 256^3: the expansion is not cached as bf16 planes")
        x = rand(nr, torch.float32)
        y = vex.vector(nr, dtype=torch.float32, context=ctx)
        _, launches = counted(("dia",), lambda: y.assign(C * x))
        ref = P.device.apply(x.storage)
        abs_err, rel = errors(y.storage, ref)
        check(rel <= DIA_TOL["f32"], f"CCSR {m}^3 vs DIA SpMat: rel {rel}")
        ms = cuda_ms(lambda: C._matvec(x.storage))
        report(f"ccsr_poisson{m}_f32", {
            "host_build_s": build_s, "cached": C.cached_coeffs is not None,
            "planes": str(C.cached_coeffs.dtype), "max_abs_err": abs_err,
            "max_rel_err": rel, "ms": ms, "launches": launches,
            "gflops": 2 * 7 * nr / (ms * 1e-3) / 1e9})
        del C, P, x, y, ref
    del A_poisson256
    torch.cuda.empty_cache()

    # -- phase 8: CG on the shifted graph Laplacian of the phase-6 matrix ----
    t = time.perf_counter()
    lp, lc, lv = shifted_laplacian(RANDOM_N, ptr, col, val)
    A = vex.SpMat(RANDOM_N, RANDOM_N, lp, lc, lv.astype(np.float32),
                  context=ctx)
    build_s = time.perf_counter() - t
    D = A.device
    check(D.format == irregular, f"Laplacian: SpMat picked {D.format}")
    b_host = (np.random.default_rng(args.seed + 8).random(RANDOM_N)
              - 0.5).astype(np.float32)
    b = vex.vector(data=b_host, context=ctx)
    tol = LAPLACE_CG_TOL * float(np.linalg.norm(b_host.astype(np.float64)))
    vex.interop.cg(A, b, tol=tol, maxiter=3)         # compiles the kernels
    keys = ("expr", "reduce") + spmv_keys(D)
    t = time.perf_counter()
    (u, iters), launches = counted(keys, lambda: vex.interop.cg(
        A, b, tol=tol, maxiter=BICGSTAB_MAXITER))
    solve_s = time.perf_counter() - t
    lap = {k: torch.from_numpy(a).to(dev) for k, a in
           (("ptr", lp), ("col", lc.astype(np.int32)), ("val", lv))}
    b64 = torch.from_numpy(b_host).to(dev, torch.float64)

    def lmv(v):
        return csr_spmv_plain(RANDOM_N, lap["ptr"], lap["col"], lap["val"], v)

    torch.cuda.synchronize()
    t = time.perf_counter()
    xr, it = plain_cg(lmv, b64, tol, CG_ITERS)
    torch.cuda.synchronize()
    plain_solve_s = time.perf_counter() - t
    x64 = u.storage.to(torch.float64)
    check(torch.isfinite(x64).all().item(), "Laplacian CG: x not finite")
    x_rel = (torch.linalg.vector_norm(x64 - xr)
             / torch.linalg.vector_norm(xr)).item()
    res_rel = (torch.linalg.vector_norm(b64 - lmv(x64))
               / torch.linalg.vector_norm(b64)).item()
    check(x_rel <= LAPLACE_X_TOL, f"Laplacian CG x differs by {x_rel}")
    check(res_rel <= 1 / LAPLACE_RESIDUAL_DROP,
          f"Laplacian CG residual fell only to {res_rel} of |b|")
    report("cg_laplacian_f32", {
        "n": RANDOM_N, "nnz": int(lp[-1]), "host_build_s": build_s,
        "format": D.format,
        "tail_rows": 0 if getattr(D, "tail", None) is None
        else int(D.tail.rows.numel()),
        "iterations": iters, "plain_f64_iterations": it,
        "ms_per_iter": solve_s / iters * 1e3,
        "plain_f64_ms_per_iter": plain_solve_s / it * 1e3,
        "x_rel_err_vs_f64": x_rel, "residual_over_b": res_rel,
        "launches": launches})
    if args.profile:       # where an iteration's time goes: 10 of them
        per_kernel, busy = profile_call(lambda: vex.interop.cg(
            A, b, tol=0.0, maxiter=10), 1)
        report("profile_cg_laplacian_10_iterations", {
            "device_busy": busy, **per_kernel})
    del A, D, b, u, lap, b64, xr, x64
    torch.cuda.empty_cache()

    # -- phase 9: the scan family at the bench's sizes -----------------------
    def scan_run(keys, fn):
        """A counted run of phase 9; its launches add up on the path."""
        out, got = counted(keys, fn)
        for key, v in got.items():
            main_launches[key] = main_launches.get(key, 0) + v
        return out, got

    def gelem(n, ms):
        return n / (ms * 1e-3) / 1e9

    def same(a, b):
        """Equal values, NaN where the other has NaN."""
        an, bn = torch.isnan(a), torch.isnan(b)
        return torch.equal(an, bn) and torch.equal(a[~an], b[~bn])

    def bits(t):
        return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])

    # inclusive_scan: 2^24 f32 (bench.py:474-503), a ragged tail, f64;
    # scan_calls keeps the timed kernel calls for the profiler at the end
    scan_calls = {}
    for tag, n, dt in (("f32", N_VEC, torch.float32),
                       ("f32_tail", N_VEC + TAIL, torch.float32),
                       ("f64", N_VEC, torch.float64)):
        dname = "f64" if dt == torch.float64 else "f32"
        x = rand(n, dt)
        y = vex.vector(n, dtype=dt, context=ctx)
        _, launches = scan_run(("scan",), lambda: vex.inclusive_scan(x, y))
        ref = scan_plain(x.storage, "add")
        abs_err, rel = errors(y.storage, ref)
        check(rel <= SCAN_TOL[dname], f"inclusive_scan {tag}: rel err {rel}")
        check(torch.equal(vex.inclusive_scan(x).storage, y.storage),
              f"inclusive_scan {tag} differs between two runs")
        xi = vex.vector(data=x.storage, context=ctx)
        _, lin = scan_run(("scan",), lambda: vex.inclusive_scan(xi, xi))
        check(torch.equal(xi.storage, y.storage),
              f"in-place inclusive_scan {tag} differs")
        rec = {"max_abs_err": abs_err, "max_rel_err": rel,
               "launches": launches["scan"] + lin["scan"]}
        if tag != "f32_tail":
            # the kernel and torch.cumsum in turns, each into its own out;
            # bound to these tensors: the profiler at the end calls them
            # again
            calls = {"scan": lambda v=x.storage, o=torch.empty_like(
                         x.storage): scan_apply(v, "add", out=o),
                     "library": lambda v=x.storage, o=torch.empty_like(
                         x.storage): torch.cumsum(v, 0, out=o)}
            turns = in_turns(calls)
            scan_calls[f"scan_{tag}"] = calls["scan"]
            scan_calls[f"cumsum_{tag}"] = calls["library"]
            plain_ms = cuda_ms(lambda: scan_plain(x.storage, "add"),
                               KERNEL_REPS)
            api_ms = cuda_ms(lambda: vex.inclusive_scan(x, y), KERNEL_REPS)
            inplace_ms = cuda_ms(lambda: vex.inclusive_scan(xi, xi),
                                 KERNEL_REPS)     # values run to inf: alike
            row = kernel_row(abs_err, turns["scan"]["ms"], plain_ms,
                             tensor_bytes(x.storage, y.storage), n,
                             turns["library"]["ms"])
            row.update(turns_row(turns, "scan", "library"),
                       host_us=host_us(calls["scan"]))
            rec.update(row, api_ms=api_ms, inplace_api_ms=inplace_ms)
            if tag == "f32":
                rec.update(scan_Gelem_s=gelem(n, api_ms),
                           scan_inplace_Gelem_s=gelem(n, inplace_ms))
                kernels["scan"] = row
        report(f"inclusive_scan_{tag}", rec)
        del x, y, xi, ref
    torch.cuda.empty_cache()

    # running MAX and MIN of standard normal values with one NaN
    # (bench.py:506-521)
    x = vex.vector(data=torch.randn(N_VEC, generator=gen, device=dev),
                   context=ctx)
    inan = 3 * N_VEC // 4 + 5
    x.storage[inan] = float("nan")
    for mono in ("max", "min"):
        y = vex.vector(N_VEC, context=ctx)
        _, launches = scan_run(("scan",), lambda: vex.inclusive_scan(
            x, y, op_name=mono))
        ref = scan_plain(x.storage, mono)
        check(same(y.storage, ref), f"inclusive_scan {mono} differs from "
              "plain")
        check(torch.isnan(y.storage[inan:]).all().item()
              and not torch.isnan(y.storage[:inan]).any().item(),
              f"inclusive_scan {mono}: NaN does not propagate")
        again = vex.inclusive_scan(x, op_name=mono)
        check(torch.equal(bits(again.storage), bits(y.storage)),
              f"inclusive_scan {mono} differs between two runs")
        api_ms = cuda_ms(lambda: vex.inclusive_scan(x, y, op_name=mono),
                         KERNEL_REPS)
        lib = torch.cummax if mono == "max" else torch.cummin
        report(f"inclusive_scan_{mono}_nan_f32", {
            "launches": launches["scan"],
            "ms": cuda_ms(lambda: scan_apply(x.storage, mono), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: scan_plain(x.storage, mono),
                                KERNEL_REPS),
            "library_ms": cuda_ms(lambda: lib(x.storage, 0), KERNEL_REPS),
            "api_ms": api_ms, f"scan_{mono}_Gelem_s": gelem(N_VEC, api_ms)})
    del x, y, ref, again
    torch.cuda.empty_cache()

    # scan_by_key over i32 keys in runs of 64 (bench.py:584-591): each
    # call one launch of the keyed kernel
    keys = vex.vector(data=torch.arange(N_VEC, device=dev,
                                        dtype=torch.int32) // RUN,
                      context=ctx)
    k9 = (keys.storage,)
    x = rand(N_VEC, torch.float32)
    heads = torch.zeros(N_VEC, dtype=torch.uint8, device=dev)
    heads[::RUN] = 1
    for mono in ("add", "max"):
        name = None if mono == "add" else mono
        yi = vex.vector(N_VEC, context=ctx)
        ye = vex.vector(N_VEC, context=ctx)

        def by_key():
            vex.inclusive_scan_by_key(keys, x, yi, op_name=name)
            vex.exclusive_scan_by_key(keys, x, ye, op_name=name)
        _, launches = scan_run(("scan_by_key",), by_key)
        ref_i = segscan_plain(heads, x.storage, mono)
        ref_e = torch.where(heads.bool(), 0.0,
                            torch.cat([ref_i.new_zeros(1), ref_i[:-1]]))
        # the route the kernel replaced (flags by tensor compares, the
        # segscan kernel, the epilogue) gives the same bits
        route_i = segscan_apply(segment_heads(k9), x.storage, mono)
        route_e = scan_by_key_epilogue(heads.bool(), route_i, torch.add,
                                       True, None)
        check(torch.equal(yi.storage, route_i)
              and torch.equal(ye.storage, route_e),
              f"scan_by_key {mono} differs from the segscan route")
        rec = {"launches": launches["scan_by_key"]}
        if mono == "add":
            abs_err, rel = errors(yi.storage, ref_i)
            _, rel_e = errors(ye.storage, ref_e)
            check(max(rel, rel_e) <= SCAN_TOL["f32"],
                  f"scan_by_key: rel err {rel}, {rel_e}")
            # the segscan kernel, called directly, in turns with the plain
            # scan of the same values, its yardstick (no PyTorch call
            # computes a segmented scan)
            calls = {"segscan": lambda h=heads, v=x.storage, o=torch.empty_like(
                         x.storage): segscan_apply(h, v, "add", out=o),
                     "scan": lambda v=x.storage, o=torch.empty_like(
                         x.storage): scan_apply(v, "add", out=o)}
            turns = in_turns(calls)
            scan_calls["segscan"] = calls["segscan"]
            seg = segscan_apply(heads, x.storage, "add")
            seg_err, _ = errors(seg, ref_i)
            kernels["segscan"] = kernel_row(
                seg_err, turns["segscan"]["ms"],
                cuda_ms(lambda: segscan_plain(heads, x.storage, "add"),
                        KERNEL_REPS),
                tensor_bytes(x.storage, heads, yi.storage), N_VEC, None)
            kernels["segscan"].update(
                ms_range=turns["segscan"]["ms_range"],
                scan_ms=turns["scan"]["ms"],
                scan_ms_range=turns["scan"]["ms_range"],
                host_us=host_us(calls["segscan"]))
            # the keyed kernel in turns with the route it replaced, called
            # directly: inclusive, and exclusive with init
            o_k, o_r = torch.empty_like(x.storage), torch.empty_like(x.storage)

            def route(exclusive=False, init=None, o=o_r, k=k9, v=x.storage):
                h = segment_heads(k)
                incl = segscan_apply(h, v, "add", out=o)
                if not exclusive:
                    return incl
                return scan_by_key_epilogue(h, incl, torch.add, True, init)
            calls = {"scan_by_key": lambda k=k9, v=x.storage, o=o_k:
                         scan_by_key_apply(k, v, "add", out=o),
                     "route": route,
                     "exclusive_init": lambda k=k9, v=x.storage, o=o_k:
                         scan_by_key_apply(k, v, "add", True, 1.0, out=o),
                     "exclusive_init_route": lambda: route(True, 1.0)}
            turns = in_turns(calls)
            scan_calls.update({
                "scan_by_key": calls["scan_by_key"],
                "scan_by_key_route": calls["route"],
                "scan_by_key_excl_init": calls["exclusive_init"],
                "scan_by_key_excl_init_route": calls["exclusive_init_route"]})
            check(torch.equal(calls["exclusive_init"](),
                              calls["exclusive_init_route"]()),
                  "exclusive scan_by_key with init differs from the route")
            ms = turns["scan_by_key"]["ms"]
            plain_ms = cuda_ms(lambda: scan_by_key_plain(k9, x.storage,
                                                         "add"), KERNEL_REPS)
            api_ms = cuda_ms(lambda: vex.inclusive_scan_by_key(keys, x, yi),
                             KERNEL_REPS)
            kernels["scan_by_key"] = kernel_row(
                abs_err, ms, plain_ms,
                tensor_bytes(keys.storage, x.storage, yi.storage), N_VEC,
                None)
            kernels["scan_by_key"].update(
                ms_range=turns["scan_by_key"]["ms_range"],
                route_ms=turns["route"]["ms"],
                route_ms_range=turns["route"]["ms_range"],
                exclusive_init_ms=turns["exclusive_init"]["ms"],
                exclusive_init_route_ms=turns["exclusive_init_route"]["ms"],
                host_us=host_us(calls["scan_by_key"]))
            rec.update(max_abs_err=abs_err, max_rel_err=rel,
                       exclusive_max_rel_err=rel_e, ms=ms, plain_ms=plain_ms,
                       library_ms=None, api_ms=api_ms,
                       exclusive_api_ms=cuda_ms(
                           lambda: vex.exclusive_scan_by_key(keys, x, ye),
                           KERNEL_REPS),
                       exclusive_init_api_ms=cuda_ms(
                           lambda: vex.exclusive_scan_by_key(keys, x, ye,
                                                             init=1.0),
                           KERNEL_REPS),
                       scan_by_key_Gelem_s=gelem(N_VEC, api_ms))
        else:
            check(torch.equal(yi.storage, ref_i)
                  and torch.equal(ye.storage, ref_e),
                  "scan_by_key max differs from plain")
        report(f"scan_by_key_{mono}_f32", rec)
    del yi, ye, ref_i, ref_e, route_i, route_e, seg

    # reduce_by_key of 2^24 values in runs of 64 (bench.py:594-609): one
    # launch of the keyed kernel, then the count to the host
    (okeys, ovals, m), launches = scan_run(
        ("reduce_by_key",), lambda: vex.reduce_by_key(keys, x))
    nruns = N_VEC // RUN
    check(m == nruns and torch.equal(
        okeys.storage, torch.arange(nruns, device=dev, dtype=torch.int32)),
        f"reduce_by_key: {m} runs, keys differ")
    ref64 = x.storage.double().view(nruns, RUN).sum(1)
    _, rel = errors(ovals.storage, ref64)
    check(rel <= SCAN_TOL["f32"], f"reduce_by_key sums: rel err {rel}")
    # the route it replaced (segscan, then compact) gives the same bits
    tails = torch.cat([heads[1:], heads.new_ones(1)])
    incl = segscan_apply(heads, x.storage, "add")
    kc, kv, kk = compact_apply(tails, incl, keys.storage)
    pc, pv_, pk = compact_plain(tails, incl, keys.storage)
    check(int(kc) == int(pc) == nruns and torch.equal(kv[:nruns], pv_[:nruns])
          and torch.equal(kk[:nruns], pk[:nruns]),
          "compaction kernel differs from plain")
    check(torch.equal(ovals.storage, kv[:nruns])
          and torch.equal(okeys.storage, kk[:nruns]),
          "reduce_by_key differs from the segscan + compact route")
    # a Python key predicate (the reference's key_eq) takes that route on
    # the main path: the segscan and compaction kernels, the same results
    (ek, ev, em), eq_launches = scan_run(
        ("segscan", "compact"),
        lambda: vex.reduce_by_key(keys, x, key_eq=lambda a, b: a == b))
    check(em == m and torch.equal(ek.storage, okeys.storage)
          and torch.equal(ev.storage, ovals.storage),
          "reduce_by_key with key_eq differs from the keyed kernel")
    # the row times one payload, the function of its library call,
    # boolean-mask indexing; the key_eq route moves two
    tails_b = tails.bool()
    kc1, kv1 = compact_apply(tails, incl)
    check(int(kc1) == nruns and torch.equal(kv1[:nruns], pv_[:nruns])
          and torch.equal(incl[tails_b], kv1[:nruns]),
          "one-payload compaction or x[flags] differs from plain")
    # bound to these tensors: the profiler at the end calls them again
    compact_calls = {
        "compact": lambda f=tails, v=incl: compact_apply(f, v),
        "library": lambda f=tails_b, v=incl: v[f],
        "compact_two": lambda f=tails, v=incl, k=keys.storage: compact_apply(
            f, v, k)}
    turns = in_turns(compact_calls)
    plain_ms = cuda_ms(lambda: compact_plain(tails, incl), KERNEL_REPS)
    two_bytes = (tensor_bytes(tails) + nruns * 2 * (
        incl.element_size() + keys.storage.element_size()) + 8)
    kernels["compact"] = kernel_row(
        0.0, turns["compact"]["ms"], plain_ms,
        tensor_bytes(tails) + nruns * 2 * incl.element_size() + 8, 0,
        turns["library"]["ms"])
    kernels["compact"].update(
        turns_row(turns, "compact", "library"),
        host_us=host_us(compact_calls["compact"]),
        two_payload_ms=turns["compact_two"]["ms"],
        two_payload_ms_range=turns["compact_two"]["ms_range"],
        two_payload_plain_ms=cuda_ms(lambda: compact_plain(
            tails, incl, keys.storage), KERNEL_REPS),
        two_payload_bound_ms=bound(two_bytes)[0],
        two_payload_host_us=host_us(compact_calls["compact_two"]))

    # the keyed kernel's launch (the count left on the card) in turns with
    # the route it replaced, called directly: flags, segscan, compact
    def rbk_route(k=k9, v=x.storage):
        h = segment_heads(k)
        t_ = torch.cat([h[1:], h.new_ones(1)])
        return compact_apply(t_, segscan_apply(h, v, "add"), *k)
    rbk_calls = {"reduce_by_key": lambda k=k9, v=x.storage:
                     reduce_by_key_launch(k, v),
                 "route": rbk_route}
    turns = in_turns(rbk_calls)
    scan_calls["reduce_by_key"] = rbk_calls["reduce_by_key"]
    scan_calls["reduce_by_key_route"] = rbk_route
    pm_, pvals, _ = reduce_by_key_plain(k9, x.storage, "add")
    check(pm_ == m, "reduce_by_key_plain counts another number of runs")
    rbk_err, _ = errors(ovals.storage, pvals)
    rbk_bytes = tensor_bytes(keys.storage, x.storage) + nruns * 8 + 8
    api_ms = cuda_ms(lambda: vex.reduce_by_key(keys, x), KERNEL_REPS)
    kernels["reduce_by_key"] = kernel_row(
        rbk_err, turns["reduce_by_key"]["ms"],
        cuda_ms(lambda: reduce_by_key_plain(k9, x.storage, "add"),
                KERNEL_REPS), rbk_bytes, N_VEC, None)
    kernels["reduce_by_key"].update(
        ms_range=turns["reduce_by_key"]["ms_range"],
        route_ms=turns["route"]["ms"],
        route_ms_range=turns["route"]["ms_range"],
        host_us=host_us(rbk_calls["reduce_by_key"]),
        api_ms=api_ms, api_host_us=host_us(lambda: vex.reduce_by_key(keys, x),
                                           20))
    report("reduce_by_key_runs64_f32", {
        "runs": m, "max_rel_err": rel, "launches": launches,
        "key_eq_launches": eq_launches,
        "ms": kernels["reduce_by_key"]["ms"],
        "route_ms": kernels["reduce_by_key"]["route_ms"],
        "compact_ms": kernels["compact"]["two_payload_ms"],
        "segscan_ms": kernels["segscan"]["ms"], "api_ms": api_ms,
        "bound_ms": kernels["reduce_by_key"]["bound_ms"],
        "reduce_by_key_Gelem_s": gelem(N_VEC, api_ms)})
    if args.profile:       # the calls timed above, dst given
        y = vex.vector(N_VEC, context=ctx)
        for tag, fn in (
                ("inclusive_scan", lambda: vex.inclusive_scan(x, y)),
                ("inclusive_scan_by_key",
                 lambda: vex.inclusive_scan_by_key(keys, x, y)),
                ("exclusive_scan_by_key_init",
                 lambda: vex.exclusive_scan_by_key(keys, x, y, init=1.0)),
                ("reduce_by_key", lambda: vex.reduce_by_key(keys, x)),
                ("reduce_by_key_key_eq", lambda: vex.reduce_by_key(
                    keys, x, key_eq=lambda a, b: a == b))):
            per_kernel, busy = profile_call(fn)
            report(f"profile_{tag}_2^24", {"device_busy": busy,
                                           **per_kernel})
    del okeys, ovals, ref64, kc, kv, kk, pc, pv_, pk, kc1, kv1, ek, ev, pvals
    del keys, x
    del heads
    torch.cuda.empty_cache()

    # reduce_by_key of 2^25 + 7 values in lognormal runs (mean ~64)
    g9 = np.random.default_rng(args.seed + 9)
    lens = np.maximum(1, g9.lognormal(np.log(RUN) - 0.5, 1.0,
                                      RBK_N_LARGE // 16)).astype(np.int64)
    nruns = int(np.searchsorted(np.cumsum(lens), RBK_N_LARGE)) + 1
    kt = torch.repeat_interleave(
        torch.arange(nruns, device=dev, dtype=torch.int32),
        torch.from_numpy(lens[:nruns]).to(dev))[:RBK_N_LARGE]
    keys = vex.vector(data=kt, context=ctx)
    x = rand(RBK_N_LARGE, torch.float32)
    (okeys, ovals, m), launches = scan_run(
        ("reduce_by_key",), lambda: vex.reduce_by_key(keys, x))
    check(m == nruns and torch.equal(
        okeys.storage, torch.arange(nruns, device=dev, dtype=torch.int32)),
        f"reduce_by_key lognormal: {m} runs of {nruns}, keys differ")
    ref64 = torch.zeros(nruns, dtype=torch.float64, device=dev).index_add_(
        0, kt.long(), x.storage.double())
    _, rel = errors(ovals.storage, ref64)
    check(rel <= SCAN_TOL["f32"], f"reduce_by_key lognormal: rel err {rel}")
    api_ms = cuda_ms(lambda: vex.reduce_by_key(keys, x), 10)
    report("reduce_by_key_lognormal_f32", {
        "n": RBK_N_LARGE, "runs": m, "max_rel_err": rel,
        "launches": launches, "api_ms": api_ms,
        "Gelem_s": gelem(RBK_N_LARGE, api_ms)})
    del kt, keys, x, okeys, ovals, ref64
    torch.cuda.empty_cache()

    # sort_by_key of 2^24 (i32 key, f32 value) pairs (bench.py:538-553)
    kh = g9.integers(0, 1 << 30, N_VEC).astype(np.int32)
    K = vex.vector(data=kh, context=ctx)
    V = rand(N_VEC, torch.float32)
    vh = V.to_numpy().copy()
    torch.cuda.synchronize()
    t = time.perf_counter()
    vex.sort_by_key(K, V)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    order = np.argsort(kh, kind="stable")
    check(np.array_equal(K.to_numpy(), kh[order])
          and np.array_equal(V.to_numpy(), vh[order]),
          "sort_by_key differs from numpy's stable argsort")
    sort_ms = cuda_ms(lambda: vex.sort_by_key(K, V), 10)
    report("sort_by_key_i32_f32", {
        "first_call_s": first_s, "api_ms": sort_ms,
        "library_ms": cuda_ms(lambda: torch.sort(K.storage, stable=True),
                              10),
        "sort_by_key_Mpairs_s": N_VEC / (sort_ms * 1e-3) / 1e6})
    del K, V, kh, vh, order

    # end to end: COO -> CSR of the phase-6 matrix from shuffled triples
    perm = torch.randperm(nnz, generator=gen, device=dev)
    rows_t = torch.repeat_interleave(
        torch.arange(RANDOM_N, device=dev, dtype=torch.int32),
        torch.from_numpy(np.diff(ptr)).to(dev))[perm]
    cols_t = torch.from_numpy(col).to(dev, torch.int32)[perm]
    vals_t = torch.from_numpy(val).to(dev)[perm]
    R, C, Vv = (vex.vector(data=a, context=ctx)
                for a in (rows_t, cols_t, vals_t))
    rh, ch, vh = (a.cpu().numpy() for a in (rows_t, cols_t, vals_t))
    del perm, rows_t, cols_t, vals_t

    def coo_to_csr():
        vex.sort_by_key((R, C), Vv)
        ones = vex.vector(nnz, dtype=torch.int32, fill=1, context=ctx)
        urows, counts, nr = vex.reduce_by_key(R, ones)
        cnt = torch.zeros(RANDOM_N + 1, dtype=torch.int32, device=dev)
        cnt[urows.storage.long()] = counts.storage
        return vex.exclusive_scan(vex.vector(data=cnt, context=ctx)), nr
    torch.cuda.synchronize()
    t = time.perf_counter()
    (ptr_v, nr), launches = scan_run(("scan", "reduce_by_key"), coo_to_csr)
    e2e_s = time.perf_counter() - t
    order = np.lexsort((ch, rh))            # stable: row, then column
    check(np.array_equal(ptr_v.to_numpy(), ptr)
          and np.array_equal(R.to_numpy(), rh[order])
          and np.array_equal(C.to_numpy(), ch[order])
          and np.array_equal(Vv.to_numpy(), vh[order]),
          "COO -> CSR differs from the host CSR")
    # the host CSR of phase 6 with its columns sorted within each row
    starts = np.repeat(ptr[:-1], np.diff(ptr))
    col_sorted = col[np.lexsort((col, starts))]
    check(np.array_equal(C.to_numpy(), col_sorted),
          "COO -> CSR columns differ from the host CSR's")
    report("coo_to_csr_random_f32", {
        "n": RANDOM_N, "nnz": nnz, "rows": nr, "e2e_s": e2e_s,
        "launches": launches})
    del R, C, Vv, ptr_v, rh, ch, vh, order, starts, col_sorted
    torch.cuda.empty_cache()

    # -- phase 10: random numbers at the bench's 2^24 ------------------------
    rseed = 1234 + args.seed
    idx = torch.arange(RNG_N, device=dev)
    got = {}

    def rng_path():
        for gname in ("philox", "threefry", "hw"):
            for normal in (False, True):
                for dname, dt in (("f32", torch.float32),
                                  ("f64", torch.float64)):
                    x = vex.vector(RNG_N, dtype=dt, context=ctx)
                    rnd = (vex.RandomNormal if normal else vex.Random)(
                        dt, gname)
                    x[:] = rnd(vex.element_index(), rseed)
                    got[gname, normal, dname] = (x.storage, rnd)
    _, launches = counted(("expr", "philox"), rng_path)
    main_launches["philox"] = launches["philox"]
    rec = {"launches": launches}
    for (gname, normal, dname), (t, rnd) in got.items():
        ref = rnd.plain(idx, rseed)
        tag = f"{gname}_{'normal' if normal else 'uniform'}_{dname}"
        if normal:
            _, rel = errors(t, ref)
            check(rel <= RNG_TOL[dname], f"{tag}: rel err {rel}")
            rec[f"{tag}_max_rel_err"] = rel
        else:
            check(torch.equal(t, ref), f"{tag} differs from its plain version")
            check(0.0 <= t.min().item() and t.max().item() < 1.0,
                  f"{tag} leaves [0, 1)")
        if gname == "hw":
            check(torch.equal(t, got["philox", normal, dname][0]),
                  f"{tag} differs from the fused philox generator")
    f32n = got["philox", True, "f32"][0]
    rec["philox_normal_f32_mean"] = f32n.double().mean().item()
    rec["philox_normal_f32_std"] = f32n.double().std().item()
    check(abs(rec["philox_normal_f32_mean"]) < 5 / RNG_N ** 0.5
          and abs(rec["philox_normal_f32_std"] - 1) < 5 / (2 * RNG_N) ** 0.5,
          "philox normals are not standard normal (5 sigma)")
    del got, f32n
    torch.cuda.empty_cache()
    # the known answers: the Philox kernel and the fused rounds
    for ctr, key, want in PHILOX_KATS:
        k = philox_bits(1, 4, key, c123=ctr[1:],
                        counters=torch.tensor([ctr[0]], device=dev))
        r = generator_rounds("philox", torch.tensor(ctr, device=dev).view(4, 1),
                             torch.tensor(key, device=dev).view(2, 1))
        for name, w in (("philox_bits", k), ("philox rounds", r)):
            check(tuple(int(v) & 0xFFFFFFFF for v in w[:, 0].cpu()) == want,
                  f"{name} misses the known answer for {ctr}, {key}")
    for ctr, key, want in THREEFRY_KATS:
        r = generator_rounds("threefry",
                             torch.tensor(ctr, device=dev).view(2, 1),
                             torch.tensor(key, device=dev).view(2, 1))
        check(tuple(int(v) & 0xFFFFFFFF for v in r[:, 0].cpu()) == want,
              f"threefry rounds miss the known answer for {ctr}, {key}")
    rec["known_answers"] = len(PHILOX_KATS) * 2 + len(THREEFRY_KATS)
    # philox_bits at 2^24 counters, four words, against its plain version
    key = (rseed, 0)
    k = philox_bits(RNG_N, 4, key, device=dev)
    p = philox_bits_plain(RNG_N, 4, key, device=dev)
    check(torch.equal(k, p), "philox_bits differs from its plain version")
    lib = _library_path("vexcl_philox")[0]
    instr = sass_instructions(lib, "vex_philox_bits_w4_iota")
    instr1 = sass_instructions(lib, "vex_philox_bits_w1_iota")
    ops_s = scheduler_ops_s()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    kernels["philox"] = kernel_row(
        0.0, cuda_ms(lambda: philox_bits(RNG_N, 4, key, device=dev),
                     KERNEL_REPS),
        cuda_ms(lambda: philox_bits_plain(RNG_N, 4, key, device=dev)),
        tensor_bytes(k), instr * RNG_N,
        cuda_ms(lambda: torch.rand(RNG_N, device=dev, generator=g),
                KERNEL_REPS), ops_s=ops_s)
    b1 = bound(RNG_N * 4, instr1 * RNG_N, ops_s)
    rec.update(philox_bits_sass_instructions=instr,
               philox_bits_1word_sass_instructions=instr1,
               scheduler_ops_s=ops_s,
               philox_bits_1word_ms=cuda_ms(
                   lambda: philox_bits(RNG_N, 1, key, device=dev),
                   KERNEL_REPS),
               philox_bits_1word_bound_ms=b1[0],
               philox_bits_1word_bound_by=b1[1],
               library_note="torch.rand: Philox4x32-10 family, not the same "
                            "stream")
    del k, p
    x = vex.vector(RNG_N, context=ctx)
    for gname in ("philox", "threefry"):
        rnd = vex.Random(torch.float32, gname)
        api_ms = cuda_ms(lambda: x.assign(rnd(vex.element_index(), rseed)),
                         KERNEL_REPS)
        rec[f"{gname}_uniform_f32_api_ms"] = api_ms
        rec[f"{gname}_Grand_s"] = RNG_N / (api_ms * 1e-3) / 1e9
    rnd = vex.Random(torch.float32, "hw")
    rec["hw_uniform_f32_api_ms"] = cuda_ms(
        lambda: x.assign(rnd(vex.element_index(), rseed)), KERNEL_REPS)
    report("random_2^24", rec)
    del x, idx

    # the Monte-Carlo models at their defaults
    for dname, dt in (("f32", torch.float32), ("f64", torch.float64)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pi, launches = counted(("reduce",), lambda: estimate_pi(
            PI_N, context=ctx, dtype=dt))
        pi_ms = (time.perf_counter() - t) * 1e3
        main_launches["reduce"] += launches["reduce"]
        n = PI_N
        rnd = vex.Random(dt)
        i = vex.element_index(0, n)
        xe, ye = rnd(i, 42), rnd(i, 43)
        e, an, ty, lv = prepare(vex.if_else(xe * xe + ye * ye < 1.0, 1.0, 0.0),
                                n, dev)
        kcount = pi * n / 4
        pcount = map_reduce_plain(e, an, ty, lv, n, "SUM", dev).item()
        kernel_ms = cuda_ms(lambda: map_reduce(e, an, ty, lv, n, "SUM", dev),
                            KERNEL_REPS)
        flips = abs(kcount - pcount)
        check(flips == 0 if dname == "f64" else flips <= PI_F32_FLIPS,
              f"estimate_pi {dname}: count {kcount} against plain {pcount}")
        check(abs(pi - 3.141592653589793) < PI_TOL,
              f"estimate_pi {dname}: {pi}")
        report(f"estimate_pi_{dname}", {
            "pi": pi, "abs_err": abs(pi - 3.141592653589793),
            "count": kcount, "plain_count": pcount, "count_diff": flips,
            "first_call_ms": pi_ms, "map_reduce_ms": kernel_ms,
            "launches": launches,
            "api_ms": cuda_ms(lambda: estimate_pi(PI_N, context=ctx,
                                                  dtype=dt))})
    torch.cuda.synchronize()
    t = time.perf_counter()
    gmean, launches = counted(("expr", "reduce"), lambda: gbm_terminal_mean(
        GBM_PATHS, GBM_STEPS, context=ctx))
    gbm_ms = (time.perf_counter() - t) * 1e3
    launches["philox"] = philox_bits.launches
    main_launches["expr"] += launches["expr"]
    main_launches["reduce"] += launches["reduce"]
    npaths, nsteps = GBM_PATHS, GBM_STEPS
    s64 = torch.full((npaths,), 100.0, dtype=torch.float64, device=dev)
    znorm = vex.RandomNormal(torch.float32)
    gi = torch.arange(npaths, device=dev)
    drift, vol = (0.05 - 0.5 * 0.2 * 0.2) / 64, 0.2 * (1 / 64) ** 0.5
    for step in range(nsteps):
        s64 *= torch.exp(drift + vol * znorm.plain(gi, 7 * 1000 + step)
                         .double())
    plain_mean = s64.mean().item()
    rel = abs(gmean - plain_mean) / plain_mean
    check(rel <= GBM_PLAIN_TOL, f"gbm {gmean} against plain f64 {plain_mean}")
    check(abs(gmean - GBM_MEAN) < GBM_MEAN_TOL,
          f"gbm {gmean} against the analytic mean {GBM_MEAN}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    gbm_terminal_mean(GBM_PATHS, GBM_STEPS, context=ctx)
    warm_ms = (time.perf_counter() - t) * 1e3
    report("gbm_terminal_mean", {
        "mean": gmean, "plain_f64_mean": plain_mean, "rel_err": rel,
        "analytic": GBM_MEAN, "first_call_ms": gbm_ms, "host_ms": warm_ms,
        "launches": launches})
    if args.profile:       # where the Monte-Carlo models' time goes
        for tag, fn in (
                ("estimate_pi_f32", lambda: estimate_pi(PI_N, context=ctx)),
                ("gbm_terminal_mean", lambda: gbm_terminal_mean(
                    GBM_PATHS, GBM_STEPS, context=ctx))):
            per_kernel, busy = profile_call(fn, 3)
            report(f"profile_{tag}", {"device_busy": busy, **per_kernel})
    del s64, gi
    torch.cuda.empty_cache()

    # -- phase 11: the runtime ------------------------------------------------
    x, y = rand(RUNTIME_N, torch.float32), rand(RUNTIME_N, torch.float32)
    user_triton = triton_module(USER_TRITON).axpy
    triple = vex.CustomKernel(USER_CUDA, name="triple")
    axpy = vex.CustomKernel(USER_CUDA, name="axpy")
    axpy_tl = vex.CustomKernel(user_triton, BLOCK=1024)
    outs = {}

    def user_kernels():
        outs["triple"] = triple(x)
        outs["axpy"] = axpy(x, y)
        outs["axpy_triton"] = axpy_tl(x, y)
        outs["launch"] = vex.backend.launch(USER_CUDA, x, name="triple",
                                            block=128)
    _, launches = counted(("custom",), user_kernels)
    main_launches["custom"] = launches["custom"]
    xs, ys = x.storage, y.storage
    rec = {"launches": launches}
    for name, ref, fn, plain in (
            ("triple", 3 * xs, lambda: triple(x), lambda: 3 * xs),
            ("axpy", 2 * xs + ys, lambda: axpy(x, y), lambda: 2 * xs + ys),
            ("axpy_triton", 2 * xs + ys, lambda: axpy_tl(x, y),
             lambda: 2 * xs + ys)):
        abs_err, rel_ = errors(outs[name].storage, ref)
        check(rel_ <= 1e-6, f"CustomKernel {name}: rel err {rel_}")
        rec[f"{name}_max_abs_err"] = abs_err
        rec[f"{name}_ms"] = cuda_ms(fn, KERNEL_REPS)
        rec[f"{name}_plain_ms"] = cuda_ms(plain, KERNEL_REPS)
    check(torch.equal(outs["launch"].storage, outs["triple"].storage),
          "launch() differs from CustomKernel")
    # the user kernel's device time, by the profiler: back to back, the
    # calls above also time the host's launch path
    per_kernel, _ = profile_call(lambda: triple(x), KERNEL_REPS)
    rec["triple_device_ms"] = sum(v for name, v in per_kernel.items()
                                  if "triple" in name) * 1e-3
    check(rec["triple_device_ms"] > 0, "the profiler saw no user kernel")
    kernels["custom"] = kernel_row(
        errors(outs["triple"].storage, 3 * xs)[0], rec["triple_device_ms"],
        rec["triple_plain_ms"], 2 * tensor_bytes(xs), RUNTIME_N,
        cuda_ms(lambda: torch.mul(xs, 3.0), KERNEL_REPS))
    del outs
    # events, enqueue onto the card, dlpack
    ev = vex.enqueue_marker(ctx)
    ev.wait()
    check(ev.complete, "a marker is not complete after wait()")
    vex.enqueue_barrier(ctx)
    cpu = vex.Context(vex.Filter.CPU, set_current=False)
    xe = vex.vector(RUNTIME_N, context=cpu)
    vex.enqueue(ctx)(xe)[:] = 2 * x
    check(xe.storage.device == dev and torch.equal(xe.storage, 2 * xs),
          "enqueue(ctx)(x)[:] = 2*a did not run on the card")
    xd = vex.interop.from_dlpack(vex.interop.to_dlpack(x))
    check(xd.storage.data_ptr() == xs.data_ptr(),
          "the dlpack round trip copied the storage")
    rec["events_enqueue_dlpack"] = "ok"
    # the profiler around the gbm run
    prof = vex.profiler("runtime", context=ctx)
    prof.tic_cl("gbm_terminal_mean")
    gbm_terminal_mean(GBM_PATHS, GBM_STEPS, context=ctx)
    prof.toc("gbm_terminal_mean")
    print(prof)
    rec["profiled_gbm_s"] = prof.root.children["gbm_terminal_mean"].watch.total
    report("runtime_custom_kernels", rec)
    del x, y, xe, xd, xs, ys
    torch.cuda.empty_cache()

    # bicgstab on the phase-6 matrix, made non-symmetric and diagonally
    # dominant: 1 + its absolute row sum added on the diagonal
    lens = np.diff(ptr)
    bptr = np.concatenate([[0], np.cumsum(lens + 1)])
    diag_at = bptr[1:] - 1
    keep = np.ones(bptr[-1], dtype=bool)
    keep[diag_at] = False
    bcol = np.empty(bptr[-1], dtype=np.int64)
    bval = np.empty(bptr[-1], dtype=np.float64)
    bcol[keep], bval[keep] = col, val
    bcol[diag_at] = np.arange(RANDOM_N)
    rows = np.repeat(np.arange(RANDOM_N), lens)
    bval[diag_at] = 1.0 + np.bincount(rows, weights=np.abs(val),
                                      minlength=RANDOM_N)
    A = vex.SpMat(RANDOM_N, RANDOM_N, bptr, bcol, bval.astype(np.float32),
                  context=ctx)
    b_host = (np.random.default_rng(args.seed + 11).random(RANDOM_N)
              - 0.5).astype(np.float32)
    b = vex.vector(data=b_host, context=ctx)
    tol = BICGSTAB_TOL * float(np.linalg.norm(b_host.astype(np.float64)))
    vex.interop.bicgstab(A, b, tol=tol, maxiter=2)    # compiles the kernels
    check(A.device.format == irregular,
          f"BiCGStab: SpMat picked {A.device.format}")
    keys = ("expr", "reduce") + spmv_keys(A.device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    (u, iters), launches = counted(keys, lambda: vex.interop.bicgstab(
        A, b, tol=tol, maxiter=BICGSTAB_MAXITER))
    solve_s = time.perf_counter() - t
    bm = {k_: torch.from_numpy(a).to(dev) for k_, a in
          (("ptr", bptr), ("col", bcol.astype(np.int32)), ("val", bval))}
    b64 = torch.from_numpy(b_host).to(dev, torch.float64)

    def bmv(v):
        return csr_spmv_plain(RANDOM_N, bm["ptr"], bm["col"], bm["val"], v)

    torch.cuda.synchronize()
    t = time.perf_counter()
    xr, it = plain_bicgstab(bmv, b64, tol, BICGSTAB_MAXITER)
    torch.cuda.synchronize()
    plain_solve_s = time.perf_counter() - t
    x64 = u.storage.to(torch.float64)
    check(torch.isfinite(x64).all().item(), "BiCGStab: x not finite")
    x_rel = (torch.linalg.vector_norm(x64 - xr)
             / torch.linalg.vector_norm(xr)).item()
    res_rel = (torch.linalg.vector_norm(b64 - bmv(x64))
               / torch.linalg.vector_norm(b64)).item()
    check(iters < BICGSTAB_MAXITER, f"BiCGStab did not converge in {iters}")
    check(x_rel <= BICGSTAB_X_TOL, f"BiCGStab x differs by {x_rel}")
    check(res_rel <= 10 * BICGSTAB_TOL,
          f"BiCGStab residual fell only to {res_rel} of |b|")
    report("bicgstab_random_f32", {
        "n": RANDOM_N, "nnz": int(bptr[-1]), "iterations": iters,
        "plain_f64_iterations": it, "ms_per_iter": solve_s / iters * 1e3,
        "plain_f64_ms_per_iter": plain_solve_s / max(it, 1) * 1e3,
        "x_rel_err_vs_f64": x_rel, "residual_over_b": res_rel,
        "launches": launches})
    del A, b, u, bm, b64, xr, x64
    del ptr, col, val
    torch.cuda.empty_cache()

    # -- phase 12: fused multi-assignment, the generator, the kinds ---------
    # LorenzEnsemble(2^22) as bench.py:721 builds it (r in [0.1, 50],
    # sigma 10, b 8/3, dt 0.01, seed 0: the constructor's defaults), in
    # f32 and f64: one launch a step, against the plain version of the
    # same recorded tree and a hand-written CUDA RK4 kernel
    lorenz = {}
    for dname, npdt in (("f32", np.float32), ("f64", np.float64)):
        t = time.perf_counter()
        ens = LorenzEnsemble(LORENZ_N, dtype=npdt, context=ctx,
                             seed=args.seed)
        ref = LorenzEnsemble.from_arrays(*(v.storage.clone() for v in (
            ens.x, ens.y, ens.z, ens.R)), context=ctx)
        host_build_s = time.perf_counter() - t
        raw = vex.CustomKernel(RAW_LORENZ, name=f"lorenz_{dname}")
        rx, ry, rz, rR = (vex.vector(data=v.storage, context=ctx)
                          for v in (ens.x, ens.y, ens.z, ens.R))
        plain = ref._step.prepare(ref.x, ref.y, ref.z, ref.R)
        rec, done = {"host_build_s": host_build_s}, 0
        for steps, tol in zip((1, LORENZ_STEPS - 1), LORENZ_TOL[dname]):
            t = time.perf_counter()
            _, launches = counted(("multi",), lambda: ens.step(steps))
            rec.setdefault("first_step_s", time.perf_counter() - t)
            add_launches(launches)
            check(launches["multi"] == steps,
                  f"Lorenz {dname}: {launches} launches for {steps} steps")
            for _ in range(steps):
                assign_multi_plain(*plain)
                rx = raw(rx, ry, rz, rR)
            done += steps
            for name, a, p_, r in zip("xyz", (ens.x, ens.y, ens.z),
                                      (ref.x, ref.y, ref.z), (rx, ry, rz)):
                _, rel_p = errors(a.storage, p_.storage)
                _, rel_r = errors(a.storage, r.storage)
                check(a.dtype == p_.dtype and rel_p <= tol and rel_r <= tol,
                      f"Lorenz {dname} {name} after {done} steps: rel err "
                      f"{rel_p} (plain), {rel_r} (raw CUDA)")
                rec[f"{name}_rel_err_plain_{done}"] = rel_p
                rec[f"{name}_rel_err_raw_{done}"] = rel_r
        turns = in_turns({"step": ens.step,
                          "raw": lambda: raw(rx, ry, rz, rR)})
        ratios = [a / b for a, b in zip(turns["step"]["times"],
                                        turns["raw"]["times"])]
        per_kernel, _ = profile_call(ens.step, KERNEL_REPS)
        check(len(per_kernel) == 1
              and "assign_kernel" in next(iter(per_kernel)),
              f"a Lorenz step is not one kernel: {per_kernel}")
        nbytes = 7 * LORENZ_N * np.dtype(npdt).itemsize
        rec.update(
            step_ms=turns["step"]["ms"], step_ms_range=turns["step"]["ms_range"],
            raw_cuda_ms=turns["raw"]["ms"],
            raw_cuda_ms_range=turns["raw"]["ms_range"],
            lorenz_rk4_Gsteps_s=LORENZ_N / (turns["step"]["ms"] * 1e-3) / 1e9,
            lorenz_overhead_vs_raw_cuda=statistics.median(ratios),
            overhead_range=[min(ratios), max(ratios)],
            device_us=next(iter(per_kernel.values())),
            host_us=host_us(ens.step),
            bound_ms=bound(nbytes)[0])
        # the kernel alone, into new outputs: its row of the kernels line
        e, an, ty, lv, outs = ens._step.prepare(ens.x, ens.y, ens.z, ens.R)
        rec["dag_ops"] = dag_ops(e)
        ko = [torch.empty_like(o) for o in outs]
        po = [torch.empty_like(o) for o in outs]
        assign_multi(e, an, ty, lv, ko)
        assign_multi_plain(e, an, ty, lv, po)
        rec["kernel_max_abs_err"] = max(errors(k_, p_)[0]
                                        for k_, p_ in zip(ko, po))
        rec["kernel_ms"] = cuda_ms(lambda: assign_multi(e, an, ty, lv, ko),
                                   KERNEL_REPS)
        rec["plain_ms"] = cuda_ms(lambda: assign_multi_plain(e, an, ty, lv,
                                                             po))
        report(f"lorenz_rk4_{dname}", rec)
        parent = PARENT_LORENZ[dname]
        print(f"lorenz {dname} against the parent: API step host_us "
              f"{rec['host_us']:.2f} (parent {parent['host_us']}), "
              f"step_ms {rec['step_ms']:.4f} (parent {parent['step_ms']}), "
              f"lorenz_overhead_vs_raw_cuda "
              f"{rec['lorenz_overhead_vs_raw_cuda']:.3f} (parent "
              f"{parent['overhead']})")
        lorenz[dname] = rec
        del ens, ref, raw, rx, ry, rz, rR, plain, e, lv, outs, ko, po
        torch.cuda.empty_cache()
    f32 = lorenz["f32"]
    # the row's time is the profiler's: back to back, the events read the
    # host's ~0.1 ms of launching a 30-argument kernel (events_ms)
    kernels["multi"] = kernel_row(
        f32["kernel_max_abs_err"], f32["device_us"] * 1e-3, f32["plain_ms"],
        7 * LORENZ_N * 4, f32["dag_ops"] * LORENZ_N, None)
    kernels["multi"].update(device_us=f32["device_us"],
                            events_ms=f32["kernel_ms"],
                            host_us=f32["host_us"])

    # the rest of the new path at 2^24 f32, each against its plain version
    x, y = rand(MULTI_N, torch.float32), rand(MULTI_N, torch.float32)
    xs, ys = x.storage.clone(), y.storage.clone()
    rec = {}
    _, launches = counted(("multi",), lambda: vex.tie(x, y).assign(
        (x + y, x - y)))
    add_launches(launches)
    check(launches["multi"] == 1 and torch.equal(x.storage, xs + ys)
          and torch.equal(y.storage, xs - ys), "tie(x, y) = (x+y, x-y)")
    xs, ys = x.storage.clone(), y.storage.clone()
    _, launches = counted(("multi",), lambda: vex.tie(x, y).assign((y, x)))
    add_launches(launches)
    check(launches["multi"] == 1 and torch.equal(x.storage, ys)
          and torch.equal(y.storage, xs), "the swap tie(x, y) = (y, x)")
    e, an, ty, lv = prepare_multi([x + y, x - y], MULTI_N, dev)
    ko = [torch.empty_like(xs) for _ in range(2)]
    po = [torch.empty_like(xs) for _ in range(2)]
    rec["tie_ms"] = cuda_ms(lambda: assign_multi(e, an, ty, lv, ko),
                            KERNEL_REPS)
    assign_multi_plain(e, an, ty, lv, po)
    check(all(torch.equal(k_, p_) for k_, p_ in zip(ko, po)),
          "tie kernel differs from its plain version")
    rec["tie_plain_ms"] = cuda_ms(lambda: assign_multi_plain(e, an, ty, lv,
                                                             po))
    rec["tie_bound_ms"] = bound(4 * 4 * MULTI_N)[0]
    del e, lv, ko, po
    # a 3-component multivector: += with a builtin, make_temp, a function
    m = vex.multivector(components=[x, y, rand(MULTI_N, torch.float32)],
                        context=ctx)
    m2 = vex.multivector(components=[rand(MULTI_N, torch.float32)
                                     for _ in range(3)], context=ctx)
    old = [c.storage.clone() for c in m.components]
    o2 = [c.storage for c in m2.components]

    @vex.function
    def squared_radius(a, b):
        return a * a + b * b

    def multivector_path():
        m.assign(vex.sin(m2) * 0.5, "+=")
        tmp = vex.make_temp(1, m2 * 2)
        m3[:] = tmp * tmp + tmp
        z[:] = squared_radius(x, y)
    m3 = vex.multivector(MULTI_N, 3, context=ctx)
    z = vex.vector(MULTI_N, context=ctx)
    _, launches = counted(("multi", "expr"), multivector_path)
    add_launches(launches)
    check(launches["multi"] == 2, f"multivector path: {launches}")
    for c, h, h2 in zip(m.components, old, o2):
        _, rel = errors(c.storage, h + torch.sin(h2) * 0.5)
        check(rel <= MV_TOL["f32"], f"m += sin(m2) * 0.5: rel err {rel}")
    for c, h2 in zip(m3.components, o2):
        _, rel = errors(c.storage, (h2 * 2) * (h2 * 2) + h2 * 2)
        check(rel <= MV_TOL["f32"], f"make_temp over m2: rel err {rel}")
    xs, ys = x.storage, y.storage
    _, rel = errors(z.storage, xs * xs + ys * ys)
    check(rel <= MV_TOL["f32"], f"a vex.function body: rel err {rel}")
    rec["multivector_ops"] = "ok"
    # the Reductor's kinds: MIN_MAX (exact; NaN), Kahan, a multivector
    u = rand(MULTI_N, torch.float32)
    u[:] = u - 0.5
    uh = u.storage
    mm = vex.Reductor(vex.MIN_MAX)
    (mn, mx), launches = counted(("reduce_multi",), lambda: mm(u))
    add_launches(launches)
    check((mn, mx) == (uh.min().item(), uh.max().item()),
          f"MIN_MAX: {(mn, mx)}")
    e, an, ty, lv = prepare_multi([u], MULTI_N, dev)
    pairs = [(e[0], "MIN"), (e[0], "MAX")]
    err = max(abs(k_.item() - p_.item()) for k_, p_ in zip(
        map_reduce_multi(pairs, an, ty, lv, MULTI_N, dev),
        map_reduce_multi_plain(pairs, an, ty, lv, MULTI_N, dev)))
    check(err == 0, f"MIN_MAX kernel differs from its plain version: {err}")
    turns = in_turns({
        "kernel": lambda: map_reduce_multi(pairs, an, ty, lv, MULTI_N, dev),
        "library": lambda: torch.aminmax(uh)})
    kernels["reduce_multi"] = kernel_row(
        err, turns["kernel"]["ms"],
        cuda_ms(lambda: map_reduce_multi_plain(pairs, an, ty, lv, MULTI_N,
                                               dev)),
        tensor_bytes(uh), 2 * MULTI_N, turns["library"]["ms"])
    kernels["reduce_multi"].update(
        ms_range=turns["kernel"]["ms_range"],
        library_ms_range=turns["library"]["ms_range"],
        host_us=host_us(lambda: map_reduce_multi(pairs, an, ty, lv, MULTI_N,
                                                 dev)))
    per_kernel, _ = profile_call(
        lambda: map_reduce_multi(pairs, an, ty, lv, MULTI_N, dev),
        KERNEL_REPS)
    kernels["reduce_multi"]["device_us"] = sum(
        v for name, v in per_kernel.items() if "reduce_kernel" in name)
    check(kernels["reduce_multi"]["device_us"] > 0,
          "the profiler saw no map-reduce kernel")
    per_kernel, _ = profile_call(lambda: torch.aminmax(uh), KERNEL_REPS)
    kernels["reduce_multi"]["library_device_us"] = sum(per_kernel.values())
    uh[MULTI_N - 3] = float("nan")
    mn, mx = mm(u)
    check(mn != mn and mx != mx, f"MIN_MAX with a NaN: {(mn, mx)}")
    # Kahan: 1.0 followed by 2^24 values of 1e-8
    kh = torch.full((MULTI_N + 1,), 1e-8, device=dev)
    kh[0] = 1.0
    kv = vex.vector(data=kh, context=ctx)
    kahan, launches = counted(("reduce_multi",),
                              lambda: vex.Reductor(vex.SUM_Kahan)(kv))
    add_launches(launches)
    exact = kh.double().sum().item()
    ulp = float(np.spacing(np.float32(exact)))
    plain_k = kahan_sum_plain(kh).item()
    torch_sum = kh.sum().item()
    check(abs(kahan - exact) <= 2 * ulp and abs(kahan - exact)
          < abs(torch_sum - exact),
          f"SUM_Kahan {kahan}, f64 {exact}, torch.sum {torch_sum}")
    rec.update(kahan=kahan, kahan_plain=plain_k, f64_sum=exact,
               torch_sum_f32=torch_sum, kahan_err_ulp=(kahan - exact) / ulp,
               plain_err_ulp=(plain_k - exact) / ulp,
               torch_sum_err_ulp=(torch_sum - exact) / ulp)
    del kh, kv
    # a Reductor over the 3-component multivector, and combined kinds
    sums, launches = counted(("reduce_multi",),
                             lambda: vex.Reductor(vex.SUM)(m2))
    add_launches(launches)
    for got, h2 in zip(sums, o2):
        p_ = h2.double().sum().item()
        check(abs(got - p_) <= SUM_TOL["f32"] * max(1.0, abs(p_)),
              f"Reductor(SUM) over a multivector: {got} vs {p_}")
    comb = vex.Reductor(vex.CombineReductors(vex.SUM, vex.MIN, vex.MAX))
    got, launches = counted(("reduce_multi",), lambda: comb(x * 2))
    add_launches(launches)
    (b,), an, ty, lv = prepare_multi([x * 2], MULTI_N, dev)
    want = map_reduce_multi_plain([(b, k_) for k_ in ("SUM", "MIN", "MAX")],
                                  an, ty, lv, MULTI_N, dev)
    check(abs(got[0] - want[0].item()) <= SUM_TOL["f32"] * abs(got[0])
          and got[1:] == (want[1].item(), want[2].item()),
          f"CombineReductors(SUM, MIN, MAX): {got}")
    del m, m2, m3, z, u, uh, old, o2, e, lv, pairs
    torch.cuda.empty_cache()
    # the phase-6 matrix on a 3-component multivector, and its values as a
    # vector-valued (nnz, 2) matrix on a 2-component one
    ptr, col, val, nnz = random_lognormal_csr(RANDOM_N, seed=args.seed)
    A = vex.SpMat(RANDOM_N, RANDOM_N, ptr, col, val, context=ctx)
    A2 = vex.SpMat(RANDOM_N, RANDOM_N, ptr, col,
                   np.stack([val, 2 * val], axis=1), context=ctx)
    xm = vex.multivector(components=[rand(RANDOM_N, torch.float32)
                                     for _ in range(3)], context=ctx)
    ym = vex.multivector(RANDOM_N, 3, context=ctx)
    y2 = vex.multivector(RANDOM_N, 2, context=ctx)
    csr = {k_: torch.from_numpy(a).to(dev) for k_, a in (
        ("ptr", ptr), ("col", col.astype(np.int32)), ("val", val))}

    def products():
        ym[:] = A * xm
        x2 = vex.multivector(components=xm.components[:2], context=ctx)
        y2[:] = A2 * x2 + x2
    _, launches = counted(("csr", "multi"), products)
    add_launches(launches)
    check(launches == {"csr": 5, "multi": 2},
          f"SpMat x multivector: {launches}")
    for j in range(3):
        want_ = csr_spmv_plain(RANDOM_N, csr["ptr"], csr["col"], csr["val"],
                               xm(j).storage)
        _, rel = errors(ym(j).storage, want_)
        check(rel <= SPMV_TOL["f32"], f"A * multivector: rel err {rel}")
        if j < 2:
            _, rel = errors(y2(j).storage,
                            (j + 1) * want_ + xm(j).storage)
            check(rel <= SPMV_TOL["f32"], f"vector-valued A: rel err {rel}")
    del A, A2, xm, ym, y2, csr, ptr, col, val
    # enqueue onto tie(x, y): CPU targets migrate to the card
    cpu = vex.Context(vex.Filter.CPU, set_current=False)
    xc, yc = (vex.vector(MULTI_N, context=cpu) for _ in range(2))
    _, launches = counted(("multi",), lambda: vex.enqueue(ctx)(
        vex.tie(xc, yc)).assign((x * 2, x + y)))
    add_launches(launches)
    check(launches["multi"] == 1 and xc.context is ctx
          and torch.equal(xc.storage, x.storage * 2)
          and torch.equal(yc.storage, x.storage + y.storage),
          "enqueue(ctx)(tie(x, y))[:] = (2x, x+y)")
    report("multi_assign_and_kinds", rec)
    del x, y, xs, ys, xc, yc
    torch.cuda.empty_cache()

    # -- phase 13: views: indexed loads (V1), reduce_view (V2), stores and
    # atomic updates through a view (V3), any_of/all_of (K2) -------------
    def views_phase():
        """Phase 13, in a scope of its own: its names do not touch the
        phases' before it."""
        t13 = time.perf_counter()
        g, nv = VIEW_GRID, VIEW_N
        slc = vex.slicer((g, g))
        rec = {}

        def bitwise(a, b):
            if a.dtype.is_floating_point:
                it = {2: torch.int16, 4: torch.int32,
                      8: torch.int64}[a.element_size()]
                a, b = a.view(it), b.view(it)
            return a.shape == b.shape and torch.equal(a, b)

        def same(a, b):
            """Equal values, NaN where a NaN is (a NaN's bits may differ)."""
            nan = torch.isnan(b)
            return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan],
                                                                    b[~nan])

        def api(keys, fn, want):
            """An API call with its counters at 0 before it: each of
            ``keys`` launched exactly ``want`` times."""
            out, got = counted(keys, fn)
            check(all(v == want for v in got.values()),
                  f"launches {got}, expected {want} each")
            add_launches(got)
            return out

        def view_timing(tag, fn, plain_fn, nbytes, library, kernel_name):
            """Timings of one view kernel call: in turns with its library call
            where there is one (median and range), device µs by the profiler,
            host µs a call, the plain version, the bound."""
            out = {}
            if library is not None:
                turns = in_turns({"kernel": fn, "library": library})
                out.update(turns_row(turns, "kernel", "library"))
            else:
                out["ms"] = cuda_ms(fn, KERNEL_REPS)
                out["library_ms"] = None
            per_kernel, _ = profile_call(fn, KERNEL_REPS)
            names = (kernel_name,) if isinstance(kernel_name, str) \
                else kernel_name
            out["device_us"] = sum(v for name, v in per_kernel.items()
                                   if any(k_ in name for k_ in names))
            if len(names) > 1:
                out["device_us_by_kernel"] = {
                    k_: sum(v for name, v in per_kernel.items() if k_ in name)
                    for k_ in names}
            check(out["device_us"] > 0, f"{tag}: the profiler saw no "
                  f"{kernel_name}: {per_kernel}")
            if library is not None:
                per_kernel, _ = profile_call(library, KERNEL_REPS)
                out["library_device_us"] = sum(per_kernel.values())
            out["host_us"] = host_us(fn)
            out["plain_ms"] = cuda_ms(plain_fn)
            out["bound_ms"], out["bound_by"] = bound(nbytes)
            out["bytes"] = nbytes
            print(f"{tag}: " + ", ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in out.items() if k not in ("ms_range",
                                                     "library_ms_range")))
            return out

        def v1(tag, expr, out, library, nbytes, lib_check=None,
               kernel_name="assign_kernel"):
            """A V1 assignment against its plain version and over two calls
            (bitwise), one launch through the API, and its timings; the
            profiler counts ``kernel_name`` (the tiled kernel for a
            transpose)."""
            api(("indexed",), lambda: out.assign(expr), 1)
            e, an, ty, lv = prepare(expr, out.size, dev)
            k = torch.empty_like(out.storage)
            p = torch.empty_like(k)
            assign(e, an, ty, lv, k)
            assign_plain(e, an, ty, lv, p)
            check(bitwise(k, p) and bitwise(k, out.storage),
                  f"{tag}: the kernel differs from its plain version")
            if lib_check is not None:
                check(bitwise(k, lib_check()), f"{tag}: the library call "
                      "differs")
            return view_timing(tag, lambda: assign(e, an, ty, lv, k),
                               lambda: assign_plain(e, an, ty, lv, p), nbytes,
                               library, kernel_name)

        interior = g - 2
        for dname, dt in (("f32", torch.float32), ("f64", torch.float64)):
            x = rand(nv, dt)
            y = vex.vector(interior * interior, dtype=dt, context=ctx)
            xv = x.storage.view(g, g)
            rec[f"interior_{dname}"] = v1(
                f"view_interior_{dname}",
                2 * slc[vex.r(1, g - 1), vex.r(1, g - 1)](x), y,
                lambda: torch.mul(xv[1:-1, 1:-1], 2),
                2 * interior * interior * x.storage.element_size(),
                lambda: torch.mul(xv[1:-1, 1:-1], 2).reshape(-1))
            rec[f"transpose_{dname}"] = v1(
                f"view_transpose_{dname}", vex.reshape(x, (g, g), (1, 0)),
                vex.vector(nv, dtype=dt, context=ctx),
                lambda: xv.t().contiguous(),
                2 * x.storage.element_size() * nv,
                lambda: xv.t().contiguous().reshape(-1),
                "assign_tiled_kernel")
            del x, y, xv
        # a 3-D reshape of order (2, 0, 1): out[i, j, k] = x[k, i, j]
        x = rand(nv, torch.float32)
        d0, d1, d2 = VIEW_3D
        x3 = x.storage.view(d2, d0, d1)
        rec["reshape3d_201_f32"] = v1(
            "view_reshape3d_201_f32", vex.reshape(x, VIEW_3D, (2, 0, 1)),
            vex.vector(nv, context=ctx),
            lambda: x3.permute(1, 2, 0).contiguous(), 2 * 4 * nv,
            lambda: x3.permute(1, 2, 0).contiguous().reshape(-1),
            "assign_tiled_kernel")
        del x, x3
        x = rand(nv, torch.float32)
        perm = torch.randperm(nv, generator=gen, device=dev).to(torch.int32)
        pv = vex.vector._adopt(perm, ctx)
        y = vex.vector(nv, context=ctx)
        # the gather through the permutation: the form of csrc/gather.cu
        # (f32, f64) on the main path, V1's single pass with the route off
        gather_names = ("partition_kernel", "gather_kernel",
                        "restore_kernel")
        for dname, dt in (("f32", torch.float32), ("f64", torch.float64)):
            xg = x if dt == torch.float32 else rand(nv, dt)
            yg = y if dt == torch.float32 else vex.vector(nv, dtype=dt,
                                                          context=ctx)
            api(("gather_ranges",),
                lambda: yg.assign(vex.permutation(pv)(xg)), 1)
            check(counters["indexed"].launches == 0,
                  f"gather {dname}: the API call launched V1")
            gops = _gather_operands(*prepare(vex.permutation(pv)(xg), nv,
                                             dev), yg.storage)
            check(gops is not None, f"gather {dname}: the route left it")
            lib = torch.index_select(xg.storage, 0, perm)
            k = torch.empty_like(lib)
            p = torch.empty_like(lib)
            gather_ranges(k, *gops)
            gather_plain(p, *gops)
            check(bitwise(k, p) and bitwise(k, lib)
                  and bitwise(k, yg.storage), f"gather {dname} through a "
                  "permutation differs from its plain version or "
                  "index_select")
            rec[f"gather_{dname}"] = view_timing(
                f"view_gather_{dname}", lambda: gather_ranges(k, *gops),
                lambda: gather_plain(p, *gops), 3 * dt.itemsize * nv,
                lambda: torch.index_select(xg.storage, 0, perm),
                gather_names)
            del xg, yg, gops, lib, k, p
        routed_ = cuda_gather.route
        cuda_gather.route = lambda *a_, **k_: False
        try:
            rec["permutation_f32"] = v1(
                "view_permutation_f32", vex.permutation(pv)(x), y,
                lambda: torch.index_select(x.storage, 0, perm), 3 * 4 * nv,
                lambda: torch.index_select(x.storage, 0, perm))
        finally:
            cuda_gather.route = routed_
        i = vex.element_index(0, nv)
        rec["pointer_f32"] = v1(
            "view_pointer_f32", vex.raw_pointer(x)[(i * 7 + 3) % nv] + x, y,
            None, 2 * 4 * nv)
        kernels["indexed"] = dict(
            kernel_row(0.0, rec["interior_f32"]["ms"],
                       rec["interior_f32"]["plain_ms"],
                       rec["interior_f32"]["bytes"], 0,
                       rec["interior_f32"]["library_ms"]),
            workload="y[:] = 2 * slc[r(1, n-1), r(1, n-1)](x), n = 4096, f32",
            **{k: rec["interior_f32"][k] for k in (
                "ms_range", "library_ms_range", "device_us", "host_us",
                "library_device_us")},
            others={k: {kk: v[kk] for kk in (
                "ms", "library_ms", "device_us", "library_device_us",
                "host_us", "plain_ms", "bound_ms") if kk in v}
                for k, v in rec.items()
                if k != "interior_f32" and not k.startswith("gather_")})

        def v2(tag, node, library, nbytes, dname, exact):
            """A V2 reduction: one launch through the API, the same bits
            over two calls, against its plain version (``exact``: equal
            values and NaN where a NaN is, the library call too; else within
            VIEW_SUM_TOL), and its timings."""
            got = api(("reduce_view",), lambda: vex.eval(node), 1)
            again = api(("reduce_view",), lambda: vex.eval(node), 1)
            args = prepare_reduce_view(node, dev)
            reduce_view_apply(*args)
            plain = torch.empty_like(args[-1])
            reduce_view_plain(*args[:-1], plain)
            check(bitwise(got, again) and bitwise(got, args[-1]),
                  f"{tag}: two calls give other bits")
            if exact:
                check(same(args[-1], plain) and same(library(), plain),
                      f"{tag}: differs from its plain version")
                abs_err, rel = 0.0, 0.0
            else:
                abs_err, rel = errors(args[-1], plain)
                check(rel <= VIEW_SUM_TOL[dname],
                      f"{tag}: rel err {rel} against the plain version")
            out = view_timing(tag, lambda: reduce_view_apply(*args),
                              lambda: reduce_view_plain(*args[:-1], plain),
                              nbytes, library, "reduce_view_kernel")
            out.update(max_abs_err=abs_err, max_rel_err=rel)
            return out, got

        # V2: row sums and column sums (the reduced range split across
        # programs) and column maxima with a NaN, f32 and f64
        for dname, dt in (("f32", torch.float32), ("f64", torch.float64)):
            xr = rand(nv, dt)
            xv = xr.storage.view(g, g)
            nbytes = (nv + g) * xr.storage.element_size()
            rec[f"rowsum_{dname}"], _ = v2(
                f"reduce_view_rowsum_{dname}",
                vex.reduce_view("sum", slc[:, :](xr), 1), lambda: xv.sum(1),
                nbytes, dname, False)
            rec[f"colsum_{dname}"], _ = v2(
                f"reduce_view_colsum_{dname}",
                vex.reduce_view("sum", slc[:, :](xr), 0), lambda: xv.sum(0),
                nbytes, dname, False)
            xv[5, 7] = float("nan")
            rec[f"colmax_{dname}"], got = v2(
                f"reduce_view_colmax_{dname}",
                vex.reduce_view("max", slc[:, :](xr), 0), lambda: xv.amax(0),
                nbytes, dname, True)
            check(got[7] != got[7] and not torch.isnan(got[:7]).any()
                  and not torch.isnan(got[8:]).any(),
                  f"column max {dname}: the NaN is not where it was put")
            del xr, xv, got
        # multi_array 256^3 f64: slabs written through views (V3), then summed
        # over the last axis (V2)
        e3 = MULTI_EXT
        m = vex.multi_array(vex.extents[e3][e3][e3], dtype=np.float64,
                            context=ctx,
                            data=torch.rand(e3 ** 3, generator=gen, device=dev,
                                            dtype=torch.float64))
        slabs = (0, 7, e3 // 2, e3 - 1)
        want_m = m.vec().storage.clone().view(e3, e3, e3)
        for s_ in slabs:   # exact in f64, so the slabs compare bitwise
            want_m[s_] = (2.0 * s_ + torch.arange(e3 * e3, device=dev,
                                                  dtype=torch.float64) * 0.5
                          ).view(e3, e3)

        def slab_writes():
            for s_ in slabs:
                m[vex.indices[s_][vex._][vex._]].assign(
                    2.0 * s_ + vex.element_index(0, e3 * e3) * 0.5)
        api(("to_view",), slab_writes, len(slabs))
        check(torch.equal(m.vec().storage.view(e3, e3, e3), want_m),
              "multi_array slabs written through views")
        mv = m.vec().storage.view(e3, e3, e3)
        rec["multi_array_sum2_f64"], _ = v2(
            "reduce_view_multi_array_sum2_f64", vex.reduce_view("sum", m, 2),
            lambda: mv.sum(2), (e3 ** 3 + e3 * e3) * 8, "f64", False)
        del m, want_m, mv
        kernels["reduce_view"] = dict(
            kernel_row(*(rec["rowsum_f32"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bytes")), 0,
                rec["rowsum_f32"]["library_ms"]),
            workload='reduce_view("sum", slc[:, :](x), 1), n = 4096, f32',
            **{k: rec["rowsum_f32"][k] for k in (
                "ms_range", "library_ms_range", "device_us", "host_us",
                "library_device_us", "max_rel_err")},
            others={k: {kk: v[kk] for kk in (
                "ms", "library_ms", "device_us", "library_device_us",
                "host_us", "plain_ms", "bound_ms") if kk in v}
                    for k, v in rec.items() if k.startswith(("rowsum_f64",
                                                              "colsum",
                                                              "colmax",
                                                              "multi_array"))})

        # V3: the scatter through a permutation (f32, f64: form A of
        # csrc/scatter.cu), the histogram and the f32 atomic add of values
        # (form B), each an API call that launches its form alone, then
        # the form against its plain version and in turns with its
        # PyTorch call; V3's Triton kernel timed on the same scatter and
        # histogram with the route turned off (it writes the slabs above)
        route_names = {"scatter_ranges": ("count_kernel", "rowscan_kernel",
                                          "distribute_kernel", "build_kernel"),
                       "scatter_privatized": ("privatized_kernel",)}

        def routed(key, fn):
            """The API call launches form ``key`` once, V3's Triton kernel
            and K1 never."""
            api((key,), fn, 1)
            check(counters["to_view"].launches == 0
                  and counters["multi"].launches == 0,
                  f"{key}: the API call launched V3's Triton kernel or K1")

        def operands(key, vargs):
            form, idx_, val_, scalar_ = _scatter_operands(*vargs)
            check(form == key.split("_")[1], f"route sent {form}, not {key}")
            return idx_, val_, scalar_

        def triton_forced(fn):
            routed_ = cuda_scatter.route
            cuda_scatter.route = lambda *a_, **k_: None
            try:
                return fn()
            finally:
                cuda_scatter.route = routed_

        perm64 = perm.long()
        for dname, dt in (("f32", torch.float32), ("f64", torch.float64)):
            xs = x if dt == torch.float32 else rand(nv, dt)
            yt = vex.vector(nv, dtype=dt, context=ctx)
            routed("scatter_ranges",
                   lambda: vex.permutation(pv)(yt).assign(xs))
            vargs = prepare_view_assign(vex.permutation(pv)(yt), xs)
            idx_, val_, _ = operands("scatter_ranges", vargs)
            k = torch.zeros(nv, dtype=dt, device=dev)
            p = torch.zeros_like(k)
            lib = torch.zeros_like(k).index_copy_(0, perm64, xs.storage)
            scatter_ranges(k, idx_, val_, "store")
            scatter_plain(p, idx_, val_, "store")
            check(bitwise(k, p) and bitwise(k, yt.storage)
                  and bitwise(k, lib), f"scatter {dname} through a "
                  "permutation differs from its plain version")
            rec[f"scatter_{dname}"] = view_timing(
                f"view_scatter_{dname}",
                lambda: scatter_ranges(k, idx_, val_, "store"),
                lambda: scatter_plain(p, idx_, val_, "store"),
                3 * dt.itemsize * nv,
                lambda: lib.index_copy_(0, perm64, xs.storage),
                route_names["scatter_ranges"])
            if dt == torch.float32:
                vargs_k = vargs[:5] + (k,) + vargs[6:]
                k.zero_()
                triton_forced(lambda: assign_to_view_kernel(*vargs_k))
                check(bitwise(k, p) and bitwise(k, lib),
                      "V3's Triton scatter differs")
                rec["scatter_f32_triton"] = view_timing(
                    "view_scatter_f32_triton",
                    lambda: triton_forced(
                        lambda: assign_to_view_kernel(*vargs_k)),
                    lambda: scatter_plain(p, idx_, val_, "store"),
                    3 * 4 * nv, None, "assign_view_kernel")
            del xs, yt, vargs, idx_, val_, k, p, lib
        keys = torch.randint(0, HIST_BINS, (nv,), generator=gen, device=dev,
                             dtype=torch.int32)
        kv = vex.vector._adopt(keys, ctx)
        hist = vex.vector(HIST_BINS, dtype=np.int32, context=ctx)
        routed("scatter_privatized", lambda: vex.eval(vex.atomic_add(
            vex.permutation(kv)(hist), 1)))
        lib = torch.bincount(keys, minlength=HIST_BINS)
        hargs = prepare_view_assign(vex.permutation(kv)(hist), 1, atomic="add")
        hidx, _, hscalar = operands("scatter_privatized", hargs)
        hk = torch.zeros(HIST_BINS, dtype=torch.int32, device=dev)
        hp = torch.zeros_like(hk)
        scatter_privatized(hk, hidx, None, "add", hscalar)
        scatter_plain(hp, hidx, None, "add", hscalar)
        check(torch.equal(hist.storage.long(), lib)
              and torch.equal(hk.long(), lib) and torch.equal(hp.long(), lib),
              "histogram differs from bincount")
        rec["histogram_i32"] = view_timing(
            "view_histogram_i32",
            lambda: scatter_privatized(hk, hidx, None, "add", hscalar),
            lambda: scatter_plain(hp, hidx, None, "add", hscalar),
            4 * nv + 4 * HIST_BINS,
            lambda: torch.bincount(keys, minlength=HIST_BINS),
            route_names["scatter_privatized"])
        hargs_k = hargs[:5] + (hk,) + hargs[6:]
        hk.zero_()
        triton_forced(lambda: assign_to_view_kernel(*hargs_k))
        check(torch.equal(hk.long(), lib), "V3's Triton histogram differs")
        rec["histogram_i32_triton"] = view_timing(
            "view_histogram_i32_triton",
            lambda: triton_forced(lambda: assign_to_view_kernel(*hargs_k)),
            lambda: scatter_plain(hp, hidx, None, "add", hscalar),
            4 * nv + 4 * HIST_BINS, None, "assign_view_kernel")
        hf = vex.vector(HIST_BINS, context=ctx)
        routed("scatter_privatized", lambda: vex.eval(vex.atomic_add(
            vex.permutation(kv)(hf), x)))
        fargs = prepare_view_assign(vex.permutation(kv)(hf), x, atomic="add")
        fidx, fval, _ = operands("scatter_privatized", fargs)
        want = torch.zeros(HIST_BINS, device=dev)
        scatter_plain(want, fidx, fval, "add")
        _, rel = errors(hf.storage, want)
        check(rel <= 1e-5, f"f32 atomic add of values: rel err {rel}")
        fk = torch.zeros(HIST_BINS, device=dev)
        rec["atomic_add_f32"] = view_timing(
            "view_atomic_add_f32",
            lambda: scatter_privatized(fk, fidx, fval, "add"),
            lambda: scatter_plain(want, fidx, fval, "add"),
            8 * nv + 4 * HIST_BINS,
            lambda: torch.zeros(HIST_BINS, device=dev).index_add_(
                0, fidx, fval), route_names["scatter_privatized"])
        rec["atomic_add_f32"]["max_rel_err"] = rel
        keep = ("ms", "library_ms", "device_us", "library_device_us",
                "host_us", "plain_ms", "bound_ms")
        kernels["gather_ranges"] = dict(
            kernel_row(0.0, rec["gather_f32"]["ms"],
                       rec["gather_f32"]["plain_ms"],
                       rec["gather_f32"]["bytes"], 0,
                       rec["gather_f32"]["library_ms"]),
            workload="y[:] = permutation(p)(x), 2^24 f32",
            **{k: rec["gather_f32"][k] for k in (
                "ms_range", "library_ms_range", "device_us", "host_us",
                "library_device_us", "device_us_by_kernel")},
            others={"gather_f64": {kk: rec["gather_f64"][kk] for kk in keep
                                   + ("device_us_by_kernel",)},
                    "v1_route_off_f32": {
                        kk: rec["permutation_f32"][kk] for kk in keep}})
        kernels["scatter_ranges"] = dict(
            kernel_row(0.0, rec["scatter_f32"]["ms"],
                       rec["scatter_f32"]["plain_ms"],
                       rec["scatter_f32"]["bytes"], 0,
                       rec["scatter_f32"]["library_ms"]),
            workload="permutation(p)(y).assign(x), 2^24 f32",
            **{k: rec["scatter_f32"][k] for k in (
                "ms_range", "library_ms_range", "device_us", "host_us",
                "library_device_us")},
            others={"scatter_f64": {kk: rec["scatter_f64"][kk]
                                    for kk in keep}})
        kernels["scatter_privatized"] = dict(
            kernel_row(0.0, rec["histogram_i32"]["ms"],
                       rec["histogram_i32"]["plain_ms"],
                       rec["histogram_i32"]["bytes"], 0,
                       rec["histogram_i32"]["library_ms"]),
            workload="eval(atomic_add(permutation(k)(h), 1)), 2^24 i32 keys "
                     "into 2^16 i32 bins",
            **{k: rec["histogram_i32"][k] for k in (
                "ms_range", "library_ms_range", "device_us", "host_us",
                "library_device_us")},
            others={"atomic_add_f32": {kk: rec["atomic_add_f32"][kk]
                                       for kk in keep + ("max_rel_err",)}})
        kernels["to_view"] = dict(
            kernel_row(0.0, rec["scatter_f32_triton"]["ms"],
                       rec["scatter_f32_triton"]["plain_ms"],
                       rec["scatter_f32_triton"]["bytes"], 0,
                       rec["scatter_f32"]["library_ms"]),
            workload="permutation(p)(y).assign(x), 2^24 f32, the route off "
                     "(on the main path: the multi_array slab writes)",
            **{k: rec["scatter_f32_triton"][k] for k in ("device_us",
                                                         "host_us")},
            others={"histogram_i32": {kk: rec["histogram_i32_triton"][kk]
                                      for kk in keep if kk in
                                      rec["histogram_i32_triton"]}})
        del hargs, hargs_k, hk, hp, want, hf, hist, fargs, fidx, fval, fk
        del keys, kv, perm64, lib, hidx
        # any_of / all_of: one map-reduce launch each
        t_ = 0.5
        xs_ = x.storage
        got = api(("reduce",), lambda: (vex.any_of(x > t_), vex.all_of(x > t_),
                                        vex.all_of(x >= 0)), 3)
        check(got == (bool(torch.any(xs_ > t_)), bool(torch.all(xs_ > t_)),
                      True), f"any_of/all_of: {got}")
        body, an, ty, lv = prepare(vex.cast(torch.int32, (x > t_) != 0), nv,
                                   dev)
        rec["any_of_f32"] = view_timing(
            "any_of_f32", lambda: map_reduce(body, an, ty, lv, nv, "MAX", dev),
            lambda: map_reduce_plain(body, an, ty, lv, nv, "MAX", dev), 4 * nv,
            lambda: torch.any(xs_ > t_), "reduce_kernel")
        del body, lv
        # tensordot of two views: V1 into operands, then the library product
        a, b = rand(nv, torch.float32), rand(nv, torch.float32)
        c = vex.vector(nv, context=ctx)
        api(("indexed",), lambda: c.assign(vex.tensordot(
            slc[:, :](a), slc[:, :](b), vex.axes_pairs(1, 0))), 2)
        want = a.storage.view(g, g).double() @ b.storage.view(g, g).double()
        _, rel = errors(c.storage, want.reshape(-1))
        check(rel <= 1e-4, f"tensordot: rel err {rel} against the f64 product")
        rec["tensordot_rel_err"] = rel
        del a, b, c, want, x, y, pv, perm
        torch.cuda.empty_cache()
        rec["phase_s"] = time.perf_counter() - t13
        report("views", {k: v for k, v in rec.items()
                         if not isinstance(v, dict)})
        results["views_rows"] = {k: v for k, v in rec.items()
                                 if isinstance(v, dict)}
    views_phase()

    # -- phase 14: FFT, complex expressions (K1/V1 and K2 on (re, im)
    # pairs) and MBA --------------------------------------------------------
    def fft_mba_phase():
        """Phase 14, in a scope of its own."""
        t14 = time.perf_counter()
        rec, rows = {}, {}

        def rel_l2(a, b):
            a, b = a.to(torch.complex128), b.to(torch.complex128)
            return ((a - b).norm() / b.norm()).item()

        def crand(n, dt):
            re = torch.rand(n, generator=gen, device=dev, dtype=dt.to_real())
            im = torch.rand(n, generator=gen, device=dev, dtype=dt.to_real())
            return torch.complex(re - 0.5, im - 0.5)

        # the FFT at the bench's sizes (bench.py:793-875): the API (cuFFT
        # through vex.FFT, straight into its target) against torch.fft in
        # c128 on the same input, the round trip, and the API in turns with
        # a raw torch.fft.fftn call
        ctypes_ = {"c64": torch.complex64, "c128": torch.complex128}
        fft_tol = {torch.complex64: 1e-5, torch.complex128: 1e-12}
        for name, shape, dims, dname in FFT_CASES:
            dt = ctypes_[dname]
            n = int(np.prod(shape))
            axes = dims if dims is not None else tuple(range(len(shape)))
            npts = int(np.prod([shape[a] for a in axes]))
            flops = 5 * n * np.log2(npts)
            x = vex.vector._adopt(crand(n, dt), ctx)
            y = vex.vector(n, dtype=dt, context=ctx)
            z = vex.vector(n, dtype=dt, context=ctx)
            f = vex.FFT(shape, dims=dims, dtype=dt)
            fi = vex.FFT(shape, dims=dims, dtype=dt, inverse=True)
            _, got = counted(("cufft",), lambda: y.assign(f(x)))
            add_launches(got)
            ref = torch.fft.fftn(x.storage.to(torch.complex128).view(shape),
                                 dim=dims).reshape(-1)
            err = rel_l2(y.storage, ref)
            check(err <= fft_tol[dt], f"{name}: rel L2 err {err}")
            z[:] = fi(y)
            back = rel_l2(z.storage, x.storage)
            check(back <= 2 * fft_tol[dt], f"{name}: round trip {back}")
            xv = x.storage.view(shape)
            turns = in_turns({"api": lambda: y.assign(f(x)),
                              "raw": lambda: torch.fft.fftn(xv, dim=dims)})
            fx_ = f(x)
            r = {"rel_l2_err_vs_c128": err, "roundtrip_rel_l2": back,
                 "api_ms": turns["api"]["ms"],
                 "api_ms_range": turns["api"]["ms_range"],
                 "raw_ms": turns["raw"]["ms"],
                 "raw_ms_range": turns["raw"]["ms_range"],
                 "api_overhead_ms": turns["api"]["ms"] - turns["raw"]["ms"],
                 "api_over_raw": turns["api"]["ms"] / turns["raw"]["ms"],
                 "cufft_into_target": f.plan.cufft_layout is not None,
                 "api_host_us": host_us(lambda: y.assign(fx_)),
                 "raw_host_us": host_us(lambda: torch.fft.fftn(xv,
                                                               dim=dims)),
                 f"{name}_GFLOPs": flops / (turns["api"]["ms"] * 1e-3) / 1e9,
                 "raw_GFLOPs": flops / (turns["raw"]["ms"] * 1e-3) / 1e9,
                 "bound_ms": bound(2 * n * dt.itemsize, flops)[0],
                 "bound_by": bound(2 * n * dt.itemsize, flops)[1]}
            if name == "fft_2^24":
                # cuFFT writes the target itself: no copy kernel after it
                api_k, _ = profile_call(lambda: y.assign(fx_), 10)
                raw_k, _ = profile_call(lambda: torch.fft.fftn(xv, dim=dims),
                                        10)
                check(not any(w in k_.lower() for k_ in api_k for w in (
                    "copy", "elementwise", "memcpy")), f"{name}: the API "
                    f"copies after cuFFT: {api_k}")
                r.update(api_device_us=sum(api_k.values()),
                         raw_device_us=sum(raw_k.values()),
                         api_kernels=list(api_k))
            if name in FFT_CT:
                # the ported Cooley-Tukey engine (planar torch.matmul
                # codelets at full f32 precision)
                fc = vex.FFT(shape, dtype=dt, impl="ct")
                y[:] = fc(x)
                r["ct_rel_l2_err_vs_c128"] = rel_l2(y.storage, ref)
                check(r["ct_rel_l2_err_vs_c128"] <= fft_tol[dt],
                      f"{name} ct: rel L2 err {r['ct_rel_l2_err_vs_c128']}")
                r["ct_ms"] = cuda_ms(lambda: y.assign(fc(x)))
                r[f"{name}_ct_planner_GFLOPs"] = flops / (r["ct_ms"]
                                                          * 1e-3) / 1e9
            report(name, r)
            rec[name] = r
            del x, y, z, ref, xv, fx_
            torch.cuda.empty_cache()

        # complex expressions at 2^24: p[:] = fx * conj(fx) and
        # Reductor(SUM)(fx), c64 and c128, each one generated launch by
        # its counter and the profiler, against its plain form, in turns
        # with its PyTorch call
        ctol = {torch.complex64: 1e-6, torch.complex128: 1e-13}
        for dname, dt in (("c64", torch.complex64),
                          ("c128", torch.complex128)):
            fx = vex.vector._adopt(crand(N_VEC, dt), ctx)
            p = vex.vector(N_VEC, dtype=dt, context=ctx)
            expr = fx * vex.conj(fx)
            _, got = counted(("complex",), lambda: p.assign(expr))
            check(got["complex"] == 1, f"{dname} fx*conj(fx): {got}")
            add_launches(got)
            e, an, ty, lv = prepare(expr, N_VEC, dev)
            k = torch.empty_like(p.storage)
            pl = torch.empty_like(k)
            assign(e, an, ty, lv, k)
            assign_plain(e, an, ty, lv, pl)
            lib = torch.mul(fx.storage, fx.storage.conj())
            err_k = errors(torch.view_as_real(k), torch.view_as_real(pl))
            err_l = errors(torch.view_as_real(p.storage),
                           torch.view_as_real(lib))
            check(err_k[1] <= ctol[dt] and err_l[1] <= ctol[dt],
                  f"{dname} fx*conj(fx): rel err {err_k}, vs torch {err_l}")
            per_kernel, _ = profile_call(lambda: p.assign(expr), KERNEL_REPS)
            check(len(per_kernel) == 1 and "assign_kernel" in next(
                iter(per_kernel)), f"{dname} fx*conj(fx) is not one "
                f"generated kernel: {per_kernel}")
            turns = in_turns({"kernel": lambda: assign(e, an, ty, lv, k),
                              "library": lambda: torch.mul(
                                  fx.storage, fx.storage.conj())})
            lib_prof, _ = profile_call(lambda: torch.mul(
                fx.storage, fx.storage.conj()), KERNEL_REPS)
            ra = dict(kernel_row(err_k[0], turns["kernel"]["ms"],
                                 cuda_ms(lambda: assign_plain(e, an, ty, lv,
                                                              pl)),
                                 2 * N_VEC * dt.itemsize, 4 * N_VEC,
                                 turns["library"]["ms"]),
                      ms_range=turns["kernel"]["ms_range"],
                      library_ms_range=turns["library"]["ms_range"],
                      device_us=sum(per_kernel.values()),
                      library_device_us=sum(lib_prof.values()),
                      host_us=host_us(lambda: p.assign(expr)),
                      api_ms=cuda_ms(lambda: p.assign(expr), KERNEL_REPS),
                      max_rel_err=err_k[1], torch_rel_err=err_l[1])
            report(f"complex_assign_{dname}", ra)
            # Reductor(SUM): the API call, then the kernel beside torch.sum
            api_sum, got = counted(("reduce_complex",),
                                   lambda: vex.Reductor(vex.SUM)(fx))
            check(got["reduce_complex"] == 1, f"{dname} SUM: {got}")
            add_launches(got)
            e, an, ty, lv = prepare(fx, N_VEC, dev)
            ks = map_reduce(e, an, ty, lv, N_VEC, "SUM", dev)
            ps = map_reduce_plain(e, an, ty, lv, N_VEC, "SUM", dev)
            ls = torch.sum(fx.storage)
            stol = SUM_TOL["f32" if dt == torch.complex64 else "f64"]
            scale = max(1.0, abs(ps.item()))
            serr = abs(ks.item() - ps.item())
            check(serr <= stol * scale and abs(api_sum - ks.item())
                  <= stol * scale and abs(ls.item() - ps.item())
                  <= stol * scale, f"{dname} SUM: kernel {ks.item()}, "
                  f"plain {ps.item()}, API {api_sum}, torch {ls.item()}")
            per_kernel, _ = profile_call(
                lambda: map_reduce(e, an, ty, lv, N_VEC, "SUM", dev),
                KERNEL_REPS)
            check(len(per_kernel) == 1 and "reduce_kernel" in next(
                iter(per_kernel)), f"{dname} SUM is not one generated "
                f"kernel: {per_kernel}")
            turns = in_turns({
                "kernel": lambda: map_reduce(e, an, ty, lv, N_VEC, "SUM",
                                             dev),
                "library": lambda: torch.sum(fx.storage)})
            lib_prof, _ = profile_call(lambda: torch.sum(fx.storage),
                                       KERNEL_REPS)
            rs = dict(kernel_row(serr, turns["kernel"]["ms"],
                                 cuda_ms(lambda: map_reduce_plain(
                                     e, an, ty, lv, N_VEC, "SUM", dev)),
                                 N_VEC * dt.itemsize, 2 * N_VEC,
                                 turns["library"]["ms"]),
                      ms_range=turns["kernel"]["ms_range"],
                      library_ms_range=turns["library"]["ms_range"],
                      device_us=sum(per_kernel.values()),
                      library_device_us=sum(lib_prof.values()),
                      host_us=host_us(lambda: map_reduce(
                          e, an, ty, lv, N_VEC, "SUM", dev)),
                      api_host_us=host_us(lambda: vex.Reductor(vex.SUM)(fx),
                                          20))
            report(f"complex_sum_{dname}", rs)
            rows[dname] = (ra, rs)
            del fx, p, k, pl, lib, e, lv
            torch.cuda.empty_cache()
        kernels["complex"] = dict(rows["c64"][0], others={"c128": rows[
            "c128"][0]}, workload="p[:] = fx * conj(fx), 2^24 c64")
        kernels["reduce_complex"] = dict(rows["c64"][1], others={
            "c128": rows["c128"][1]}, workload="Reductor(SUM)(fx), 2^24 c64")

        # MBA: bench.py's fit (bench.py:683-716), z[:] = interp(X, Y) at
        # 2^24 points, f32 and f64: one launch of the route's form of
        # csrc/mba.cu (cuda_mba.route) and no V1 launch, the kernel against
        # its plain version (the tree's plain form) and the f64 host
        # evaluation; every form (taps, band, cluster) bit for bit the
        # others, and the taps and band forms in turns on (a) uniform
        # random points, with V1's tree (the route before the kernel), and
        # (b) a 4096^2 row-major raster over the domain (the cluster
        # form's times: scripts/torch_mba_forms.py); in f32 also the tree
        # through the API and the patch form
        rng_l = np.random.default_rng(7)
        sx, sy = rng_l.random(4096), rng_l.random(4096)
        surf = vex.mba(lo=(-0.01, -0.01), hi=(1.01, 1.01), coords=(sx, sy),
                       values=np.sin(7 * sx) * np.cos(5 * sy), grid=(8, 8),
                       levels=6)
        check(surf.lattice.shape == (259, 259) and surf.patch is not None,
              f"mba: lattice {surf.lattice.shape}")
        shape_l = tuple(g + 3 for g in surf.grids[0])
        grid_l = surf.grids[0]
        side = int(round(N_VEC ** 0.5))
        INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}
        mba_rows = {}
        for dname, dt in (("f32", torch.float32), ("f64", torch.float64)):
            X, Y = rand(N_VEC, dt), rand(N_VEC, dt)
            z = vex.vector(N_VEC, dtype=dt, context=ctx)
            hq = [X.storage[:4096].double().cpu().numpy(),
                  Y.storage[:4096].double().cpu().numpy()]
            host = torch.from_numpy(mba_host(surf.lo, surf.hi,
                                             surf.grids[0], surf.lattice, hq))
            route = cuda_mba.route(dt, grid_l)
            api = surf(X, Y)
            _, got = counted(("mba", f"mba_{route}"), lambda: z.assign(api))
            check(got["mba"] == 1 and got[f"mba_{route}"] == 1
                  and assign_indexed.launches == 0,
                  f"mba {dname}: {got}, V1 {assign_indexed.launches}")
            add_launches(got)
            lat = surf.tables(dt, dev)[0]
            tab = surf.kernel_table(dt, dev)
            coords = [X.storage, Y.storage]
            shapes = {"band": cuda_mba.band_shape(dt, grid_l),
                      "cluster": cuda_mba.cluster_shape(dt, grid_l)}
            forms = ["taps"] + [f for f, sh in shapes.items()
                                if sh is not None]
            timed = ("taps", "band")
            outs = {f: torch.empty_like(z.storage) for f in forms}
            k = outs[route]
            pl = torch.empty_like(k)
            for f in forms:
                mba_eval(outs[f], coords, lat, surf.lo, surf.hi, grid_l, tab,
                         f)
            mba_plain(pl, coords, lat, surf.lo, surf.hi, surf.grids[0])
            abs_err, rel = errors(k, pl)
            herr = (z.storage[:4096].double().cpu() - host).abs().max().item()
            check(rel <= TOL[dname] and herr <= MBA_HOST_TOL[dname]
                  and torch.equal(k, z.storage), f"mba {dname}: rel err "
                  f"{rel} to its plain form, {herr} to the f64 host "
                  "evaluation")
            check(all(torch.equal(outs[f].view(INT_OF[dt]),
                                  k.view(INT_OF[dt])) for f in forms),
                  f"mba {dname}: the forms differ")
            per_kernel, _ = profile_call(lambda: z.assign(api), KERNEL_REPS)
            check(len(per_kernel) == 1 and MBA_KERNEL[route] in next(
                iter(per_kernel)), f"mba {dname} is not one launch of the "
                f"{route} form's kernel: {per_kernel}")
            tree = mba_device_eval(surf.lo, surf.hi, surf.grids,
                                   [lat.reshape(shape_l)], [X, Y])
            e, an, ty, lv = prepare(tree, N_VEC, dev)
            kt = torch.empty_like(k)
            assign(e, an, ty, lv, kt)
            abs_t, rel_t = errors(kt, pl)
            check(rel_t <= TOL[dname], f"mba {dname} V1 tree: rel err {rel_t}")

            def form_calls(xy, outs=outs):
                return {f: (lambda f=f: mba_eval(outs[f], xy, lat, surf.lo,
                                                 surf.hi, grid_l, tab, f))
                        for f in timed}

            # (a) random points, V1's tree beside; (b) the raster
            fns = form_calls(coords)
            fns["v1_tree"] = lambda: assign(e, an, ty, lv, kt)
            turns = {"random": in_turns(fns)}
            raster = [(lo_ + (torch.arange(side, device=dev,
                                           dtype=torch.float64) + 0.5)
                       * ((hi_ - lo_) / side)).to(dt)
                      for lo_, hi_ in zip(surf.lo, surf.hi)]
            raster = [raster[0].repeat_interleave(side),
                      raster[1].repeat(side)]
            r_outs = {f: torch.empty_like(k) for f in forms}
            for f in forms:
                mba_eval(r_outs[f], raster, lat, surf.lo, surf.hi, grid_l,
                         tab, f)
            check(all(torch.equal(r_outs[f].view(INT_OF[dt]),
                                  r_outs["taps"].view(INT_OF[dt]))
                      for f in forms), f"mba {dname} raster: forms differ")
            r_fns = form_calls(raster, r_outs)
            turns["raster"] = in_turns(r_fns)
            form_rows = {}
            for kind, calls in (("random", fns), ("raster", r_fns)):
                for f in timed:
                    dev_k, _ = profile_call(calls[f], KERNEL_REPS)
                    form_rows.setdefault(kind, {})[f] = {
                        "ms": turns[kind][f]["ms"],
                        "ms_range": turns[kind][f]["ms_range"],
                        "device_us": sum(dev_k.values()),
                        "host_us": host_us(calls[f])}
            tree_k, _ = profile_call(lambda: assign(e, an, ty, lv, kt),
                                     KERNEL_REPS)
            plain_ms = cuda_ms(lambda: mba_plain(
                pl, coords, lat, surf.lo, surf.hi, surf.grids[0]), 3)
            nbytes = 3 * dt.itemsize * N_VEC
            row = dict(kernel_row(abs_err, turns["random"][route]["ms"],
                                  plain_ms, nbytes, 0, None),
                       ms_range=turns["random"][route]["ms_range"],
                       device_us=form_rows["random"][route]["device_us"],
                       host_us=host_us(lambda: z.assign(api)),
                       max_rel_err=rel, host_f64_abs_err=herr, form=route,
                       forms=form_rows,
                       shapes={f: sh._asdict() for f, sh in shapes.items()
                               if sh is not None},
                       resident_clusters={
                           f: cuda_mba.resident_clusters(dt, grid_l, sh, dev)
                           for f, sh in shapes.items() if sh is not None},
                       v1_tree_ms=turns["random"]["v1_tree"]["ms"],
                       v1_tree_ms_range=turns["random"]["v1_tree"][
                           "ms_range"],
                       v1_tree_device_us=sum(tree_k.values()),
                       mba_Mpts_s=N_VEC / (turns["random"][route]["ms"]
                                           * 1e-3) / 1e6)
            # each kernel's own row: the taps form's kernel (mba_kernel)
            # and the shared-memory kernel (mba_cluster_kernel) as the band
            # form, on the random points
            for key, best in (("mba_taps", "taps"),
                              ("mba_cluster_kernel", "band")):
                mba_rows[(key, dname)] = dict(
                    kernel_row(errors(outs[best], pl)[0],
                               turns["random"][best]["ms"], plain_ms,
                               nbytes, 0, None),
                    form=best, ms_range=turns["random"][best]["ms_range"],
                    device_us=form_rows["random"][best]["device_us"],
                    host_us=form_rows["random"][best]["host_us"],
                    raster_ms=turns["raster"][best]["ms"],
                    raster_device_us=form_rows["raster"][best]["device_us"])
            if dt == torch.float32:
                # V1's tree through the API and the patch form (V1)
                _, got = counted(("mba_tree",), lambda: z.assign(tree))
                check(got["mba_tree"] == 1, f"mba tree: {got}")
                add_launches(got)
                patch = surf.tables(dt, dev)[1]
                pexpr = mba_device_eval(surf.lo, surf.hi, surf.grids, None,
                                        [X, Y], patch=patch)
                ep, anp, typ, lvp = prepare(pexpr, N_VEC, dev)
                assign(ep, anp, typ, lvp, kt)
                _, rel_p = errors(kt, pl)
                check(rel_p <= TOL[dname], f"mba patch: rel err {rel_p}")
                patch_k, _ = profile_call(
                    lambda: assign(ep, anp, typ, lvp, kt), KERNEL_REPS)
                mba_rows["tree"] = dict(kernel_row(
                    abs_t, turns["random"]["v1_tree"]["ms"], plain_ms,
                    nbytes, 0, None),
                    ms_range=turns["random"]["v1_tree"]["ms_range"],
                    device_us=sum(tree_k.values()),
                    host_us=host_us(lambda: z.assign(tree), 20),
                    patch_ms=cuda_ms(lambda: assign(ep, anp, typ, lvp, kt)),
                    patch_device_us=sum(patch_k.values()),
                    workload="z[:] = the interpolant's tree, 2^24 f32")
                del patch, pexpr, ep, lvp
            report(f"mba_{dname}_2^24", {k_: v for k_, v in row.items()
                                         if not isinstance(v, dict)})
            for kind in ("random", "raster"):
                report(f"mba_{dname}_{kind}_forms", {
                    f"{f}_{m}": v for f, r in form_rows[kind].items()
                    for m, v in r.items() if m != "ms_range"})
            mba_rows[dname] = row
            del X, Y, z, api, k, pl, kt, tree, e, lv, coords, outs, raster
            del r_outs, fns, r_fns
            torch.cuda.empty_cache()
        # the band form holding a whole lattice: an f64 fit of 5 levels (a
        # 131^2 lattice of 137 KB, which one CTA holds) at 2^24 random
        # points through the API, one launch, bit for bit the taps form and
        # within 1e-12 of the plain version, in turns with the taps form
        small = vex.mba(lo=(-0.01, -0.01), hi=(1.01, 1.01), coords=(sx, sy),
                        values=np.sin(7 * sx) * np.cos(5 * sy), grid=(8, 8),
                        levels=5)
        dt, grid_s = torch.float64, small.grids[0]
        route = cuda_mba.route(dt, grid_s)
        check(route == "band", f"mba 131^2 f64: the route took {route}")
        X, Y = rand(N_VEC, dt), rand(N_VEC, dt)
        z = vex.vector(N_VEC, dtype=dt, context=ctx)
        api = small(X, Y)
        _, got = counted(("mba", "mba_band"), lambda: z.assign(api))
        check(got["mba"] == 1 and got["mba_band"] == 1,
              f"mba 131^2 f64: {got}")
        add_launches(got)
        lat, coords = small.tables(dt, dev)[0], [X.storage, Y.storage]
        outs = {f: torch.empty_like(z.storage) for f in ("band", "taps")}
        calls = {f: (lambda f=f: mba_eval(outs[f], coords, lat, small.lo,
                                          small.hi, grid_s, form=f))
                 for f in outs}
        for fn in calls.values():
            fn()
        pl = torch.empty_like(z.storage)
        mba_plain(pl, coords, lat, small.lo, small.hi, grid_s)
        abs_err, rel = errors(outs["band"], pl)
        check(rel <= TOL["f64"] and torch.equal(outs["band"], z.storage)
              and torch.equal(outs["band"].view(torch.int64),
                              outs["taps"].view(torch.int64)),
              f"mba 131^2 f64: rel err {rel}, or the forms differ")
        turns = in_turns(calls)
        small_row = {}
        for f, fn in calls.items():
            dev_k, _ = profile_call(fn, KERNEL_REPS)
            small_row[f] = {"ms": turns[f]["ms"],
                            "ms_range": turns[f]["ms_range"],
                            "device_us": sum(dev_k.values()),
                            "host_us": host_us(fn)}
        report("mba_f64_131^2_forms", {f"{f}_{m}": v for f, r in
                                       small_row.items() for m, v in
                                       r.items() if m != "ms_range"})
        mba_rows[("mba_cluster_kernel", "f64_131")] = dict(
            small_row["band"], form="band", max_abs_err=abs_err,
            taps_ms=small_row["taps"]["ms"],
            taps_device_us=small_row["taps"]["device_us"],
            shape=cuda_mba.band_shape(dt, grid_s)._asdict(),
            workload="z[:] = interp(X, Y), 2^24 f64, 131^2 lattice")
        del small, X, Y, z, api, outs, calls, pl, coords, lat
        torch.cuda.empty_cache()
        rec["cufft_launches"] = main_launches["cufft"]
        rec["mba_Mpts_s"] = mba_rows["f32"]["mba_Mpts_s"]
        rec["mba_f64_Mpts_s"] = mba_rows["f64"]["mba_Mpts_s"]
        kernels["mba"] = dict(mba_rows["f32"],
                                   others={"f64": mba_rows["f64"]},
                                   workload="z[:] = interp(X, Y), 2^24 f32, "
                                   "259^2 lattice, the route's form")
        for key, what in (("mba_taps", "the taps form"),
                          ("mba_cluster_kernel", "the band form")):
            kernels[key] = dict(mba_rows[(key, "f32")],
                                others={o: mba_rows[(key, o)] for o in
                                        ("f64", "f64_131")
                                        if (key, o) in mba_rows},
                                workload="mba_eval on 2^24 random f32 "
                                f"points, 259^2 lattice, {what}")
        kernels["mba_tree"] = mba_rows["tree"]
        del surf
        torch.cuda.empty_cache()
        rec["phase_s"] = time.perf_counter() - t14
        report("fft_complex_mba", {k_: v for k_, v in rec.items()
                                   if not isinstance(v, dict)})
    fft_mba_phase()

    # -- phase 15: builtins, integer pow and boolean arithmetic in the
    # generated kernels, advanced slicer keys, images ----------------------
    def builtins_images_phase():
        """Phase 15, in a scope of its own."""
        from vexcl_tpu_torch.expr import triton_emit
        from vexcl_tpu_torch.expr.builtins import KERNEL_BUILTINS
        from vexcl_tpu_torch.ops import image as image_mod
        from vexcl_tpu_torch.ops.image import patch_table
        from vexcl_tpu_torch.types import dtype_of_code

        t15 = time.perf_counter()
        rec = {}

        def bitwise(a, b):
            bits = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[a.element_size()]
            return (a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a.view(bits), b.view(bits)))

        def uniform(n, lo, hi, dt=torch.float32):
            return vex.vector(data=lo + (hi - lo) * torch.rand(
                n, generator=gen, device=dev, dtype=dt), context=ctx)

        def ints(n, lo, hi, dt=torch.int32):
            return vex.vector(data=torch.randint(
                lo, hi, (n,), generator=gen, device=dev, dtype=dt),
                context=ctx)

        def kernel_and_plain(expr, n):
            e, an, ty, lv = prepare(expr, n, dev)
            k = torch.empty(n, dtype=dtype_of_code(ty[id(e)]), device=dev)
            p = torch.empty_like(k)
            assign(e, an, ty, lv, k)
            assign_plain(e, an, ty, lv, p)
            return k, p, (e, an, ty, lv)

        def rel_err(name, k, p):
            """The kernel's worst error element by element, relative to
            the plain value's magnitude (absolute below 1); the same
            values where either is not finite."""
            if not p.dtype.is_floating_point:
                check(torch.equal(k, p), f"{name}: the kernel differs from "
                      "its plain form")
                return 0.0
            fin = torch.isfinite(p)
            check(torch.equal(torch.isfinite(k), fin)
                  and torch.equal(torch.isnan(k), torch.isnan(p))
                  and torch.equal(k[~fin & ~torch.isnan(p)],
                                  p[~fin & ~torch.isnan(p)]),
                  f"{name}: the kernel's non-finite values differ")
            if not fin.any():
                return 0.0
            k, p = k[fin].double(), p[fin].double()
            return ((k - p).abs() / p.abs().clamp_min(1.0)).max().item()

        # every builtin's kernel form once at BUILTIN_N against its plain
        # form (f32 operands over the card tests' domains; i32, or i16 for
        # upsample, for the integer helpers; an i32 exponent for ldexp)
        t = time.perf_counter()
        worst = {}
        for name in KERNEL_BUILTINS:
            nargs = vex.BUILTINS[name].nargs
            if name in BUILTIN_INTEGER:
                idt = torch.int16 if name == "upsample" else torch.int32
                args = [ints(BUILTIN_N, -1000, 1000, idt)
                        for _ in range(nargs)]
            else:
                lo, hi = BUILTIN_DOMAIN.get(name, (-3.0, 3.0))
                args = [uniform(BUILTIN_N, lo, hi) for _ in range(nargs)]
                if name == "ldexp":
                    args[1] = ints(BUILTIN_N, -20, 20)
            k, p, _ = kernel_and_plain(vex.BUILTINS[name](*args), BUILTIN_N)
            worst[name] = rel_err(name, k, p)
            check(worst[name] <= BUILTIN_TOL, f"{name}: rel err "
                  f"{worst[name]}")
        rec["builtins_checked"] = len(worst)
        rec["builtins_s"] = time.perf_counter() - t
        rec["builtins_worst"] = max(worst, key=worst.get)
        rec["builtins_worst_rel_err"] = worst[rec["builtins_worst"]]
        # booleans: + is or, * is and, //, % and ** in i32, orders on 0, 1
        b, c, d = (vex.vector(data=torch.rand(
            BUILTIN_N, generator=gen, device=dev) < 0.5, context=ctx)
            for _ in range(3))
        bool_exprs = [b + c, b * c, vex.mad(b, c, d), b ** c, b // c,
                      b % c, b < c, vex.max(b, c), vex.select(b, c, d)]
        for i_, expr in enumerate(bool_exprs):
            k, p, _ = kernel_and_plain(expr, BUILTIN_N)
            rel_err(f"boolean expression {i_}", k, p)
        rec["boolean_exprs_checked"] = len(bool_exprs)

        def timed(tag, expr, out, library, nbytes, nops=0, ops_s=F32_OPS_S,
                  key="builtins"):
            """One API assignment (one launch of its counter), the
            kernel against its plain form, in turns with its library
            call, the plain form's time, device and host µs."""
            _, got = counted((key,), lambda: out.assign(expr))
            check(got[key] == 1, f"{tag}: launches {got}")
            add_launches(got)
            k, p, (e, an, ty, lv) = kernel_and_plain(expr, out.size)
            err = rel_err(tag, k, p)
            check(err <= BUILTIN_TOL, f"{tag}: rel err {err}")
            abs_err = (k.double() - p.double()).abs().max().item()
            fns = {"kernel": lambda: assign(e, an, ty, lv, k)}
            if library is not None:
                fns["library"] = library
            turns = in_turns(fns)
            per_kernel, _ = profile_call(fns["kernel"], KERNEL_REPS)
            row = dict(kernel_row(
                abs_err, turns["kernel"]["ms"],
                cuda_ms(lambda: assign_plain(e, an, ty, lv, p), 3), nbytes,
                nops, turns["library"]["ms"] if library else None, ops_s),
                ms_range=turns["kernel"]["ms_range"],
                device_us=sum(v for n_, v in per_kernel.items()
                              if "assign_kernel" in n_),
                host_us=host_us(lambda: out.assign(expr)), max_rel_err=err)
            if library is not None:
                row["library_ms_range"] = turns["library"]["ms_range"]
            report(tag, row)
            return row, k

        # the memory rate in this process: a 2^26 f32 copy
        src = torch.rand(1 << 26, generator=gen, device=dev)
        dst = torch.empty_like(src)
        copy_ms = cuda_ms(lambda: dst.copy_(src), KERNEL_REPS)
        stream_bytes_s = 2 * 4 * (1 << 26) / (copy_ms * 1e-3)
        rec["stream_copy_ms"] = copy_ms
        rec["stream_GBs"] = stream_bytes_s / 1e9
        del src, dst

        # select and integer pow at 2^24 against the assignment kernel's
        # bound, in turns with torch.where and torch.pow
        n = N_VEC
        x, y = uniform(n, -1.0, 1.0), uniform(n, -1.0, 1.0)
        cond = vex.vector(data=torch.rand(n, generator=gen, device=dev)
                          < 0.5, context=ctx)
        z = vex.vector(n, dtype=torch.float32, context=ctx)
        kernels["builtins"], _ = timed(
            "builtin_select_2^24_f32", vex.select(x, y, cond), z,
            lambda: torch.where(cond.storage, y.storage, x.storage),
            (4 + 4 + 1 + 4) * n)
        kernels["builtins"]["workload"] = (
            "z[:] = select(x, y, c), 2^24 f32, c boolean")
        ia, ib = ints(n, -3, 4), ints(n, 0, 41)
        zi = vex.vector(n, dtype=torch.int32, context=ctx)
        # the loop's rounds (the largest exponent's bits): and, compare,
        # select, two multiplies and a shift each, and the negative
        # exponent's selects
        rounds = int(ib.storage.max().item()).bit_length()
        kernels["ipow"], _ = timed(
            "integer_pow_2^24_i32", ia ** ib, zi,
            lambda: torch.pow(ia.storage, ib.storage), 12 * n,
            (6 * rounds + 8) * n, scheduler_ops_s(), key="ipow")
        kernels["ipow"]["workload"] = (
            "z[:] = a ** b, 2^24 i32, a in [-3, 3], b in [0, 40]")
        del x, y, cond, z, ia, ib, zi
        torch.cuda.empty_cache()

        # advanced slicer keys: each form one V1 launch, bitwise against
        # its plain form; (i, j) on the 4096^2 grid at 2^24 timed in
        # turns with PyTorch's advanced indexing of the same grid
        g = VIEW_GRID
        xg = uniform(g * g, -1.0, 1.0)
        dims3 = (256, 256, 256)
        i3, j3, one = ints(1000, -300, 300), ints(1000, -300, 300), ints(
            1, 0, 256)
        forms = {"array_int": (i3, 7), "arrays_adjacent": (i3, j3),
                 "arrays_separated": (i3, vex._, j3),
                 "int_separated": (5, vex._, i3),
                 "one_broadcast": (one, i3, vex._)}
        for tag, key in forms.items():
            view = vex.slicer(dims3)[key](xg)
            out = vex.vector(view.size_hint(), dtype=torch.float32,
                             context=ctx)
            _, got = counted(("advanced_index",), lambda: out.assign(view))
            check(got["advanced_index"] == 1, f"{tag}: launches {got}")
            add_launches(got)
            k, p, _ = kernel_and_plain(view, out.size)
            rel_err(f"advanced key {tag}", k, p)
        def forced(module, name, value, fn):
            """fn() with module.name set to value (a route's force)."""
            setattr(module, name, value)
            try:
                return fn()
            finally:
                setattr(module, name, None)

        def gather_form_row(tag, expr, out, library, nbytes,
                            exact_library):
            """One API assignment of a gather at the flat index of two
            coordinate arrays (``expr`` alone): one call of the gather
            form's fused variant, no other gather call, no V1 launch;
            bitwise against its plain form, V1 forced (the parent's form)
            and, where ``exact_library``, the library call; in turns the
            fused variant, V1, the plain form and the library call;
            device µs by kernel and host µs a call of each form.  Returns
            (the fused variant's row, V1's row)."""
            _, got = counted(("gather_coords",), lambda: out.assign(expr))
            others = {k_: counters[k_].launches
                      for k_ in ("gather_ranges", "indexed")}
            check(got == {"gather_coords": 1} and not any(others.values()),
                  f"{tag}: launches {got}, {others}")
            add_launches(got)
            e, an, ty, lv = prepare(expr, out.size, dev)
            k = out.storage.clone()
            p = torch.empty_like(k)
            assign_plain(e, an, ty, lv, p)
            v1 = torch.empty_like(k)

            def form():
                assign(e, an, ty, lv, k)

            def v1_form():
                forced(triton_emit, "INDEX_GATHER", "v1",
                       lambda: assign(e, an, ty, lv, v1))
            v1_form()
            lib = library()
            check(bitwise(k, p) and bitwise(v1, p)
                  and (not exact_library or bitwise(lib.reshape(-1), p)),
                  f"{tag}: the forms, the plain form or the library call "
                  "differ")
            lib_diff = (lib.reshape(-1).double() - p.double()).abs().max()
            turns = in_turns({"kernel": form, "v1": v1_form,
                              "plain": lambda: assign_plain(e, an, ty, lv,
                                                            p),
                              "library": library})
            per = {name: profile_call(fn, KERNEL_REPS)[0] for name, fn in (
                ("kernel", form), ("v1", v1_form))}
            common = dict(library_ms_range=turns["library"]["ms_range"],
                          plain_ms_range=turns["plain"]["ms_range"],
                          library_max_abs_diff=lib_diff.item())
            row = dict(kernel_row(
                0.0, turns["kernel"]["ms"], turns["plain"]["ms"], nbytes, 0,
                turns["library"]["ms"]),
                ms_range=turns["kernel"]["ms_range"],
                device_us=sum(per["kernel"].values()),
                device_us_by_kernel=per["kernel"],
                host_us=host_us(lambda: out.assign(expr)),
                form="gather_coords (the fused variant of csrc/gather.cu)",
                Gsamples_s=out.size / (turns["kernel"]["ms"] * 1e-3) / 1e9,
                **common)
            v1_row = dict(kernel_row(
                0.0, turns["v1"]["ms"], turns["plain"]["ms"], nbytes, 0,
                turns["library"]["ms"]),
                ms_range=turns["v1"]["ms_range"],
                device_us=sum(v for n_, v in per["v1"].items()
                              if "assign_kernel" in n_),
                host_us=host_us(lambda: forced(
                    triton_emit, "INDEX_GATHER", "v1",
                    lambda: out.assign(expr))),
                form="V1 (the assignment kernel's indexed loads), forced",
                **common)
            report(tag, row)
            report(f"{tag}_v1", v1_row)
            return row, v1_row

        # slicer((4096, 4096))[i, j] at 2^24 keys alone: the fused variant,
        # in turns with V1 and PyTorch's x[i, j]; the advanced_index row
        # is V1's (the forced [i, j]; on the main path the five forms
        # above), the fused variant's is under gather_coords
        gi, gj = ints(n, 0, g), ints(n, 0, g)
        gi64, gj64 = gi.storage.long(), gj.storage.long()
        grid2 = xg.storage.view(g, g)
        zg = vex.vector(n, dtype=torch.float32, context=ctx)
        view = vex.slicer((g, g))[gi, gj](xg)
        ij_fused, kernels["advanced_index"] = gather_form_row(
            "advanced_index_2^24_f32", view, zg, lambda: grid2[gi64, gj64],
            (4 + 4 + 4) * n + 4 * g * g, True)
        ij_fused["workload"] = kernels["advanced_index"]["workload"] = (
            "z[:] = slicer((4096, 4096))[i, j](x), 2^24 random (i, j), "
            "f32; the library call reads i64 indices")
        rec["advanced_forms_checked"] = len(forms)
        del xg, i3, j3, one, gi, gj, gi64, gj64, grid2, zg, view
        torch.cuda.empty_cache()

        # images: a 4096^2 f32 image, 2^24 f32 points drawn uniformly
        # over it, beside grid_sample (the same function on the normalised
        # grid, padding "border": a yardstick of time, not the oracle);
        # the bound reads X, Y, z and the image once at the card's memory
        # rate, and stream_bound_ms at the copy's rate measured above.
        # Bilinear: the patch table (one V1 launch), in turns with the
        # four taps (the parent's form), the plain form and grid_sample;
        # nearest: the gather form's fused variant, in turns with V1 (the
        # parent's form; its row under the image sample's kernel)
        w = h = IMG_GRID
        img = torch.rand(h, w, generator=gen, device=dev)
        X, Y = uniform(n, 0.0, w - 1.0), uniform(n, 0.0, h - 1.0)
        grid = torch.stack([X.storage / (w - 1) * 2 - 1,
                            Y.storage / (h - 1) * 2 - 1], -1).view(1, 1, n, 2)
        inp = img.view(1, 1, h, w)
        z = vex.vector(n, dtype=torch.float32, context=ctx)
        nbytes = 3 * 4 * n + 4 * h * w

        def gs(mode):
            return lambda: torch.nn.functional.grid_sample(
                inp, grid, mode=mode, padding_mode="border",
                align_corners=True)

        im = vex.image2d(img, filter="linear", context=ctx)
        t = time.perf_counter()
        expr = im(X, Y)
        torch.cuda.synchronize()
        first_sample_s = time.perf_counter() - t
        check(expr.patched, "image linear: the route did not take the "
              "patch table")
        _, got = counted(("image",), lambda: z.assign(expr))
        check(got["image"] == 1, f"image linear: launches {got}")
        add_launches(got)
        k, p, (e, an, ty, lv) = kernel_and_plain(expr, n)
        err = rel_err("image linear", k, p)
        check(err <= BUILTIN_TOL, f"image linear: rel err {err}")
        table = im.patch()
        check(bitwise(table, patch_table(img)),
              "image linear: the patch table differs from a fresh build")
        build_ms = cuda_ms(lambda: patch_table(img, table), 10)
        taps = forced(image_mod, "FORCE", "taps", lambda: im(X, Y))
        check(not taps.patched, "image linear: the taps were not forced")
        kt, pt, (et, ant, tyt, lvt) = kernel_and_plain(taps, n)
        check(bitwise(pt, p), "image linear: the plain forms of the table "
              "and of the taps differ")
        err_t = rel_err("image linear taps", kt, pt)
        check(err_t <= BUILTIN_TOL, f"image linear taps: rel err {err_t}")
        turns = in_turns({
            "kernel": lambda: assign(e, an, ty, lv, k),
            "taps": lambda: assign(et, ant, tyt, lvt, kt),
            "plain": lambda: assign_plain(e, an, ty, lv, p),
            "grid_sample": gs("bilinear")})
        per_kernel, _ = profile_call(lambda: assign(e, an, ty, lv, k),
                                     KERNEL_REPS)
        per_taps, _ = profile_call(lambda: assign(et, ant, tyt, lvt, kt),
                                   KERNEL_REPS)
        row = dict(kernel_row(
            (k.double() - p.double()).abs().max().item(),
            turns["kernel"]["ms"], turns["plain"]["ms"], nbytes, 0,
            turns["grid_sample"]["ms"]),
            stream_bound_ms=nbytes / stream_bytes_s * 1e3,
            ms_range=turns["kernel"]["ms_range"],
            library_ms_range=turns["grid_sample"]["ms_range"],
            plain_ms_range=turns["plain"]["ms_range"],
            taps_ms=turns["taps"]["ms"],
            taps_ms_range=turns["taps"]["ms_range"],
            table_build_ms=build_ms, first_sample_s=first_sample_s,
            device_us=sum(v for n_, v in per_kernel.items()
                          if "assign_kernel" in n_),
            taps_device_us=sum(v for n_, v in per_taps.items()
                               if "assign_kernel" in n_),
            host_us=host_us(lambda: z.assign(expr)),
            taps_host_us=host_us(lambda: z.assign(taps)),
            max_rel_err=err, taps_max_rel_err=err_t,
            grid_sample_max_abs_diff=(gs("bilinear")().view(-1) - k).abs()
            .max().item(), form="patch table, one 16-byte row a point",
            Gsamples_s=n / (turns["kernel"]["ms"] * 1e-3) / 1e9)
        report("image2d_linear_2^24_f32", row)
        del im, expr, taps, e, lv, et, lvt, k, p, kt, pt, table
        torch.cuda.empty_cache()
        im = vex.image2d(img, filter="nearest", context=ctx)
        near, near_v1 = gather_form_row(
            "image2d_nearest_2^24_f32", im(X, Y), z, gs("nearest"), nbytes,
            False)
        for r_ in (near, near_v1):
            r_["stream_bound_ms"] = nbytes / stream_bytes_s * 1e3
        kernels["image"] = dict(
            row, others={"nearest_v1": near_v1},
            workload="z[:] = img(X, Y), bilinear, 4096^2 f32 image, 2^24 "
            "f32 points uniform over it")
        kernels["gather_coords"] = dict(
            near, others={"advanced_index": ij_fused},
            workload="z[:] = img(X, Y), nearest, 4096^2 f32 image, 2^24 f32 "
            "points uniform over it; the library call is grid_sample")
        del im, img, X, Y, grid, inp, z
        torch.cuda.empty_cache()

        # svm_vector's map/unmap on the card, and Filter.Exclusive's lock
        # on this card (held by this process, then released)
        from vexcl_tpu_torch.context import release_exclusive_locks

        sv = vex.svm_vector(1 << 20, dtype=torch.float32, context=ctx)
        with sv as host:
            host[:] = np.arange(1 << 20, dtype=np.float32)
        check(torch.equal(sv.storage.cpu(), torch.arange(
            1 << 20, dtype=torch.float32)), "svm_vector: unmap lost data")
        ex = vex.Context(vex.Filter.Exclusive(
            vex.Filter.GPU & vex.Filter.Count(1)), set_current=False)
        check(ex.device == dev, f"Filter.Exclusive chose {ex.device}")
        release_exclusive_locks()
        rec["phase_s"] = time.perf_counter() - t15
        report("builtins_images", rec)
    builtins_images_phase()

    # -- phase 16: gradients and vmap through the generator's kernels, and
    # the saturating float-to-integer casts ---------------------------------
    def autodiff_phase():
        """Phase 16, in a scope of its own."""
        t16 = time.perf_counter()
        rec = {}
        rows = {}
        # LorenzEnsemble(2^22) as phase 12 builds it: the gradient of
        # sum(w (x_T + y_T + z_T)) after GRAD_STEPS steps of
        # as_function() in x0, y0, z0 and R, one backward launch a step
        for dname, npdt in (("f32", np.float32), ("f64", np.float64)):
            ens = LorenzEnsemble(LORENZ_N, dtype=npdt, context=ctx,
                                 seed=args.seed)
            step = ens._step
            fn = step.as_function()
            dt = ens.x.storage.dtype
            w = torch.rand(LORENZ_N, generator=gen, device=dev, dtype=dt)
            x0 = [v.storage.clone() for v in (ens.x, ens.y, ens.z, ens.R)]
            ins = [t.clone().requires_grad_() for t in x0]

            def loss(f, xs):
                x, y, z, R = xs
                for _ in range(GRAD_STEPS):
                    x, y, z = f(x, y, z, R)
                return (w * (x + y + z)).sum()

            def gradients():
                return torch.autograd.grad(loss(fn, ins), ins)

            t = time.perf_counter()
            gradients()
            torch.cuda.synchronize()
            rec[f"{dname}_first_call_s"] = time.perf_counter() - t
            got, launches = counted(("backward", "multi"), gradients)
            add_launches({"backward": launches["backward"]})
            check(launches["backward"] == GRAD_STEPS
                  and launches["multi"] == 2 * GRAD_STEPS,
                  f"Lorenz gradient {dname}: {launches} for {GRAD_STEPS} "
                  "steps (one forward and one backward launch a step)")
            # the plain version: the same adjoint trees through their plain
            # forms, step by step back from the plain forward's states
            with torch.no_grad():
                states = [tuple(x0[:3])]
                for _ in range(GRAD_STEPS):
                    states.append(step.plain(*states[-1], x0[3]))
                cots, g_r = [w, w, w], torch.zeros_like(w)
                for st in reversed(states[:-1]):
                    bk = step.backward_kernel([*st, x0[3]], cots, [True] * 4)
                    *cots, g = bk.plain(*st, x0[3], *cots)
                    g_r = g_r + g
            plain = [*cots, g_r]
            # a second oracle: PyTorch's autograd over the forward's plain
            # forms (the Lorenz tree has no kink)
            ref_ins = [t.clone().requires_grad_() for t in x0]
            auto = torch.autograd.grad(loss(step.plain, ref_ins), ref_ins)
            for name, g, p_, a in zip(("x0", "y0", "z0", "R"), got, plain,
                                      auto):
                check(g.dtype == dt, f"gradient {name} {dname}: {g.dtype}")
                _, rel_p = errors(g, p_)
                _, rel_a = errors(g, a)
                check(rel_p <= GRAD_TOL[dname] and rel_a <= GRAD_TOL[dname],
                      f"Lorenz gradient {name} {dname}: rel err {rel_p} "
                      f"(plain), {rel_a} (autograd over the plain forms)")
                rec[f"{dname}_{name}_rel_err_plain"] = rel_p
                rec[f"{dname}_{name}_rel_err_autograd"] = rel_a
            del got, plain, auto, ref_ins, ins
            # the backward kernel alone, on the last step's inputs and
            # three cotangents of their own (one tensor thrice would be
            # read from memory once)
            st = states[GRAD_STEPS - 1]
            cs = [torch.rand(LORENZ_N, generator=gen, device=dev, dtype=dt)
                  for _ in range(3)]
            bk = step.backward_kernel([*st, x0[3]], cs, [True] * 4)
            bkf = bk.as_function()
            bargs = (*st, x0[3], *cs)
            kout, pout = bkf(*bargs), bk.plain(*bargs)
            err = max(errors(k_, p_)[0] for k_, p_ in zip(kout, pout))
            e, an, ty, lv = bk.prepare_function(*bargs)
            ko = [torch.empty_like(o) for o in kout]
            ms = cuda_ms(lambda: assign_multi(e, an, ty, lv, ko),
                         KERNEL_REPS)
            api_ms = cuda_ms(lambda: bkf(*bargs), KERNEL_REPS)
            plain_ms = cuda_ms(lambda: bk.plain(*bargs))
            per_kernel, _ = profile_call(lambda: bkf(*bargs), KERNEL_REPS)
            check(len(per_kernel) == 1
                  and "assign_kernel" in next(iter(per_kernel)),
                  f"a backward call is not one kernel: {per_kernel}")
            # PyTorch's autograd over one step's plain forms, for scale
            ps = [t.clone().requires_grad_() for t in (*st, x0[3])]
            pouts = step.plain(*ps)
            autograd_ms = cuda_ms(lambda: torch.autograd.grad(
                pouts, ps, cs, retain_graph=True))
            itemsize = np.dtype(npdt).itemsize
            row = kernel_row(err, ms, plain_ms, 11 * LORENZ_N * itemsize,
                             dag_ops(e) * LORENZ_N, None,
                             F32_OPS_S if dname == "f32" else F64_OPS_S)
            row.update(api_events_ms=api_ms,
                       device_us=next(iter(per_kernel.values())),
                       host_us=host_us(lambda: bkf(*bargs)),
                       autograd_plain_ms=autograd_ms, dag_ops=dag_ops(e))
            rows[dname] = row
            report(f"lorenz_backward_{dname}", row)
            del ens, step, fn, w, x0, states, cots, g_r, bk, bkf, bargs, cs
            del kout, pout, e, an, ty, lv, ko, ps, pouts
            torch.cuda.empty_cache()
        kernels["backward"] = dict(
            rows["f32"], others={"f64": rows["f64"]},
            workload=f"the backward of one LorenzEnsemble(2^22) RK4 step "
            "(x, y, z, R and three cotangents in, four gradients out), f32")

        # a second derivative on a small tree, a vector x and a 0-d a: the
        # backward of the backward against the same trees' plain forms
        params = [tgen.symbolic() for _ in range(2)]
        out = tgen.symbolic()
        out[:] = vex.sin(params[0]) * params[1] + params[0] * params[0] \
            * params[0]
        small = tgen.build_kernel("second", [out], params)
        x = torch.rand(GRAD_N, generator=gen, device=dev,
                       dtype=torch.float64).requires_grad_()
        a = torch.tensor(1.5, device=dev, dtype=torch.float64,
                         requires_grad=True)
        c1, v = (torch.rand(GRAD_N, generator=gen, device=dev,
                            dtype=torch.float64) for _ in range(2))
        s = torch.tensor(0.7, device=dev, dtype=torch.float64)
        (y,) = small.as_function()(x, a)
        gx, ga = torch.autograd.grad(y, (x, a), c1, create_graph=True)
        hxx, hxa = torch.autograd.grad((gx * v).sum() + ga * s, (x, a))
        bk1 = small.backward_kernel([x, a], [c1], [True, True])
        bk2 = bk1.backward_kernel([x, a, c1], [v, s], [True, True, False])
        with torch.no_grad():
            pxx, pxa = bk2.plain(x, a, c1, v, s)
        _, rel_xx = errors(hxx, pxx)
        _, rel_xa = errors(hxa.reshape(1), pxa.reshape(1))
        check(rel_xx <= GRAD_TOL["f64"] and rel_xa <= 1e-10,
              f"second derivative: rel err {rel_xx}, {rel_xa}")
        rec.update(second_rel_err_xx=rel_xx, second_rel_err_xa=rel_xa)
        del x, a, c1, v, y, gx, ga, hxx, hxa, pxx, pxa

        # vmap over a (4, 2^20) batch: one launch, the four unbatched
        # calls' bits
        ens = LorenzEnsemble(GRAD_N, context=ctx, seed=args.seed)
        fn = ens._step.as_function()
        ys, zs, rs = (t.storage for t in (ens.y, ens.z, ens.R))
        xb = torch.rand(4, GRAD_N, generator=gen, device=dev)
        got, launches = counted(("multi",), lambda: torch.func.vmap(
            lambda u: fn(u, ys, zs, rs))(xb))
        check(launches["multi"] == 1 and got[0].shape == (4, GRAD_N),
              f"vmap: {launches}, shape {tuple(got[0].shape)}")
        for i in range(4):
            check(all(torch.equal(g[i], o) for g, o in zip(
                got, fn(xb[i], ys, zs, rs))), f"vmap row {i} differs")
        del ens, fn, ys, zs, rs, xb, got

        # the saturating casts: every float (and complex) type into every
        # integer type in one K1 launch a source type, bitwise against the
        # plain forms, at CAST_N values with NaN, the infinities, each
        # limit and its neighbours, and values beyond every range
        targets = [torch.int8, torch.int16, torch.int32, torch.int64,
                   torch.uint8, torch.uint16, torch.uint32, torch.uint64]
        limits = torch.tensor([float(v) for t in targets for v in (
            torch.iinfo(t).min, torch.iinfo(t).max)], dtype=torch.float64,
            device=dev)
        for src in (torch.float16, torch.bfloat16, torch.float32,
                    torch.float64, torch.complex64, torch.complex128):
            real = src.to_real() if src.is_complex else src
            lim = limits.to(real)
            inf = torch.full_like(lim, float("inf"))
            special = torch.cat([torch.tensor(
                [float("nan"), float("inf"), -float("inf"), -0.5, 3.7, -3.7],
                device=dev, dtype=real), lim, torch.nextafter(lim, inf),
                torch.nextafter(lim, -inf)])
            mag = torch.rand(CAST_N - special.numel(), generator=gen,
                             device=dev, dtype=torch.float64)
            sgn = torch.rand(mag.shape, generator=gen, device=dev) < 0.5
            wide = torch.where(sgn, -1.0, 1.0) * 2.0 ** (72 * mag - 2)
            xs = torch.cat([special, wide.to(real)])
            if src.is_complex:
                xs = torch.complex(xs, xs.flip(0))
            xv = vex.vector(data=xs, context=ctx)
            e, an, ty, lv = prepare_multi([vex.cast(t, xv) for t in targets],
                                          CAST_N, dev)
            ko = [torch.empty(CAST_N, dtype=t, device=dev) for t in targets]
            po = [torch.empty_like(o) for o in ko]
            assign_multi(e, an, ty, lv, ko)
            assign_multi_plain(e, an, ty, lv, po)
            for t, k_, p_ in zip(targets, ko, po):
                check(torch.equal(k_, p_), f"saturating cast {src} -> {t}: "
                      "the kernel differs from its plain form")
        rec["casts_checked"] = 6 * len(targets)
        del xs, xv, e, an, ty, lv, ko, po
        # its cost: z_i32[:] = x_f32 at 2^24 through the API (the
        # saturating store) in turns with the unsaturated store and
        # Tensor.to(torch.int32)
        xf = rand(N_VEC, torch.float32)
        xf[:] = (xf - 0.5) * 6e9            # a share beyond the i32 range
        zi = vex.vector(N_VEC, dtype=torch.int32, context=ctx)
        zi[:] = xf
        raw = triton_module(RAW_CAST).cast_f32_i32
        zr = torch.empty(N_VEC, dtype=torch.int32, device=dev)

        def unsaturated():
            raw[(N_VEC // 1024,)](xf.storage, zr, N_VEC, BLOCK=1024,
                                  num_warps=4)

        e, an, ty, lv = prepare(vex.as_expr(xf), N_VEC, dev)
        zp = torch.empty_like(zr)
        assign_plain(e, an, ty, lv, zp)
        check(torch.equal(zi.storage, zp), "z_i32[:] = x_f32: the kernel "
              "differs from its plain form")
        inside = xf.storage.abs() < 2.0 ** 31
        unsaturated()
        check(torch.equal(zr[inside], zp[inside]),
              "the unsaturated store differs inside the i32 range")
        turns = in_turns({"saturating": lambda: zi.assign(xf),
                          "unsaturated": unsaturated,
                          "library": lambda: xf.storage.to(torch.int32)})
        rec.update(cast_f32_i32_ms=turns["saturating"]["ms"],
                   cast_f32_i32_ms_range=turns["saturating"]["ms_range"],
                   cast_f32_i32_unsaturated_ms=turns["unsaturated"]["ms"],
                   cast_f32_i32_unsaturated_ms_range=turns[
                       "unsaturated"]["ms_range"],
                   cast_f32_i32_library_ms=turns["library"]["ms"],
                   cast_f32_i32_bound_ms=bound(8 * N_VEC)[0])
        del xf, zi, zr, zp, e, an, ty, lv, inside
        torch.cuda.empty_cache()
        rec["phase_s"] = time.perf_counter() - t16
        report("autodiff_casts", rec)
    autodiff_phase()

    def partitions_phase():
        """Phase 17: contexts of several parts.  Four parts of the one
        card (and one part a card where the host has several): the main
        path run per part (expressions, the Reductor, DIA with halos in a
        CG solve, stencils, the irregular SpMV with the gathered x and
        with ghost sets, the scan with carries, the counter-based
        generator), each against the one-part result."""
        nonlocal halo_x
        t17 = time.perf_counter()
        rec = {}
        configs = [("parts", [dev] * PARTS)]
        ncards = torch.cuda.device_count()
        if ncards > 1:
            configs.append(("cards", [torch.device("cuda", i)
                                      for i in range(min(ncards, PARTS))]))
        else:
            print("phase 17: one card visible, so the parts share it; the "
                  "phase did not repeat over distinct cards")
        rec["repeated_over_cards"] = ncards > 1
        f = (np.random.default_rng(args.seed).random(nrows) - 0.5).astype(
            np.float32)
        solver1 = PoissonSolver(POISSON_N, context=ctx)
        D1 = solver1.A.device
        solver1.solve(f, maxiter=3)
        u1, it1 = solver1.solve(f, maxiter=CG_ITERS)
        ptr_r, col_r, val_r, _ = random_lognormal_csr(RANDOM_N,
                                                      seed=args.seed)
        S1 = vex.SpMat(RANDOM_N, RANDOM_N, ptr_r, col_r, val_r, context=ctx)
        c = np.linspace(0.1, 0.5, 5)
        st5 = vex.stencil((c / c.sum()).astype(np.float32), center=2)
        st255 = vex.stencil(np.random.default_rng(args.seed).standard_normal(
            255).astype(np.float32) / 255, center=100)
        scan_ints = (np.random.default_rng(args.seed).random(N_VEC)
                     < 0.5).astype(np.float32)

        def one_and_parts(ctxP, data):
            return (vex.vector(data=data, context=ctx),
                    vex.vector(data=data, context=ctxP))

        def same_bits(a, b, what):
            check(a.dtype == b.dtype and np.array_equal(
                a.view(np.uint8), b.view(np.uint8)),
                f"{what}: the parts differ from one part")

        for label, devs in configs:
            ctxP = vex.Context(devices=devs, set_current=False)
            timed = label == "parts"
            r = rec[label] = {"devices": [str(d) for d in devs]}
            # CG: PoissonSolver(256) in f32 over the parts, DIA with halos
            t = time.perf_counter()
            solverP = PoissonSolver(POISSON_N, context=ctxP)
            r["host_construct_s"] = time.perf_counter() - t
            DP = solverP.A.device
            check(DP.mode == "dia_halo" and all(
                p_.dtype == torch.bfloat16 for p_ in DP._planes),
                f"{label}: PoissonSolver's SpMat is {DP.mode}")
            t = time.perf_counter()
            solverP.solve(f, maxiter=3)
            torch.cuda.synchronize()
            r["first_3_iters_s"] = time.perf_counter() - t
            t = time.perf_counter()
            (uP, itP), launches = counted(
                ("expr", "reduce", "dia_halo"),
                lambda: solverP.solve(f, maxiter=CG_ITERS))
            r["cg_s"] = time.perf_counter() - t
            check(abs(itP - it1) <= 1, f"{label}: CG took {itP} iterations, "
                  f"one part {it1}")
            check(launches["dia_halo"] == (itP + 1) * len(devs),
                  f"{label}: CG launched the halo'd DIA kernel "
                  f"{launches['dia_halo']} times in {itP} iterations")
            if timed:
                add_launches(launches)
            planes64 = torch.cat([p_.to(dev) for p_ in DP._planes],
                                 dim=1).to(torch.float64)
            b64 = torch.from_numpy(f).to(dev, torch.float64)

            def mv(v):
                return dia_matvec_plain(nrows, nrows, DP.offsets, planes64, v)

            xr, _ = plain_cg(mv, b64, 1e-6, CG_ITERS)
            xP = torch.from_numpy(uP.to_numpy()).to(dev, torch.float64)
            check(torch.isfinite(xP).all().item(), "CG over parts: x is "
                  "not finite")
            x_rel = (torch.linalg.vector_norm(xP - xr)
                     / torch.linalg.vector_norm(xr)).item()
            x1 = u1.storage.to(torch.float64)
            x_rel1 = (torch.linalg.vector_norm(xP - x1)
                      / torch.linalg.vector_norm(x1)).item()
            check(x_rel <= CG_X_TOL, f"{label}: CG x differs from the f64 "
                  f"CG by {x_rel}")
            r.update(cg_iterations=itP, one_part_iterations=it1,
                     x_rel_err_vs_f64=x_rel, x_rel_diff_vs_one_part=x_rel1,
                     cg_launches=launches)
            del planes64, b64, xr, xP, x1

            # the DIA SpMV over the parts, bit for bit one part
            xa = torch.rand(nrows, generator=gen, device=dev,
                            dtype=torch.float32).cpu().numpy()
            x1v, xPv = one_and_parts(ctxP, xa)
            y1v = vex.vector(nrows, dtype=torch.float32, context=ctx)
            yPv = vex.vector(nrows, dtype=torch.float32, context=ctxP)
            y1v[:] = solver1.A * x1v
            _, launches = counted(("dia_halo",),
                                  lambda: yPv.assign(solverP.A * xPv))
            check(launches["dia_halo"] == len(devs), f"{label}: one SpMV "
                  f"launched {launches}")
            same_bits(yPv.to_numpy(), y1v.to_numpy(), f"{label} DIA SpMV")
            # the stencils: 2^26 f32 width 5, 2^24 f32 255 taps
            for sname, n_, st in (("stencil5", STENCIL_N, st5),
                                  ("stencil255", STENCIL_N_SMALL, st255)):
                sa = torch.rand(n_, generator=gen, device=dev,
                                dtype=torch.float32).cpu().numpy()
                s1, sP = one_and_parts(ctxP, sa)
                o1 = vex.vector(n_, dtype=torch.float32, context=ctx)
                oP = vex.vector(n_, dtype=torch.float32, context=ctxP)
                o1[:] = s1 * st
                _, launches = counted(("stencil",),
                                      lambda: oP.assign(sP * st))
                same_bits(oP.to_numpy(), o1.to_numpy(), f"{label} {sname}")
                r[f"{sname}_launches"] = launches["stencil"]
                if timed and sname == "stencil5":
                    turns = in_turns({"one": lambda: o1.assign(s1 * st),
                                      "parts": lambda: oP.assign(sP * st)})
                    r["stencil5_ms"] = {k_: v["ms"] for k_, v in
                                        turns.items()}
                    r["stencil5_host_us"] = {
                        "one": host_us(lambda: o1.assign(s1 * st)),
                        "parts": host_us(lambda: oP.assign(sP * st))}
                del s1, sP, o1, oP
            torch.cuda.empty_cache()
            # the irregular SpMV: SpMat over the parts (the JAX package's
            # choice: more than 2^22 entries take the gathered x) and the
            # ghost sets forced, each bit for bit one part
            ra = torch.rand(RANDOM_N, generator=gen, device=dev,
                            dtype=torch.float32).cpu().numpy()
            r1, rP = one_and_parts(ctxP, ra)
            q1 = vex.vector(RANDOM_N, dtype=torch.float32, context=ctx)
            qP = vex.vector(RANDOM_N, dtype=torch.float32, context=ctxP)
            q1[:] = S1 * r1
            t = time.perf_counter()
            SP = vex.SpMat(RANDOM_N, RANDOM_N, ptr_r, col_r, val_r,
                           context=ctxP)
            r["lognormal_construct_s"] = time.perf_counter() - t
            t = time.perf_counter()
            GP = distributed(RANDOM_N, RANDOM_N, ptr_r, col_r, val_r,
                             context=ctxP, mode="ell_a2a")
            r["ghost_sets_construct_s"] = time.perf_counter() - t
            r["lognormal_mode"] = SP.device.mode
            r["ghost_values"] = int(sum(len(s_) for s_ in GP._send))
            for mname, A in (("spmat", SP), ("ghost_sets", GP)):
                _, launches = counted(("csr",), lambda: qP.assign(A * rP))
                check(launches["csr"] == len(devs), f"{label} {mname}: "
                      f"{launches}")
                same_bits(qP.to_numpy(), q1.to_numpy(),
                          f"{label} lognormal SpMV ({mname})")
            if timed:
                turns = in_turns({"one": lambda: q1.assign(S1 * r1),
                                  "parts": lambda: qP.assign(SP * rP),
                                  "ghost_sets": lambda: qP.assign(GP * rP)})
                r["lognormal_spmv_ms"] = {k_: v["ms"] for k_, v in
                                          turns.items()}
            del r1, rP, q1, qP, SP, GP
            torch.cuda.empty_cache()
            # inclusive_scan of 2^24 f32: integer-valued data bit for bit
            # (exact sums), normal data within PART_SCAN_TOL, MAX bitwise
            na = torch.randn(N_VEC, generator=gen, device=dev).cpu().numpy()
            for dname, data, op in (("ints", scan_ints, None),
                                    ("normal", na, None),
                                    ("max", na, torch.maximum)):
                c1v, cPv = one_and_parts(ctxP, data)
                w1 = vex.inclusive_scan(c1v, op=op).to_numpy()
                wP, launches = counted(
                    ("scan", "expr"),
                    lambda: vex.inclusive_scan(cPv, op=op))
                check(launches["scan"] == len(devs) + 1
                      and launches["expr"] == len(devs) - 1,
                      f"{label} scan: {launches}")
                wP = wP.to_numpy()
                if dname == "normal":
                    err = np.abs(wP.astype(np.float64) - w1).max()
                    check(err <= PART_SCAN_TOL * max(1.0, np.abs(w1).max()),
                          f"{label} scan over parts: abs err {err}")
                    r["scan_normal_abs_err"] = float(err)
                else:
                    same_bits(wP, w1, f"{label} scan {dname}")
                if timed and dname == "normal":
                    turns = in_turns({
                        "one": lambda: vex.inclusive_scan(c1v),
                        "parts": lambda: vex.inclusive_scan(cPv)})
                    r["scan_ms"] = {k_: v["ms"] for k_, v in turns.items()}
                del c1v, cPv
            # x[:] = rnd(element_index(), seed) at 2^24: the global index
            g1 = vex.vector(N_VEC, dtype=torch.float32, context=ctx)
            gP = vex.vector(N_VEC, dtype=torch.float32, context=ctxP)
            rnd = vex.Random(torch.float32, "philox")
            g1[:] = rnd(vex.element_index(), args.seed + 17)
            _, launches = counted(("expr",), lambda: gP.assign(
                rnd(vex.element_index(), args.seed + 17)))
            check(launches["expr"] == len(devs), f"{label} rng: {launches}")
            same_bits(gP.to_numpy(), g1.to_numpy(), f"{label} rng")
            # the Reductor: SUM within the f32 sum tolerance, MIN and MAX
            # exact, one map-reduce launch a part
            sums = {}
            for key, v_ in (("one", g1), ("parts", gP)):
                expr_ = v_ * v_ - 0.25
                if key == "parts":
                    got_, launches = counted(("reduce",), lambda: vex.Reductor(
                        vex.SUM)(expr_))
                    check(launches["reduce"] == len(devs),
                          f"{label} Reductor: {launches}")
                else:
                    got_ = vex.Reductor(vex.SUM)(expr_)
                sums[key] = (got_, vex.Reductor(vex.MIN)(expr_),
                             vex.Reductor(vex.MAX)(expr_))
            check(abs(sums["parts"][0] - sums["one"][0])
                  <= SUM_TOL["f32"] * max(1.0, abs(sums["one"][0]))
                  and sums["parts"][1:] == sums["one"][1:],
                  f"{label} Reductor over parts: {sums}")
            r["reductor"] = sums
            if timed:
                # one part against four, in turns: CG ms an iteration, the
                # SpMV, and the host's time a call of an assignment, a
                # Reductor dot and the SpMV through the API
                cg_ms = {"one": [], "parts": []}
                for who in ("one", "parts", "parts", "one") * 2:
                    sv = solver1 if who == "one" else solverP
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    sv.solve(f, maxiter=PART_TURN_ITERS)
                    torch.cuda.synchronize()
                    cg_ms[who].append((time.perf_counter() - t)
                                      / PART_TURN_ITERS * 1e3)
                r["cg_ms_per_iter"] = {k_: statistics.median(v)
                                       for k_, v in cg_ms.items()}
                r["cg_ms_per_iter_range"] = {k_: [min(v), max(v)]
                                             for k_, v in cg_ms.items()}
                turns = in_turns({"one": lambda: y1v.assign(solver1.A * x1v),
                                  "parts": lambda: yPv.assign(
                                      solverP.A * xPv)})
                r["dia_spmv_ms"] = {k_: v["ms"] for k_, v in turns.items()}
                r["host_us"] = {
                    "assign_one": host_us(lambda: y1v.assign(x1v + 0.7 * y1v)),
                    "assign_parts": host_us(
                        lambda: yPv.assign(xPv + 0.7 * yPv)),
                    "dot_one": host_us(lambda: vex.Reductor(vex.SUM)(
                        x1v * y1v)),
                    "dot_parts": host_us(lambda: vex.Reductor(vex.SUM)(
                        xPv * yPv)),
                    "spmv_one": host_us(lambda: y1v.assign(solver1.A * x1v)),
                    "spmv_parts": host_us(
                        lambda: yPv.assign(solverP.A * xPv))}
                # the kernels line's row: the halo'd form's launches of one
                # SpMV (the halos exchanged first) against their plain
                # versions
                xs = xPv.parts
                halos = exchange_halos(xs, DP.col_pts, DP.lhalo, DP.rhalo)
                offd = DP._offsets[dev]

                def halo_kernels():
                    return [dia_matvec_halo(
                        int(r0), nrows, DP.offsets, offd, pl, xl, xb, xr_)
                        for r0, pl, xb, (xl, xr_) in zip(
                            DP.row_pts[:-1], DP._planes, xs, halos)]

                def halo_plain():
                    return [dia_matvec_halo_plain(
                        int(r0), nrows, DP.offsets, pl, xl, xb, xr_)
                        for r0, pl, xb, (xl, xr_) in zip(
                            DP.row_pts[:-1], DP._planes, xs, halos)]
                ks, ps = torch.cat(halo_kernels()), torch.cat(halo_plain())
                abs_err, rel = errors(ks, ps)
                check(rel <= DIA_TOL["f32"], f"halo'd DIA kernel: rel err "
                      f"{rel}")
                nbytes = (tensor_bytes(*DP._planes, *xs, ks)
                          + sum(tensor_bytes(a_, b_) for a_, b_ in halos))
                # the four launches' device time (the profiler): their
                # events read the host's four wrapper calls
                per_kernel, _ = profile_call(halo_kernels, KERNEL_REPS)
                dev_us = sum(v for k_, v in per_kernel.items()
                             if "dia_spmv_halo_kernel" in k_)
                check(dev_us > 0, f"the profiler saw no halo'd DIA kernel: "
                      f"{per_kernel}")
                kernels["dia_halo"] = kernel_row(
                    abs_err, dev_us / 1e3, cuda_ms(halo_plain), nbytes,
                    2 * solverP.A.nnz,
                    None)     # cuSPARSE's time on the same x: at the end
                kernels["dia_halo"].update(
                    device_us=dev_us,
                    events_ms=cuda_ms(halo_kernels, KERNEL_REPS),
                    one_part_device_us=sum(profile_call(
                        lambda: dia_matvec(nrows, nrows, D1.offsets,
                                           D1.offsets_dev, D1.vals,
                                           x1v.storage),
                        KERNEL_REPS)[0].values()))
                halo_x = torch.from_numpy(xa).to(dev)
                del ks, ps, halos
            del x1v, xPv, y1v, yPv, g1, gP, solverP, uP
            torch.cuda.empty_cache()
        rec["s"] = time.perf_counter() - t17
        report("partitions", {k_: v for k_, v in rec.items()})
        del solver1, u1, S1, D1

    halo_x = None
    partitions_phase()

    def algorithms_phase():
        """Phase 18: sort, the FFT, the keyed scans, reduce_by_key and
        any_of/all_of over four parts of the one card at the bench's sizes,
        each against one part on the same inputs: bit for bit where the
        order allows (the sorts, MAX, integer-valued sums, counts, keys,
        the predicates), else within the printed tolerance; the launches
        of the four-step FFT, the per-part keyed kernels and no gathered
        transform; then one part against four in turns (events ms) and
        the host's µs a call."""
        from vexcl_tpu_torch.ops.sort_dist import sort_parts

        t18 = time.perf_counter()
        rec = {"tolerances": {"fft_c64_rel": FFT_PART_TOL,
                              "sum_rel": PART_SCAN_TOL}}
        ctxP = vex.Context(devices=[dev] * PARTS, set_current=False)
        if torch.cuda.device_count() > 1:
            print("phase 18: the parts share the first card; "
                  "tests/test_torch_cuda_multidevice.py spreads them over "
                  "the cards")
        rng = np.random.default_rng(args.seed + 18)
        timed = {}

        def both(data):
            return tuple(vex.vector(data=data, context=c)
                         for c in (ctx, ctxP))

        def same_bits(a, b, what):
            a, b = a.to_numpy(), b.to_numpy()
            check(a.dtype == b.dtype and np.array_equal(
                a.view(np.uint8), b.view(np.uint8)),
                f"phase 18 {what}: the parts differ from one part")

        def close(a, b, tol, what):
            a, b = (torch.from_numpy(v.to_numpy()) for v in (a, b))
            if a.is_complex():
                a, b = torch.view_as_real(a), torch.view_as_real(b)
            _, rel = errors(a, b)
            check(rel <= tol, f"phase 18 {what}: rel err {rel} > {tol}")
            return rel

        # sort_by_key of 2^24 uniform i32 keys in [0, 2^30) with f32
        # values (bench.py:538), and a descending f32 sort
        keys = rng.integers(0, 1 << 30, N_VEC, dtype=np.int32)
        vals = rng.random(N_VEC, dtype=np.float32)
        k1, kP = both(keys)
        v1, vP = both(vals)
        vex.sort_by_key(k1, v1)
        merges = sort_parts.merges
        vex.sort_by_key(kP, vP)
        rec["sort_merges"] = sort_parts.merges - merges
        check(rec["sort_merges"] == PARTS * (PARTS - 1) // 2,
              f"sort over parts: {rec['sort_merges']} merges")
        same_bits(kP, k1, "sort_by_key keys")
        same_bits(vP, v1, "sort_by_key values")
        f1, fP = both(vals)
        vex.sort(f1, descending=True)
        vex.sort(fP, descending=True)
        same_bits(fP, f1, "descending sort")
        # a timed sort sorts a fresh device copy of the keys and values
        src, fresh = both(keys) + both(vals), both(keys) + both(vals)

        def sort_fresh(i):
            fresh[i].assign(src[i])
            fresh[i + 2].assign(src[i + 2])
            vex.sort_by_key(fresh[i], fresh[i + 2])

        timed["sort_by_key"] = (lambda: sort_fresh(0),
                                lambda: sort_fresh(1), SORT_REPS)
        del k1, kP, v1, vP, f1, fP
        # the 1-D FFT of 2^24 c64 forward and inverse, the 2-D 4096^2
        x = (rng.standard_normal(N_VEC) + 1j * rng.standard_normal(N_VEC)
             ).astype(np.complex64)
        for name, shape, inverse in (("fft_2^24", (N_VEC,), False),
                                     ("ifft_2^24", (N_VEC,), True),
                                     ("fft2d_4096", (FFT2D_SIDE,) * 2,
                                      False)):
            f = vex.FFT(shape, inverse=inverse, dtype=torch.complex64)
            x1, xP = both(x)
            y1 = vex.vector(N_VEC, dtype=torch.complex64, context=ctx)
            yP = vex.vector(N_VEC, dtype=torch.complex64, context=ctxP)
            y1[:] = f(x1)
            check(f(xP).plan.impl == "dist", f"{name}: not four-step")
            _, launches = counted(("cufft", "complex"),
                                  lambda: yP.assign(f(xP)))
            # the gathered route would be one execution and no transpose
            want = (2 * PARTS, (3 if len(shape) == 1 else 2) * PARTS)
            check((launches["cufft"], launches["complex"]) == want,
                  f"{name} over parts: {launches}")
            add_launches(launches)
            rec[f"{name}_launches"] = launches
            rec[f"{name}_rel_err"] = close(yP, y1, FFT_PART_TOL, name)
            if name != "ifft_2^24":
                timed[name] = (lambda f=f, x1=x1, y1=y1: y1.assign(f(x1)),
                               lambda f=f, xP=xP, yP=yP: yP.assign(f(xP)),
                               FFT_REPS)
        per_kernel, busy = profile_call(timed["fft_2^24"][1], FFT_REPS)
        rec["fft_2^24_parts_device_us"] = per_kernel
        rec["fft_2^24_parts_busy"] = busy
        # keyed scans and reduce_by_key at 2^24 f32, i32 keys in runs of
        # 63 and one run longer than a part
        kk = (np.arange(N_VEC) // KEY_RUN).astype(np.int32)
        lo = N_VEC // PARTS - N_VEC // 8
        kk[lo:lo + N_VEC // PARTS + N_VEC // 4] = kk[lo]
        xr = rng.random(N_VEC, dtype=np.float32)
        xi = rng.integers(-3, 4, N_VEC).astype(np.float32)
        kk1, kkP = both(kk)
        xr1, xrP = both(xr)
        xi1, xiP = both(xi)
        # (name, function, arguments, values, bit for bit, fix-up
        # launches: none for the first part of an inclusive scan)
        for name, fn, kw, x_1, x_P, exact, fixups in (
                ("inclusive_scan_by_key", vex.inclusive_scan_by_key, {},
                 xr1, xrP, False, PARTS - 1),
                ("exclusive_scan_by_key_init", vex.exclusive_scan_by_key,
                 dict(init=2.0), xi1, xiP, True, PARTS),
                ("inclusive_scan_by_key_max", vex.inclusive_scan_by_key,
                 dict(op_name="max"), xr1, xrP, True, PARTS - 1)):
            w1 = fn(kk1, x_1, **kw)
            wP, launches = counted(
                ("scan_by_key", "reduce", "segscan", "expr"),
                lambda: fn(kkP, x_P, **kw))
            check(launches == {"scan_by_key": PARTS, "reduce": PARTS,
                               "segscan": 1, "expr": fixups},
                  f"{name} over parts: {launches}")
            add_launches(launches)
            rec[f"{name}_launches"] = launches
            if exact:
                same_bits(wP, w1, name)
            else:
                rec[f"{name}_rel_err"] = close(wP, w1, PART_SCAN_TOL, name)
        timed["inclusive_scan_by_key"] = (
            lambda: vex.inclusive_scan_by_key(kk1, xr1),
            lambda: vex.inclusive_scan_by_key(kkP, xrP), KEYED_REPS)
        for name, x_1, x_P, exact in (("reduce_by_key", xr1, xrP, False),
                                      ("reduce_by_key_ints", xi1, xiP, True)):
            ok1, ov1, m1 = vex.reduce_by_key(kk1, x_1)
            (okP, ovP, mP), launches = counted(
                ("reduce_by_key",), lambda: vex.reduce_by_key(kkP, x_P))
            check(launches["reduce_by_key"] == PARTS and mP == m1
                  and ovP.nparts == PARTS,
                  f"{name} over parts: {launches}, count {mP} / {m1}")
            add_launches(launches)
            same_bits(okP, ok1, f"{name} keys")
            if exact:
                same_bits(ovP, ov1, name)
            else:
                rec[f"{name}_rel_err"] = close(ovP, ov1, PART_SCAN_TOL, name)
            rec[f"{name}_count"] = mP
        timed["reduce_by_key"] = (lambda: vex.reduce_by_key(kk1, xr1),
                                  lambda: vex.reduce_by_key(kkP, xrP),
                                  KEYED_REPS)
        # any_of / all_of of a 2^24 expression
        preds = {}
        for who, xv in (("one", xr1), ("parts", xrP)):
            preds[who] = (vex.any_of(xv > 0.999999), vex.all_of(xv >= 0),
                          vex.any_of(xv > 2), vex.all_of(xv > 0.5))
        _, launches = counted(("reduce",), lambda: vex.any_of(xrP > 2))
        check(launches["reduce"] == PARTS and preds["parts"] == preds["one"]
              == (True, True, False, False),
              f"any_of/all_of over parts: {preds}, {launches}")
        add_launches(launches)
        timed["any_of"] = (lambda: vex.any_of(xr1 > 2),
                           lambda: vex.any_of(xrP > 2), KEYED_REPS)
        # one part against four, in turns (events), and host µs a call
        for name, (one, parts, reps) in timed.items():
            got = {"one": [], "parts": []}
            for r in range(3):
                for who in (("one", "parts") if r % 2 == 0
                            else ("parts", "one")):
                    got[who].append(cuda_ms(one if who == "one" else parts,
                                            reps))
            rec[f"{name}_ms"] = {k_: statistics.median(v)
                                 for k_, v in got.items()}
            rec[f"{name}_ms_range"] = {k_: [min(v), max(v)]
                                       for k_, v in got.items()}
            rec[f"{name}_host_us"] = {"one": host_us(one, reps),
                                      "parts": host_us(parts, reps)}
        del x1, xP, y1, yP, kk1, kkP, xr1, xrP, xi1, xiP, src, fresh, timed
        torch.cuda.empty_cache()
        rec["s"] = time.perf_counter() - t18
        report("algorithms_over_parts", rec)

    algorithms_phase()

    def views_parts_phase():
        """Phase 19: views, gathers, scatters, atomic updates, images and
        MBA over four parts of the one card (and one part a card where the
        host has several), through the API at full width, each against the
        one-part call on the same inputs: bit for bit, a float ``+=`` with
        repeated indices within VIEW_SUM_TOL of the largest magnitude; the
        one-part kernels launched on every part (V2 and the base's gather
        once a distinct device), the gathered bases on the card, each table
        held once a distinct device; then one part against four in turns
        (events ms), host µs a call, and device µs by kernel of (a)-(c)."""
        from vexcl_tpu_torch.parallel import halo

        t19 = time.perf_counter()
        rec = {"tolerances": VIEW_SUM_TOL}
        configs = [("parts", [dev] * PARTS)]
        ncards = torch.cuda.device_count()
        if ncards > 1:
            configs.append(("cards", [torch.device("cuda", i)
                                      for i in range(min(ncards, PARTS))]))
        else:
            print("phase 19: one card visible, so the parts share it; the "
                  "phase did not repeat over distinct cards")
        rec["repeated_over_cards"] = ncards > 1
        rng = np.random.default_rng(args.seed + 19)
        # the scatter route's form -> its launch counter
        form_key = {"ranges": "scatter_ranges",
                    "privatized": "scatter_privatized"}
        perm = rng.permutation(N_VEC).astype(np.int32)
        hx = rng.random(N_VEC, dtype=np.float32)
        hv = rng.random(N_VEC, dtype=np.float32)
        reps_keys = rng.integers(0, N_VEC, N_VEC).astype(np.int32)
        bins_keys = rng.integers(0, HIST_BINS, N_VEC).astype(np.int32)
        hnan = hx.copy()
        hnan[N_VEC // 3] = np.nan
        img = rng.random((IMG_GRID, IMG_GRID), dtype=np.float32)
        cx = rng.random(N_VEC, dtype=np.float32) * (IMG_GRID - 1)
        cy = rng.random(N_VEC, dtype=np.float32) * (IMG_GRID - 1)
        ki = rng.integers(0, VIEW_GRID, N_VEC).astype(np.int32)
        kj = rng.integers(0, VIEW_GRID, N_VEC).astype(np.int32)
        # unique indices (a scatter's repeated index has no order), one
        # wrapped from below and two out of range
        host_idx = perm[:1 << 20].astype(np.int64)
        host_idx[:3] = [host_idx[0] - N_VEC, N_VEC + 3, -N_VEC - 9]
        host_vals = rng.random(len(host_idx), dtype=np.float32)
        rng_l = np.random.default_rng(7)
        sx, sy = rng_l.random(4096), rng_l.random(4096)
        surf = vex.mba(lo=(-0.01, -0.01), hi=(1.01, 1.01), coords=(sx, sy),
                       values=np.sin(7 * sx) * np.cos(5 * sy), grid=(8, 8),
                       levels=6)
        check(surf.lattice.shape == (259, 259),
              f"phase 19 mba: lattice {surf.lattice.shape}")
        im_lin = vex.image2d(img, filter="linear", context=ctx)
        im_near = vex.image2d(img, filter="nearest", context=ctx)
        sl = vex.slicer((VIEW_GRID, VIEW_GRID))
        gathered = []
        plain_all_gather = halo.all_gather

        def watched(parts, devices):
            out = plain_all_gather(parts, devices)
            gathered.extend(t.device.type for t in out)
            return out

        halo.all_gather = watched
        try:
            for label, devs in configs:
                ctxP = vex.Context(devices=devs, set_current=False)
                main = label == "parts"
                distinct = len(set(devs))
                r = rec[label] = {"devices": [str(d) for d in devs]}
                timed = {}

                def both(data, dt=None):
                    return tuple(vex.vector(data=data, dtype=dt, context=c)
                                 for c in (ctx, ctxP))

                def empty(n, dt):
                    return tuple(vex.vector(n, dtype=dt, context=c)
                                 for c in (ctx, ctxP))

                def same_bits(a, b, what):
                    check(b.nparts == len(devs) and all(
                        p_.device.type == "cuda" for p_ in b.parts),
                        f"phase 19 {what}: a part off the card")
                    a, b = a.to_numpy(), b.to_numpy()
                    check(a.dtype == b.dtype and np.array_equal(
                        a.view(np.uint8), b.view(np.uint8)),
                        f"phase 19 {what}: the parts differ from one part")

                def launched(keys, fn, what, each=None):
                    """The parts' API call counted: ``each`` (default every
                    key) launched once a part."""
                    _, got = counted(keys, fn)
                    for k_ in (keys if each is None else each):
                        check(got[k_] == len(devs),
                              f"phase 19 {what}: {got} over {len(devs)} "
                              "parts")
                    if main:
                        add_launches(got)
                    r[f"{what}_launches"] = got

                m_part = N_VEC // len(devs)
                # (a) y[:] = permutation(p)(x), f32 and f64
                p1, pP = both(perm)
                bases = {}
                for dname, dt in (("f32", torch.float32),
                                  ("f64", torch.float64)):
                    x1, xP = bases[dname] = both(hx, dt)
                    y1, yP = empty(N_VEC, dt)
                    y1[:] = vex.permutation(p1)(x1)
                    key = ("gather_ranges" if cuda_gather.route(
                        dt, N_VEC, m_part, torch.int32) else "indexed")
                    launched((key,), lambda: yP.assign(vex.permutation(pP)(
                        xP)), f"gather_{dname}")
                    same_bits(y1, yP, f"gather {dname}")
                    timed[f"a_gather_{dname}"] = (
                        lambda y1=y1, x1=x1: y1.assign(
                            vex.permutation(p1)(x1)),
                        lambda yP=yP, xP=xP: yP.assign(
                            vex.permutation(pP)(xP)))
                    r[f"all_gather_{dname}_ms"] = cuda_ms(
                        lambda xP=xP: plain_all_gather(xP.parts, devs),
                        VIEW_PART_REPS)
                x1, xP = bases["f32"]
                v1, vP = both(hv)
                # (b) permutation(p)(z).assign(v), and += at repeated
                # indices
                z1, zP = empty(N_VEC, torch.float32)
                vex.permutation(p1)(z1).assign(v1)
                form = cuda_scatter.route("store", torch.float32, m_part,
                                          N_VEC)
                key = form_key.get(form, "to_view")
                launched((key,) + (("multi",) if form else ()),
                         lambda: vex.permutation(pP)(zP).assign(vP),
                         "scatter_store", (key,))
                same_bits(z1, zP, "scatter")
                timed["b_scatter"] = (
                    lambda: vex.permutation(p1)(z1).assign(v1),
                    lambda: vex.permutation(pP)(zP).assign(vP))
                k1, kP = both(reps_keys)
                a1, aP = both(np.zeros(N_VEC, np.float32))
                vex.permutation(k1)(a1).assign(v1, "+=")
                form = cuda_scatter.route("add", torch.float32, m_part,
                                          N_VEC)
                key = form_key.get(form, "to_view")
                launched((key,) + (("multi",) if form else ()),
                         lambda: vex.permutation(kP)(aP).assign(vP, "+="),
                         "scatter_add", (key,))
                _, rel = errors(torch.from_numpy(aP.to_numpy()),
                                torch.from_numpy(a1.to_numpy()))
                check(rel <= VIEW_SUM_TOL["f32"],
                      f"phase 19 scatter +=: rel err {rel}")
                r["scatter_add_rel_err"] = rel
                timed["b_scatter_add"] = (
                    lambda: vex.permutation(k1)(a1).assign(v1, "+="),
                    lambda: vex.permutation(kP)(aP).assign(vP, "+="))
                # (c) the histogram of 2^24 keys into 2^16 partitioned
                # bins, and atomic_max of f32 values
                b1, bP = both(bins_keys)
                h1, hP = both(np.zeros(HIST_BINS, np.int32))
                vex.eval(vex.atomic_add(vex.permutation(b1)(h1), 1))
                form = cuda_scatter.route("add", torch.int32,
                                          HIST_BINS // len(devs), N_VEC)
                key = form_key.get(form, "to_view")
                launched((key,), lambda: vex.eval(vex.atomic_add(
                    vex.permutation(bP)(hP), 1)), "histogram")
                same_bits(h1, hP, "histogram")
                check(int(h1.to_numpy().sum()) == N_VEC,
                      "phase 19 histogram: a key lost")
                timed["c_histogram"] = (
                    lambda: vex.eval(vex.atomic_add(vex.permutation(b1)(h1),
                                                    1)),
                    lambda: vex.eval(vex.atomic_add(vex.permutation(bP)(hP),
                                                    1)))
                m1, mP = both(np.full(HIST_BINS, -1.0, np.float32))
                vex.eval(vex.atomic_max(vex.permutation(b1)(m1), v1))
                form = cuda_scatter.route("max", torch.float32,
                                          HIST_BINS // len(devs), N_VEC)
                key = form_key.get(form, "to_view")
                launched((key,), lambda: vex.eval(vex.atomic_max(
                    vex.permutation(bP)(mP), vP)), "atomic_max")
                same_bits(m1, mP, "atomic_max")
                timed["c_atomic_max"] = (
                    lambda: vex.eval(vex.atomic_max(vex.permutation(b1)(m1),
                                                    v1)),
                    lambda: vex.eval(vex.atomic_max(vex.permutation(bP)(mP),
                                                    vP)))
                # (d) the interior and the transpose of a 4096^2 f32
                # multi_array
                g1, gP = (vex.multi_array(vex.extents[VIEW_GRID][VIEW_GRID],
                                          dtype=torch.float32, context=c)
                          for c in (ctx, ctxP))
                g1.vec()[:] = x1
                gP.vec()[:] = xP
                inner = (VIEW_GRID - 2) ** 2
                in1, inP = empty(inner, torch.float32)
                key = (slice(1, -1), slice(1, -1))
                in1[:] = g1[key]
                launched(("indexed",), lambda: inP.assign(gP[key]),
                         "interior")
                same_bits(in1, inP, "interior")
                timed["d_interior"] = (lambda: in1.assign(g1[key]),
                                       lambda: inP.assign(gP[key]))
                t1, tP = empty(N_VEC, torch.float32)
                t1[:] = vex.reshape(g1.vec(), (VIEW_GRID, VIEW_GRID), (1, 0))
                launched(("indexed",), lambda: tP.assign(vex.reshape(
                    gP.vec(), (VIEW_GRID, VIEW_GRID), (1, 0))), "transpose")
                same_bits(t1, tP, "transpose")
                timed["d_transpose"] = (
                    lambda: t1.assign(vex.reshape(
                        g1.vec(), (VIEW_GRID, VIEW_GRID), (1, 0))),
                    lambda: tP.assign(vex.reshape(
                        gP.vec(), (VIEW_GRID, VIEW_GRID), (1, 0))))
                # (e) reduce_view row sums, and the column max with a NaN
                n1, nP = (vex.multi_array(None, data=hnan.reshape(
                    VIEW_GRID, VIEW_GRID), context=c) for c in (ctx, ctxP))
                for name, src1, srcP, op, ax in (
                        ("row_sums", g1, gP, "sum", 1),
                        ("column_max_nan", n1, nP, "max", 0)):
                    o1, oP = empty(VIEW_GRID, torch.float32)
                    o1[:] = vex.reduce_view(op, src1, ax)
                    _, got = counted(("reduce_view",), lambda: oP.assign(
                        vex.reduce_view(op, srcP, ax)))
                    check(got["reduce_view"] == distinct,
                          f"phase 19 {name}: {got}")
                    if main:
                        add_launches(got)
                    r[f"{name}_launches"] = got
                    same_bits(o1, oP, name)
                    if op == "max":
                        check(np.isnan(oP.to_numpy()).sum() == 1,
                              "phase 19 column max: the NaN is lost")
                    timed[f"e_{name}"] = (
                        lambda o1=o1, s1=src1, op=op, ax=ax: o1.assign(
                            vex.reduce_view(op, s1, ax)),
                        lambda oP=oP, sP=srcP, op=op, ax=ax: oP.assign(
                            vex.reduce_view(op, sP, ax)))
                # (f) a bilinear sample of the 4096^2 image (the patch
                # route), a nearest one and slicer[i, j]; the image stays
                # on the card that holds it, a copy on each other card
                X1, XP = both(cx)
                Y1, YP = both(cy)
                s1, sP = empty(N_VEC, torch.float32)
                s1[:] = im_lin(X1, Y1)
                check(im_lin(XP, YP).patched, "phase 19: no patch table")
                copies = halo.replicate.copies
                launched(("image",), lambda: sP.assign(im_lin(XP, YP)),
                         "image_linear")
                r["table_copies"] = halo.replicate.copies - copies
                check(r["table_copies"] == len(set(devs) - {dev}),
                      f"phase 19: {r['table_copies']} copies of the patch "
                      f"table onto {distinct} devices")
                same_bits(s1, sP, "linear sample")
                timed["f_linear"] = (lambda: s1.assign(im_lin(X1, Y1)),
                                     lambda: sP.assign(im_lin(XP, YP)))
                coords_key = ("gather_coords" if cuda_gather.index_route(
                    torch.float32, IMG_GRID * IMG_GRID, m_part)
                    else "indexed")
                s1[:] = im_near(X1, Y1)
                launched((coords_key,), lambda: sP.assign(im_near(XP, YP)),
                         "image_nearest")
                same_bits(s1, sP, "nearest sample")
                timed["f_nearest"] = (lambda: s1.assign(im_near(X1, Y1)),
                                      lambda: sP.assign(im_near(XP, YP)))
                ki1, kiP = both(ki)
                kj1, kjP = both(kj)
                s1[:] = sl[ki1, kj1](x1)
                launched(("advanced_index" if coords_key == "indexed"
                          else coords_key,),
                         lambda: sP.assign(sl[kiP, kjP](xP)), "slicer_ij")
                same_bits(s1, sP, "slicer[i, j]")
                timed["f_slicer_ij"] = (
                    lambda: s1.assign(sl[ki1, kj1](x1)),
                    lambda: sP.assign(sl[kiP, kjP](xP)))
                # (g) MBA on the 259^2 lattice at 2^24 f32 points
                U1, UP = both(cx / IMG_GRID)
                W1, WP = both(cy / IMG_GRID)
                s1[:] = surf(U1, W1)
                form = cuda_mba.route(torch.float32, surf.grids[0])
                launched(("mba", f"mba_{form}"),
                         lambda: sP.assign(surf(UP, WP)), "mba")
                same_bits(s1, sP, "mba")
                # the route's tables: the taps form's, or the lattice
                held = [k_[1] for k_ in (surf._kernel_tables
                                         if form == "taps" else surf._tables)
                        if k_[0] == torch.float32]
                check(sorted(map(str, held)) == sorted(map(str, set(
                    devs) | {dev})), f"phase 19 mba: tables on {held}")
                timed["g_mba"] = (lambda: s1.assign(surf(U1, W1)),
                                  lambda: sP.assign(surf(UP, WP)))
                # (h) Gather and Scatter of 2^20 host indices
                G1, GP = vex.Gather(ctx, host_idx), vex.Gather(ctxP,
                                                              host_idx)
                got1, gotP = G1(x1), GP(xP)
                check(np.array_equal(got1.view(np.uint32),
                                     gotP.view(np.uint32)),
                      "phase 19 Gather: the parts differ from one part")
                S1, SP = vex.Scatter(ctx, host_idx), vex.Scatter(ctxP,
                                                                host_idx)
                S1(host_vals, x1)
                launched(("to_view",), lambda: SP(host_vals, xP),
                         "scatter_host")
                same_bits(x1, xP, "Scatter")
                timed["h_gather_host"] = (lambda: G1(x1), lambda: GP(xP))
                timed["h_scatter_host"] = (lambda: S1(host_vals, x1),
                                           lambda: SP(host_vals, xP))
                if not main:
                    del timed
                    torch.cuda.empty_cache()
                    continue
                # one part against four in turns (events ms), host µs a
                # call, device µs by kernel of (a)-(c)
                for name, (one, parts) in timed.items():
                    got = {"one": [], "parts": []}
                    for r_ in range(3):
                        for who in (("one", "parts") if r_ % 2 == 0
                                    else ("parts", "one")):
                            got[who].append(cuda_ms(
                                one if who == "one" else parts,
                                VIEW_PART_REPS))
                    r[f"{name}_ms"] = {k_: statistics.median(v)
                                       for k_, v in got.items()}
                    r[f"{name}_ms_range"] = {k_: [min(v), max(v)]
                                             for k_, v in got.items()}
                    r[f"{name}_host_us"] = {
                        "one": host_us(one, VIEW_PART_REPS),
                        "parts": host_us(parts, VIEW_PART_REPS)}
                    if name[0] in "abc":
                        r[f"{name}_device_us"] = {
                            "one": profile_call(one, VIEW_PART_REPS)[0],
                            "parts": profile_call(parts, VIEW_PART_REPS)[0]}
                r["all_gather_share_f32"] = (
                    r["all_gather_f32_ms"] / r["a_gather_f32_ms"]["parts"])
                del timed
                torch.cuda.empty_cache()
        finally:
            halo.all_gather = plain_all_gather
        check(gathered and set(gathered) == {"cuda"},
              f"phase 19 gathered bases onto {set(gathered)}")
        rec["s"] = time.perf_counter() - t19
        report("views_over_parts", rec)

    views_parts_phase()

    def runtime_parts_phase():
        """Phase 20: the runtime's operations over four parts of the one
        card against one part, through the API at full width: (a)
        ``enqueue`` of an expression, the 5-tap stencil, the 1-D FFT
        (c64) and a bilinear sample of the 4096^2 image at 2^24 points
        from four parts onto one and from one onto four, the tables copied
        once a device; (b) the user CUDA and Triton kernels and the halo
        kernel over ``with_halo``, one launch a part; (c) the Lorenz
        step's ``as_function`` at 2^22, f32 and f64, one K1 launch a
        part; (d) ``reinterpret`` f32 to u16 and to f64 and ``resize``
        over unequal parts; (e) a custom-op scan; (f) the lognormal 2^20
        CSR matrix of one part times a four-part x; (g)
        ``dryrun_multichip(4)`` at 2^24; (h) ``Context()``'s parts.  Each
        bit for bit one part's (within FFT_PART_TOL for the four-step
        transform, PART_SCAN_TOL for the custom op's carries); then one
        part against four in turns (events ms), host µs a call and
        device µs by kernel."""
        from vexcl_tpu_torch.dryrun import HALO3, dryrun_multichip
        from vexcl_tpu_torch.parallel import halo

        t20 = time.perf_counter()
        rec = {"tolerances": {"fft": FFT_PART_TOL, "scan": PART_SCAN_TOL}}
        ctxP = vex.Context(devices=[dev] * PARTS, set_current=False)
        rng = np.random.default_rng(args.seed + 20)
        hx = rng.random(N_VEC, dtype=np.float32)
        timed = {}

        def both(data, dt=None, n=None):
            return tuple(vex.vector(data=data, dtype=dt, context=c)
                         if data is not None else vex.vector(n, dtype=dt,
                                                             context=c)
                         for c in (ctx, ctxP))

        def same_bits(a, b, what, tol=None):
            a, b = a.to_numpy(), b.to_numpy()
            if tol is None:
                check(a.dtype == b.dtype and np.array_equal(
                    a.view(np.uint8), b.view(np.uint8)),
                    f"phase 20 {what}: the parts differ from one part")
                return
            err = np.abs(a - b).max() / max(1.0, np.abs(a).max())
            check(err <= tol, f"phase 20 {what}: {err} from one part")
            rec[f"{what}_rel_err"] = float(err)

        def launched(keys, fn, what, each):
            _, got = counted(keys, fn)
            check(all(got[k_] == each for k_ in keys),
                  f"phase 20 {what}: launches {got}, not {each} each")
            add_launches(got)
            rec[f"{what}_launches"] = got

        # (a) enqueue between four parts and one part
        x1, xP = both(hx)
        st5 = vex.stencil(np.linspace(0.1, 0.5, 5).astype(np.float32) / 1.5,
                          center=2)
        img = rng.random((IMG_GRID, IMG_GRID), dtype=np.float32)
        im = vex.image2d(img, filter="linear", context=ctx)
        cx1, cxP = both(rng.random(N_VEC, dtype=np.float32)
                        * (IMG_GRID - 1))
        cy1, cyP = both(rng.random(N_VEC, dtype=np.float32)
                        * (IMG_GRID - 1))
        fft = vex.FFT(N_VEC, dtype=torch.complex64)
        z1, zP = both(hx + 1j * rng.random(N_VEC, dtype=np.float32),
                      torch.complex64)
        values = {
            "expr": (("expr",), torch.float32,
                     lambda x, z, cx, cy: 2 * x + vex.sin(x)),
            "stencil": (("stencil",), torch.float32,
                        lambda x, z, cx, cy: x * st5),
            "fft": (("cufft",), torch.complex64,
                    lambda x, z, cx, cy: fft(z)),
            "image": (("image",), torch.float32,
                      lambda x, z, cx, cy: im(cx, cy)),
        }
        one_in, parts_in = (x1, z1, cx1, cy1), (xP, zP, cxP, cyP)
        for name, (keys, dt, value) in values.items():
            y1 = vex.vector(N_VEC, dtype=dt, context=ctx)
            y1[:] = value(*one_in)
            copies = halo.replicate.copies
            # four parts onto one: the vector migrates to the one part
            yP = vex.vector(N_VEC, dtype=dt, context=ctxP)
            launched(keys, lambda: vex.enqueue(ctx)(yP).assign(
                value(*parts_in)), f"a_{name}_to_one", 1)
            check(yP.nparts == 1 and yP.context is ctx,
                  f"phase 20 {name}: the vector did not migrate")
            same_bits(y1, yP, f"a_{name}_to_one")
            # one part onto four
            y4 = vex.vector(N_VEC, dtype=dt, context=ctx)
            _, got = counted(keys, lambda: vex.enqueue(ctxP)(y4).assign(
                value(*one_in)))
            rec[f"a_{name}_to_parts_launches"] = got
            check(y4.nparts == PARTS, f"phase 20 {name}: {y4.nparts} parts")
            same_bits(y1, y4, f"a_{name}_to_parts",
                      FFT_PART_TOL if name == "fft" else None)
            # the tables lie on the card already: nothing copied
            rec[f"a_{name}_table_copies"] = halo.replicate.copies - copies
            check(halo.replicate.copies - copies == 0,
                  f"phase 20 {name}: tables copied on one device")
            yo = vex.vector(N_VEC, dtype=dt, context=ctx)
            yp = vex.vector(N_VEC, dtype=dt, context=ctxP)
            timed[f"a_{name}"] = (
                lambda y1=y1, v=value: y1.assign(v(*one_in)),
                lambda yo=yo, v=value: vex.enqueue(ctx)(yo).assign(
                    v(*parts_in)))
            timed[f"a_{name}_onto_parts"] = (
                lambda y1=y1, v=value: y1.assign(v(*one_in)),
                lambda yp=yp, v=value: vex.enqueue(ctxP)(yp).assign(
                    v(*one_in)))
            del y4

        # (b) user kernels: a launch a part
        user_triton = triton_module(USER_TRITON).axpy
        v1, vP = both(rng.random(N_VEC, dtype=np.float32))
        kc = vex.CustomKernel(USER_CUDA, name="triple")
        kt = vex.CustomKernel(user_triton, BLOCK=1024)
        kh = vex.CustomKernel(HALO3)
        outs = {}
        for name, k_, args_ in (
                ("cuda", kc, lambda c: (c,)),
                ("triton", kt, lambda c: (c, v1 if c is x1 else vP)),
                ("halo", kh, lambda c: (c, halo.with_halo(c, 1, 1)))):
            one = k_(*args_(x1))
            box = []
            launched(("custom",), lambda: box.append(k_(*args_(xP))),
                     f"b_{name}", PARTS)
            same_bits(one, box[0], f"b_{name}")
            outs[name] = one
            timed[f"b_{name}"] = (lambda k_=k_, a_=args_: k_(*a_(x1)),
                                  lambda k_=k_, a_=args_: k_(*a_(xP)))
        hp = np.pad(hx, 1, mode="edge")
        check(np.allclose(outs["halo"].to_numpy(), hp[:-2] + hp[1:-1]
                          + hp[2:], rtol=1e-6, atol=1e-6),
              "phase 20 halo kernel against numpy")
        del outs, hp
        # (c) the Lorenz step's functional form, one K1 launch a part
        for dname, npdt in (("f32", np.float32), ("f64", np.float64)):
            ens = LorenzEnsemble(LORENZ_N, dtype=npdt, context=ctx,
                                 seed=args.seed)
            fn = ens._step.as_function()
            st1 = [ens.x, ens.y, ens.z, ens.R]
            stP = [vex.vector(data=v.storage, context=ctxP) for v in st1]
            one = fn(*st1)
            box = []
            launched(("multi",), lambda: box.append(fn(*stP)),
                     f"c_lorenz_{dname}", PARTS)
            for a_, b_ in zip(one, box[0]):
                same_bits(a_, b_, f"c_lorenz_{dname}")
            timed[f"c_lorenz_{dname}"] = (lambda st1=st1, fn=fn: fn(*st1),
                                          lambda stP=stP, fn=fn: fn(*stP))
            del ens, one, box
        # (d) reinterpret and resize over unequal parts (2^24 + 6)
        hodd = rng.standard_normal(N_VEC + 6).astype(np.float32)
        o1, oP = both(hodd)
        rec["d_points"] = [int(p_) for p_ in oP.partition()]
        for dname, dt in (("u16", torch.uint16), ("f64", torch.float64)):
            a_, b_ = o1.reinterpret(dt), oP.reinterpret(dt)
            check(np.array_equal(b_.partition(),
                                 vex.partition(b_.size, ctxP)),
                  f"phase 20 reinterpret {dname}: not split at its points")
            if dt == torch.uint16:      # numpy reads no torch.uint16
                a_, b_ = (v.reinterpret(torch.int16) for v in (a_, b_))
            same_bits(a_, b_, f"d_reinterpret_{dname}")
            back = b_.reinterpret(torch.float32)
            same_bits(o1, back, f"d_reinterpret_{dname}_back")
            timed[f"d_reinterpret_{dname}"] = (
                lambda dt=dt: o1.reinterpret(dt),
                lambda dt=dt: oP.reinterpret(dt))
        for size in (N_VEC + 1000, N_VEC - 1000):
            r1, rP = both(hodd)
            r1.resize(size, fill=2.0)
            rP.resize(size, fill=2.0)
            same_bits(r1, rP, f"d_resize_{size}")
        timed["d_resize"] = (
            lambda: vex.vector(data=o1.storage, context=ctx).resize(
                N_VEC + 1000),
            lambda: oP.copy().resize(N_VEC + 1000))
        # (e) a scan with a custom op over the parts
        hyp = lambda p_, q_: torch.sqrt(p_ * p_ + q_ * q_)  # noqa: E731
        s1 = vex.inclusive_scan(x1, op=hyp)
        sP = vex.inclusive_scan(xP, op=hyp)
        same_bits(s1, sP, "e_custom_scan", PART_SCAN_TOL)
        timed["e_custom_scan"] = (lambda: vex.inclusive_scan(x1, op=hyp),
                                  lambda: vex.inclusive_scan(xP, op=hyp))
        del s1, sP
        # (f) a one-part CSR matrix times four parts of x
        ptr_r, col_r, val_r, _ = random_lognormal_csr(RANDOM_N,
                                                      seed=args.seed)
        S1 = vex.SpMat(RANDOM_N, RANDOM_N, ptr_r, col_r, val_r, context=ctx)
        check(S1.device.format == "csr", f"phase 20: {S1.device.format}")
        hr = rng.random(RANDOM_N, dtype=np.float32)
        r1, rP = both(hr)
        y1, yP = both(None, torch.float32, RANDOM_N)
        y1[:] = S1 * r1
        launched(("csr",), lambda: yP.assign(S1 * rP), "f_spmv", 1)
        same_bits(y1, yP, "f_spmv")
        timed["f_spmv"] = (lambda: y1.assign(S1 * r1),
                           lambda: yP.assign(S1 * rP))
        # (g) the dry run over four parts of the card at 2^24
        t = time.perf_counter()
        launched(("custom",), lambda: dryrun_multichip(
            PARTS, n=N_VEC, seed=args.seed), "g_dryrun", PARTS)
        rec["g_dryrun_s"] = time.perf_counter() - t
        # (h) the default context: every card, one part each
        dflt = vex.Context(set_current=False)
        print(f"phase 20 Context(): {dflt!r}".replace("\n", "; "))
        check(dflt.size == torch.cuda.device_count(),
              f"phase 20: Context() has {dflt.size} parts")
        rec["h_context_parts"] = dflt.size
        # one part against four in turns (events ms), host µs a call,
        # device µs by kernel
        for name, (one, parts) in timed.items():
            got = {"one": [], "parts": []}
            for r_ in range(3):
                for who in (("one", "parts") if r_ % 2 == 0
                            else ("parts", "one")):
                    got[who].append(cuda_ms(one if who == "one" else parts,
                                            RUNTIME_PART_REPS))
            rec[f"{name}_ms"] = {k_: statistics.median(v)
                                 for k_, v in got.items()}
            rec[f"{name}_host_us"] = {
                "one": host_us(one, RUNTIME_PART_REPS),
                "parts": host_us(parts, RUNTIME_PART_REPS)}
            rec[f"{name}_device_us"] = {
                "one": profile_call(one, RUNTIME_PART_REPS)[0],
                "parts": profile_call(parts, RUNTIME_PART_REPS)[0]}
        del timed
        torch.cuda.empty_cache()
        rec["s"] = time.perf_counter() - t20
        report("runtime_over_parts", rec)

    runtime_parts_phase()

    # -- phase 21: gradients through views and partial reductions, and the
    # port's examples -------------------------------------------------------
    def view_gradients_phase():
        """Phase 21, in a scope of its own: the gradient of sum(w f(u))
        through ``as_function`` where f reads a view or a partial
        reduction, each backward step's launches by kernel, held against
        the same stages' plain versions and PyTorch's autograd over the
        forward's plain forms, the forward and the backward timed by
        events; then the port's examples at the tier-1 test's sizes."""
        t21 = time.perf_counter()
        rec = {}
        stage_keys = ("multi", "indexed", "expr", "to_view",
                      "scatter_ranges", "scatter_privatized", "reduce_view",
                      "reduce_multi", "backward")

        def kernel_of(body):
            param, out = tgen.symbolic(), tgen.symbolic()
            out[:] = body(param)
            return tgen.build_kernel("view_grad", [out], [param])

        from vexcl_tpu_torch.expr.compile import evaluate_multi
        from vexcl_tpu_torch.expr.node import ArrayTerminal

        def grad_case(tag, kern, u, w, tol, nbytes, library=None):
            """The backward step of one case: (its row, its launches).
            The step, the plain stages and the library call are timed in
            turns (TURNS timings of STEP_REPS steps), beside the K1 copy
            of the gradient that ``Kernel._hoisted`` saves (the stage's
            tensor is returned as the output)."""
            fn = kern.as_function()
            ui = u.clone().requires_grad_()
            (y,) = fn(ui)

            def step():
                return torch.autograd.grad(y, ui, w, retain_graph=True)[0]

            step()
            got, _ = counted((), step)
            launches = {k: counters[k].launches for k in stage_keys
                        if counters[k].launches}
            # the same stages' plain versions, and PyTorch's autograd over
            # the forward's plain forms
            bk = kern.backward_kernel([u], [w], [True])
            with torch.no_grad():
                (plain,) = bk.plain(u, w)
            ur = u.clone().requires_grad_()
            (yp,) = kern.plain(ur)
            (auto,) = torch.autograd.grad(yp, ur, w, retain_graph=True)
            abs_p, rel_p = errors(got, plain)
            _, rel_a = errors(got, auto)
            if tol == 0:
                check(torch.equal(got, plain), f"{tag}: the gradient "
                      f"differs from its plain stages' (abs {abs_p})")
            else:
                check(rel_p <= tol, f"{tag}: rel err {rel_p} against the "
                      "plain stages")
            dname = "f64" if u.dtype == torch.float64 else "f32"
            check(rel_a <= GRAD_TOL[dname], f"{tag}: rel err {rel_a} "
                  "against autograd over the plain forms")
            fns = {"step": step, "plain": lambda: bk.plain(u, w),
                   "k1_copy": lambda: evaluate_multi(
                       [ArrayTerminal(got)], n=got.numel(), device=dev)}
            if library is not None:
                _, rel_l = errors(library(), got)
                check(rel_l <= tol, f"{tag}: the library call's gradient "
                      f"differs (rel {rel_l})")
                fns["library"] = library
            turns = in_turns(fns, STEP_REPS)
            row = kernel_row(abs_p, turns["step"]["ms"],
                             turns["plain"]["ms"], nbytes, 0,
                             turns.get("library", {}).get("ms"))
            row.update({f"{k}_ms_range" if k != "step" else "ms_range":
                        t["ms_range"] for k, t in turns.items()},
                       k1_copy_ms=turns["k1_copy"]["ms"])
            per_kernel, busy = profile_call(step, 10)
            row.update(forward_ms=cuda_ms(lambda: fn(u)),
                       step_launches=launches,
                       device_us=sum(per_kernel.values()),
                       device_us_by_kernel=per_kernel, busy=busy,
                       host_us=host_us(step, 50),
                       rel_err_plain=rel_p, rel_err_autograd=rel_a,
                       autograd_plain_ms=cuda_ms(lambda: torch.autograd.grad(
                           yp, ur, w, retain_graph=True)))
            report(f"view_grad_{tag}", row)
            del y, yp, got, plain, auto
            return row, launches

        scatters = ("scatter_ranges", "scatter_privatized", "to_view")
        perm_rows = {}
        for dname, dt in (("f32", torch.float32), ("f64", torch.float64)):
            n = N_VEC
            u, c, w = (torch.rand(n, generator=gen, device=dev, dtype=dt)
                       for _ in range(3))
            cv = vex.vector(data=c, context=ctx)
            item = torch.tensor([], dtype=dt).element_size()
            for form, idx in (
                    ("permutation", torch.randperm(n, generator=gen,
                                                   device=dev)),
                    ("duplicates", torch.randint(
                        -n - n // 16, n + n // 16, (n,), generator=gen,
                        device=dev))):
                idx = idx.to(torch.int32)
                pv = vex.vector(data=idx, context=ctx)
                kern = kernel_of(lambda p_: vex.permutation(pv)(p_ + cv)
                                 * 2.0)
                lib = None
                if form == "permutation":
                    lib = lambda: torch.zeros_like(u).index_add_(  # noqa
                        0, idx, w, alpha=2.0)
                row, got = grad_case(
                    f"{form}_{dname}", kern, u, w,
                    0 if form == "permutation" else SUM_TOL[dname],
                    n * (2 * item + 4), lib)
                check(any(got.get(k) for k in scatters) and got.get("multi"),
                      f"{form} {dname}: no scatter or K1 launch: {got}")
                add_launches({"vb_permutation": sum(
                    got.get(k, 0) for k in scatters)})
                perm_rows[(form, dname)] = row
            del u, c, w, cv, pv, idx, kern
            torch.cuda.empty_cache()
        kernels["vb_permutation"] = dict(
            perm_rows[("permutation", "f32")],
            route="cuda" if any(perm_rows[("permutation", "f32")][
                "step_launches"].get(k) for k in scatters[:2])
            else "triton",
            others={f"{f}_{d}": r for (f, d), r in perm_rows.items()
                    if (f, d) != ("permutation", "f32")},
            workload="the gradient of sum(w (permutation(p)(u + c) * 2)) "
            "in u, 2^24 f32, p a random permutation (one K1 launch for "
            "2w, the scatter's add into zeros)")

        g = VIEW_GRID
        n = g * g
        u, c = (torch.rand(n, generator=gen, device=dev) for _ in range(2))
        cv = vex.vector(data=c, context=ctx)
        grid = vex.slicer([g, g])
        cases = {
            "slice": (lambda p_: grid[:, 1:g - 1](p_ + cv), g * (g - 2),
                      4 * (g * (g - 2) + n), ("to_view",)),
            "reduce_sum": (lambda p_: vex.reduce_view(
                "sum", grid[:, :](p_ + cv), 1), g, 4 * (g + n),
                ("to_view",)),
            "reduce_max": (lambda p_: vex.reduce_view(
                "max", grid[:, :](p_ + cv), 1), g, 4 * (g + 3 * n),
                ("to_view", "reduce_view", "multi")),
        }
        # one PyTorch call that gives the same gradient, where there is
        # one: the slice's cotangent padded by the two edge columns, the
        # row sum's spread along each row
        libraries = {
            "slice": lambda w: lambda: torch.nn.functional.pad(
                w.view(g, g - 2), (1, 1)).view(-1),
            "reduce_sum": lambda w: lambda: w.repeat_interleave(g),
        }
        for tag, (body, m, nbytes, must) in cases.items():
            w = torch.rand(m, generator=gen, device=dev)
            lib = libraries[tag](w) if tag in libraries else None
            row, got = grad_case(tag, kernel_of(body), u, w,
                                 0 if tag != "reduce_max" else TOL["f32"],
                                 nbytes, lib)
            check(all(got.get(k) for k in must),
                  f"{tag}: the backward did not launch {must}: {got}")
            add_launches({f"vb_{tag}": sum(got.get(k, 0) for k in must)})
            kernels[f"vb_{tag}"] = dict(row, workload={
                "slice": "the gradient of sum(w slicer[:, 1:4095](u + c)) "
                         "in u, a 4096^2 f32 grid (V3 stores into zeros)",
                "reduce_sum": "the gradient of sum(w reduce_view(sum, "
                              "slicer[:, :](u + c), 1)) in u, 4096^2 f32 "
                              "(the cotangent spread along the rows by "
                              "V3's stores)",
                "reduce_max": "the same with max: V2 for the maxima and "
                              "for the ties' counts, K1 for w / count, V3 "
                              "for the spread"}[tag])
            del w
        del u, c, cv
        torch.cuda.empty_cache()
        rec["view_gradients_s"] = time.perf_counter() - t21

        # the port's examples at the tier-1 test's sizes, on the cards
        import contextlib
        import importlib.util
        import io
        import runpy

        from vexcl_tpu_torch import context as tcontext

        spec = importlib.util.spec_from_file_location(
            "example_cases", os.path.join(HERE, "tests",
                                          "test_torch_examples.py"))
        cases_mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cases_mod)
        keep = (list(sys.argv), list(sys.path), tcontext._current_context)
        times, outputs = {}, {}
        try:
            for name, (argv, lines) in sorted(cases_mod.CASES.items()):
                path = os.path.join(HERE, "examples", "torch", name + ".py")
                sys.argv = [path, *argv]
                out = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    runpy.run_path(path, run_name="__main__")
                torch.cuda.synchronize()
                times[name] = time.perf_counter() - t
                text = out.getvalue()
                missing = [ln for ln in lines if ln not in text]
                check(not missing, f"example {name} did not print "
                      f"{missing}:\n{text[-2000:]}")
                outputs[name] = text
                print(f"example {name}: {times[name]:.2f} s, "
                      + " | ".join(ln.strip() for ln in text.splitlines()
                                   if " on " in ln and ("/s" in ln
                                                        or "ms" in ln))[:600])
        finally:
            sys.argv, sys.path, tcontext._current_context = keep
            tcontext.release_exclusive_locks()
        check("jax" not in sys.modules and "vexcl_tpu" not in sys.modules,
              "an example imported jax or vexcl_tpu")
        rec["examples_s"] = times
        rec["s"] = time.perf_counter() - t21
        report("view_gradients_examples", rec)
        results["example_output"] = outputs     # with --json

    view_gradients_phase()

    # last, after every solver phase, so that no solver's ms per iteration
    # (compared between versions of this script) follows these timings'
    # profiler session or cuSPARSE call: the
    # map-reduce's device time per call, and the DIA row's library call,
    # cuSPARSE's CSR product of the Poisson matrix with f32 values (the
    # DIA kernel reads bf16 planes) on phase 3's x
    per_kernel, _ = profile_call(sum_pap, KERNEL_REPS)
    kernels["reduce"]["device_us"] = sum(
        v for name, v in per_kernel.items() if "reduce_kernel" in name)
    check(kernels["reduce"]["device_us"] > 0,
          "the profiler saw no map-reduce kernel")
    report("reduce_sum_pAp_256^3_f32", {
        "kernel": pap_k, "plain": p_, "profile": per_kernel,
        **{key: kernels["reduce"][key] for key in (
            "ms", "ms_range", "library_ms", "library_ms_range", "device_us",
            "host_us", "library_host_us")}})
    del pv, Apv, pap
    # the redesigned rows' device time per call: the compaction (one and
    # two payloads) and the irregular SpMV's three products, f32 and f64
    prof = {}
    for name, fn in compact_calls.items():
        per_kernel, _ = profile_call(fn, KERNEL_REPS)
        prof[name] = sum(per_kernel.values())
        if name == "compact":
            check(any("compact_kernel" in k_ for k_ in per_kernel)
                  and len(per_kernel) == 1,
                  f"a compaction is not one kernel: {per_kernel}")
    for dname, calls in spmv_timed.items():
        for name, fn in calls.items():
            per_kernel, _ = profile_call(fn, KERNEL_REPS)
            prof[f"{name}_{dname}"] = sum(per_kernel.values())
    kernels["compact"].update(device_us=prof["compact"],
                              library_device_us=prof["library"],
                              two_payload_device_us=prof["compact_two"])
    kernels["sell"].update(device_us=prof["sell_spmv_f32"],
                           library_device_us=prof["cusparse_sell_part_f32"])
    kernels["csr"].update(device_us=prof["csr_spmv_f32"],
                          library_device_us=prof["cusparse_f32"])
    # the scans and the keyed kernel: one kernel a call (cumsum is the
    # library's own; a route is the tensor code and kernels it replaced)
    one_kernel = {"scan_f32": "scan_kernel", "scan_f64": "scan_kernel",
                  "segscan": "scan_kernel", "scan_by_key": "by_key_kernel",
                  "scan_by_key_excl_init": "by_key_kernel",
                  "reduce_by_key": "by_key_kernel"}
    for name, fn in scan_calls.items():
        per_kernel, _ = profile_call(fn, KERNEL_REPS)
        prof[name] = sum(per_kernel.values())
        if name in one_kernel:
            check(len(per_kernel) == 1
                  and any(one_kernel[name] in k_ for k_ in per_kernel),
                  f"a {name} call is not one kernel: {per_kernel}")
    kernels["scan"].update(device_us=prof["scan_f32"],
                           library_device_us=prof["cumsum_f32"])
    kernels["segscan"].update(device_us=prof["segscan"])
    kernels["scan_by_key"].update(
        device_us=prof["scan_by_key"],
        route_device_us=prof["scan_by_key_route"],
        exclusive_init_device_us=prof["scan_by_key_excl_init"],
        exclusive_init_route_device_us=prof["scan_by_key_excl_init_route"])
    kernels["reduce_by_key"].update(
        device_us=prof["reduce_by_key"],
        route_device_us=prof["reduce_by_key_route"])
    check(all(v > 0 for v in prof.values()),
          f"the profiler saw no kernel of a call: {prof}")
    report("profile_device_us_per_call", prof)
    del compact_calls, spmv_timed, tails, tails_b, incl, scan_calls
    torch.cuda.empty_cache()
    ptr, col, val = poisson_7pt(POISSON_N, dtype=np.float32)
    lib_dia = torch.sparse_csr_tensor(
        torch.from_numpy(ptr).to(dev, torch.int32),
        torch.from_numpy(col).to(dev, torch.int32),
        torch.from_numpy(val).to(dev), size=(nrows, nrows),
        check_invariants=False)
    del ptr, col, val
    _, lib_rel = errors(lib_dia @ dia_xy[0], dia_xy[1])
    check(lib_rel <= SPMV_TOL["f32"], f"cuSPARSE Poisson: rel err {lib_rel}")
    kernels["dia"]["library_ms"] = cuda_ms(lambda: lib_dia @ dia_xy[0],
                                           KERNEL_REPS)
    # the halo'd form computes the same product over four parts
    kernels["dia_halo"]["library_ms"] = cuda_ms(lambda: lib_dia @ halo_x,
                                                KERNEL_REPS)
    report("spmv_poisson256_cusparse_f32", {
        "ms": kernels["dia"]["library_ms"], "max_rel_err_vs_dia": lib_rel})
    del lib_dia, dia_xy
    torch.cuda.empty_cache()

    rows = [
        ("expression_assign", "triton", "vexcl_tpu_torch/expr/triton_emit.py",
         "vexcl_tpu/expr/compile.py:244", "expr"),
        ("map_reduce", "triton", "vexcl_tpu_torch/ops/triton_reduce.py",
         "vexcl_tpu/ops/pallas_reduce.py:34", "reduce"),
        ("dia_spmv", "cuda", "vexcl_tpu_torch/csrc/dia_spmv.cu",
         "vexcl_tpu/sparse/pallas_dia.py:51", "dia"),
        ("stencil_1d", "cuda", "vexcl_tpu_torch/csrc/stencil.cu",
         "vexcl_tpu/ops/pallas_stencil.py:59", "stencil"),
        ("sell_spmv", "cuda", "vexcl_tpu_torch/csrc/spmv_sell.cu",
         "vexcl_tpu/sparse/shuffle.py:252", "sell"),
        ("csr_spmv", "cuda", "vexcl_tpu_torch/csrc/spmv_sell.cu",
         "vexcl_tpu/sparse/shuffle.py:807", "csr"),
        ("scan", "cuda", "vexcl_tpu_torch/csrc/scan.cu",
         "vexcl_tpu/ops/pallas_scan.py:70, "
         "vexcl_tpu/ops/pallas_monoid_scan.py:27", "scan"),
        ("segscan", "cuda", "vexcl_tpu_torch/csrc/scan.cu",
         "vexcl_tpu/ops/pallas_segscan.py:53", "segscan"),
        ("compact", "cuda", "vexcl_tpu_torch/csrc/compact.cu",
         "vexcl_tpu/ops/pallas_compact.py:72", "compact"),
        ("reduce_by_key", "cuda", "vexcl_tpu_torch/csrc/by_key.cuh",
         "vexcl_tpu/ops/pallas_rbk.py:50", "reduce_by_key"),
        ("scan_by_key", "cuda", "vexcl_tpu_torch/csrc/by_key.cuh",
         "vexcl_tpu/ops/pallas_segscan.py:53, "
         "vexcl_tpu/ops/scan_by_key.py:62-125", "scan_by_key"),
        ("philox_bits", "cuda", "vexcl_tpu_torch/csrc/philox.cu",
         "vexcl_tpu/ops/random.py:141", "philox"),
        ("custom_kernel", "cuda", "vexcl_tpu_torch/backend.py",
         "vexcl_tpu/backend.py:34", "custom"),
        ("assign_multi", "triton", "vexcl_tpu_torch/expr/triton_emit.py",
         "vexcl_tpu/expr/compile.py:519", "multi"),
        ("map_reduce_multi", "triton", "vexcl_tpu_torch/ops/triton_reduce.py",
         "vexcl_tpu/ops/reductor.py:69", "reduce_multi"),
        ("assign_indexed", "triton", "vexcl_tpu_torch/expr/triton_emit.py",
         "vexcl_tpu/expr/view.py:174-224, vexcl_tpu/expr/view.py:286-337, "
         "vexcl_tpu/expr/pointer.py:32-35", "indexed"),
        ("reduce_view", "triton", "vexcl_tpu_torch/ops/triton_reduce_view.py",
         "vexcl_tpu/expr/view.py:381-384", "reduce_view"),
        ("assign_to_view", "triton", "vexcl_tpu_torch/expr/triton_emit.py",
         "vexcl_tpu/expr/view.py:66-100, vexcl_tpu/ops/atomic.py:57-124",
         "to_view"),
        ("scatter_ranges", "cuda", "vexcl_tpu_torch/csrc/scatter.cu",
         "vexcl_tpu/expr/view.py:66-100, vexcl_tpu/ops/atomic.py:57-124",
         "scatter_ranges"),
        ("scatter_privatized", "cuda", "vexcl_tpu_torch/csrc/scatter.cu",
         "vexcl_tpu/ops/atomic.py:57-124", "scatter_privatized"),
        ("gather_ranges", "cuda", "vexcl_tpu_torch/csrc/gather.cu",
         "vexcl_tpu/expr/view.py:283-286", "gather_ranges"),
        ("assign_complex", "triton", "vexcl_tpu_torch/expr/triton_emit.py",
         "vexcl_tpu/expr/compile.py:244, vexcl_tpu/expr/compile.py:519",
         "complex"),
        ("map_reduce_complex", "triton",
         "vexcl_tpu_torch/ops/triton_reduce.py",
         "vexcl_tpu/ops/reductor.py:69-97", "reduce_complex"),
        ("mba_tap_gather", "triton", "vexcl_tpu_torch/expr/triton_emit.py",
         "vexcl_tpu/ops/mba.py:164-208", "mba_tree"),
        ("mba_cuda", "cuda", "vexcl_tpu_torch/csrc/mba.cu",
         "vexcl_tpu/ops/mba.py:164-208", "mba"),
        ("mba_taps", "cuda", "vexcl_tpu_torch/csrc/mba.cu",
         "vexcl_tpu/ops/mba.py:164-208", "mba_taps"),
        ("mba_cluster", "cuda", "vexcl_tpu_torch/csrc/mba.cu",
         "vexcl_tpu/ops/mba.py:164-208", "mba_cluster_kernel"),
        ("builtin_select", "triton", "vexcl_tpu_torch/expr/triton_emit.py",
         "vexcl_tpu/expr/builtins.py:293", "builtins"),
        ("integer_pow", "triton", "vexcl_tpu_torch/expr/triton_emit.py",
         "vexcl_tpu/expr/node.py:356", "ipow"),
        ("advanced_index", "triton", "vexcl_tpu_torch/expr/view.py",
         "vexcl_tpu/expr/view.py:217-224", "advanced_index"),
        ("image_sample_patch", "triton", "vexcl_tpu_torch/ops/image.py",
         "vexcl_tpu/ops/image.py:47-89", "image"),
        ("gather_coords", "cuda", "vexcl_tpu_torch/csrc/gather.cu",
         "vexcl_tpu/ops/image.py:57-60, vexcl_tpu/expr/view.py:217-224",
         "gather_coords"),
        ("generator_backward", "triton",
         "vexcl_tpu_torch/expr/adjoint.py, "
         "vexcl_tpu_torch/expr/triton_emit.py",
         "none (XLA autodiff of vexcl_tpu/generator.py:175-206)", "backward"),
        ("dia_spmv_halo", "cuda", "vexcl_tpu_torch/csrc/dia_spmv.cu",
         "vexcl_tpu/sparse/pallas_dia.py:147, "
         "vexcl_tpu/sparse/pallas_dia.py:305 (prepadded)", "dia_halo"),
        ("view_backward_permutation", "cuda",
         "vexcl_tpu_torch/expr/adjoint.py, vexcl_tpu_torch/csrc/scatter.cu",
         "none (XLA's transpose of jnp.take in jax.grad through "
         "vexcl_tpu/generator.py:175-206)", "vb_permutation"),
        ("view_backward_slice", "triton",
         "vexcl_tpu_torch/expr/adjoint.py, "
         "vexcl_tpu_torch/expr/triton_emit.py",
         "none (XLA's transpose of a slice in jax.grad through "
         "vexcl_tpu/generator.py:175-206)", "vb_slice"),
        ("view_backward_reduce_sum", "triton",
         "vexcl_tpu_torch/expr/adjoint.py, "
         "vexcl_tpu_torch/expr/triton_emit.py",
         "none (XLA's transpose of jnp.sum, vexcl_tpu/expr/view.py:357)",
         "vb_reduce_sum"),
        ("view_backward_reduce_max", "triton",
         "vexcl_tpu_torch/expr/adjoint.py, "
         "vexcl_tpu_torch/ops/triton_reduce_view.py, "
         "vexcl_tpu_torch/expr/triton_emit.py",
         "none (XLA's chooser rule of jnp.max, vexcl_tpu/expr/view.py:359)",
         "vb_reduce_max"),
    ]
    # the cluster kernel's launches: its band and cluster forms
    main_launches["mba_cluster_kernel"] = (
        main_launches.get("mba_band", 0) + main_launches.get("mba_cluster", 0))
    check("jax" not in sys.modules and "vexcl_tpu" not in sys.modules,
          "the port imported jax or vexcl_tpu")
    line = {"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": main_launches[key], **kernels[key]}
        for name, route, src, rep, key in rows]}
    results["kernels"] = line["kernels"]
    results["total_s"] = time.perf_counter() - start_s
    results["profile_lost_records"] = PROFILE_LOST
    print(f"profiler: {len(PROFILE_LOST)} traces; lead-in records lost "
          f"a trace: first {PROFILE_LOST[:1]}, most "
          f"{max(PROFILE_LOST, default=0)}, last {PROFILE_LOST[-1:]}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(results, fh, indent=1)
    print(f"total: {results['total_s']:.1f} s")
    print(smi_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
