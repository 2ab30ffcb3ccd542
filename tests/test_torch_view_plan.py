"""The schedules of the views' two redesigned kernels, on the CPU.

V2 (``ops/triton_reduce_view.py``): the plan splits the reduced range
into chunks; every reduced index must be folded by exactly one lane of
one program, and every partial combined exactly once.  V1's tiled form
(``expr/triton_emit.py``): chosen by the tree's structure alone, for
exactly the trees whose view reads with coefficient 1 on an axis before
its innermost one.  Every generated source of both kernels must be
Python that parses (the kernels themselves build and run only on the
card: ``tests/test_torch_cuda_views.py``).
"""

import ast
import itertools

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vt
from vexcl_tpu_torch.expr.compile import prepare
from vexcl_tpu_torch.expr.triton_emit import (ASSIGN_TILE,
                                              assign_tiled_source,
                                              tiled_programs, tiled_view)
from vexcl_tpu_torch.ops.triton_reduce_view import (ROW_STEP_BYTES,
                                                    STEP_BYTES, _layout,
                                                    plan,
                                                    prepare_reduce_view,
                                                    reduce_view_source)
from vexcl_tpu_torch.types import code_of

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _covered(pl, nred):
    """The reduced indices each lane column of each split reaches, as the
    kernel's loop walks them: ``rstart`` from the chunk's start by
    ``RT * UNROLL``, lane ``rl`` of unrolled step u at rstart + u*RT + rl,
    masked at the chunk's end."""
    seen = np.zeros(nred, dtype=np.int64)
    step = pl.rt * pl.unroll
    for s in range(pl.nsplit):
        beg, end = s * pl.chunk, min((s + 1) * pl.chunk, nred)
        for rstart in range(beg, end, step):
            for u in range(pl.unroll):
                rv = rstart + u * pl.rt + np.arange(pl.rt)
                seen[rv[rv < end]] += 1
    return seen


_COUNTS = [1, 2, 3, 31, 33, 127, 1000, 4095, 4096, 20000]


@pytest.mark.parametrize("r_fast", [False, True])
@pytest.mark.parametrize("itemsize", [1, 4, 8])
@pytest.mark.parametrize("programs", [8, 528])
def test_split_plan_covers_every_reduced_index_once(r_fast, itemsize,
                                                   programs):
    for n_out, nred in itertools.product(_COUNTS, _COUNTS):
        pl = plan(n_out, nred, r_fast, itemsize, programs)
        assert pl == plan(n_out, nred, r_fast, itemsize, programs)
        block = pl.ot * pl.rt
        assert block & (block - 1) == 0
        assert block * pl.unroll * max(4, itemsize) <= (
            ROW_STEP_BYTES if r_fast else STEP_BYTES)
        assert (pl.tiles - 1) * pl.ot < n_out <= pl.tiles * pl.ot
        assert pl.chunk % (pl.rt * pl.unroll) == 0
        # every split holds reduced indices; none past the range
        assert (pl.nsplit - 1) * pl.chunk < nred <= pl.nsplit * pl.chunk
        assert 1 <= pl.nsplit <= 65535
        np.testing.assert_array_equal(_covered(pl, nred), 1)
        # the last program of a tile folds each split's partial once
        seen = np.zeros(pl.nsplit, dtype=np.int64)
        for s0 in range(0, pl.nsplit, pl.rt):
            sv = s0 + np.arange(pl.rt)
            seen[sv[sv < pl.nsplit]] += 1
        np.testing.assert_array_equal(seen, 1)
        # a grid of fewer tiles than programs is split while steps allow
        if pl.tiles < programs and pl.nsplit == 1:
            assert nred <= pl.rt * pl.unroll


def test_split_plan_of_the_grids():
    """The column reduction of the 4096^2 grid fills 132 SMs x 4; a row
    reduction is not split; a warp of a column tile reads 128 bytes; a
    multi_array's row sums take several rows a program."""
    col = plan(4096, 4096, False, 4, 528)
    assert (col.ot, col.tiles, col.nsplit, col.chunk) == (32, 128, 5, 896)
    assert col.tiles * col.nsplit >= 528
    assert col.ot * 4 >= 128
    row = plan(4096, 4096, True, 8, 528)
    assert (row.ot, row.rt, row.nsplit) == (1, 1024, 1)
    assert plan(1, 20000, False, 4, 528).nsplit == 5
    # rows shorter than the budget: a warp's 32 lanes a row
    multi = plan(256 * 256, 256, True, 8, 528)
    assert (multi.ot, multi.rt, multi.nsplit) == (32, 32, 1)


def _reduce_nodes(x):
    g = 8
    yield vt.reduce_view("sum", vt.slicer((g, g))[:, :](x), 0)
    yield vt.reduce_view("max", vt.slicer((g, g))[:, :](x), 1)
    yield vt.reduce_view("min", vt.slicer((4, 4, 4))[:, :, :](x), (0, 2))
    yield vt.reduce_view("prod", vt.slicer((4, 4, 4))[:, :, :](x), (1,))
    yield vt.reduce_view("sum", vt.slicer((4, 4, 4))[:, :, :](x), (0, 1, 2))
    yield vt.reduce_view("sum", vt.reshape(x, (g, g), (1, 0)), 1)
    yield vt.reduce_view("max", 2 * x, 0)
    yield vt.reduce_view("sum", vt.slicer((g, g))[1:7, ::2](x), 0)


@pytest.mark.parametrize("dt", [np.float32, np.float64, np.int32, np.bool_])
def test_reduce_view_sources_parse(tctx, dt):
    x = vt.vector(data=(np.arange(64) % 3).astype(dt), context=tctx)
    for node in _reduce_nodes(x):
        inner, an, ty, _, op, shape, axes, out = prepare_reduce_view(node,
                                                                     CPU)
        pattern = _layout(shape, axes)[-1]
        for unroll in (1, 2, 4):
            src = reduce_view_source(inner, an, ty, op, pattern, unroll,
                                     code_of(out.dtype))
            ast.parse(src)
            assert "def reduce_view_kernel(" in src
            assert "tl.atomic_add(ticket_ptr" in src
        if isinstance(inner, vt.MultiSliceView):
            # the view is handed its coordinates: no division in the loop
            # over the reduced range unless two reduced axes share it
            loop = src.split("for rstart in")[1].split("tile =")[0]
            assert ("//" in loop) == (pattern.count("r") > 1)


def _tiled_trees(x, y, z):
    """(tree, its length, the tiled axis or None)."""
    a, b = 16, 12
    c3 = (3, 4, 5)
    return [
        (vt.reshape(x, (a, b), (1, 0)), a * b, 0),
        (vt.reshape(z, c3, (2, 0, 1)), 60, 1),
        (vt.reshape(z, c3, (0, 2, 1)), 60, 1),
        (vt.reshape(z, c3, (1, 2, 0)), 60, 0),
        (vt.reshape(x[0:a], (a, b), (0,)), a * b, 0),
        (vt.reshape(x, (a, b), (1, 0)) + y, a * b, 0),
        (2 * vt.reshape(vt.slicer((a, b))[:, :](x), (b, a), (1, 0)), a * b,
         0),
        (vt.reshape(x, (a, b), (1, 0)) * vt.reshape(y, (b, a), (1, 0)),
         a * b, 0),
        # contiguous innermost reads: the 1-D kernel
        (vt.slicer((a, b))[:, :](x), a * b, None),
        (vt.slicer((a, b))[1:a - 1, 1:b - 1](x), (a - 2) * (b - 2), None),
        (vt.reshape(z, c3, (1, 0, 2)), 60, None),
        (vt.reshape(x, (a, b), (0, 1)), a * b, None),
        (vt.reshape(x[0:b], (a, b), (1,)), a * b, None),
        (vt.slicer((b, a))[1:b - 1, :](vt.reshape(x, (b, a), (1, 0))),
         (b - 2) * a, None),
        (vt.slicer((a, b))[:, 3](x), a, None),
        (vt.slicer((a, b))[::2, ::3](x), 8 * 4, None),
        (vt.slicer((a, b))[np.arange(a)[::-1], :](x), a * b, None),
        (vt.permutation(vt.element_index(0, a * b))(
            vt.reshape(x, (a, b), (1, 0))), a * b, None),
        (x + y, a * b, None),
    ]


def test_tiled_form_picks_exactly_the_transposing_trees(tctx):
    rng = np.random.default_rng(0)
    x, y = (vt.vector(data=rng.random(192), context=tctx) for _ in range(2))
    z = vt.vector(data=rng.random(60), context=tctx)
    for tree, n, axis in _tiled_trees(x, y, z):
        e, an, ty, _ = prepare(tree, n, CPU)
        tile = tiled_view([e]) if an.indexed else None
        assert (None if tile is None else tile[2]) == axis, tree
        if tile is None:
            continue
        counts = [c for c, _, _, _ in tile[1].axes]
        tu, tl_, _ = ASSIGN_TILE
        assert tiled_programs(tile) * tu * tl_ >= n
        for codes in (["f64"], ["f32", "i32"]):
            exprs = [e] * len(codes)
            src = assign_tiled_source(exprs, an, ty, codes, tile)
            ast.parse(src)
            assert "def assign_tiled_kernel(" in src
            assert "tl.trans(" in src
            # the stores come after every load
            last_load = src.rindex("tl.load(")
            assert src.index("tl.store(") > last_load
        assert len(counts) >= 2


def test_tiled_choice_is_structural(tctx):
    """Two sizes of one transpose share a kernel key's tiled form; the
    form is in the signature (the axis markers), not in the sizes."""
    keys = set()
    for a, b in ((16, 12), (15, 11)):
        x = vt.vector(data=np.zeros(a * b), context=tctx)
        e, an, _, _ = prepare(vt.reshape(x, (a, b), (1, 0)), a * b, CPU)
        tile = tiled_view([e])
        keys.add((an.sig, tile[0], tile[2]))
    assert len(keys) == 1
