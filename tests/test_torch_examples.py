"""The port's examples (``examples/torch/``) on the CPU.

Each runs in this process (``runpy``, ``sys.argv`` set: one torch import
for all of them) with ``--device cpu`` at a small size, and must print
its own verification lines; an AST scan of its imports (and of the
helper module it shares) holds that it imports neither ``jax`` nor
``vexcl_tpu``.  The port's current context, ``sys.path`` and the
exclusive-device locks are put back after each.
"""

import ast
import os
import runpy
import sys

import pytest

from vexcl_tpu_torch import context as tcontext

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(os.path.dirname(HERE), "examples", "torch")

#: example -> (arguments at the test's size, lines it must print on any
#: device; ``chip_smoke.py`` runs the same on the cards)
CASES = {
    "hello": (["--n", "1024"], ["check 2*a + sqrt(b): ok"]),
    "benchmark": (["--log2", "12", "--reps", "2"], [
        "check saxpy, fused, reduction, philox, sort, scan: ok",
        "GB/s", "Mkeys/s"]),
    "complex_simple": ([], ["check X * Y: ok", "check X / Y: ok"]),
    "complex_spmv": (["--n", "64"], [
        "check A * x: ok", "check A * x against scipy: ok"]),
    "fft_benchmark": (["--sizes", "1024", "105", "--shapes", "16x16",
                       "--reps", "2"], [
        "check every transform against torch.fft in c128: ok",
        "GFLOP/s"]),
    "fft_profile": (["--sizes", "16", "17", "--runs", "2", "--repeats",
                     "1"], ["check (16, 16) against torch.fft.fft2: ok",
                            "check (17, 17) against torch.fft.fft2: ok"]),
    "mba_benchmark": (["--log2", "10", "--samples", "256", "--reps", "2"],
                      ["check against the CPU evaluation of 1024 points: "
                       "ok", "Mpoints/s on "]),
    "symbolic_odeint": (["--n", "256", "--steps", "10"], [
        "check one RK4 step against numpy f64: ok", "M steps/s"]),
    "thirdparty_sort": (["--log2", "10", "--reps", "1"], [
        "check vex.sort and torch.sort give the same keys: ok",
        "torch.sort:"]),
    "viennacl_solvers": (["--n", "128"], [
        "check CG: ok", "check scipy CG: ok", "check BiCGStab: ok"]),
    "devlist": (["--parts", "4"], ["All devices:", "4 parts on "]),
    "exclusive": (["--parts", "4"], ["Locked devices:",
                                     "sum over 4 parts: 999000.0"]),
    "distributed_algorithms": (["--parts", "4", "--n", "4096"], [
        "sort: globally ordered", "scan: matches cumsum",
        "launches over 4 parts"]),
}


def test_every_example_has_a_case():
    found = {f[:-3] for f in os.listdir(EXAMPLES)
             if f.endswith(".py") and not f.startswith("_")}
    assert found == set(CASES)


def _imports(path):
    """The top-level package of every import in ``path``, and of the
    local modules it imports from its own folder."""
    seen, todo, out = set(), [path], set()
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        with open(p) as fh:
            tree = ast.parse(fh.read(), p)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for name in names:
                out.add(name.split(".")[0])
                local = os.path.join(EXAMPLES, name + ".py")
                if os.path.exists(local):
                    todo.append(local)
    return out


@pytest.fixture
def restored(monkeypatch):
    """The port's current context, ``sys.path`` and ``sys.argv`` as they
    were; the exclusive locks released."""
    monkeypatch.setattr(tcontext, "_current_context",
                        tcontext._current_context)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    yield
    tcontext.release_exclusive_locks()


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, restored, capsys):
    path = os.path.join(EXAMPLES, name + ".py")
    bad = {"jax", "vexcl_tpu"} & _imports(path)
    assert not bad, f"{name} imports {bad}"
    args, lines = CASES[name]
    sys.argv = [path, "--device", "cpu", *args]
    runpy.run_path(path, run_name="__main__")
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, f"{name} did not print {line!r}:\n{out}"
