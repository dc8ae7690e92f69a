"""scripts/bisect_torch_batch.py's comparison on toy programs: a program
whose rows depend on their own row alone reads no differing operation
between a batch of 4 and rows 0-1 of a batch of 2, a flattened batch axis
(outer, batch, inner) included; a program that mixes rows is caught at
the first operation that does, with its shapes; an operation run alone
at both batch sizes reads equal when it is row-wise. The script imports
nothing of JAX (it runs on the card's machine)."""

import ast
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import bisect_torch_batch as bis  # noqa: E402

B, HALF = 4, 2


def _rowwise(x):
    y = torch.sin(x) * 2.0 + 1.0
    flat = y.permute(1, 0, 2).reshape(3 * x.shape[0], 5)   # the batch inside a flattened axis
    return (flat * flat).reshape(3, x.shape[0], 5).sum(-1)


def _mixing(x):
    y = torch.sin(x) * 2.0
    return y - y.mean(0, keepdim=True)                      # every row reads the whole batch


def _run(fn):
    x = torch.rand((B, 3, 5), generator=torch.Generator().manual_seed(0))
    rec = bis.make_mode(None, B, HALF)
    with rec:
        fn(x)
    rows = x[:HALF].clone()
    cmp = bis.make_mode(rec.ops, B, HALF)
    with cmp:
        fn(rows)
    return rec, cmp


def test_rowwise_program_reads_no_difference():
    rec, cmp = _run(_rowwise)
    assert len(rec.ops) >= 5 and cmp.diffs == [] and cmp.parted is None


def test_row_mixing_is_caught_at_its_first_operation():
    _, cmp = _run(_mixing)
    first = cmp.diffs[0]
    assert first["op"] == "aten::mean"
    assert first["in_shapes"] == [(HALF, 3, 5)] and first["recorded_in_shapes"] == [(B, 3, 5)]
    assert first["unequal"] > 0 and first["max_abs"] > 0


@pytest.mark.parametrize("op", [torch.sin, lambda t: t.sum(-1), lambda t: t @ t.transpose(-1, -2)],
                         ids=["sin", "sum", "bmm"])
def test_a_rowwise_operation_alone_reads_equal(op):
    x = torch.rand((HALF, 3, 5), generator=torch.Generator().manual_seed(1))
    big = torch.cat([x, x])
    rec = bis.make_mode(None, B, HALF)
    with rec:
        op(big)
    func = None

    class Grab(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, f, types, args=(), kwargs=None):
            nonlocal func
            if not getattr(f, "is_view", False):
                func = func or (f, args, kwargs or {})
            return f(*args, **(kwargs or {}))

    with Grab():
        op(x)
    f, args, kwargs = func
    assert f._schema.name == rec.ops[0][0]
    got = bis.alone(f, args, kwargs, rec.ops[0][3], B, HALF)
    assert got["unequal"] == 0 and got["grown_shapes"][0][0] == B


def test_script_imports_no_jax():
    with open(os.path.join(ROOT, "scripts", "bisect_torch_batch.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "dynosam_tpu")], names
