"""The ports of scripts/bench_table.py, scripts/bench_batched.py and
scripts/bench_mesh_scaling.py (dynosam_tpu_torch/{bench_table,
bench_batched,bench_mesh_scaling}.py) on the CPU at the small size: every
row and batch size runs and gives a finite rate; the table goes to the
port's file by default and never touches the repository's root
BENCH_TABLE.md; the sections splice between their markers; and two gloo
ranks step the batched program with no collective in the steady steps and
each rank's shapes equal to the unsharded B/P program's (with the counter
shown to see a collective when one runs)."""

import datetime
import math
import os

import pytest
import torch
import torch.distributed as dist

from dynosam_tpu_torch import bench_batched as tbb
from dynosam_tpu_torch import bench_mesh_scaling as tms
from dynosam_tpu_torch import bench_table as tbt
from dynosam_tpu_torch.parallel import batched as tbatched
from dynosam_tpu_torch.parallel import group as tgroup
from test_torch_config import _argparse_defaults

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TABLE = os.path.join(ROOT, "dynosam_tpu_torch", "BENCH_TABLE.md")
ROOT_TABLE = os.path.join(ROOT, "BENCH_TABLE.md")
SMALL = {"device": "cpu", "small": True, "measure": 2, "profile_frames": 1, "seed": 0}


@pytest.mark.parametrize("row", list(tbt.ROWS))
def test_row_runs_on_the_cpu(row):
    kw = dict(SMALL, **({} if row == "real-io" else {"warmup": 2}))
    r = tbt.ROWS[row][1](**kw)
    assert math.isfinite(r["fps"]) and r["fps"] > 0 and math.isclose(r["ms"], 1e3 / r["fps"])
    # no device on the CPU: no busy time, no idle share, no kernel launch
    assert r["busy_ms"] is None and r["idle"] is None
    assert all(v == 0 for v in r["launches"].values())
    if row == "real-io":
        assert r["frames"] == 2


@pytest.mark.parametrize("module", [tbt, tbb, tms], ids=lambda m: m.__name__.split(".")[-1])
def test_default_out_is_the_ports_table(module):
    assert os.path.realpath(_argparse_defaults(module.main)["out"]) == os.path.realpath(PORT_TABLE)


def test_programs_leave_the_root_table_alone(tmp_path, monkeypatch):
    """Run from the repository's root, as the reference's scripts are: the
    root BENCH_TABLE.md stays byte for byte; the table and the batched
    section go to --out, and a table rewrite keeps the batched section."""
    monkeypatch.chdir(ROOT)
    before = open(ROOT_TABLE, "rb").read()
    out = str(tmp_path / "table.md")
    skip = [r for r in tbt.ROWS if r != "fused-synth"]
    args = ["--device", "cpu", "--small", "--out", out]
    tbt.main(args + ["--warmup", "2", "--measure", "1", "--profile-frames", "1", "--skip", *skip])
    res = tbb.main(args + ["--batches", "1", "2", "--warmup", "1", "-n", "1"])
    assert all(math.isfinite(r["fps"]) and r["fps"] > 0 for r in res.values())
    assert math.isclose(res[2]["fps"], 2 * res[2]["fps_per_seq"])
    tbt.main(args + ["--warmup", "2", "--measure", "1", "--profile-frames", "1", "--skip", *skip])
    text = open(out).read()
    assert open(ROOT_TABLE, "rb").read() == before
    assert "| fused-synth |" in text and "fused-synth-klt |" not in text
    header = next(line for line in text.splitlines() if line.startswith("| config |"))
    assert "GFLOP" not in header and "MFU" not in header and "device idle share" in header
    batched = text.split(tbt.BB_BEGIN)[1].split(tbt.BB_END)[0]
    assert "| 1 |" in batched and "| 2 |" in batched
    assert text.count(tbt.MESH_BEGIN) == text.count(tbt.MESH_END) == 1


def test_splice_appends_then_replaces(tmp_path):
    path = str(tmp_path / "t.md")
    tbt.splice(path, tbt.MESH_BEGIN, tbt.MESH_END, "one\n")
    tbt.splice(path, tbt.MESH_BEGIN, tbt.MESH_END, "two\n")
    text = open(path).read()
    assert "two" in text and "one" not in text and text.count(tbt.MESH_BEGIN) == 1
    assert tbt.preserved_section(path, tbt.MESH_BEGIN, tbt.MESH_END) == "\ntwo\n"


def test_collective_counter_sees_a_collective():
    """A one-rank gloo group in this process: group.py's helpers, and the
    batched path's gather, are counted through every name that holds them."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{tgroup.free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        group = tgroup.Group(rank=0, world=1, device=torch.device("cpu"), backend="gloo", pg=dist.group.WORLD)
        originals = (tgroup.all_reduce_sum, tbatched.gather_to_rank0, dist.all_reduce, dist.gather)
        with tms.count_collectives() as calls:
            tgroup.all_reduce_sum(torch.ones(3), group)
            tbatched.gather_outputs({"x": torch.ones(2)}, group)
        assert calls == {"group.all_reduce_sum": 1, "dist.all_reduce": 1, "group.gather_to_rank0": 1,
                         "dist.gather": 1}
        # every name restored after the block
        assert (tgroup.all_reduce_sum, tbatched.gather_to_rank0, dist.all_reduce, dist.gather) == originals
        with tms.count_collectives() as calls:
            pass
        assert calls == {}
    finally:
        dist.destroy_process_group()


def test_mesh_scaling_two_gloo_ranks(tmp_path):
    """bench_mesh_scaling --device cpu --ranks 2 --steps 2: both checks
    hold; the section splices into an existing table."""
    out = tmp_path / "table.md"
    out.write_text(f"# t\n\n{tbt.MESH_BEGIN}\n{tbt.MESH_END}\n")
    r = tms.main(["--device", "cpu", "--ranks", "2", "--steps", "2", "--out", str(out)])
    assert r["backend"] == "gloo" and r["zero_collectives"] and r["per_rank_shapes_equal_b_over_p"] and r["finite"]
    assert r["collective_calls_in_steady_steps"] == {} and r["profiler_comm_ops_in_steady_steps"] == []
    assert len(r["rank_t_step_s"]) == 2 and all(t > 0 for t in r["rank_t_step_s"])
    assert r["timed_caveat"] and "share the CPU" in r["timed_caveat"]
    assert "Scaling over ranks" in out.read_text()
