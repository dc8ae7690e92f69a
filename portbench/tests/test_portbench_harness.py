"""The harness finds what BENCHMARK.json names, by name, and nothing else:
a cell, configuration, mix and per-layer metric added as new files and new
entries run without an edit to an existing file; the K1 byte count; the
traffic generator's determinism."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

import tiny
from portbench import k1_bytes, scenes, spec
from portbench import trace as tr


def test_k1_bytes_at_one_and_eight_lanes():
    assert k1_bytes.k1_bytes(1, 384, 1280, 16) == 1_989_120
    assert k1_bytes.k1_bytes(8, 384, 1280, 16) == 15_912_960


def test_every_cell_of_the_repository_loads():
    bench = json.load(open(os.path.join(tiny.REPO, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = spec.load_cell(tiny.REPO, w["name"])
        assert cell.traffic["lanes"] % cell.traffic["scenes"] == 0
        assert cell.limits
        for m in cell.per_layer:
            assert callable(spec.metric_reader(tiny.REPO, m["name"]))


def test_a_cell_config_mix_and_metric_added_as_files(tmp_path):
    root = tiny.make_root(str(tmp_path))
    pb = os.path.join(root, "portbench")
    shutil.copy(os.path.join(pb, "configs", "tiny-hybrid.json"), os.path.join(pb, "configs", "later-config.json"))
    traffic = json.load(open(os.path.join(pb, "traffic", "tiny-hybrid.json")))
    traffic["lanes"] = 6
    json.dump(traffic, open(os.path.join(pb, "traffic", "later-mix.json"), "w"))
    json.dump({"limits": {"cam_t_m": 0.5}}, open(os.path.join(pb, "limits", "later.cell.json"), "w"))
    with open(os.path.join(pb, "metrics", "later_metric.py"), "w") as f:
        f.write("def read(trace):\n    return trace.lanes * 2.0\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "later.cell", "config": "later-config", "traffic": "later-mix", "chips": 1,
                               "why": "added later"})
    bench["per_layer"].append({"name": "later_metric", "unit": "x", "better": "lower", "source": "host_clock",
                               "layer": "entry: batched step", "moves": "frames_per_s", "workloads": ["later.cell"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))

    cell = spec.load_cell(root, "later.cell")
    assert cell.traffic["lanes"] == 6 and cell.limits == {"cam_t_m": 0.5}
    assert [m["name"] for m in cell.per_layer][-1] == "later_metric"
    assert "later_metric" not in [m["name"] for m in spec.load_cell(root, "tiny-hybrid.sweep").per_layer]
    t = tr.Trace(lanes=6, steps=2, step_ms=[1.0, 2.0])
    assert spec.metric_reader(root, "later_metric")(t) == 12.0
    with pytest.raises(KeyError, match="later.cell"):
        spec.load_cell(root, "no.such.cell")


def test_readers_return_nothing_without_their_input(tmp_path):
    root = tiny.make_root(str(tmp_path))
    t = tr.Trace(lanes=4, steps=3, step_ms=[10.0, 20.0, 30.0], config=tiny.load("configs", "kitti-hybrid.json"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    read = {m["name"]: spec.metric_reader(root, m["name"])(t) for m in bench["per_layer"]}
    assert read.pop("step_ms_p95") == pytest.approx(29.0)
    assert all(v is None for v in read.values()), read


def test_k1_roofline_reads_the_traced_kernel(tmp_path):
    root = tiny.make_root(str(tmp_path))
    cfg = tiny.load("configs", "kitti-hybrid.json")
    least = k1_bytes.k1_least_s(8, cfg["camera"]["height"], cfg["camera"]["width"], 16)
    t = tr.Trace(lanes=8, steps=2, step_ms=[1.0], config=cfg,
                 kernels={"void shi_tomasi_cell_kernel<16>(...)": [4 * least, 4 * least], "other": [1.0]})
    assert spec.metric_reader(root, "k1_roofline_pct")(t) == pytest.approx(25.0)


def test_summarize_sums_device_time_and_names_gaps():
    class E:
        def __init__(self, s, d, name):
            self._s, self._d, self._n = s, d, name

        def device_type(self):
            return torch.autograd.DeviceType.CUDA

        def is_user_annotation(self):
            return self._n.startswith("portbench.")

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._d

        def name(self):
            return self._n

    # the anchor at device 1000 for host 0; host spans on the host's clock
    ev = [E(1000, 10, "anchor"), E(1100, 100, "k"), E(1150, 100, "k"), E(1500, 100, "m"),
          E(1000, 900, "portbench.step")]
    spans = [(0, 1000, "outside the program's step"), (120, 520, "backend")]
    s = tr.summarize(ev, 1e-6, spans, anchor_ns=0)
    assert s["busy_s"] == pytest.approx(300e-9) and s["device_ops"] == 3
    assert s["kernels"] == {"k": [pytest.approx(1e-7)] * 2, "m": [pytest.approx(1e-7)]}
    assert s["idle_gaps"] == [("backend", pytest.approx(250e-9))]


def _bank(seed, root):
    cell = spec.load_cell(root, "tiny-stereo-imu.sweep")
    return scenes.SceneBank(seed, cell.traffic, cell.config, "cpu")


def test_the_generator_gives_the_same_frames_from_the_same_seed(tmp_path):
    root = tiny.make_root(str(tmp_path))
    seed = 2**31 + 12345
    a, b, c = _bank(seed, root), _bank(seed, root), _bank(seed + 1, root)
    for name in scenes.FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not torch.equal(a.depth, c.depth)
    assert sorted(a.object_counts) == sorted(c.object_counts)
    a.check_visible(1)
    lanes = scenes.lane_scenes(4, 2, 1, "cpu")
    got = a.gather(lanes, 5)
    assert torch.equal(got["rgb"][0], a.rgb[1, 5]) and torch.equal(got["rgb"][1], a.rgb[0, 5])
    assert got["frame_id"].tolist() == [5] * 4
    assert not a.imu_valid[:, 0].any() and a.imu_valid[:, 1:].all()
    assert torch.isfinite(a.flow).all() and (a.depth > 0).all()
    assert np.array_equal(a.visible_px.numpy(), b.visible_px.numpy())
