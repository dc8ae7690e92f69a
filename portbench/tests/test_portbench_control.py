"""The control on the card: the plain reference put in the program's place
with TF32 matrix products (the precision below the configuration's float32)
is not correct under each cell's committed limits, while the program is, at
the tiny cut. The cell's own size is measured by `python -m
portbench.calibrate --control` (readings in PERF.md)."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

import tiny
from portbench import run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["hybrid", "stereo-imu"])
def test_the_tf32_control_is_not_correct_and_the_program_is(card, tmp_path, config):
    bench = json.load(open(os.path.join(tiny.REPO, "BENCHMARK.json")))
    cell = next(w["name"] for w in bench["workloads"] if w["config"] == "kitti-" + config)
    limits = tiny.tiny_limits(tiny.load("limits", cell + ".json")["limits"])
    root = tiny.make_root(str(tmp_path), limits=limits, lanes=8)
    name = f"tiny-{config}.sweep"
    seed = 2**31 + 99

    def one(control):
        return run.run_cell(root, name, seed, 3.0, 0, device="cuda", t_start=time.perf_counter(),
                            control=control, log=lambda s: None)

    assert one(False)["correct"] is True
    assert one(True)["correct"] is False
