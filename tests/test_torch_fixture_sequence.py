"""The port of scripts/make_fixture_sequence.py
(dynosam_tpu_torch/make_fixture_sequence.py) against the script, on the CPU.

  * at tests/test_kitti_writer.py's size (6 frames, 160x48) the port's
    entry point against the script's main() itself (its fixture_scenario
    and the JAX writer, the same world offset): the same file names;
    times.txt and DatasetParams.yaml byte-equal (the float32 base line fx *
    0.537 m as the script computes it); images, uint16 disparity and masks
    decoded equal; .flo within FLOW_PX (1.5e-4 px read); the numbers of
    pose_gt.txt and object_pose.txt within POSE_PER_FRAME per frame (boxes
    equal) and their text equal but for those digits: the two renderers'
    float32 pose chains part by ~7e-6 m per frame (se3_exp is
    ill-conditioned at the fixture's 0.002 rad yaw; tests/test_torch_rich.py
    holds the renderers to each other), which the files print at 9
    decimals. The printed visibility line equals the script's, and both
    count the same files;
  * --rich at 2 frames of 1242x375: byte for byte the files of
    eval/accuracy.py's write_rich, the route tests/test_torch_rich.py holds
    to JAX;
  * at the defaults (60 frames, 320x96) against the committed
    tests/fixtures/kitti_fixture, by chip_smoke.py phase 21's readings and
    bounds;
  * the default --out is under the git-ignored results/, not tests/.
"""

import contextlib
import io
import os
import sys

import numpy as np
import torch
from PIL import Image

import chip_smoke
from dynosam_tpu_torch import make_fixture_sequence as mfs
from dynosam_tpu_torch.eval.accuracy import write_rich

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES, W, H = 6, 160, 48
FLOW_PX = 1e-3
POSE_PER_FRAME = 1e-5


def _reference_main(argv):
    """scripts/make_fixture_sequence.py's main() under argv -> its printed
    lines."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("ref_make_fixture_sequence",
                                                  os.path.join(ROOT, "scripts", "make_fixture_sequence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out, saved = io.StringIO(), sys.argv
    sys.argv = ["make_fixture_sequence.py", *argv]
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = saved
    return out.getvalue().splitlines()


def _port_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mfs.main(argv + ["--device", "cpu"])
    return out.getvalue().splitlines()


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _numbers(text):
    return np.array([float(x) for x in text.split()])


def _words(text):
    """The text with every number's digits after the point dropped."""
    return [x.split(".")[0] for x in text.split()]


def test_entry_point_matches_the_script(tmp_path):
    size = ["--frames", str(N_FRAMES), "--width", str(W), "--height", str(H)]
    a_dir, b_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    ref_lines = _reference_main(size + ["--out", a_dir])
    got_lines = _port_main(size + ["--out", b_dir])
    assert got_lines[0] == ref_lines[0] == f"frames visible (>=25 px): {{1: 6, 2: 6, 3: 6}} of {N_FRAMES}"
    # "wrote <out>: <n> files, <size> MB" (the PNG encoders compress apart)
    assert got_lines[1].split(":")[1].split(",")[0] == ref_lines[1].split(":")[1].split(",")[0]
    names = _tree(a_dir)
    assert _tree(b_dir) == names and len(names) == 4 * N_FRAMES + 4
    for rel in names:
        a_path, b_path = os.path.join(a_dir, rel), os.path.join(b_dir, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(b_path)), np.asarray(Image.open(a_path)),
                                          err_msg=rel)
        elif rel.endswith(".flo"):
            a, b = np.fromfile(a_path, np.float32), np.fromfile(b_path, np.float32)
            np.testing.assert_array_equal(b[:3], a[:3])
            np.testing.assert_allclose(b[3:], a[3:], rtol=0, atol=FLOW_PX, err_msg=rel)
        elif rel.startswith("motion"):
            assert open(b_path).read() == open(a_path).read(), rel
        elif rel in ("times.txt", "DatasetParams.yaml"):
            assert open(b_path, "rb").read() == open(a_path, "rb").read(), rel
        else:
            a_text, b_text = open(a_path).read(), open(b_path).read()
            assert _words(b_text) == _words(a_text), rel
            for la, lb in zip(a_text.splitlines(), b_text.splitlines()):
                a, b = _numbers(la), _numbers(lb)
                k = a[0]
                if rel == "object_pose.txt":
                    np.testing.assert_array_equal(b[:6], a[:6], err_msg=la)
                np.testing.assert_allclose(b, a, rtol=0, atol=POSE_PER_FRAME * max(k, 1), err_msg=la)


def test_rich_flag_writes_the_rich_route(tmp_path):
    a_dir, b_dir = str(tmp_path / "route"), str(tmp_path / "cli")
    write_rich(a_dir, 2, "cpu")
    lines = _port_main(["--rich", "--frames", "2", "--width", "1242", "--height", "375", "--out", b_dir])
    assert lines[0] == "frames visible (>=25 px): {1: 2, 2: 2, 3: 2, 4: 2} of 2"
    names = _tree(a_dir)
    assert _tree(b_dir) == names and len(names) == 4 * 2 + 4
    for rel in names:
        assert open(os.path.join(b_dir, rel), "rb").read() == open(os.path.join(a_dir, rel), "rb").read(), rel


def test_defaults_match_the_committed_fixture(tmp_path):
    out = str(tmp_path / "kitti_fixture")
    lines = _port_main(["--out", out])
    r = chip_smoke.fixture_file_readings(chip_smoke.KITTI_FIXTURE, out)
    assert not chip_smoke.fixture_writer_over(r), r
    assert r["visible_out"] == r["visible_ref"]
    assert lines[0] == f"frames visible (>=25 px): {r['visible_ref']} of 60"


def test_default_out_is_not_under_tests(monkeypatch):
    written = []
    monkeypatch.setattr(mfs, "visibility", lambda dense: {})
    monkeypatch.setattr(mfs, "write_fixture", lambda out, *a: written.append(out))
    _port_main([])
    assert written == [mfs.DEFAULT_OUT] == [os.path.join("results", "torch", "kitti_fixture")]
    assert "results/" in open(os.path.join(ROOT, ".gitignore")).read().splitlines()
