"""The port's tooling modules against the JAX reference (and OpenCV / PIL
where the reference draws or writes through them): backend/graph_tools.py,
frontend/serialization.py (files cross-loaded between the two packages),
pipeline/viz.py, nn/weights.py::load_ultralytics_weights, and the entry
point's --viz and --detector_weights."""

import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dynosam_tpu.backend import graph as jgraph
from dynosam_tpu.backend import graph_tools as jtools
from dynosam_tpu.backend import hybrid as jhybrid
from dynosam_tpu.backend import solver as jsolver
from dynosam_tpu.backend import window as jwindow
from dynosam_tpu.dataproviders.simulator import Scenario, ScenarioSpec
from dynosam_tpu.frontend import serialization as jser
from dynosam_tpu_torch import jpeg, native
from dynosam_tpu_torch import run_dynosam as trun
from dynosam_tpu_torch.backend import graph_tools as ttools
from dynosam_tpu_torch.backend import hybrid as thybrid
from dynosam_tpu_torch.backend.graph import GraphState
from dynosam_tpu_torch.convert import dataclass_to_numpy
from dynosam_tpu_torch.frontend import serialization as tser
from dynosam_tpu_torch.frontend.types import VisionPacket
from dynosam_tpu_torch.nn import weights as tweights
from dynosam_tpu_torch.nn import yolov8
from dynosam_tpu_torch.pipeline import viz
from torch_port_util import np_tree, packet_backend_cfg, port_cfg, reference_window_run, to_port

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "kitti_fixture")
NUM_FRAMES = 7


@pytest.fixture(scope="module")
def scene():
    """The reference backend tests' two-object scene: its packets, a
    hybrid window of 6 ingested frames, and WCME windows before each of two
    advances (the second with the marginal prior live)."""
    scn = Scenario(ScenarioSpec.default_two_objects(num_frames=NUM_FRAMES, pixel_noise=0.4,
                                                    depth_noise=0.02, seed=5))
    packets = [scn.measurements(k, 4) for k in range(NUM_FRAMES)]
    hcfg = packet_backend_cfg(max_frames=6, backend_updater_enum=3)
    hg = jgraph.empty_graph(hcfg)
    for p in packets[:6]:
        hg = jgraph.update_from_packet_hybrid(hg, p, scn.intr, hcfg)
    wcfg = packet_backend_cfg(max_frames=5, backend_updater_enum=0, optimization_mode=1)
    _, windows = reference_window_run(wcfg, packets, scn.intr, jgraph.update_from_packet,
                                      jsolver.optimize, jwindow.advance)
    return dict(packets=packets, hybrid=(hcfg, hg), wcme=(wcfg, windows[-1]))


def _close_breakdowns(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k]["count"] == ref[k]["count"], k
        # f32 sums of up to ~1e3 terms in another order
        assert got[k]["chi2"] == pytest.approx(ref[k]["chi2"], rel=1e-4, abs=1e-6), k


@pytest.mark.parametrize("form", ["hybrid", "wcme"])
def test_error_breakdown_and_export(scene, form, tmp_path):
    """error_breakdown and export_graph_json against the reference's on one
    window: counts equal, chi2 within 1e-4 relative; the JSON's structure
    equal."""
    cfg, jg = scene[form]
    hyb = form == "hybrid"
    tg = to_port(GraphState, jg)
    _close_breakdowns(ttools.error_breakdown(tg, port_cfg(cfg), hybrid=hyb),
                      jtools.error_breakdown(jg, cfg, hybrid=hyb))
    ref = jtools.export_graph_json(jg, cfg, str(tmp_path / "ref.json"), hybrid=hyb)
    got = ttools.export_graph_json(tg, port_cfg(cfg), str(tmp_path / "got.json"), hybrid=hyb)
    for key in ("frames", "frame_ids", "static_landmarks", "objects", "factors"):
        assert got[key] == ref[key], key
    for k, v in ref["errors"].items():
        assert got["errors"][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    with open(tmp_path / "got.json") as f:
        assert json.load(f)["factors"] == got["factors"]
    if not hyb:
        assert got["factors"]["marginal_prior"] == 1.0 and got["errors"]["marginal_prior"] > 0


def test_sparsity_stats_and_png(scene, tmp_path):
    """sparsity_stats equals the reference's; the sparsity PNG, written by
    the port's encoder, has PIL's pixels of the reference's file."""
    cfg, jg = scene["hybrid"]
    S = np.asarray(jhybrid.linearize(jg, cfg, 0.0).S)
    tS = thybrid.linearize(to_port(GraphState, jg), port_cfg(cfg), 0.0).S
    np.testing.assert_allclose(tS.numpy(), S, rtol=1e-4, atol=1e-4 * np.abs(S).max())
    ref = jtools.sparsity_stats(S, tol=1e-12)
    assert ttools.sparsity_stats(S, tol=1e-12) == ref
    assert ttools.sparsity_stats(torch.from_numpy(S), tol=1e-12) == ref
    assert 0 < ref["nnz"] < ref["rows"] * ref["cols"]
    jtools.save_sparsity_png(S, str(tmp_path / "ref.png"), tol=1e-12)
    ttools.save_sparsity_png(torch.from_numpy(S), str(tmp_path / "got.png"), tol=1e-12)
    a, b = Image.open(tmp_path / "ref.png"), Image.open(tmp_path / "got.png")
    assert a.mode == b.mode == "L"
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_packets_cross_load(scene, tmp_path):
    """A packet stream saved by either package loads in the other, equal
    leaf for leaf; the replay provider yields them in order."""
    packets = scene["packets"]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jser.save_packets(jpath, packets)
    got = tser.load_packets(jpath, device="cpu")
    assert len(got) == len(packets)
    for p, g in zip(packets, got):
        ref, mine = np_tree(p), dataclass_to_numpy(g)
        assert_equal_trees(ref, mine)
    tser.save_packets(tpath, got)
    back = jser.load_packets(tpath)
    for p, b in zip(packets, back):
        assert_equal_trees(np_tree(p), np_tree(b))
    replay = tser.PacketReplayProvider(tpath, device="cpu")
    assert len(replay) == len(packets)
    assert [int(p.frame_id) for p in replay] == [int(p.frame_id) for p in packets]


def assert_equal_trees(ref, got, path=""):
    assert set(ref) == set(got), path
    for k in ref:
        if isinstance(ref[k], dict):
            assert_equal_trees(ref[k], got[k], f"{path}.{k}")
        else:
            r, g = np.asarray(ref[k]), np.asarray(got[k])
            assert r.dtype == g.dtype and r.shape == g.shape, (path, k, r.dtype, g.dtype)
            np.testing.assert_array_equal(g, r, err_msg=f"{path}.{k}")


def test_graph_state_cross_load(scene, tmp_path):
    """A graph-state checkpoint written by either package restores in the
    other; the host window fill round-trips as the reference's int32."""
    cfg, jg = scene["wcme"]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jser.save_graph_state(jpath, jg)
    template = to_port(GraphState, jgraph.empty_graph(cfg))
    got = tser.load_graph_state(jpath, template)
    assert isinstance(got.num_frames, int) and got.num_frames == int(jg.num_frames)
    assert_equal_trees(np_tree(jg), dataclass_to_numpy(got))
    tser.save_graph_state(tpath, got)
    back = jser.load_graph_state(tpath, jgraph.empty_graph(cfg))
    assert_equal_trees(np_tree(jg), np_tree(back))


# ---------------------------------------------------------------------------
# viz against OpenCV
# ---------------------------------------------------------------------------

def test_primitives_match_opencv():
    """Filled radius-2 (and 1, 3) circles, 1-px rectangles and 1-px lines
    of every slope, inside and across the border: pixel for pixel as
    cv2.circle / cv2.rectangle / cv2.line draw them."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        a, b = np.zeros((40, 50, 3), np.uint8), np.zeros((40, 50, 3), np.uint8)
        c = tuple(int(v) for v in rng.integers(1, 256, 3))
        x, y, r = int(rng.integers(-3, 53)), int(rng.integers(-3, 43)), int(rng.integers(1, 4))
        cv2.circle(a, (x, y), r, c, -1)
        viz._fill_circle(b, x, y, r, c)
        np.testing.assert_array_equal(b, a, err_msg=f"circle {x} {y} {r}")
        p0, p1 = tuple(int(v) for v in rng.integers(0, 40, 2)), tuple(int(v) for v in rng.integers(0, 40, 2))
        cv2.rectangle(a, p0, p1, c, 1)
        viz._draw_rectangle(b, p0, p1, c)
        np.testing.assert_array_equal(b, a, err_msg=f"rectangle {p0} {p1}")
        cv2.line(a, p0, p1, c, 1)
        viz._draw_line(b, p0, p1, c)
        np.testing.assert_array_equal(b, a, err_msg=f"line {p0} {p1}")


def _reference_viz():
    """The reference's viz module (it draws with cv2, present here)."""
    from dynosam_tpu.pipeline import viz as jviz

    return jviz


def test_tracking_image_matches_opencv(scene):
    """render_tracking_image against the reference's on the simulator's
    packets over a textured frame: equal pixel for pixel outside each
    object's id text (cv2.putText's Hershey glyphs against the port's own
    5x7 digits; see the viz module docstring), and inside the masked boxes
    the dots and box edges are compared on the pixels neither text
    touches."""
    jviz = _reference_viz()
    rng = np.random.default_rng(1)
    for p in scene["packets"][:3]:
        rgb = rng.random((240, 320, 3)).astype(np.float32)
        ref = jviz.render_tracking_image(rgb, p)
        got = viz.render_tracking_image(torch.from_numpy(rgb), to_port(VisionPacket, p))
        assert got.shape == ref.shape and got.dtype == np.uint8
        mask = _text_mask(got.shape, to_port(VisionPacket, p))
        assert mask.sum() < 0.02 * mask.size
        np.testing.assert_array_equal(got[~mask], ref[~mask])


def _text_mask(shape, packet):
    """Pixels either package's id text may set: the port's glyph box and
    cv2.getTextSize's box (with its baseline) at the same origin."""
    mask = np.zeros(shape[:2], bool)
    dt = packet.dynamic_tracks
    uv, oids, valid = dt.uv.numpy(), dt.object_id.numpy(), dt.valid.numpy()
    for oid in np.unique(oids[valid]):
        if oid <= 0:
            continue
        x1, y1 = uv[(oids == oid) & valid].min(axis=0)
        org = (int(x1), int(y1) - 3)
        (tw, th), base = cv2.getTextSize(str(int(oid)), cv2.FONT_HERSHEY_SIMPLEX, 0.4, 1)
        x0, y0, xa, ya = viz.text_box(str(int(oid)), org)
        for ax0, ay0, ax1, ay1 in ((x0, y0, xa, ya), (org[0] - 1, org[1] - th - 1, org[0] + tw + 1, org[1] + base + 1)):
            mask[max(ay0, 0):max(ay1 + 1, 0), max(ax0, 0):max(ax1 + 1, 0)] = True
    return mask


def test_trajectory_plot_matches_opencv():
    """render_trajectory_topdown against the reference's: the 1-px object
    trails are cv2's pixel for pixel (test_primitives_match_opencv), the
    2-px camera trail is drawn by the port's own widening of the 1-px line,
    so the plot differs from cv2's only along the camera trail: fewer than
    0.5% of its pixels differ (read 0.14%), all within 2 px of cv2's
    trail."""
    jviz = _reference_viz()
    rng = np.random.default_rng(2)
    K = 40
    traj = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    traj[:, 0, 3] = np.cumsum(rng.normal(0, 0.3, K))
    traj[:, 2, 3] = np.cumsum(rng.uniform(0.5, 1.0, K))
    objs = {3: traj[:20].copy(), 5: traj[10:].copy()}
    objs[3][:, 0, 3] += 2.0
    objs[5][:, 2, 3] -= 1.5
    ref = jviz.render_trajectory_topdown(traj, objs)
    got = viz.render_trajectory_topdown(torch.from_numpy(traj), objs)
    differ = (got != ref).any(axis=-1)
    share = differ.mean()
    print(f"trajectory plot: {share:.4%} of the pixels differ")
    assert share < 5e-3
    cam = (ref == np.array([180, 60, 0], np.uint8)).all(-1) | (got == np.array([180, 60, 0], np.uint8)).all(-1)
    near = cv2.dilate(cam.astype(np.uint8), np.ones((5, 5), np.uint8)) > 0
    assert not (differ & ~near).any()


def test_display_writer_and_avi(scene, tmp_path):
    """DisplayWriter: tracking PNGs (decoded equal to the rendered images),
    the trajectory PNG, and the Motion-JPEG AVI whose frames decode to each
    PNG's own JPEG round trip bit for bit (jpeg.encode_jpeg then
    decode_jpeg), within JPEG loss of the PNG (mean absolute error under 3
    grey levels; read 0.88-0.90 at quality 95 on these smooth frames)."""
    w = viz.DisplayWriter(str(tmp_path))
    yy, xx = np.mgrid[0:96, 0:160].astype(np.float32)
    imgs = []
    for k, p in enumerate(scene["packets"][:4]):
        # a smooth frame, as a camera image is between its edges
        rgb = np.stack([0.5 + 0.4 * np.sin(xx / (9 + k) + c) * np.cos(yy / 13) for c in range(3)], -1)
        rgb = torch.from_numpy(rgb.astype(np.float32))
        pk = to_port(VisionPacket, p)
        w.write_tracking(rgb, pk)
        imgs.append(viz.render_tracking_image(rgb, pk))
    w.write_trajectory([np.eye(4, dtype=np.float32) + k for k in range(4)])
    assert os.path.exists(os.path.join(w.path, "trajectory_topdown.png"))
    path = w.write_video()
    assert path.endswith(".avi")
    frames = viz.read_avi_frames(path)
    assert len(frames) == len(imgs)
    cap = cv2.VideoCapture(path)            # the container is a valid AVI for OpenCV too
    assert cap.isOpened() and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(imgs)
    cap.release()
    for k, (img, data) in enumerate(zip(imgs, frames)):
        png = native.read_png(os.path.join(w.path, f"tracking_{k:06d}.png"), color=True, order="bgr")
        np.testing.assert_array_equal(png, img)                 # BGR, as cv2.imread
        rgb = img[..., ::-1]
        dec = jpeg.decode_jpeg(data)
        np.testing.assert_array_equal(dec, jpeg.decode_jpeg(jpeg.encode_jpeg(np.ascontiguousarray(rgb), 95)))
        err = np.abs(dec.astype(np.int32) - rgb).mean()
        print(f"AVI frame {k}: mean |JPEG - PNG| {err:.3f} grey levels")
        assert err < 3.0


# ---------------------------------------------------------------------------
# ultralytics weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ultra():
    """The port's own scale-n, 80-class network from a seed, and its
    weights under ultralytics' names."""
    torch.manual_seed(0)
    model = yolov8.YoloV8Seg(num_classes=80, scale="n").eval()
    # non-trivial BatchNorm statistics, as a trained network has
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.1, 0.1)
                mod.running_var.uniform_(0.5, 1.5)
    return model, tweights.ultralytics_state_dict(model)


def test_load_ultralytics_weights(ultra, tmp_path):
    """From the dict and from a torch.save'd file (and with the wrapping
    Model's `model.model.` prefix): every tensor equals the network's, and
    so do its outputs."""
    model, sd = ultra
    path = str(tmp_path / "sd.pt")
    torch.save(sd, path)
    x = torch.rand(1, 64, 96, 3)
    with torch.no_grad():
        ref = model(x)
    for src in (sd, path, {"model." + k: v for k, v in sd.items()}):
        got = tweights.load_ultralytics_weights(src, num_classes=80, scale="n", device="cpu")
        for k, v in model.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
        with torch.no_grad():
            out = got(x)
        for key in ("boxes", "cls", "mcoef"):
            for a, b in zip(out[key], ref[key]):
                assert torch.equal(a, b), key
        assert torch.equal(out["proto"], ref["proto"])
    bad = dict(sd)
    del bad["model.22.cv3.0.2.bias"]
    with pytest.raises(KeyError, match="cv3.0.2.bias"):
        tweights.load_ultralytics_weights(bad, device="cpu")


def test_ultralytics_weights_against_the_reference_loader(ultra):
    """The JAX loader on the same dict, mapped to torch names by the flax
    checkpoint reader's mapping (state_dict_from_flax): every tensor equal
    to the port's but the proto upsample's, which is the port's flipped in
    both spatial axes. The reference's `_deconv_k` leaves out the flip
    that flax's ConvTranspose (transpose_kernel=False) needs (ROADMAP queue
    3); the port loads ultralytics' torch ConvTranspose2d weight unchanged,
    the correct mapping."""
    from dynosam_tpu.nn.weights import load_ultralytics_weights as jload

    model, sd = ultra
    jvars = jax.tree.map(np.asarray, jload({k: v.numpy() for k, v in sd.items()}, num_classes=80, scale="n"))
    ref = tweights.state_dict_from_flax(jvars)
    got = tweights.load_ultralytics_weights(sd, num_classes=80, scale="n", device="cpu").state_dict()
    got = {k: v for k, v in got.items() if not k.endswith("num_batches_tracked")}
    assert set(ref) == set(got)
    for k in got:
        if k == "proto.upsample.weight":
            assert not torch.equal(ref[k], got[k])
            assert torch.equal(ref[k], torch.flip(got[k], dims=(2, 3)))
        else:
            assert torch.equal(ref[k], got[k]), k


def test_entry_point_viz_and_detector_weights(ultra, tmp_path):
    """python -m dynosam_tpu_torch.run_dynosam --viz --use_detector
    --detector_weights <state_dict> on 6 fixture frames on the CPU: the
    logs, 6 tracking PNGs, the trajectory plot and a 6-frame AVI."""
    _, sd = ultra
    wpath = str(tmp_path / "yolov8n-seg-sd.pt")
    torch.save(sd, wpath)
    out = tmp_path / "run"
    trun.main(["--dataset_type", "0", "--dataset_path", FIXTURE, "--device", "cpu", "--frames", "6",
               "--flags", os.path.join(ROOT, "params", "backend.flags"),
               "--output_path", str(out), "--viz", "--use_detector", "--detector_weights", wpath])
    names = sorted(os.listdir(out / "viz"))
    assert names == sorted([f"tracking_{k:06d}.png" for k in range(6)] + ["tracking.avi", "trajectory_topdown.png"])
    assert len(viz.read_avi_frames(str(out / "viz" / "tracking.avi"))) == 6
    png = native.read_png(str(out / "viz" / "tracking_000000.png"), color=True)
    assert png.shape == (96, 320, 3)
    with open(out / "dynosam_tpu_camera_pose_log.csv") as f:
        assert len(f.read().strip().splitlines()) == 7          # header + 6 frames


def test_packet_replay_through_a_backend(scene, tmp_path):
    """Packets saved, replayed through PacketReplayProvider into a fresh
    RegularBackend: the same camera poses as the backend fed directly."""
    from dynosam_tpu_torch.backend.backend import RegularBackend
    from torch_port_util import port_intr

    path = str(tmp_path / "p.npz")
    packets = [to_port(VisionPacket, p) for p in scene["packets"]]
    tser.save_packets(path, packets)
    cfg = port_cfg(packet_backend_cfg(max_frames=5, backend_updater_enum=3, optimization_mode=2))
    intr = port_intr(Scenario(ScenarioSpec.default_two_objects(num_frames=1)).intr)
    poses = []
    for source in (packets, tser.PacketReplayProvider(path, device="cpu")):
        be = RegularBackend(cfg, intr, device="cpu")
        poses.append([be.step(p).X_world_cam for p in source])
    assert len(poses[1]) == len(packets)
    for a, b in zip(*poses):
        np.testing.assert_array_equal(a, b)
