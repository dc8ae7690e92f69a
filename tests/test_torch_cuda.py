"""Card-only tests of the PyTorch port: the hand-written CUDA kernels (K1
Shi-Tomasi with its fused per-cell argmax, K2 mask combination and its
one-launch label image) against their plain versions, the
detector engine and the fused step past its window on the card against the
same code on the CPU. They skip without a CUDA device. This file imports no JAX, so it
also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dynosam_tpu_torch.config import (
    BackendParams,
    DynoConfig,
    FrontendParams,
    OptimizerParams,
    TrackerParams,
)
from dynosam_tpu_torch.bench_config import detector_config, detector_scene
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario
from dynosam_tpu_torch.nn.detector import YoloV8DetectorEngine
from dynosam_tpu_torch.ops.cuda import mask_combine as mc
from dynosam_tpu_torch.ops.cuda import shi_tomasi as st
from dynosam_tpu_torch.parallel.batched import init_pipeline_state, make_fused_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", [(384, 1280), (3, 96, 200), (37, 61), (2, 3)])
def test_kernel_matches_plain_version(cuda, shape):
    img = torch.rand(shape, generator=cuda, device="cuda")
    before = st.shi_tomasi_response.launches
    out = st.shi_tomasi_response(img)
    assert st.shi_tomasi_response.launches == before + 1
    ref = st.shi_tomasi_response_reference(img)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_batched_kernel_equals_single_images(cuda):
    imgs = torch.rand((3, 64, 96), generator=cuda, device="cuda")
    batched = st.shi_tomasi_response(imgs)
    for b in range(3):
        assert torch.equal(batched[b], st.shi_tomasi_response(imgs[b].contiguous()))


def test_constant_frame_ties_take_the_first_index(cuda):
    img = torch.full((64, 96), 0.3, device="cuda")
    for a, b in zip(st.cell_reduce(st.shi_tomasi_response(img), 16),
                    st.cell_reduce(st.shi_tomasi_response_reference(img), 16)):
        assert torch.equal(a, b)


def test_kernel_rejects_a_noncontiguous_tensor(cuda):
    img = torch.rand((64, 96), generator=cuda, device="cuda")
    with pytest.raises(ValueError):
        st.shi_tomasi_response(img.t())


@pytest.mark.parametrize("batch", [None, 8])
@pytest.mark.parametrize("cell", [8, 16])
@pytest.mark.parametrize("hw", [(384, 1280), (384, 640), (100, 90), (375, 1242), (384, 1248), (96, 320),
                                (96, 128)])
def test_fused_cell_max_equals_plain_version(cuda, hw, cell, batch):
    """Responses bit for bit (no FMA contraction on either side), so the
    per-cell maxima and their pixels are equal in every cell. 375x1242 and
    100x90 take the scalar loads (W % 4 != 0); 384x1248 and 96x320 (the
    padded rich fixture and the dyno-KITTI fixture) the 16-byte loads of a
    last column tile narrower than the kernel's; 96x128 (the graft's small
    configuration) one column tile that is both the first and the last."""
    shape = hw if batch is None else (batch, *hw)
    img = torch.rand(shape, generator=cuda, device="cuda")
    before = st.shi_tomasi_cell_max.launches
    got = st.shi_tomasi_cell_max(img, cell)
    assert st.shi_tomasi_cell_max.launches == before + 1
    ref = st.shi_tomasi_cell_max_reference(img, cell)
    for name, a, b in zip("best u v".split(), got, ref):
        assert a.shape == b.shape == (*shape[:-2], (hw[0] // cell) * (hw[1] // cell)), name
        assert torch.equal(a, b), (name, int((a != b).sum()))
    if batch is not None:
        for b in range(batch):
            for a, one in zip(got, st.shi_tomasi_cell_max(img[b].contiguous(), cell)):
                assert torch.equal(a[b], one)


@pytest.mark.parametrize("hw", [(384, 640), (384, 1248), (96, 320), (96, 128)])
@pytest.mark.parametrize("cell", [8, 16])
def test_fused_cell_max_ties_take_each_cells_first_pixel(cuda, cell, hw):
    img = torch.full(hw, 0.5, device="cuda")
    best, u, v = st.shi_tomasi_cell_max(img, cell)
    gw = hw[1] // cell
    cells = torch.arange(best.numel(), device="cuda")
    assert torch.equal(u, (cells % gw * cell).float()) and torch.equal(v, (cells // gw * cell).float())
    for a, b in zip((best, u, v), st.shi_tomasi_cell_max_reference(img, cell)):
        assert torch.equal(a, b)


def test_fused_cell_max_takes_nan_as_the_largest(cuda):
    img = torch.rand((64, 96), generator=cuda, device="cuda")
    img[20, 37] = float("nan")
    got = st.shi_tomasi_cell_max(img, 16)
    ref = st.shi_tomasi_cell_max_reference(img, 16)
    assert bool(torch.isnan(got[0]).any())
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("bad", ["cell12", "float64", "noncontiguous", "rank1"])
def test_fused_cell_max_rejects_what_the_kernel_does_not_take(cuda, bad):
    img = torch.rand((64, 96), generator=cuda, device="cuda")
    arg, cell = {"cell12": (img, 12), "float64": (img.double(), 16),
                 "noncontiguous": (img.t(), 8), "rank1": (img.reshape(-1), 8)}[bad]
    before = st.shi_tomasi_cell_max.launches
    with pytest.raises((TypeError, ValueError)):
        st.shi_tomasi_cell_max(arg, cell)
    assert st.shi_tomasi_cell_max.launches == before


@pytest.mark.parametrize("k, hp, wp, nm", [(32, 96, 160, 32), (5, 37, 61, 32), (1, 1, 1, 32),
                                            (64, 8, 8, 16), (300, 24, 40, 32)])
def test_mask_combine_kernel_matches_plain_version(cuda, k, hp, wp, nm):
    proto = torch.randn((hp, wp, nm), generator=cuda, device="cuda")
    coef = torch.randn((k, nm), generator=cuda, device="cuda")
    before = mc.mask_combine.launches
    out = mc.mask_combine(proto, coef)
    assert mc.mask_combine.launches == before + 1
    torch.testing.assert_close(out, mc.mask_combine_reference(proto, coef), rtol=0, atol=1e-5)


def test_mask_combine_rejects_what_the_kernel_does_not_take(cuda):
    proto = torch.randn((8, 8, 32), generator=cuda, device="cuda")
    with pytest.raises(ValueError):         # K=2000's coefficients exceed the device's shared memory
        mc.mask_combine(proto, torch.randn((2000, 32), generator=cuda, device="cuda"))
    with pytest.raises(ValueError):         # devices differ
        mc.mask_combine(proto, torch.randn((4, 32)))
    with pytest.raises(ValueError):         # nm not a multiple of 4
        p30 = torch.randn((8, 8, 30), generator=cuda, device="cuda")
        mc.mask_combine(p30, torch.randn((4, 30), generator=cuda, device="cuda"))


@pytest.mark.parametrize("k, hp, wp", [(32, 96, 160), (5, 37, 61)])
def test_mask_combine_kernel_takes_the_nchw_view(cuda, k, hp, wp):
    proto = torch.randn((1, 32, hp, wp), generator=cuda, device="cuda").permute(0, 2, 3, 1)[0]
    coef = torch.randn((k, 32), generator=cuda, device="cuda")
    before = mc.mask_combine.launches
    out = mc.mask_combine(proto, coef)
    assert mc.mask_combine.launches == before + 1
    torch.testing.assert_close(out, mc.mask_combine_reference(proto, coef), rtol=0, atol=1e-5)


def _label_inputs(gen, k, hp, wp, H, W):
    """NCHW-view prototypes, boxes crossing the border and each other, a
    fifth of the rows invalid with NaN coefficients, rows 1 and 3 tied."""
    proto = torch.randn((1, 32, hp, wp), generator=gen, device="cuda").permute(0, 2, 3, 1)[0]
    coef = torch.randn((k, 32), generator=gen, device="cuda")
    size = torch.tensor([W, H], dtype=torch.float32, device="cuda")
    c = (torch.rand((k, 2), generator=gen, device="cuda") * 1.2 - 0.1) * size
    wh = (torch.rand((k, 2), generator=gen, device="cuda") * 0.55 + 0.05) * size
    boxes = torch.cat([c - wh / 2, c + wh / 2], 1)
    boxes[3] = boxes[1] + 5.0
    scores = torch.rand((k,), generator=gen, device="cuda") * 0.7 + 0.3
    scores[3] = scores[1]
    valid = torch.rand((k,), generator=gen, device="cuda") > 0.2
    valid[[1, 3]] = True
    coef[~valid] = float("nan")
    return proto, coef, boxes.contiguous(), torch.where(valid, scores, 0.0), valid


def _near_threshold(proto, coef, boxes, valid, out_hw, pad, thr=0.5, near=1e-5):
    """(H, W) pixels where a valid detection inside its padded box has a
    plain interpolated value within `near` of the threshold."""
    low = mc.mask_combine_reference(proto, coef)
    vals = torch.nn.functional.interpolate(low[None], size=out_hw, mode="bilinear", align_corners=False)[0]
    inside = mc.crop_threshold(torch.ones_like(low), boxes, valid, out_hw, 0.0, pad)
    return (((vals - thr).abs() <= near) & inside).any(0)


@pytest.mark.parametrize("box_pad", [0.0, 2.0])
@pytest.mark.parametrize("k, hp, wp, H, W", [(32, 96, 160, 384, 640), (5, 37, 61, 148, 244), (4, 10, 10, 7, 13),
                                             (32, 24, 80, 96, 320)])
def test_mask_label_kernel_matches_plain_version(cuda, k, hp, wp, H, W, box_pad):
    proto, coef, boxes, scores, valid = _label_inputs(cuda, k, hp, wp, H, W)
    before = mc.mask_label.launches
    out = mc.mask_label(proto, coef, boxes, scores, valid, (H, W), box_pad=box_pad)
    assert mc.mask_label.launches == before + 1
    ref = mc.mask_label_reference(proto, coef, boxes, scores, valid, (H, W), box_pad=box_pad)
    near = _near_threshold(proto, coef, boxes, valid, (H, W), box_pad)
    assert out.dtype == torch.int32 and out.shape == (H, W)
    assert not bool(((out != ref) & ~near).any())
    assert float(near.float().mean()) <= 1e-4
    # the same labels from contiguous NHWC prototypes
    assert torch.equal(out, mc.mask_label(proto.contiguous(), coef, boxes, scores, valid, (H, W), box_pad=box_pad))


@pytest.mark.parametrize("box_pad", [0.0, 2.0])
def test_mask_label_kernel_at_the_fixture_detector(cuda, box_pad):
    """Entry B at the detected-masks accuracy run's shape: the committed
    checkpoint at the dyno-KITTI fixture's 96x320 (24x80 prototypes) on its
    frame 0, where it finds nothing (no score reaches 0.05 on any fixture
    frame, on the CPU as in the JAX package): an all-background label."""
    import os

    from dynosam_tpu_torch.dataproviders.kitti import KittiDataProvider
    from dynosam_tpu_torch.nn import postprocess as pp

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "kitti_fixture")
    rgb = KittiDataProvider(root, device="cuda").frame(0).rgb
    engine = YoloV8DetectorEngine(input_hw=(96, 320), score_threshold=0.35, device="cuda")
    with torch.no_grad():
        out = engine.model(rgb[None])
        single = {k: [a[0] for a in v] if isinstance(v, list) else v[0] for k, v in out.items()}
        det = pp.nms(*pp.decode_all(single), max_detections=engine.max_detections,
                     score_threshold=engine.score_threshold, iou_threshold=engine.iou_threshold,
                     class_ids=engine.class_ids)
    proto = single["proto"]
    assert tuple(proto.shape[:2]) == (24, 80) and int(det.valid.sum()) == 0
    args = (proto, det.mcoef, det.boxes, det.scores, det.valid, (96, 320))
    got = mc.mask_label(*args, box_pad=box_pad)
    ref = mc.mask_label_reference(*args, box_pad=box_pad)
    assert torch.equal(got, ref) and not bool(got.any())


def test_mask_label_rejects_what_the_kernel_does_not_take(cuda):
    proto, coef, boxes, scores, valid = _label_inputs(cuda, 6, 24, 40, 96, 160)
    before = mc.mask_label.launches
    with pytest.raises(ValueError):         # nm = 24 is not instantiated
        mc.mask_label(proto[..., :24], coef[:, :24].contiguous(), boxes, scores, valid, (96, 160))
    with pytest.raises(ValueError):         # devices differ
        mc.mask_label(proto, coef, boxes.cpu(), scores, valid, (96, 160))
    with pytest.raises(ValueError):         # rows not on one pixel grid
        mc.mask_label(proto.transpose(0, 1), coef, boxes, scores, valid, (96, 160))
    assert mc.mask_label.launches == before


def test_detector_engine_on_the_card_matches_the_cpu(cuda):
    _, intr = detector_config()
    rgb = detector_scene(intr, 1, device="cpu").frame(0).rgb
    dets = {}
    for dev in ("cpu", "cuda"):
        launches = mc.mask_combine.launches, mc.mask_label.launches
        label, det = YoloV8DetectorEngine(device=dev).detect(rgb.to(dev))
        dets[dev] = (label.cpu(), det.valid.cpu(), det.boxes.cpu())
        if dev == "cuda":       # the label image in one launch of entry B, entry A never
            assert (mc.mask_combine.launches, mc.mask_label.launches) == (launches[0], launches[1] + 1)
    (lc, vc, bc), (lg, vg, bg) = dets["cpu"], dets["cuda"]
    assert torch.equal(vc, vg) and int(vc.sum()) > 0
    torch.testing.assert_close(bg[vg], bc[vc], rtol=0, atol=0.05)
    assert float((lg == lc).float().mean()) >= 0.999


def test_fused_step_on_the_card_matches_the_cpu(cuda):
    cfg = DynoConfig(
        frontend=FrontendParams(max_objects=4, tracker=TrackerParams(
            max_features_per_frame=128, min_features_per_frame=64,
            max_dynamic_features_per_frame=128, detection_cell_size=8,
            min_corner_response=1e-6)),
        backend=BackendParams(
            optimization_mode=2, backend_updater_enum=3, max_frames=3, max_objects=4,
            max_static_landmarks=128, max_dynamic_landmarks=128,
            optimizer=OptimizerParams(max_iterations=2)),
    )
    outs = {}
    for dev in ("cpu", "cuda"):
        # 3-frame window over 5 frames: the last two steps advance it
        scene = default_dense_scenario(num_frames=5, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        step = make_fused_step(cfg, scene.intr, gen)
        state = init_pipeline_state(cfg, dev)
        launches = (st.shi_tomasi_cell_max.launches, st.shi_tomasi_response.launches)
        xs = []
        for k in range(5):
            state, out = step(state, scene.frame(k))
            xs.append(out["X_world_cam"].cpu().numpy())
        outs[dev] = np.stack(xs)
        assert bool(state.graph.prior_valid)
        if dev == "cuda":
            assert (st.shi_tomasi_cell_max.launches, st.shi_tomasi_response.launches) == (
                launches[0] + 5, launches[1])
    # noise-free scene: RANSAC's outcome does not depend on the draws
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=1e-4)


@pytest.mark.parametrize("over", [{"backend.backend_updater_enum": 0}, {"backend.backend_updater_enum": 1},
                                  {"backend.decoupled_object_solve": False}], ids=["wcme", "wcpe", "joint"])
def test_batched_forms_on_the_card_match_the_cpu(cuda, over):
    """make_batched_pipeline with WCME, WCPE and the joint hybrid solve at
    B=2 (sequence b on frames b..b+4, a 3-frame window advanced twice) on
    the card against the same code on the CPU: the batched K1 entry
    launches once per frame for both sequences, the map entry never, and
    the camera poses agree at the unbatched fused step's bound (1e-4)."""
    import dataclasses

    from dynosam_tpu_torch.parallel.batched import make_batched_pipeline

    cfg = DynoConfig(
        frontend=FrontendParams(max_objects=4, tracker=TrackerParams(
            max_features_per_frame=128, min_features_per_frame=64,
            max_dynamic_features_per_frame=128, detection_cell_size=8,
            min_corner_response=1e-6)),
        backend=BackendParams(
            optimization_mode=2, backend_updater_enum=3, max_frames=3, max_objects=4,
            max_static_landmarks=128, max_dynamic_landmarks=128,
            optimizer=OptimizerParams(max_iterations=2)),
    ).with_overrides(over)
    B, N = 2, 5
    outs = {}
    for dev in ("cpu", "cuda"):
        scene = default_dense_scenario(num_frames=N + B - 1, device=dev)
        step, init = make_batched_pipeline(cfg, scene.intr, torch.Generator(device=dev).manual_seed(0))
        state = init(B, dev)
        launches = (st.shi_tomasi_cell_max.launches, st.shi_tomasi_response.launches)
        xs = []
        for k in range(N):
            frames = [scene.frame(k + b) for b in range(B)]
            stacked = dataclasses.replace(frames[0], **{name: torch.stack([getattr(f, name) for f in frames])
                                                        for name in frames[0].tensors()})
            state, out = step(state, stacked)
            xs.append(out["X_world_cam"].cpu().numpy())
        outs[dev] = np.stack(xs)
        assert bool(state.graph.prior_valid.all())
        if dev == "cuda":
            assert (st.shi_tomasi_cell_max.launches, st.shi_tomasi_response.launches) == (
                launches[0] + N, launches[1])
    # noise-free scene: RANSAC's outcome does not depend on the draws
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=1e-4)


def test_tracker_batch_launches_the_batched_entry_once(cuda):
    """The tracker's detection at B=8 (bench width, cell 16) is one launch
    of the kernel's blockIdx.z entry, and its per-cell results equal eight
    single-image launches bit for bit."""
    from dynosam_tpu_torch.bench_config import bench_config
    from dynosam_tpu_torch.frontend import tracker as tracker_mod
    from dynosam_tpu_torch.parallel.batched import _map_tensors

    cfg, _ = bench_config()
    B, H, W = 8, 384, 1280
    gray = torch.rand((B, H, W), generator=cuda, device="cuda")
    state = _map_tensors(lambda x: x.expand((B,) + x.shape).clone(),
                         tracker_mod.empty_tracker_state(cfg.frontend, "cuda"))
    depth = torch.full((B, H, W), 10.0, device="cuda")
    flow = torch.zeros((B, H, W, 2), device="cuda")
    mask = torch.zeros((B, H, W), dtype=torch.int32, device="cuda")
    first = torch.ones((B,), dtype=torch.bool, device="cuda")
    launches = (st.shi_tomasi_cell_max.launches, st.shi_tomasi_response.launches)
    out = tracker_mod.track_frame(state, gray, depth, flow, mask, cfg.frontend, first)
    assert (st.shi_tomasi_cell_max.launches, st.shi_tomasi_response.launches) == (
        launches[0] + 1, launches[1])
    assert out.s_uv.shape == (B, cfg.frontend.tracker.max_features_per_frame, 2)
    assert bool((out.s_valid.sum(-1) > 0).all())
    batched = st.shi_tomasi_cell_max(gray, 16)
    for b in range(B):
        one = st.shi_tomasi_cell_max(gray[b].contiguous(), 16)
        assert all(torch.equal(x[b], y) for x, y in zip(batched, one))


def test_viode_depth_is_dense_stereo_on_the_card(cuda, tmp_path):
    """A VIODE provider on the card computes its depth with
    cv/stereo.py::dense_stereo_depth there (frame_host hands it over on the
    device), equal to the same provider's on the CPU at the stereo tests'
    bound: valid maps equal, depths to 1e-6 relative."""
    from dynosam_tpu_torch.dataproviders.base import create_dataset
    from dynosam_tpu_torch.dataproviders.fixture_writers import write_viode_sequence

    scene = default_dense_scenario(num_frames=4, device="cpu")
    write_viode_sequence(scene, str(tmp_path), baseline=0.5)
    intr = {k: getattr(scene.intr, k) for k in ("fx", "fy", "cx", "cy")}
    kw = dict(intrinsics=intr, baseline=0.5, num_disparities=64)
    on_card = create_dataset(6, str(tmp_path), device="cuda", **kw)
    on_cpu = create_dataset(6, str(tmp_path), device="cpu", **kw)
    host = on_card.frame_host(2)
    assert host.depth.is_cuda and not host.rgb.is_cuda
    got, ref = on_card.frame(2).depth, on_cpu.frame(2).depth
    assert got.is_cuda
    got = got.cpu()
    assert torch.equal(got > 0, ref > 0) and (ref > 0).float().mean() > 0.2
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)


def test_training_step_on_the_card_matches_the_cpu(cuda):
    """One train_detector step at full width (384x640, two images of the
    committed pool, from the committed checkpoint, lr past the warmup): the
    loss within 1e-5 relative and every leaf after the update within
    1e-6 + 2 * lr of the CPU's (Adam's normalised step carries the whole
    relative error of a gradient element near zero), all but 0.1% of the
    elements within 1e-6."""
    import os

    from dynosam_tpu_torch import train_detector as td

    ref = np.load(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "dynosam_tpu_torch",
                               "testdata", "train_ref_6steps.npz"))
    pool = (list(ref["pool_imgs"]), list(ref["pool_masks"]), list(ref["pool_cmaps"]))
    batch = td.sample_batch(np.random.default_rng(1), *pool, 2)
    lr = 2e-3
    out = {}
    for dev in ("cpu", "cuda"):
        leaves = td.load_leaves(td.COMMITTED_CKPT, dev)
        opt = td.OptaxAdamW(leaves, lambda c: lr)
        leaves, loss = td.make_train_step(td.make_model(dev), opt)(leaves, *td.to_device(batch, dev))
        out[dev] = (float(loss), {k: v.detach().cpu() for k, v in leaves.items()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    loose = n = 0
    for k, v in out["cpu"][1].items():
        err = (out["cuda"][1][k] - v).abs()
        assert float(err.max()) <= 1e-6 + 2 * lr, k
        loose += int((err > 1e-6).sum())
        n += err.numel()
    assert loose <= 1e-3 * n, loose


def test_streaming_mode_on_the_card_matches_the_reference(cuda):
    """exp_streaming's incremental mode at the script's defaults on the card,
    the port's Scenario taking the JAX run's draws
    (testdata/streaming_ref_20f.npz): the same scored (frame, object) keys,
    every frame's pose and every scored motion within chip_smoke.py phase
    20's bounds of JAX's."""
    import os

    import chip_smoke
    from dynosam_tpu_torch import exp_streaming as es

    ref = np.load(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "dynosam_tpu_torch",
                               "testdata", chip_smoke.STREAMING_REF))
    d = es.DEFAULTS
    uniforms, normals = chip_smoke.streaming_draws(ref)
    scn = es.scenario(d["frames"], d["pixel_noise"], d["depth_noise"], "cuda", uniforms=uniforms, normals=normals)
    packets = es.noisy_packets(scn, d["init_rot_noise"], d["init_trans_noise"])
    be, _, _ = es.run_mode(2, scn, packets, d["window"], d["iters"], "cuda")
    assert be.state.X.is_cuda
    X = np.stack([be.pose_at(k) for k in range(d["frames"])])
    np.testing.assert_allclose(X, ref["2_X"], rtol=0, atol=chip_smoke.STREAMING_BOUNDS["pose_m"])
    keys = [tuple(int(x) for x in k) for k in ref["2_motion_key"]]
    assert sorted(es.motion_errors(be, scn)) == sorted(keys)
    for key, H in zip(keys, ref["2_motion_H"]):
        np.testing.assert_allclose(be.motion_at(*key), H, rtol=0, atol=chip_smoke.STREAMING_BOUNDS["motion_m"])


def test_point_sum_rounds_by_batch_size(cuda):
    """The first operation whose rows part between the batched step at B=4
    and rows 0-3 of the same step at B=8 (scripts/bisect_torch_batch.py,
    bench_config, frame 1): the camera refit's weighted point sum,
    `torch.sum(p * w, dim=-2)` over (B, 800, 3) in ops/kabsch.py::
    solve_rigid_quat. torch's CUDA reduction splits the 800 terms by a launch
    shape that depends on how many sums it makes (B x 3), so a row of a
    batch of 4 rounds otherwise than the same row of a batch of 8. Each is
    a float32 sum within 1e-5 of the float64 one, and one batch size
    repeats bit for bit: the library's rounding, not rows mixing. This is
    what parts the multi-device path's 2 ranks of B=4 from one run of B=8."""
    B, N = 8, 800
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.rand((B, N, 3), generator=gen, device="cuda")
    lo = torch.tensor([-20.0, -2.0, 4.0], device="cuda")
    hi = torch.tensor([20.0, 2.0, 60.0], device="cuda")
    p = lo + (hi - lo) * u                                   # the bench scene's range of points
    w = (torch.rand((B, N, 1), generator=gen, device="cuda") > 0.2).to(torch.float32)
    pw = p * w
    s8 = torch.sum(pw, dim=-2)
    s4 = torch.sum(pw[:4].clone(), dim=-2)
    assert torch.equal(torch.sum(pw, dim=-2), s8)
    exact = pw.double().sum(-2)
    for s, rows in ((s8[:4], exact[:4]), (s4, exact[:4])):
        assert float(((s.double() - rows).abs() / rows.abs()).max()) < 1e-5
    assert not torch.equal(s8[:4], s4), "the sums of rows 0-3 rounded alike at B=4 and B=8"
