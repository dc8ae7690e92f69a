"""The batched step's frontend modes against the JAX reference: the
detector's ByteTrack relabelling (prefer_provided_object_detection=False),
the IMU with its rotation prior (the known-rotation RANSAC) and in-loop
stereo, each through `make_batched_pipeline` over B=3 sequences of the dense
test scene, sequence b starting b frames later, through one window advance.

Each mode's run is held (a) to the reference's jitted
`make_batched_pipeline` (`jax.vmap` of the fused step) on the same frames,
and (b) sequence by sequence to the port's unbatched fused step; both
batched runs take the reference's RANSAC draws, one key per sequence
(`_init_batch`), injected stacked on the batch axis, and the unbatched runs
the same draws. ByteTrack's masks carry instance labels permuted per frame
and per sequence (`bench_config.label_permutations(0, ...)`, the smoke's
own), so its relabelling has to
restore each object's identity; the stereo frames carry the right image
rendered at +baseline and a provided depth corrupted by 1.15x, the IMU
frames the scene's 32-sample window.

Bounds. Integer, bool and id outputs are equal. Against the reference,
camera poses within 1e-4 m / rad and valid motions within 1e-3, the fused
step's parity bounds (test_torch_parallel.py). Against the unbatched step,
from the batch axis's reordering of f32 sums, measured on these frames (this
CPU, one thread), the reference's own vmapped step against its unbatched
step beside the port's batched step against its unbatched step:

    mode        poses (ref / port)    motion entries (ref / port)
    ByteTrack   8.2e-7 / 3.6e-6       6.6e-5 / 8.9e-5
    IMU         8.2e-7 / 3.6e-6       6.6e-5 / 8.9e-5
    stereo      3.5e-5 / 3.2e-5       3.9e-4 / 2.2e-4

ByteTrack and the IMU keep test_torch_parallel.py's bounds (poses 1e-5,
motions 2e-4). Stereo's LK matches move the static depths, which the window
solve amplifies in both packages (in frames 2-4, after the frontend poses
agree to 1.1e-6): its bounds are 3x the reference's spread, poses 1e-4 and
motions 1.2e-3. Against the reference the port reads at most 9.4e-6 m / rad
and 5.1e-5 (ByteTrack, IMU) and 2.6e-5 and 1.3e-4 (stereo).

The stereo mode's run is in test_torch_batched_stereo.py, so that the two
files run side by side. The per-function cases hold the batched
`greedy_assign`, `bytetrack_step`, `preintegrate` and `lk_track` against
their unbatched selves at B=3: integer and bool outputs equal (LK's pass
flags too), floats within 1e-6 (ByteTrack's Kalman state, the preintegrated
IMU) and 1e-4 px (LK's tracks, points at every image border included).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.dataproviders.synthetic_dense import default_dense_scenario as j_dense
from dynosam_tpu.parallel import batched as jbatched
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.bench_config import label_permutations
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario as t_dense
from dynosam_tpu_torch.frontend import imu as timu
from dynosam_tpu_torch.frontend.types import FrameInputs
from dynosam_tpu_torch.nn import bytetrack as tbt
from dynosam_tpu_torch.ops import lk as tlk
from dynosam_tpu_torch.parallel import batched as tbatched
from dynosam_tpu_torch.utils import lie as tlie
from torch_port_util import inject_draws, np_tree, port_cfg, reference_draws, small_cfg, t
from torch_port_util import seq_of as _seq
from torch_port_util import stack_frames as _stack_frames

torch.set_num_threads(1)
B = 3
F = 4                      # window slots
N = 5                      # frames per sequence: the last one advances the window
IMU_SAMPLES = 32
DEPTH_CORRUPTION = 1.15
REF_POSE, REF_MOTION = 1e-4, 1e-3          # against the reference (module docstring)
# batched vs unbatched, per mode (module docstring)
UNBATCHED_TOL = {"bytetrack": (1e-5, 2e-4), "imu": (1e-5, 2e-4), "stereo": (1e-4, 1.2e-3)}
MODES = {
    "bytetrack": {"frontend.tracker.prefer_provided_object_detection": False},
    "imu": {"frontend.use_imu": True, "frontend.imu.use_rotation_prior": True},
    "stereo": {},
}


def _mode_frames(mode, jd, n_scene, cfg):
    """The JAX scene's frames [k] for mode `mode`, and for ByteTrack the
    permuted masks [b][k] of sequence b's frame k."""
    out = []
    T_lr = jnp.eye(4).at[0, 3].set(float(jd.intr.baseline))
    for k in range(n_scene):
        fr = jd.frame(k)
        if mode == "stereo":
            X_r, L_k = jd.scn.X_gt[k] @ T_lr, jd._L_all[:, k]
            depth_r, mask_r = jd._depth_mask(X_r, L_k)
            fr = fr.replace(depth=fr.depth * DEPTH_CORRUPTION, right=jd._world_rgb(X_r, L_k, depth_r, mask_r))
        elif mode == "imu":
            imu, imu_valid = jd.scn.imu_window(k, IMU_SAMPLES)
            fr = fr.replace(imu_samples=imu, imu_valid=imu_valid)
        out.append(fr)
    masks = None
    if mode == "bytetrack":
        lut = label_permutations(0, N, B, 2 * cfg.frontend.max_objects)
        masks = [[lut[k, b][np.asarray(out[k + b].mask)] for k in range(N)] for b in range(B)]
    return out, masks


def _port_frame(jf, mask=None):
    names = ("frame_id", "rgb", "depth", "flow", "mask", "imu_samples", "imu_valid", "right")
    fr = FrameInputs(**{n: None if getattr(jf, n) is None else t(getattr(jf, n)) for n in names})
    return fr if mask is None else dataclasses.replace(fr, mask=t(mask))


def _run_mode(mode):
    cfg = small_cfg(max_frames=F).with_overrides(MODES[mode])
    tcfg = port_cfg(cfg)
    n_scene = N + B - 1
    textured = mode == "stereo"
    jd = j_dense(num_frames=n_scene, world_texture=textured)
    td = t_dense(num_frames=n_scene, world_texture=textured, device="cpu")
    jframes, masks = _mode_frames(mode, jd, n_scene, cfg)

    def seq_frame(k, b):
        jf = jframes[k + b]
        return jf if masks is None else jf.replace(mask=jnp.asarray(masks[b][k]))

    # the reference: one jitted vmapped program
    jstep, jinit = jbatched.make_batched_pipeline(cfg, jd.intr)
    js = jinit(B)
    draws = [reference_draws(js.frontend.key[b], cfg.frontend, N) for b in range(B)]
    jouts = []
    for k in range(N):
        fr = jax.tree.map(lambda *x: jnp.stack(x), *[seq_frame(k, b) for b in range(B)])
        js, jo = jstep(js, fr)
        jouts.append({n: np.asarray(v) for n, v in jo.items()})

    tframes = [[_port_frame(seq_frame(k, b)) for k in range(N)] for b in range(B)]
    tstep, tinit = tbatched.make_batched_pipeline(tcfg, td.intr)
    ts = convert.pipeline_state_from_numpy(np_tree(jinit(B)), "cpu", batched=True)
    touts = []
    with pytest.MonkeyPatch.context() as mp:
        queue = inject_draws(mp, [np.stack([d[i] for d in draws]) for i in range(2 * N)])
        for k in range(N):
            ts, to = tstep(ts, _stack_frames([tframes[b][k] for b in range(B)]))
            touts.append(to)
        assert not queue
        uouts = []
        for b in range(B):
            mp.undo()                     # back to the port's own sampler, then this sequence's draws
            queue = inject_draws(mp, draws[b])
            ustep = tbatched.make_fused_step(tcfg, td.intr)
            us = tbatched.init_pipeline_state(tcfg, "cpu")
            seq = []
            for k in range(N):
                us, uo = ustep(us, tframes[b][k])
                seq.append(uo)
            uouts.append(seq)
            assert not queue
    return dict(jouts=jouts, touts=touts, uouts=uouts, ts=ts, js=js, td=td, tframes=tframes)


@pytest.fixture(scope="module", params=["bytetrack", "imu"])
def run(request):
    return request.param, _run_mode(request.param)


def _rot_trans(A, B_):
    dR = torch.as_tensor(np.swapaxes(A[..., :3, :3], -1, -2) @ B_[..., :3, :3])
    rot = torch.linalg.norm(tlie.so3_log(dR), dim=-1).numpy()
    return rot, np.linalg.norm(A[..., :3, 3] - B_[..., :3, 3], axis=-1)


def check_matches_reference(mode, r):
    """(a) The port's batched step against jax.jit(make_batched_pipeline):
    poses within 1e-4 m / rad, object ids and motion validity equal, valid
    motions within 1e-3; the tracks equal, their static depths (stereo's)
    within the fused step's bounds; ByteTrack's ids persist through the
    permuted labels, the IMU's velocities agree."""
    n_valid = 0
    for k, (jo, to) in enumerate(zip(r["jouts"], r["touts"])):
        for key in ("X_world_cam", "frontend_pose"):
            rot, trans = _rot_trans(to[key].numpy(), jo[key])
            assert trans.max() < REF_POSE and rot.max() < REF_POSE, (mode, k, key, trans, rot)
        np.testing.assert_array_equal(to["object_ids"].numpy(), jo["object_ids"])
        v = jo["object_motion_valid"]
        np.testing.assert_array_equal(to["object_motion_valid"].numpy(), v)
        np.testing.assert_allclose(to["object_motions"].numpy()[v], jo["object_motions"][v], atol=REF_MOTION)
        n_valid += int(v.sum())
    assert n_valid > 0
    assert r["ts"].graph.num_frames == F and bool(r["ts"].graph.prior_valid.all())
    ref, got = np_tree(r["js"]), convert.pipeline_state_to_numpy(r["ts"], batched=True)
    trk_r, trk_g = ref["frontend"]["tracker"], got["frontend"]["tracker"]
    for name in ("s_valid", "s_tid", "d_valid", "d_tid", "d_oid", "obj_ids"):
        np.testing.assert_array_equal(trk_g[name], trk_r[name], err_msg=name)
    v = trk_r["s_valid"]
    np.testing.assert_allclose(trk_g["s_depth"][v], trk_r["s_depth"][v], rtol=1e-4, atol=2e-3)
    if mode == "bytetrack":
        for name in ("track_id", "active", "time_lost", "next_id"):
            np.testing.assert_array_equal(trk_g["bt_state"][name], trk_r["bt_state"][name], err_msg=name)
        # the two objects keep their first ids in every sequence, whatever
        # labels the masks gave them
        ids = np.stack([jo["object_ids"] for jo in r["jouts"]])
        for b in range(B):
            assert set(ids[:, b].ravel()) - {-1} == {1, 2}, ids[:, b]
    if mode == "imu":
        np.testing.assert_allclose(r["ts"].frontend.v_world.numpy(), np.asarray(r["js"].frontend.v_world),
                                   atol=1e-5)


def check_equals_unbatched(mode, r):
    """(b) Sequence b of the batch equals the unbatched step run alone on
    the same frames with the same draws (UNBATCHED_TOL)."""
    pose_tol, motion_tol = UNBATCHED_TOL[mode]
    for b in range(B):
        for k in range(N):
            out_b, uo = _seq(r["touts"][k], b), r["uouts"][b][k]
            where = f"{mode} seq {b} frame {k}"
            for key in ("object_ids", "object_motion_valid"):
                np.testing.assert_array_equal(out_b[key].numpy(), uo[key].numpy(), err_msg=f"{where} {key}")
            for key in ("X_world_cam", "frontend_pose"):
                err = float((out_b[key] - uo[key]).abs().max())
                assert err <= pose_tol, (where, key, err)
            err = float((out_b["object_motions"] - uo["object_motions"]).abs().max())
            assert err <= motion_tol, (where, err)


def test_batched_mode_matches_reference(run):
    check_matches_reference(*run)


def test_batched_mode_equals_unbatched_runs(run):
    check_equals_unbatched(*run)


# ---------------------------------------------------------------------------
# Per-function: each batched function against its unbatched self
# ---------------------------------------------------------------------------

def _rand_boxes(rng, shape):
    xy = rng.uniform(0.0, 100.0, shape + (2,))
    wh = rng.uniform(5.0, 40.0, shape + (2,))
    return torch.as_tensor(np.concatenate([xy, xy + wh], -1), dtype=torch.float32)


def _case_greedy_assign(rng):
    T, D = 6, 5
    cost = torch.as_tensor(rng.uniform(0.0, 1.0, (B, T, D)), dtype=torch.float32)
    cost[1, 2, :] = cost[1, 2, 0]              # ties: the first index wins
    row_ok = torch.as_tensor(rng.uniform(size=(B, T)) < 0.8)
    col_ok = torch.as_tensor(rng.uniform(size=(B, D)) < 0.8)
    r2c, c2r = tbt.greedy_assign(cost, row_ok, col_ok, 0.3, iters=min(T, D))
    for b in range(B):
        r1, c1 = tbt.greedy_assign(cost[b], row_ok[b], col_ok[b], 0.3, iters=min(T, D))
        assert torch.equal(r2c[b], r1) and torch.equal(c2r[b], c1), b
    # one pair for the whole batch would leave the other sequences unmatched
    assert bool((r2c >= 0).sum(-1).min() >= 2)


def _case_bytetrack_step(rng):
    T, D = 8, 6
    state = tbt.empty_state(T, device="cpu")
    batch = tbatched._map_tensors(lambda x: x.expand((B,) + x.shape).clone(), state)
    singles = [state] * B
    base = _rand_boxes(rng, (B, D))
    for step in range(4):
        boxes = base + step * torch.as_tensor(rng.uniform(0.0, 3.0, (B, D, 1)), dtype=torch.float32)
        # each sequence sees its own detections, in its own order
        perm = torch.as_tensor(np.stack([rng.permutation(D) for _ in range(B)]))
        boxes = torch.take_along_dim(boxes, perm[..., None], dim=1)
        score = torch.as_tensor(rng.uniform(0.05, 1.0, (B, D)), dtype=torch.float32)
        valid = torch.as_tensor(rng.uniform(size=(B, D)) < 0.85)
        batch, ids = tbt.bytetrack_step(batch, boxes, score, valid)
        for b in range(B):
            singles[b], ids_b = tbt.bytetrack_step(singles[b], boxes[b], score[b], valid[b])
            assert torch.equal(ids[b], ids_b), (step, b)
            got = _seq(batch, b)
            for f in dataclasses.fields(tbt.ByteTrackState):
                g, r = getattr(got, f.name), getattr(singles[b], f.name)
                if g.is_floating_point():
                    assert float((g - r).abs().max()) <= 1e-6 * max(float(r.abs().max()), 1.0), f.name
                else:
                    assert torch.equal(g, r), (step, b, f.name)
    assert len({int(x) for x in batch.next_id}) > 1       # the sequences spawned differently
    masks = torch.as_tensor(rng.integers(0, 5, (B, 24, 32)), dtype=torch.int32)
    got = tbt.masks_to_detections(masks, max_dets=6)
    for b in range(B):
        for g, r in zip(got, tbt.masks_to_detections(masks[b], max_dets=6)):
            assert torch.equal(g[b], r)


def _case_preintegrate(rng):
    S = 16
    samples = np.concatenate([rng.uniform(0.001, 0.01, (B, S, 1)), rng.normal(0.0, 2.0, (B, S, 3)),
                              rng.normal(0.0, 0.5, (B, S, 3))], -1)
    samples = torch.as_tensor(samples, dtype=torch.float32)
    valid = torch.as_tensor(np.arange(S)[None] < np.array([[S], [S - 3], [5]]))
    params = timu.ImuParams.create(accel_bias=(0.1, 0.0, -0.05), gyro_bias=(0.0, 0.01, 0.0), device="cpu")
    X = tlie.se3_exp(torch.as_tensor(rng.normal(0.0, 0.3, (B, 6)), dtype=torch.float32))
    v = torch.as_tensor(rng.normal(0.0, 1.0, (B, 3)), dtype=torch.float32)
    pim = timu.preintegrate(samples, valid, params)
    X_p, v_p = timu.predict(X, v, pim, params)
    assert pim.dt.shape == (B,)
    for b in range(B):
        one = timu.preintegrate(samples[b], valid[b], params)
        X1, v1 = timu.predict(X[b], v[b], one, params)
        for g, r in ((pim.dR[b], one.dR), (pim.dv[b], one.dv), (pim.dp[b], one.dp), (pim.dt[b], one.dt),
                     (X_p[b], X1), (v_p[b], v1), (timu.rotation_prior(pim)[b], timu.rotation_prior(one))):
            assert float((g - r).abs().max()) <= 1e-6, b


def _case_lk_track(rng):
    td = t_dense(num_frames=B + 1, world_texture=True, device="cpu")
    H, W = td.intr.height, td.intr.width
    gray = [0.299 * f.rgb[..., 0] + 0.587 * f.rgb[..., 1] + 0.114 * f.rgb[..., 2]
            for f in (td.frame(k) for k in range(B + 1))]
    g0, g1 = torch.stack(gray[:B]), torch.stack(gray[1:])
    n = 48
    uv = np.stack([rng.uniform(0.0, W - 1.0, (B, n)), rng.uniform(0.0, H - 1.0, (B, n))], -1)
    # points on every border: the strip windows clamp per image width
    uv[:, :4] = [[0.0, 0.0], [W - 1.0, 0.0], [0.0, H - 1.0], [W - 1.0, H - 1.0]]
    uv[:, 4:8, 0] = [1.5, 2.5, W - 2.5, W - 1.5]
    uv = torch.as_tensor(uv, dtype=torch.float32)
    valid = torch.as_tensor(rng.uniform(size=(B, n)) < 0.9)
    uv1, ok = tlk.lk_track(g0, g1, uv, valid, levels=3, half=3, iters=8)
    n_ok = 0
    for b in range(B):
        u1, o1 = tlk.lk_track(g0[b], g1[b], uv[b], valid[b], levels=3, half=3, iters=8)
        both = ok[b] & o1
        assert float((uv1[b] - u1)[both].abs().max()) <= 1e-4, b
        assert int((ok[b] != o1).sum()) == 0, b
        n_ok += int(both.sum())
    assert n_ok >= 30                          # 49 of the 144 on these frames


@pytest.mark.parametrize("case", ["greedy_assign", "bytetrack_step", "preintegrate", "lk_track"])
def test_batched_function_equals_unbatched(case):
    """(c) Each batched function against its unbatched self at B=3 (bounds
    in the module docstring)."""
    globals()[f"_case_{case}"](np.random.default_rng(1))
