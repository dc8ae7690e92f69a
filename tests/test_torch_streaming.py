"""The port of scripts/exp_streaming.py (dynosam_tpu_torch/exp_streaming.py)
against the script itself, on the CPU at 10 frames, a 4-frame window and 3
LM iterations.

The script runs as it is, in a subprocess under JAX_PLATFORMS=cpu
(make_torch_smoke_reference.py streaming_run: its printed lines, its
Scenario's draws, the packets its backends took, and each mode's poses and
scored motions recorded). The port's Scenario takes the reference's
landmark uniforms and noise normals (torch_port_util scenario_uniforms /
scenario_normals), so both sides see the same scene:

  * packets: valid flags equal; uv and depth equal where the ground-truth
    pose chains agree bit for bit, otherwise within a few float32 roundings
    of the projection: uv on the valid tracks within PACKET_UV_PX (3.1e-5
    px read; the invalid ones, behind or near the camera plane, amplify the
    chains' ulps to 1.2e-2 px here and are masked everywhere), depth within
    PACKET_DEPTH_M (9.5e-7 m read); the perturbed initial poses, odometry
    and motions (lie.retract in torch against JAX's, both float32) within
    PACKET_POSE (1.9e-6 read);
  * each mode's run: the same scored (frame, object) keys, every frame's
    pose and every scored motion within POSE_M / MOTION_M;
  * main(): the same lines, each number within SUMMARY_CM / SUMMARY_RAD
    and the motion counts equal.

Why not closer: on identical packets the windowed modes land ~2e-4 m from
JAX (sliding-window 2.03e-4 m here). Every optimize ends at the float32
error floor of its LM (at the defaults' frame 1 the camera phase's error is
~662, one ulp 6.1e-5, and its last accept / reject decisions compare
candidates a few ulps apart, where the two packages' error sums differ by
that much), and the windowed modes carry each such tail forward. One ulp
on one of JAX's own input fields moves one optimize by more than the port
differs from it (frame 1: 2.4e-6 against 6.0e-7 m here, 2.5e-5 against
2.3e-5 m at the defaults; test_lm_tail_is_float32_rounding_noise), and one
ulp on one frame's depths moves JAX's whole run by more than the port
differs from it (2.09e-4 against 2.03e-4 m;
test_whole_run_moves_with_one_ulp_of_input). The printed rotation error is
arccos of a float32 trace near 1, which resolves ~2e-5 rad.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dynosam_tpu_torch import exp_streaming as es
from dynosam_tpu_torch.dataproviders import simulator as tsim
from torch_port_util import np_tree, scenario_normals, scenario_uniforms, to_port

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, WINDOW, ITERS = 10, 4, 3
ARGV = ["--frames", str(FRAMES), "--window", str(WINDOW), "--iters", str(ITERS)]
PACKET_UV_PX = 1e-4
PACKET_DEPTH_M = 1e-5
PACKET_POSE = 1e-5
# the runs, ~7-10x the readings on this CPU: poses 2.5e-5 (full-batch),
# 2.3e-4 (sliding-window), 2.9e-4 m (incremental); motions 5.4e-5, 2.9e-5,
# 1.8e-5
POSE_M = 2e-3
MOTION_M = 5e-4
# the printed numbers, ~5x the readings: ATE 0.019 cm, AME 0.001 cm,
# rotation 9e-5 rad
SUMMARY_CM = 0.1
SUMMARY_RAD = 5e-4


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The script's run at ARGV, recorded in a subprocess."""
    out = str(tmp_path_factory.mktemp("streaming") / "ref.npz")
    code = ("import sys; sys.path.insert(0, 'scripts'); import make_torch_smoke_reference as m; "
            f"m.streaming_reference({out!r}, {ARGV!r})")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, capture_output=True, timeout=600)
    return dict(np.load(out))


def _draws(spec):
    return scenario_uniforms(spec), scenario_normals(spec, spec.num_frames)


def _jax_spec():
    from dynosam_tpu.dataproviders.simulator import ScenarioSpec

    return ScenarioSpec.default_two_objects(num_frames=FRAMES, pixel_noise=0.4, depth_noise=0.02, seed=es.SCENE_SEED)


def _jax_sliding_window():
    """The script's sliding-window backend, built from the JAX package, and
    the JAX Scenario it runs on."""
    from dynosam_tpu.backend.backend import RegularBackend as JaxBackend
    from dynosam_tpu.config import BackendParams, NoiseParams, OptimizerParams
    from dynosam_tpu.dataproviders.simulator import Scenario as JaxScenario

    jscn = JaxScenario(_jax_spec())
    cfg = BackendParams(optimization_mode=1, backend_updater_enum=3, max_frames=WINDOW, max_objects=es.MAX_OBJ,
                        max_static_landmarks=256, max_dynamic_landmarks=96,
                        noise=NoiseParams(use_range_dependent_noise=False),
                        optimizer=OptimizerParams(max_iterations=ITERS))
    return (lambda: JaxBackend(cfg, jscn.intr)), jscn


@pytest.fixture(scope="module")
def port():
    """The port's scene (the reference's draws) and its noisy packets."""
    u, n = _draws(_jax_spec())
    scn = es.scenario(FRAMES, 0.4, 0.02, "cpu", uniforms=u, normals=n)
    return scn, es.noisy_packets(scn, 0.01, 0.05)


def test_reference_draws_are_the_scripts(ref):
    u, n = _draws(_jax_spec())
    np.testing.assert_array_equal(ref["uniforms_static"], u["static"])
    np.testing.assert_array_equal(ref["normals_static_pixel"], n["static"][0])
    np.testing.assert_array_equal(ref["normals_objects_depth"], np.stack([d for _, d in n["objects"]]))
    assert list(ref["modes"]) == [0, 1, 2] and list(ref["args"]) == [FRAMES, WINDOW, ITERS]


def test_packets_match_reference(ref, port):
    _, packets = port
    for k, p in enumerate(packets):
        for table in ("static", "dynamic"):
            tt = getattr(p, f"{table}_tracks")
            np.testing.assert_array_equal(tt.valid.numpy(), ref[f"packet_{table}_valid"][k])
            valid = ref[f"packet_{table}_valid"][k]
            np.testing.assert_allclose(tt.uv.numpy()[valid], ref[f"packet_{table}_uv"][k][valid], rtol=0,
                                       atol=PACKET_UV_PX, err_msg=f"{k} {table} uv")
            np.testing.assert_allclose(tt.depth.numpy(), ref[f"packet_{table}_depth"][k], rtol=0,
                                       atol=PACKET_DEPTH_M, err_msg=f"{k} {table} depth")
        for name, key in (("X_world_cam", "packet_X"), ("odom_prev_curr", "packet_odom"),
                          ("object_motions", "packet_motions")):
            np.testing.assert_allclose(getattr(p, name).numpy(), ref[key][k], rtol=0, atol=PACKET_POSE,
                                       err_msg=f"{k} {name}")
    # frame 0's pose and odometry are exact, the motions perturbed
    np.testing.assert_array_equal(packets[0].X_world_cam.numpy(), np.eye(4, dtype=np.float32))
    assert not np.allclose(packets[0].object_motions.numpy(), np.eye(4), atol=1e-3)


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["full_batch", "sliding_window", "incremental"])
def test_mode_matches_reference(ref, port, mode):
    scn, packets = port
    be, step_s, _ = es.run_mode(mode, scn, packets, WINDOW, ITERS, "cpu")
    assert len(step_s) == FRAMES
    X = np.stack([be.pose_at(k) for k in range(FRAMES)])
    np.testing.assert_allclose(X, ref[f"{mode}_X"], rtol=0, atol=POSE_M)
    me = es.motion_errors(be, scn)
    keys = [tuple(k) for k in ref[f"{mode}_motion_key"]]
    assert sorted(me) == sorted(keys) and len(keys) == 16
    for key, H, err in zip(keys, ref[f"{mode}_motion_H"], ref[f"{mode}_motion_err"]):
        np.testing.assert_allclose(be.motion_at(*key), H, rtol=0, atol=MOTION_M, err_msg=str(key))
        assert abs(me[key][0] - err[0]) <= MOTION_M, key


def _numbers(line):
    return [float(x) for x in line.replace("[", " ").replace("=", " ").split() if _is_number(x)]


def _is_number(x):
    try:
        float(x)
        return True
    except ValueError:
        return False


def test_main_prints_the_scripts_lines(ref, monkeypatch, capsys):
    u, n = _draws(_jax_spec())
    orig = es.scenario
    monkeypatch.setattr(es, "scenario", lambda *a, **kw: orig(*a, uniforms=u, normals=n, **kw))
    results = es.main(ARGV + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    want = list(ref["lines"])
    assert sorted(results) == [0, 1, 2] and len(got) == len(want) == 3 + 2 * (FRAMES + 1)
    for g, w in zip(got, want):
        # the same text around the numbers
        assert [x for x in g.split() if not _is_number(x)] == [x for x in w.split() if not _is_number(x)], (g, w)
        a, b = _numbers(g), _numbers(w)
        assert len(a) == len(b), (g, w)
        if g.startswith("mode="):
            mode, ate, rms, med, rot, count = a
            assert mode == b[0] and count == b[5] == 16, (g, w)
            np.testing.assert_allclose([ate, rms, med], b[1:4], rtol=0, atol=SUMMARY_CM, err_msg=g)
            assert abs(rot - b[4]) <= SUMMARY_RAD, (g, w)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=SUMMARY_CM, err_msg=g)
    # the same cells are scored ("----" where a motion is missing)
    assert [g.count("----") for g in got] == [w.count("----") for w in want]


def test_lm_tail_is_float32_rounding_noise():
    """Sliding-window, frame 1, on JAX's own state before the optimize: the
    port's optimize differs from JAX's by d; one ulp up or down on every
    nonzero entry of one of JAX's float input fields (poses, measurements,
    depths) moves JAX's own camera poses by more than d."""
    import jax

    from dynosam_tpu_torch.backend import graph as pgraph
    from dynosam_tpu_torch.backend import hybrid as phybrid

    new_backend, jscn = _jax_sliding_window()
    jb = new_backend()
    opt, seen = jb._jit_optimize, []
    jb._jit_optimize = lambda st: (seen.append(st), opt(st))[1]
    for k in range(2):
        jb.step(jscn.measurements(k, es.MAX_OBJ))
    jst = seen[1]
    tree = {name: v for name, v in np_tree(jst).items() if isinstance(v, np.ndarray)}
    nf = int(tree["num_frames"])
    pcfg = es.backend_config(1, FRAMES, WINDOW, ITERS)
    st = pgraph.empty_graph(pcfg, "cpu")
    st = dataclasses.replace(st, num_frames=nf, **{
        name: torch.from_numpy(v.copy()) for name, v in tree.items()
        if name != "num_frames" and isinstance(getattr(st, name, None), torch.Tensor)})

    def cam(X):
        return np.asarray(X)[:nf, :3, 3]

    base = cam(opt(jst).X)
    d = float(np.abs(cam(phybrid.optimize(st, pcfg).X) - base).max())
    assert d > 0
    moved = 0.0
    for name in ("X", "ms", "s_z"):
        for to in (np.inf, -np.inf):
            a = np.array(tree[name])
            a[a != 0] = np.nextafter(a[a != 0], np.float32(to))
            moved = max(moved, float(np.abs(cam(opt(jst.replace(**{name: jax.numpy.asarray(a)})).X) - base).max()))
    assert moved > d, (moved, d)


def test_whole_run_moves_with_one_ulp_of_input(ref, port):
    """Sliding-window over the reference's own packets: one ulp up or down
    on frame 1's static depths moves JAX's own poses further than the
    port's run on the same packets lands from JAX's."""
    import jax.numpy as jnp

    from dynosam_tpu_torch.frontend.types import VisionPacket

    new_backend, jscn = _jax_sliding_window()
    # the script's packets, rebuilt from the recorded ones

    jp = []
    for k in range(FRAMES):
        p = jscn.measurements(k, es.MAX_OBJ)
        p = p.replace(X_world_cam=jnp.asarray(ref["packet_X"][k]), odom_prev_curr=jnp.asarray(ref["packet_odom"][k]),
                      object_motions=jnp.asarray(ref["packet_motions"][k]))
        np.testing.assert_array_equal(np.asarray(p.static_tracks.depth), ref["packet_static_depth"][k])
        jp.append(p)

    def jrun(packets):
        be = new_backend()
        for p in packets:
            be.step(p)
        be.finalize_matured()
        return np.stack([np.asarray(be.pose_at(k)) for k in range(FRAMES)])

    base = jrun(jp)
    scn, _ = port
    be, _, _ = es.run_mode(1, scn, [to_port(VisionPacket, p) for p in jp], WINDOW, ITERS, "cpu")
    d = float(np.abs(np.stack([be.pose_at(k) for k in range(FRAMES)]) - base).max())
    moved = 0.0
    for to in (np.inf, -np.inf):
        nudged = list(jp)
        st = nudged[1].static_tracks
        a = np.array(st.depth)
        a[a != 0] = np.nextafter(a[a != 0], np.float32(to))
        nudged[1] = nudged[1].replace(static_tracks=st.replace(depth=jnp.asarray(a)))
        moved = max(moved, float(np.abs(jrun(nudged) - base).max()))
    assert moved > d > 0, (moved, d)


def test_default_draws_are_unchanged_without_normals():
    """normals= left out: the port draws from its own generator as before
    (per frame seeded with seed * 1_000_003 + k: static pixel, static depth,
    then each object's pixel and depth); the same normals given explicitly
    make the same packets."""
    spec = tsim.ScenarioSpec.default_two_objects(num_frames=3, pixel_noise=0.4, depth_noise=0.02, seed=5)
    own = tsim.Scenario(spec, device="cpu")
    blocks = [spec.num_static] + [o.num_points for o in spec.objects]
    px = {b: [] for b in range(len(blocks))}
    dd = {b: [] for b in range(len(blocks))}
    for k in range(3):
        gen = torch.Generator().manual_seed(spec.seed * 1_000_003 + k)
        for b, nb in enumerate(blocks):
            px[b].append(torch.randn((nb, 2), generator=gen).numpy())
            dd[b].append(torch.randn((nb,), generator=gen).numpy())
    pairs = [(np.stack(px[b]), np.stack(dd[b])) for b in range(len(blocks))]
    given = tsim.Scenario(spec, device="cpu", normals={"static": pairs[0], "objects": pairs[1:]})
    for k in range(3):
        a, b = own.measurements(k, 4), given.measurements(k, 4)
        for table in ("static_tracks", "dynamic_tracks"):
            for f in ("uv", "depth", "valid"):
                assert torch.equal(getattr(getattr(a, table), f), getattr(getattr(b, table), f)), (k, table, f)
    # and the noise is there: the noise-free scene projects elsewhere
    clean = tsim.Scenario(dataclasses.replace(spec, pixel_noise_sigma=0.0, depth_noise_sigma=0.0), device="cpu")
    assert not torch.equal(clean.measurements(1, 4).static_tracks.uv, own.measurements(1, 4).static_tracks.uv)
