"""Where the rich fixture's frontend parts from JAX's on identical draws
(dynosam_tpu_torch/testdata/rich_frontend_ref_100f.npz, written by
scripts/make_torch_smoke_reference.py --only rich_frontend).

The frontend alone over the 100-frame rich fixture, JAX under PRNGKey(0)
and the port on the CPU with those draws, agrees frame by frame (camera
within 2e-5 m, valid slots' motions within 1e-3) until frame 32, where
object 4 re-enters after its first deep occlusion as a single column of
19 collinear points: the yaw about that line is unobservable, and the
three-point Kabsch of RANSAC's hypothesis 0 (every hypothesis holds all 19
points) and Horn's refit take whichever of two yaws 180 degrees apart the
last f32 bits favour. These tests hold that on the saved inputs of
solve_all_object_motions at that frame: given the same inputs JAX and the
port take the same branch, JAX's own inputs give JAX's branch and the
port's give the port's, and a one-ulp change of one sample point moves
JAX itself to the port's branch. It is a near-tie both sides decide, not
a different function."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.config import DynoConfig
from dynosam_tpu.cv import camera as jcam
from dynosam_tpu.frontend import motion as jmotion
from dynosam_tpu_torch.bench_config import RICH_MIN_AREA, kitti_accuracy_config
from dynosam_tpu_torch.cv import camera as tcam
from dynosam_tpu_torch.frontend import motion as tmotion

torch.set_num_threads(1)
REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "dynosam_tpu_torch", "testdata",
                   "rich_frontend_ref_100f.npz")
ARGS = ("object_ids", "track_object_ids", "pts_world_prev", "uv_k", "pts_world_k", "track_valid", "X_k")
ARRAYS = ("pts_world_prev", "pts_world_k")


@pytest.fixture(scope="module")
def rich():
    z = dict(np.load(REF))
    pcfg = kitti_accuracy_config("incremental", 100, 0, min_observable_mask_area=RICH_MIN_AREA).normalized()
    jcfg = DynoConfig.from_dict(dataclasses.asdict(pcfg)).normalized()
    fx, fy, cx, cy, w, h, bl = z["intr"]
    jintr = jcam.CameraIntrinsics.create(fx, fy, cx, cy, width=int(w), height=int(h), baseline=bl)
    tintr = tcam.CameraIntrinsics.create(fx, fy, cx, cy, width=int(w), height=int(h), baseline=bl)
    key = jnp.asarray(z["obj_key"])
    fp = jcfg.frontend
    shape = (fp.motion_solver.object.num_hypotheses(), fp.tracker.max_dynamic_features_per_frame)
    uniforms = torch.from_numpy(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
        jax.random.split(key, fp.max_objects))))
    jsolve = jax.jit(lambda k, *a: jmotion.solve_all_object_motions(k, *a, jintr, fp.motion_solver))

    def jax_solve(ins):
        r = jsolve(key, *[jnp.asarray(ins[n]) for n in ARGS])
        return np.asarray(r.pose), np.asarray(r.valid), np.asarray(r.num_inliers)

    def port_solve(ins):
        r = tmotion.solve_all_object_motions(None, *[torch.from_numpy(np.asarray(ins[n])) for n in ARGS], tintr,
                                             pcfg.frontend.motion_solver, uniforms=uniforms)
        return r.pose.numpy(), r.valid.numpy(), r.num_inliers.numpy()

    inputs = {side: {n: z[f"{side}_{n}"] for n in ARGS} for side in ("jax", "port")}
    return {"z": z, "jax": jax_solve, "port": port_solve, "inputs": inputs, "slot": int(z["part_slot"])}


def test_draws_are_consumed_in_jaxs_order_and_the_frontends_agree_before_the_parting(rich):
    """Two draws (camera, objects) per frame, none left after 100 frames;
    before the parting frame the camera within 2e-5 m, the same valid
    slots, their motions within 1e-3."""
    z = rich["z"]
    f = int(z["part_frame"])
    np.testing.assert_array_equal(z["draws_left"], 2 * (99 - np.arange(100)))
    assert f == 32 and rich["slot"] == 3 and int(z["object_ids"][f, rich["slot"]]) == 4
    assert z["cam_diff_m"][: f + 1].max() < 2e-5
    np.testing.assert_array_equal(z["valid_jax"][:f], z["valid_port"][:f])
    both = z["valid_jax"][:f] & z["valid_port"][:f]
    assert z["motion_diff"][:f][both].max() < 1e-3
    # the saved inputs of both sides differ by f32 noise only
    for n in ("object_ids", "track_object_ids", "track_valid"):
        np.testing.assert_array_equal(rich["inputs"]["jax"][n], rich["inputs"]["port"][n])
    for n, tol in (("pts_world_prev", 2e-5), ("pts_world_k", 2e-5), ("uv_k", 1e-3), ("X_k", 2e-5)):
        np.testing.assert_allclose(rich["inputs"]["port"][n], rich["inputs"]["jax"][n], rtol=0, atol=tol)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_equal_inputs_give_equal_branches(rich, side):
    """On either side's inputs, JAX and the port agree (valid slots' motions
    within 1e-3, inlier counts and validity equal), and each side's own
    inputs give the branch that side took in its run."""
    ins = rich["inputs"][side]
    jp, jv, jn = rich["jax"](ins)
    tp, tv, tn = rich["port"](ins)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(jn, tn)
    np.testing.assert_allclose(tp[jv], jp[jv], rtol=0, atol=1e-3)
    s = rich["slot"]
    taken = rich["z"][f"{side}_H"][s]
    assert np.sign(jp[s, 0, 0]) == np.sign(taken[0, 0])
    np.testing.assert_allclose(jp[s], taken, rtol=0, atol=1e-2)
    assert np.sign(rich["z"]["jax_H"][s, 0, 0]) != np.sign(rich["z"]["port_H"][s, 0, 0])


def test_the_parting_slot_is_a_line_of_points(rich):
    """The slot's 19 correspondences are collinear (second singular value
    under 1e-5 of the first), so Horn's quaternion matrix has a double top
    eigenvalue: the yaw about the line is unobservable."""
    ins = rich["inputs"]["jax"]
    oid = ins["object_ids"][rich["slot"]]
    rows = ins["track_valid"] & (ins["track_object_ids"] == oid)
    assert rows.sum() == 19
    p = ins["pts_world_prev"][rows].astype(np.float64)
    q = ins["pts_world_k"][rows].astype(np.float64)
    sv = np.linalg.svd(p - p.mean(0), compute_uv=False)
    assert sv[1] < 1e-5 * sv[0]
    S = (p - p.mean(0)).T @ (q - q.mean(0))
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = S
    N = np.array([[sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
                  [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
                  [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
                  [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]])
    ev = np.linalg.eigvalsh(N)
    assert ev[-1] - ev[-2] < 1e-6 * ev[-1]


@pytest.mark.parametrize("flip", range(7))
def test_one_ulp_moves_jax_to_the_ports_branch(rich, flip):
    """One coordinate of one of hypothesis 0's sample points moved by one
    f32 ulp in JAX's own inputs: JAX takes the port's branch (and the port,
    which found these changes, takes it too)."""
    flips = rich["z"]["ulp_flips"]
    assert len(flips) == 7
    arr, row, coord, direction = (int(v) for v in flips[flip])
    ins = dict(rich["inputs"]["jax"])
    a = ins[ARRAYS[arr]].copy()
    a[row, coord] = np.nextafter(a[row, coord], np.float32(direction * np.inf))
    assert a[row, coord] != ins[ARRAYS[arr]][row, coord]
    ins[ARRAYS[arr]] = a
    s = rich["slot"]
    port_branch = np.sign(rich["z"]["port_H"][s, 0, 0])
    assert np.sign(rich["jax"](ins)[0][s, 0, 0]) == port_branch
    assert np.sign(rich["port"](ins)[0][s, 0, 0]) == port_branch
