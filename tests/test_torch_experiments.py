"""Parity of the port's experiment runner (dynosam_tpu_torch/run_experiments.py)
with scripts/run_experiments.py, on the CPU: two cells of the committed JAX
sweep over the fixture (dynosam_tpu_torch/testdata/experiments_ref_10f/,
make_torch_smoke_reference.py --only experiments) through the port's main
with JAX seed 0's RANSAC draws injected, against seed 0's rows; the
configuration against the reference's make_config; timing_summary against
the reference's on a CSV of unequal columns; the synthetic: kind; and where
the CLI writes by default.

The two sliding-window cells (WCME, WCPE) run a damped Gauss-Newton of ten
iterations that accepts every finite step. On WCME's second frame and
WCPE's third, the reduced system of that step is cond ~1e11 in float64,
where both packages compute the same matrix; in float32 each package's
matrix is off its float64 one by a third of its own size or more, and
indefinite. The step taken there is rounding noise on both sides: a
one-ulp change of JAX's input moves JAX's own result by more than the
port differs from JAX on the same input. So those two cells are held to
JAX seed 0 on the same draws within wider stated bounds (CELL_TOL), and
test_sliding_window_step_is_float32_rounding_noise shows why."""

import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from dynosam_tpu.config import DynoConfig
from dynosam_tpu_torch import run_experiments as rx
from torch_port_util import inject_draws, np_tree, reference_draws, xla_cholesky

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "kitti_fixture")
REF = os.path.join(ROOT, "dynosam_tpu_torch", "testdata", "experiments_ref_10f", "seed0.npz")
FRAMES = 10
# |port - JAX seed 0| per field on the same draws: hybrid and WCPE batch
# read within 1e-5 m (ATE, RPE) / 1.6e-4 rad / 6e-5 m (AME) on this CPU
TOL = {"ate_trans_rmse": 2e-5, "ate_rot_rmse": 5e-4, "rpe_trans_rmse": 2e-5, "ame_trans_rmse": 2e-4,
       "ame_trans_median": 2e-4}
# The sliding-window cells, with XLA's Cholesky in the port as in JAX: on
# this CPU WCME read 1.93e-5 m, 4.66e-3 rad, 1.98e-5 m, 2.72e-3 m, 5.15e-3 m
# and WCPE 1.32e-4 m, 2.25e-2 rad, 4.83e-4 m, 5.02e-3 m, 6.67e-3 m off JAX
# seed 0 (module docstring); the bounds are about twice that.
CELL_TOL = {
    "wcme_sliding": {"ate_trans_rmse": 4e-5, "ate_rot_rmse": 1e-2, "rpe_trans_rmse": 4e-5, "ame_trans_rmse": 6e-3,
                     "ame_trans_median": 1e-2},
    "wcpe_sliding": {"ate_trans_rmse": 3e-4, "ate_rot_rmse": 5e-2, "rpe_trans_rmse": 1e-3, "ame_trans_rmse": 1e-2,
                     "ame_trans_median": 1.5e-2},
}


def _reference():
    spec = importlib.util.spec_from_file_location("ref_run_experiments",
                                                  os.path.join(ROOT, "scripts", "run_experiments.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("form,mode", [(3, 2), (1, 0), (0, 1), (1, 1)],
                         ids=["hybrid_incremental", "wcpe_batch", "wcme_sliding", "wcpe_sliding"])
def test_sweep_cell_equals_the_jax_row(tmp_path, monkeypatch, form, mode):
    ref = np.load(REF)
    cell = f"{rx.FORMS[form]}_{rx.MODES[mode]}"
    if mode == 1:
        xla_cholesky(monkeypatch)
    jcfg = DynoConfig.from_dict(dataclasses.asdict(rx.make_config(form, mode, FRAMES))).normalized()
    queue = inject_draws(monkeypatch, reference_draws(jax.random.PRNGKey(0), jcfg.frontend, FRAMES))
    summary = rx.main(["--sequence", f"kitti:{FIXTURE}", "--frames", str(FRAMES), "--forms", str(form),
                       "--modes", str(mode), "--out", str(tmp_path), "--device", "cpu"])
    assert not queue
    r = summary["kitti_kitti_fixture"][cell]
    row = dict(zip([str(f) for f in ref["fields"]], ref["summary"][[str(c) for c in ref["cells"]].index(cell)]))
    for f, tol in CELL_TOL.get(cell, TOL).items():
        assert abs(r[f] - row[f]) <= tol, (f, r[f], row[f])
    # what the cell writes, and the summaries
    out = tmp_path / "kitti_kitti_fixture" / cell
    assert (out / "statistics_samples.csv").exists()
    assert any(p.name.endswith(".json") for p in out.iterdir())
    assert any(p.name.startswith("dynosam_tpu_") and p.name.endswith("_log.csv") for p in out.iterdir())
    tags = set(str(t) for t in ref[f"{cell}_timing_tags"])
    assert {"pipeline.frontend", "pipeline.backend"} <= tags & set(r["timing_ms"])
    md = (tmp_path / "SUMMARY.md").read_text().splitlines()
    assert "| config | ATE (cm) | AME rms (cm) | AME med (cm) | frontend ms | backend ms |" in md
    assert any(ln.startswith(f"| {cell} | {r['ate_trans_rmse'] * 100:.3f} |") for ln in md)
    assert json.loads((tmp_path / "summary.json").read_text())["kitti_kitti_fixture"][cell]["ate_trans_rmse"] \
        == r["ate_trans_rmse"]


def _reference_optimize_input(tmp_path, form, k):
    """JAX's sliding-window cell over the fixture's first k + 1 frames under
    its own key (seed 0) -> (the backend state its k-th optimize took, that
    compiled optimize)."""
    from dynosam_tpu.dataproviders.base import create_dataset
    from dynosam_tpu.pipeline.pipeline import DynoPipeline

    ds = create_dataset(0, FIXTURE)
    pipe = DynoPipeline(_reference().make_config(form, 1, FRAMES), ds.intrinsics(), output_path=str(tmp_path))
    opt, seen = pipe.backend._jit_optimize, []

    def record(st):
        seen.append(st)
        return opt(st)

    pipe.backend._jit_optimize = record
    for i in range(k + 1):
        pipe.process_frame(ds.frame(i), ds.ground_truth(i))
    return seen[k], opt


@pytest.mark.parametrize("form,k", [(0, 1), (1, 2)], ids=["wcme_sliding-frame1", "wcpe_sliding-frame2"])
def test_sliding_window_step_is_float32_rounding_noise(tmp_path, form, k):
    """Where the sliding-window cells part from JAX: on JAX's own state
    before that frame's optimize, (1) both packages build the same reduced
    system in float64 (within 1e-8 of its largest entry), of condition
    above 1e10; (2) in float32 each package's system is off the float64 one
    by more than a tenth of its largest entry (WCME read 0.91 and 1.24,
    WCPE 0.18 and 0.16) and has a negative eigenvalue; (3) JAX's own
    optimized object translations, under one ulp up or down on every
    nonzero entry of one float input field (poses, motions, measurements,
    depths), spread wider than the port's optimize differs from JAX's on
    the same input (WCME 0.52 m against 1.6e-2 m, WCPE 3.9e-2 m against
    7.7e-4 m on this CPU). Rounding decides the step, not a different
    function."""
    from dynosam_tpu.backend import solver as jsolver
    from dynosam_tpu.backend import wcpe as jwcpe
    from dynosam_tpu_torch.backend import graph as pgraph
    from dynosam_tpu_torch.backend import solver as psolver
    from dynosam_tpu_torch.backend import wcpe as pwcpe

    jst, jopt = _reference_optimize_input(tmp_path, form, k)
    jmod, pmod = {0: (jsolver, psolver), 1: (jwcpe, pwcpe)}[form]
    jcfg = _reference().make_config(form, 1, FRAMES).backend
    pcfg = rx.make_config(form, 1, FRAMES).backend
    tree = {n: v for n, v in np_tree(jst).items() if isinstance(v, np.ndarray)}
    lam = jcfg.optimizer.lm_initial_lambda

    def port_state(dtype):
        st = pgraph.empty_graph(pcfg, "cpu")
        return dataclasses.replace(st, num_frames=int(tree["num_frames"]), **{
            n: torch.from_numpy(v.astype(dtype) if v.dtype.kind == "f" else v.copy())
            for n, v in tree.items() if n != "num_frames" and isinstance(getattr(st, n, None), torch.Tensor)})

    with jax.enable_x64(True):
        j64 = jst.replace(**{n: jax.numpy.asarray(v.astype(np.float64) if v.dtype.kind == "f" else v)
                             for n, v in tree.items()})
        S64 = np.asarray(jmod.linearize(j64, jcfg, jax.numpy.asarray(lam, jax.numpy.float64)).S)
    top = np.abs(S64).max()
    P64 = pmod.linearize(port_state(np.float64), pcfg, torch.tensor(lam, dtype=torch.float64)).S.numpy()
    assert S64.dtype == P64.dtype == np.float64
    assert np.abs(P64 - S64).max() <= 1e-8 * top
    w = np.linalg.eigvalsh(S64)
    assert w.min() > 0 and w.max() / w.min() > 1e10
    S32 = np.asarray(jmod.linearize(jst, jcfg, jax.numpy.asarray(lam, jax.numpy.float32)).S, np.float64)
    P32 = pmod.linearize(port_state(np.float32), pcfg, torch.tensor(lam, dtype=torch.float32)).S.numpy()
    for S in (S32, P32):
        assert np.abs(S - S64).max() > 0.1 * top
        assert np.linalg.eigvalsh(S.astype(np.float64)).min() < 0

    def trans(st):
        return np.asarray(st.H)[..., :3, 3]

    base = trans(jopt(jst))
    port = pmod.optimize(port_state(np.float32), pcfg).H.numpy()[..., :3, 3]
    moved = 0.0
    for name in ("X", "H", "ms", "md", "s_z", "d_z"):
        for to in (np.inf, -np.inf):
            a = np.array(tree[name])
            a[a != 0] = np.nextafter(a[a != 0], np.float32(to))
            moved = max(moved, float(np.abs(trans(jopt(jst.replace(**{name: jax.numpy.asarray(a)}))) - base).max()))
    assert moved > float(np.abs(port - base).max())


def test_make_config_equals_the_references():
    ref = _reference()
    for form in (0, 1, 3):
        for mode in (0, 1, 2):
            assert dataclasses.asdict(rx.make_config(form, mode, 40)) == dataclasses.asdict(ref.make_config(form, mode, 40))
    assert (rx.FORMS, rx.MODES, rx.DATASET_TYPES) == (ref.FORMS, ref.MODES, ref.DATASET_TYPES)


def test_timing_summary_equals_the_references(tmp_path):
    p = tmp_path / "statistics_samples.csv"
    rng = np.random.default_rng(0)
    cols = {"pipeline.frontend": rng.uniform(1, 9, 7), "pipeline.backend": rng.uniform(5, 50, 4),
            "pipeline.relog": rng.uniform(0, 1, 1)}
    lines = [",".join(cols)]
    for i in range(7):
        lines.append(",".join(f"{v[i]:.6f}" if i < len(v) else "" for v in cols.values()))
    p.write_text("\n".join(lines) + "\n")
    got = rx.timing_summary(str(p))
    assert got == _reference().timing_summary(str(p))
    assert got["pipeline.backend"] == pytest.approx(float(np.mean(np.round(cols["pipeline.backend"], 6))))
    assert rx.timing_summary(str(tmp_path / "missing.csv")) == {}


def test_synthetic_kind_runs_a_cell(tmp_path):
    name, ds = rx.open_sequence("synthetic:", 4, "cpu")
    assert name == "synthetic_synthetic" and len(ds) == 4
    r = rx.run_cell(ds, 3, 2, 4, str(tmp_path / "cell"), device="cpu")
    assert np.isfinite([r["ate_trans_rmse"], r["ate_rot_rmse"], r["rpe_trans_rmse"]]).all()
    assert {"pipeline.frontend", "pipeline.backend"} <= set(r["timing_ms"])
    with pytest.raises(ValueError, match="unknown sequence type"):
        rx.open_sequence("nope:/x", 4, "cpu")


def test_a_failing_cell_is_recorded_and_defaults_stay_outside_the_reference(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("cell failed")

    monkeypatch.setattr(rx, "run_cell", boom)
    summary = rx.main(["--sequence", "synthetic:", "--frames", "2", "--forms", "3", "--modes", "2",
                       "--out", str(tmp_path), "--device", "cpu"])
    assert summary["synthetic_synthetic"]["hybrid_incremental"] == {"error": "RuntimeError: cell failed"}
    assert "| hybrid_incremental | ERROR |" in (tmp_path / "SUMMARY.md").read_text()
    assert rx.DEFAULT_OUT.startswith(os.path.join("results", "torch"))
