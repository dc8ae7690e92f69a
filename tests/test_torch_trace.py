"""The port's own trace (`utils/stats.py`: `tracing`, `span`, `count`,
`count_tensor`, and the spans `timed` / `Timer` record) and the device
time it puts down to spans (`timing.py::device_by_span`).

The batched step is run at the graft's small configuration, cut to a
3-frame window and one iteration of each loop (B = 2, four frames of
64 x 48: the last one advances the window), with recording off and on:
the same torch operations in the same order, the profiler's own
`profiler::` range operations aside, and the same outputs bit for bit.
No JAX here: the trace is the port's alone.
"""

import contextlib
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dynosam_tpu_torch import bench_config, timing
from dynosam_tpu_torch.backend import solver
from dynosam_tpu_torch.backend import window as twindow
from dynosam_tpu_torch.config import BackendParams
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario
from dynosam_tpu_torch.parallel import batched as tbatched
from dynosam_tpu_torch.utils import stats

torch.set_num_threads(1)
B = 2
F = 3                      # window slots
N = F + 1                  # frames per lane: the last one advances the window
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def test_spans_nest_with_parent_step_and_self_time():
    stats.Statistics.reset()
    with stats.tracing() as rec:
        with stats.span("outer"):
            for _ in range(2):
                with stats.span("step", new_step=True):
                    with stats.span("a"):
                        with stats.span("a.b"):
                            pass
                        with stats.timed("a.timed"):
                            pass
                    t = stats.Timer("t").start()
                    with stats.span("in.timer"):
                        pass
                    t.stop()
            # a timer left running is ended, unrecorded, by the span around it
            stats.Timer("left.open").start()
        assert stats.span("x") is not stats._OFF
    by_id = {sp[3]: sp for sp in rec.spans}
    name_of = {sid: sp[2] for sid, sp in by_id.items()}
    outer = next(sp for sp in rec.spans if sp[2] == "outer")
    assert outer[4] is None and outer[5] is None
    steps = [sp for sp in rec.spans if sp[2] == "step"]
    assert [sp[5] for sp in steps] == [0, 1]
    assert all(sp[4] == outer[3] for sp in steps)
    parents = {"a": "step", "a.b": "a", "a.timed": "a", "t": "step", "in.timer": "t"}
    for sp in rec.spans:
        if sp[2] in parents:
            assert name_of[sp[4]] == parents[sp[2]], sp
            assert sp[5] == by_id[sp[4]][5], sp
    assert sorted({sp[2] for sp in rec.spans}) == sorted({"outer", "step"} | set(parents))
    # the timers' samples are unchanged: one per timed block
    assert stats.Statistics.tags() == ["a.timed", "t"]
    assert [stats.Statistics.get(k).count for k in ("a.timed", "t")] == [2, 2]
    stats.Statistics.reset()

    # self time: the duration less the children's
    child = {}
    for s0, s1, _, _, parent, _ in rec.spans:
        if parent is not None:
            child[parent] = child.get(parent, 0) + s1 - s0
    times = stats.host_times(rec.spans)
    for name in ("outer", "step", "a", "a.b", "t"):
        mine = [sp for sp in rec.spans if sp[2] == name]
        total = sum(s1 - s0 for s0, s1, *_ in mine)
        assert times[name] == (total * 1e-9, (total - sum(child.get(sp[3], 0) for sp in mine)) * 1e-9)
    assert times["a.b"][0] == times["a.b"][1]


def test_a_profiler_running_shows_the_spans():
    from torch.profiler import ProfilerActivity, profile

    with stats.tracing() as rec:
        with stats.span("quiet"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with stats.span("seen"):
                torch.ones(2).add_(1)
    assert [sp[2] for sp in rec.spans] == ["quiet", "seen"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "seen" in names and "quiet" not in names


def test_nothing_is_recorded_with_recording_off():
    with stats.tracing() as rec:
        flags = torch.tensor([True, False, True])
        stats.count_tensor("flags", flags)
        stats.count("n", 3)
        assert rec.counters == {"n": 3}         # the tensors are summed on exit
    assert rec.counters == {"n": 3, "flags": 2}
    spans, counters = list(rec.spans), dict(rec.counters)
    assert stats._recorder is None
    assert stats.span("off") is stats._OFF
    with stats.span("off", new_step=True):
        stats.count("n", 1)
        stats.count_tensor("flags", flags)
    stats.Timer("off.timer").start().stop()
    with stats.timed("off.timed"):
        pass
    assert rec.spans == spans and rec.counters == counters
    stats.Statistics.reset()


class _Ops(TorchDispatchMode):
    """Every dispatched torch operation, in order, but the profiler's own
    range operations."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace != "profiler":
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _config():
    """The small configuration with a 3-frame window, one LM iteration a
    phase and one iteration of each frontend refinement."""
    cfg = bench_config.small_config()
    fe, be = cfg.frontend, cfg.backend
    ms = dataclasses.replace(fe.motion_solver, refinement_iterations=1, object_refinement_iterations=1,
                             joint_of_iterations=1)
    return dataclasses.replace(
        cfg, frontend=dataclasses.replace(fe, motion_solver=ms),
        backend=dataclasses.replace(be, max_frames=F, optimizer=dataclasses.replace(be.optimizer, max_iterations=1)))


def _run(recording, scene, frames, log=contextlib.nullcontext):
    cfg = _config()
    step, init_fn = tbatched.make_batched_pipeline(cfg, scene.intr, torch.Generator().manual_seed(0))
    states = init_fn(B, "cpu")
    outs, full = [], None
    with stats.tracing() if recording else stats._OFF as rec:
        with log() as ops:
            for k, frame in enumerate(frames):
                if k == F:
                    full = states.graph
                states, out = step(states, frame)
                outs.append(out)
    return {"ops": ops and ops.ops, "outs": outs, "states": states, "rec": rec, "full": full, "cfg": cfg}


@pytest.fixture(scope="module")
def runs():
    scene = default_dense_scenario(num_frames=N + B - 1, width=64, height=48, device="cpu")
    frames = []
    for k in range(N):          # lane b plays frame k + b
        lanes = [scene.frame(k + b) for b in range(B)]
        frames.append(dataclasses.replace(lanes[0], **{n: torch.stack([getattr(f, n) for f in lanes])
                                                       for n in lanes[0].tensors()}))
    _run(False, scene, frames)      # the helpers' cached constants are made on a first call
    return {"off": _run(False, scene, frames, _Ops), "on": _run(True, scene, frames, _Ops)}


def _tensors(obj):
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _tensors(obj[k])]
    return [obj] if torch.is_tensor(obj) else []


def test_recording_adds_no_op_and_changes_no_output(runs):
    off, on = runs["off"], runs["on"]
    assert off["rec"] is None and on["full"].num_frames == F
    # a host read would show as an operation (aten._local_scalar_dense)
    assert on["ops"] == off["ops"]
    for a, b in zip(_tensors(on["outs"]) + _tensors(on["states"]), _tensors(off["outs"]) + _tensors(off["states"]),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)

    rec = on["rec"]
    name_of = {sp[3]: sp[2] for sp in rec.spans}
    parents = {}
    for _, _, name, _, parent, _ in rec.spans:
        parents.setdefault(name, set()).add(name_of.get(parent))
    assert parents["step"] == {None}
    assert parents["frontend"] == parents["backend"] == {"step"}
    for child in ("frontend.track", "frontend.camera", "frontend.objects"):
        assert parents[child] == {"frontend"}
    for child in ("backend.ingest", "backend.optimize", "backend.advance"):
        assert parents[child] == {"backend"}
    assert parents["backend.optimize.camera"] == parents["backend.optimize.objects"] == {"backend.optimize"}
    assert parents["lm.linearize"] == parents["lm.solve"] == {"backend.optimize.camera", "backend.optimize.objects"}
    assert parents["lm.error"] == parents["lm.linearize"]
    # every span inside a step carries that step's call index
    steps = sorted(sp[5] for sp in rec.spans if sp[2] == "step")
    assert steps == list(range(N))
    assert {sp[5] for sp in rec.spans} == set(steps)
    assert sum(sp[2] == "backend.advance" for sp in rec.spans) == 1
    # two phases of max_iterations a step over B lanes; one advance of B lanes
    iters = 2 * on["cfg"].backend.optimizer.max_iterations * N
    assert rec.counters["lm.lane_iterations"] == B * iters
    assert 0 <= rec.counters["lm.idle_lane_iterations"] <= B * iters
    assert rec.counters["advance.lanes"] == B
    assert rec.counters["advance.eigh_lanes"] == sum(sp[2] == "backend.advance.eigh" for sp in rec.spans)


@pytest.mark.parametrize("broken", [(), (1,), (0, 1)])
def test_eigh_lanes_counts_the_planted_breakdowns(runs, monkeypatch, broken):
    """The advance of the full window with the factorisations of the
    `broken` lanes made to fail: the eigh route takes exactly those."""
    full, bcfg = runs["off"]["full"], runs["off"]["cfg"].backend
    orig = torch.linalg.cholesky_ex

    def chol(a, *args, **kw):
        L, info = orig(a, *args, **kw)
        if a.ndim == 3 and a.shape[-1] == full.D:
            info = info.clone()
            info[list(broken)] = 1
        return L, info

    monkeypatch.setattr(torch.linalg, "cholesky_ex", chol)
    with stats.tracing() as rec:
        twindow.advance_hybrid(full, bcfg)
    assert rec.counters == {"advance.lanes": B, "advance.eigh_lanes": len(broken)}
    assert [sp[2] for sp in rec.spans] == (["backend.advance.eigh"] if broken else [])


@dataclasses.dataclass
class _Lanes:
    X: torch.Tensor            # (lanes, 1): each lane's error

    @property
    def batch_shape(self):
        return self.X.shape[:1]


def test_lm_counts_a_converged_lane_idle_on_every_later_iteration():
    """Lane 0 halves its error at every iteration; lane 1 starts converged:
    its first step is accepted with a decrease under the tolerance, and it
    is idle in every iteration after."""
    cfg = BackendParams()
    iterations = 4
    step = torch.tensor([[0.5], [1.0 - 1e-7]])

    with stats.tracing() as rec:
        out = solver.lm_accept_reject(
            _Lanes(torch.ones(2, 1)), cfg,
            linearize_fn=lambda st, cfg_, lam: None,
            apply_fn=lambda st, lin, dx: _Lanes(st.X * step),
            solve_fn=lambda lin: None,
            error_fn=lambda st, cfg_: st.X[:, 0],
            iterations=iterations,
        )
    assert float(out.X[0, 0]) == 0.5 ** iterations
    assert rec.counters == {"lm.lane_iterations": 2 * iterations, "lm.idle_lane_iterations": iterations - 1}
    assert [sp[2] for sp in rec.spans].count("lm.error") == 1 + iterations


class _Event:
    def __init__(self, name, start, dur, corr, device, annotation=False):
        self._v = (name, start, dur, corr, CUDA if device else CPU, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_device_time_goes_to_the_span_that_launched_it():
    """Fake raw events on a profiler clock K ns ahead of the host's: each
    kernel joins its launch by correlation id, the launch goes on the host
    clock by the anchor's, and its time goes to the innermost span open
    then; subtrees sum; an event launched outside every span or without a
    launch is unattributed; the gaps are named by either set of spans."""
    K, anchor_ns = 10**6, 1000
    spans = [  # (start, end, name, id, parent, step)
        (2200, 3000, "frontend.track", 2, 1, 0), (2100, 4000, "frontend", 1, 0, 0),
        (4600, 6000, "backend.advance", 4, 3, 0), (4500, 8500, "backend", 3, 0, 0),
        (2000, 9000, "step", 0, None, 0),
    ]
    bench = [(1900, 9200, "wrapper"), (5500, 6500, "bench inner")]
    launches = {1: 1000, 11: 2250, 12: 3500, 13: 4700, 14: 7000, 15: 9500}   # host ns
    dur = {1: 2, 11: 100, 12: 50, 13: 300, 14: 40, 15: 10}
    events = [_Event("cudaLaunchKernel", K + t, 5, c, False) for c, t in launches.items()]
    events += [_Event("Lazy Function Loading", K + 2255, 1, 11, False),
               _Event("frontend", K + 2100, 1900, 0, True, annotation=True),
               _Event("kernel without a launch", K + 9600, 7, 99, True)]
    events += [_Event(f"kernel {c}", K + launches[c] + 10, dur[c], c, True) for c in launches]
    got = timing.device_by_span(events[::-1], anchor_ns, spans, other=bench)

    ns = 1e-9
    assert got["busy_s"] == pytest.approx(507 * ns)
    assert got["span_s"] == pytest.approx({"step": 490 * ns, "frontend": 150 * ns, "frontend.track": 100 * ns,
                                           "backend": 340 * ns, "backend.advance": 300 * ns})
    assert got["self_s"] == pytest.approx({"frontend": 50 * ns, "frontend.track": 100 * ns,
                                           "backend": 40 * ns, "backend.advance": 300 * ns})
    assert got["unattributed_s"] == pytest.approx(17 * ns) and got["unmatched"] == 1
    assert got["span_s"]["step"] + got["unattributed_s"] == pytest.approx(got["busy_s"])
    assert [g[0] for g in got["idle_gaps"]] == ["backend", "bench inner", "frontend.track", "step",
                                                "outside every span"]
    assert [g[1] for g in got["idle_gaps"]] == pytest.approx([2460 * ns, 2000 * ns, 1150 * ns, 1150 * ns, 80 * ns])
