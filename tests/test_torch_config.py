"""The port stands alone: its copy of the configuration (and of the YAML and
.flags readers) equals the reference's, field for field; no module of the
port and nothing in chip_smoke.py imports the JAX package, OpenCV or PIL,
or loads the reference's native library; and the entry points that make
tensors default to the card, not the CPU."""

import ast
import dataclasses
import inspect
import os

import pytest

from dynosam_tpu import config as jconfig
from dynosam_tpu_torch import bench_config as tbench
from dynosam_tpu_torch import config as tconfig
from dynosam_tpu_torch import exp_streaming as tstream
from dynosam_tpu_torch import make_fixture_sequence as tfixture
from dynosam_tpu_torch import multichip as tmultichip
from dynosam_tpu_torch import run_dynosam as trun
from dynosam_tpu_torch import run_experiments as trx
from dynosam_tpu_torch import scale_check as tscale
from dynosam_tpu_torch import train_detector as ttrain
from dynosam_tpu_torch.backend import backend as tbackend
from dynosam_tpu_torch.dataproviders import base as tbase
from dynosam_tpu_torch.dataproviders import kitti as tkitti
from dynosam_tpu_torch.dataproviders import simulator as tsim
from dynosam_tpu_torch.dataproviders import synthetic_dense as tdense
from dynosam_tpu_torch.nn import bytetrack as tbt
from dynosam_tpu_torch.nn import detector as tdet
from dynosam_tpu_torch.parallel import group as tgroup
from dynosam_tpu_torch.pipeline import pipeline as tpipe
from torch_port_util import port_cfg, small_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_CLASSES = sorted(
    name for name, obj in vars(jconfig).items()
    if dataclasses.is_dataclass(obj) and obj.__module__ == jconfig.__name__
)


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        v = f.default_factory()
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return dataclasses.MISSING


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclass_matches_the_reference(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert dataclasses.is_dataclass(tcls)
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(jf, tf):
        assert str(b.type) == str(a.type), a.name
        assert _default(b) == _default(a), a.name
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


def test_config_methods_match_the_reference():
    j = small_cfg()
    t = port_cfg(j)
    assert isinstance(t, tconfig.DynoConfig)
    assert dataclasses.asdict(t.normalized()) == dataclasses.asdict(j.normalized())
    over = {"frontend.tracker.detection_cell_size": 16, "odometry_rotation_sigma": 0.3}
    assert dataclasses.asdict(t.with_overrides(over)) == dataclasses.asdict(j.with_overrides(over))
    raw = {"backend": {"max_frames": 7, "noise": {"robust_k_huber": 2.0}}, "unknown": 1}
    assert (dataclasses.asdict(tconfig.DynoConfig.from_dict(raw))
            == dataclasses.asdict(jconfig.DynoConfig.from_dict(raw)))
    with pytest.raises(KeyError):
        t.with_overrides({"no_such_field": 1})
    for flags in ("params/backend.flags",):
        path = os.path.join(ROOT, flags)
        assert tconfig.load_flags_file(path) == jconfig.load_flags_file(path)
        over = jconfig.load_flags_file(path)
        assert dataclasses.asdict(t.with_overrides(over)) == dataclasses.asdict(j.with_overrides(over))


def test_load_flags_file_matches_the_reference(tmp_path):
    path = tmp_path / "t.flags"
    path.write_text("# comment\n--optimization_mode=0\n--use_vo_factor=False\n--flag_alone\n"
                    "  --odometry_rotation_sigma=0.25  \n--name=text\n-not_a_flag=1\n")
    got = tconfig.load_flags_file(str(path))
    assert got == jconfig.load_flags_file(str(path))
    assert got == {"optimization_mode": 0, "use_vo_factor": False, "flag_alone": True,
                   "odometry_rotation_sigma": 0.25, "name": "text"}


def test_from_yaml_matches_the_reference():
    path = os.path.join(ROOT, "params", "default.yaml")
    assert (dataclasses.asdict(tconfig.DynoConfig.from_yaml(path))
            == dataclasses.asdict(jconfig.DynoConfig.from_yaml(path)))


def _port_sources():
    for base, _, files in os.walk(os.path.join(ROOT, "dynosam_tpu_torch")):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _reaches_the_jax_package(name):
    """The JAX package and JAX itself, and the image libraries the card's
    machine lacks (the port decodes PNGs itself)."""
    return name is not None and name.split(".")[0] in (
        "dynosam_tpu", "jax", "jaxlib", "flax", "cv2", "PIL")


def test_port_sources_import_nothing_of_the_jax_package():
    """Every import statement, at any depth (inside functions too)."""
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}" for n in names
                    if _reaches_the_jax_package(n)]
    assert not bad, bad


@pytest.mark.parametrize("module", [tstream, tfixture, tmultichip, tgroup], ids=lambda m: m.__name__.split(".")[-1])
def test_import_scan_covers_the_script_ports(module):
    assert os.path.realpath(module.__file__) in {os.path.realpath(p) for p in _port_sources()}


def test_port_sources_load_no_native_library():
    """The port reads the dyno-KITTI formats with numpy; it never loads the
    reference's native/libdynoio.so."""
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            text = fh.read()
        if "dynoio" in text:
            bad.append(os.path.relpath(path, ROOT))
    assert not bad, bad


@pytest.mark.parametrize("entry", [
    tsim.Scenario.__init__,
    tdense.DenseScenario.__init__,
    tdense.default_dense_scenario,
    tbench.bench_scene,
    tbench.detector_scene,
    tdet.YoloV8DetectorEngine.__init__,
    tbt.empty_state,
    tkitti.KittiDataProvider.__init__,
    tbase.create_dataset,
    tbackend.RegularBackend.__init__,
    tpipe.DynoPipeline.__init__,
    trun.run,
    tstream.scenario,
    tstream.run_mode,
    tfixture.write_fixture,
    tgroup.init_group,
    tgroup.spawn,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(entry):
    default = inspect.signature(entry).parameters["device"].default
    assert default in ("cuda", inspect.Parameter.empty), default


def _argparse_defaults(main):
    """{dest: default} of the parser `main` builds, read before it parses."""
    import argparse

    seen = {}

    def parse(self, argv=None):
        seen.update({a.dest: a.default for a in self._actions})
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen


def test_command_line_defaults_to_the_card():
    assert _argparse_defaults(trun.main)["device"] == "cuda"


@pytest.mark.parametrize("module", [tstream, tfixture, tscale, trx, ttrain, tmultichip],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_script_ports_default_to_the_card(module):
    """The ports of the reference's scripts take --device, default cuda."""
    assert _argparse_defaults(module.main)["device"] == "cuda"
