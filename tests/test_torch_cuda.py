"""Card-only tests of the PyTorch port: the hand-written CUDA kernel against
its plain version, and the fused step on the card against the same step on
the CPU. They skip without a CUDA device. This file imports no JAX, so it
also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dynosam_tpu.config import (
    BackendParams,
    DynoConfig,
    FrontendParams,
    OptimizerParams,
    TrackerParams,
)
from dynosam_tpu_torch.dataproviders.synthetic_dense import default_dense_scenario
from dynosam_tpu_torch.frontend.tracker import _cell_reduce
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
    for a, b in zip(_cell_reduce(st.shi_tomasi_response(img), 16),
                    _cell_reduce(st.shi_tomasi_response_reference(img), 16)):
        assert torch.equal(a, b)


def test_kernel_rejects_a_noncontiguous_tensor(cuda):
    img = torch.rand((64, 96), generator=cuda, device="cuda")
    with pytest.raises(ValueError):
        st.shi_tomasi_response(img.t())


def test_fused_step_on_the_card_matches_the_cpu(cuda):
    cfg = DynoConfig(
        frontend=FrontendParams(max_objects=4, tracker=TrackerParams(
            max_features_per_frame=128, min_features_per_frame=64,
            max_dynamic_features_per_frame=128, detection_cell_size=8,
            min_corner_response=1e-6)),
        backend=BackendParams(
            optimization_mode=2, backend_updater_enum=3, max_frames=4, max_objects=4,
            max_static_landmarks=128, max_dynamic_landmarks=128,
            optimizer=OptimizerParams(max_iterations=2)),
    )
    outs = {}
    for dev in ("cpu", "cuda"):
        scene = default_dense_scenario(num_frames=4, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        step = make_fused_step(cfg, scene.intr, gen)
        state = init_pipeline_state(cfg, dev)
        launches = st.shi_tomasi_response.launches
        xs = []
        for k in range(4):
            state, out = step(state, scene.frame(k))
            xs.append(out["X_world_cam"].cpu().numpy())
        outs[dev] = np.stack(xs)
        if dev == "cuda":
            assert st.shi_tomasi_response.launches == launches + 4
    # noise-free scene: RANSAC's outcome does not depend on the draws
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=1e-4)
