"""The fused step of the second half of scripts/bisect_perf.py's variants,
port against JAX (test_torch_bisect_perf.py holds the first half, the
variants themselves and their configurations)."""

import pytest
import torch

from dynosam_tpu_torch import bisect_perf as tbp
from test_torch_bisect_perf import FIRST_HALF, check_variant_step

torch.set_num_threads(1)
SECOND_HALF = [n for n in tbp.VARIANTS if n not in FIRST_HALF]


def test_halves_cover_every_variant():
    assert sorted(FIRST_HALF + SECOND_HALF) == sorted(tbp.VARIANTS)


@pytest.mark.parametrize("name", SECOND_HALF)
def test_variant_fused_step_matches_reference(name):
    check_variant_step(name)
