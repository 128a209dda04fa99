"""The serving decode of E-NeRV-Boost against the JAX v5 decode (Pallas in
interpret mode) and the flax forward, its calibration against JAX's and
its W8A8 stages: the tests of tests/test_torch_families_serving.py on the
tiny E-NeRV-Boost (its trunk, t_branch and stage-0 ConvUpBlock in the
prefix, the tail from stage 1)."""

import pytest

from test_torch_families_serving import (  # noqa: F401
    serve_family, test_calibration_matches_jax,
    test_decode_matches_pallas_v5_and_flax,
    test_w8a8_decode_serves_the_jax_stages)


@pytest.fixture(scope="module")
def served():
    return serve_family("ENeRV_Boost")
