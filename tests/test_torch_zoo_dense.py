"""DenseNet-121 (32x32: live BNs, a concatenating trunk, avg-pool
transitions) in the port against the JAX package on the CPU: float logits,
the W4A4 headline simulation, W8A8 serving module by module against eager
JAX and as a whole against its float logits (bars and reasons in
``tests/_torch_zoo_family.py``).  Its own file: the JAX package compiles its
246-site W4A4 forward for over a minute, so the suite's workers take it
apart from the other families."""

import numpy as np
import pytest

import _torch_zoo_family as fam
from _torch_zoo_family import (one_torch_thread, serving, test_float_logits_match_jax,  # noqa: F401
                               test_prepared_codes_equal_jax,
                               test_serving_modules_match_eager_jax,
                               test_w4a4_headline_simulation_matches_jax)
from _torch_parity import Pair

SIZES = {'densenet121': 32}


@pytest.fixture(scope='module', params=sorted(SIZES))
def pair(request):
    return Pair(request.param, SIZES[request.param])


def test_whole_model_serving_within_bound(record_property):
    out, scales = fam.check_serving_whole('densenet121', 64)
    record_property('densenet121_serving_rel', out)
    assert not any(np.ndim(v) for v in scales.values())
