"""Tests that need the card.  They skip without a GPU; on a GPU host run
``JAX_PLATFORMS= python -m pytest tests -m gpu``."""

import pytest

from relp_tpu.models.generated import (
    dense_allocation_lp,
    highs_objective,
    sparse_box_lp,
)
from relp_tpu.simplex.driver import solve_general_form
from relp_tpu.utils.config import SolverConfig

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("algorithm", ["primal", "dual", "pdlp", "ipm"])
def test_engines_on_the_card(gpu_device, algorithm):
    make = dense_allocation_lp if algorithm == "ipm" else (
        lambda: sparse_box_lp(300, 900)
    )
    ref = highs_objective(make())
    res = solve_general_form(make(), SolverConfig(algorithm=algorithm))
    assert res.solution is not None
    assert abs(res.solution.objective_value - ref) <= 1e-6 * max(1.0, abs(ref))


def test_arrays_live_on_the_card(gpu_device):
    import jax.numpy as jnp

    x = jnp.arange(4.0)
    assert x.devices() == {gpu_device}
    assert x.dtype == jnp.float64  # the package enables x64
