"""The second step function of the 3D CLI's ``eqv_on_log_only``: one 3D
stage-2 step with the eqv leg off (no TPS warp, no sixth forward) against
the JAX step built the same way (arco_tpu/cli/train_arco_3d.py:139-145),
with the set-up and tolerances of test_torch_port_3d_step.py. Its own file,
so that its JAX compile runs beside the eqv step's.
"""

import pytest

from test_torch_port_3d_step import check_loss_term, check_state, step_pair
from test_torch_port_step import TERMS


@pytest.fixture(scope="module")
def one_step_each():
    return step_pair(compute_eqv=False)


@pytest.mark.parametrize("term", TERMS)
def test_loss_terms(one_step_each, term):
    check_loss_term(one_step_each, term)


def test_state_after_the_step(one_step_each):
    check_state(one_step_each)


def test_the_eqv_leg_is_off(one_step_each):
    _, jm, _, m = one_step_each
    assert float(m["loss_eqv"]) == float(jm["loss_eqv"]) == 0.0
    assert float(m["reco_loss"]) > 0
