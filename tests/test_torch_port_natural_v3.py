"""DeepLabV3Plus (at batch 2 and at batch 1, where the ASPP's pooled
BatchNorm sees one value a channel, which torch's own batch_norm refuses)
and DeepLab2Branch at 65x65 and 64x64, held against JAX by the tests of
test_torch_port_natural.py (its docstring states what they check and their
tolerances). They sit in a file of their own so that pytest-xdist runs
them beside the DeepLab-v2 cases."""

import pytest

from test_torch_port_natural import (  # noqa: F401
    CASES_V3, DeepLabPair, case_id, test_eval_forward_float64,
    test_float32_against_float64, test_gradients_float32_against_float64,
    test_gradients_float64, test_running_stats_after_train_forward,
    test_train_forward_float64)


@pytest.fixture(scope="module", params=CASES_V3, ids=case_id)
def pair(request):
    return DeepLabPair(*request.param)
