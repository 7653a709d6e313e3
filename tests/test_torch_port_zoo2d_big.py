"""The three large models of the 2D zoo, EffiUNet and VisionTransformerSeg
at 64x64 and SwinUnet at 48x48, held against JAX by the tests of
test_torch_port_zoo2d.py (its docstring states what they check and their
tolerances). They sit in a file of their own so that pytest-xdist runs
them beside the others."""

import pytest

from test_torch_port_zoo2d import (BIG, Pair, test_eval_forward,  # noqa: F401
                                   test_gradients, test_loader_round_trip,
                                   test_train_forward_and_running_stats)


@pytest.fixture(scope="module", params=BIG)
def pair(request):
    return Pair(request.param)
