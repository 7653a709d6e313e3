"""The port's 3D sliding-window evaluation against the JAX package's: the
window grid, one case summed on the host and one kept on the device, the
largest connected component, and ``evaluate_3d``.

The predictor is one deterministic function written in each framework:
class 1 gets probability 0.75 where the voxel's value plus half its depth
fraction inside the window exceeds 0.75, else 0.25, so overlapping windows
disagree, and every score is a sum of exact binary fractions. So the label
maps must be equal exactly, and the metrics to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.eval import sliding_window as jsw
from arco_tpu.eval import sliding_window_device as jswd

from arco_torch.eval import sliding_window as sw
from arco_torch.eval import sliding_window_device as swd

PATCH = (16, 16, 8)


def _jax_predict(x):                      # [B, w, h, d, 1] -> [B, w, h, d, 2]
    z = jnp.arange(x.shape[3], dtype=jnp.float32) / x.shape[3]
    p1 = jnp.where(x[..., 0] + 0.5 * z > 0.75, 0.75, 0.25)
    return jnp.stack([1.0 - p1, p1], axis=-1)


def _port_predict(x):                     # [B, 1, w, h, d] -> [B, 2, w, h, d]
    x = torch.as_tensor(x)
    z = torch.arange(x.shape[4], dtype=torch.float32) / x.shape[4]
    p1 = torch.where(x[:, 0] + 0.5 * z > 0.75, 0.75, 0.25)
    return torch.stack([1.0 - p1, p1], dim=1)


def _volume(shape, seed):
    rs = np.random.RandomState(seed)
    label = np.zeros(shape, np.uint8)
    label[shape[0] // 4:3 * shape[0] // 4, shape[1] // 4:,
          :shape[2] // 2] = 1
    label[0:2, 0:2, 0:2] = 1                         # a second component
    image = (0.6 * label + 0.3 * rs.rand(*shape)).astype(np.float32)
    return image, label


def test_window_starts():
    for size, patch, stride in ((40, 16, 18), (16, 16, 4), (10, 16, 4),
                                (97, 80, 4)):
        assert sw.window_starts(size, patch, stride) \
            == jsw.window_starts(size, patch, stride)


# the second shape is smaller than the patch in its first and last dims
@pytest.mark.parametrize("shape", [(40, 36, 20), (12, 30, 6)])
def test_one_case_on_the_host_and_on_the_device(shape):
    image, _ = _volume(shape, 1)
    want_lab, want_score = jsw.test_single_case_3d(
        _jax_predict, image, 9, 4, PATCH, 2)
    jdev_lab, _ = jswd.test_single_case_3d_device(
        jax.jit(_jax_predict), image, 9, 4, PATCH, 2)
    np.testing.assert_array_equal(jdev_lab, want_lab)
    lab, score = sw.test_single_case_3d(_port_predict, image, 9, 4, PATCH,
                                        2)
    np.testing.assert_array_equal(lab, want_lab)
    np.testing.assert_array_equal(score, want_score)
    dlab, dscore = swd.test_single_case_3d_device(_port_predict, image, 9, 4,
                                                  PATCH, 2, device="cpu")
    assert isinstance(dscore, torch.Tensor) and dlab.dtype == np.int32
    np.testing.assert_array_equal(dlab, want_lab)
    np.testing.assert_array_equal(dscore.numpy(), want_score)
    assert 0 < want_lab.mean() < 1


def test_largest_connected_component():
    _, label = _volume((20, 20, 10), 2)
    np.testing.assert_array_equal(sw.largest_connected_component(label),
                                  jsw.largest_connected_component(label))
    assert sw.largest_connected_component(label).sum() < label.sum()
    empty = np.zeros((4, 4, 4), np.uint8)
    assert sw.largest_connected_component(empty) is empty


@pytest.mark.parametrize("use_nms", [False, True])
def test_evaluate_3d(use_nms):
    vols = {f"case{i}": _volume((36, 36, 20), 3 + i) for i in range(2)}
    kw = dict(patch_size=PATCH, stride_xy=9, stride_z=4, use_nms=use_nms)
    want = jsw.evaluate_3d(list(vols), vols.__getitem__, _jax_predict, 2,
                           **kw)
    for case_fn in (None, lambda *a: swd.test_single_case_3d_device(
            *a, device="cpu")):
        got = sw.evaluate_3d(list(vols), vols.__getitem__, _port_predict, 2,
                             case_fn=case_fn, **kw)
        assert got["raw"].shape == want["raw"].shape == (2, 1, 4)
        np.testing.assert_allclose(got["raw"], want["raw"], rtol=0,
                                   atol=1e-6)
    assert 0 < want["mean"][0] < 1
