"""The port's profiling helpers (arco_torch/utils/profiling.py) on the CPU:
the three timers call what they time ``warmup + n`` times and return a
mean in seconds, the forward timer records no autograd graph, the
forward + backward timer leaves the gradient of one call (not a sum over
calls), and ``trace`` writes a Chrome trace that holds the traced ops.
The CUDA-event side of the timers runs on the card (chip_smoke.py phase
14)."""

import json
import math

import torch

from arco_torch.models import net_factory
from arco_torch.train.supervised import (PolySGD, init_supervised_state,
                                         make_supervised_step)
from arco_torch.utils import profiling

torch.set_num_threads(1)


def _conv():
    torch.manual_seed(0)
    return torch.nn.Conv2d(1, 4, 3, padding=1)


def test_measure_fp_time_counts_calls_without_autograd():
    conv, x, seen = _conv(), torch.randn(2, 1, 8, 8), []

    def apply_fn(v):
        y = conv(v)
        seen.append(y.requires_grad)
        return y
    t = profiling.measure_fp_time(apply_fn, x, n=5, warmup=3)
    assert math.isfinite(t) and t > 0
    assert seen == [False] * 8


def test_measure_fp_bp_time_leaves_one_calls_gradient():
    conv, x, calls = _conv(), torch.randn(2, 1, 8, 8), []

    def loss_fn(params, v):
        calls.append(1)
        return params(v).square().mean()
    t = profiling.measure_fp_bp_time(loss_fn, conv, x, n=4, warmup=2)
    assert math.isfinite(t) and t > 0 and len(calls) == 6
    want = torch.autograd.grad(loss_fn(conv, x), conv.weight)[0]
    torch.testing.assert_close(conv.weight.grad, want)


def test_measure_fp_bp_time_takes_a_list_of_tensors():
    w = torch.randn(3, 3, requires_grad=True)
    x = torch.randn(3)
    t = profiling.measure_fp_bp_time(lambda p, v: (p[0] @ v).sum(), [w], x,
                                     n=3, warmup=1)
    assert t > 0
    torch.testing.assert_close(w.grad, x.expand(3, 3))


def test_step_timer_runs_warmup_plus_n_steps():
    torch.manual_seed(0)
    model = net_factory("unet", in_chns=1, class_num=2)
    tx = PolySGD(0.01, 10)
    state = init_supervised_state(model, tx, device="cpu")
    step = make_supervised_step(model, tx, 2)
    batch = {"image": torch.randn(2, 1, 16, 16),
             "label": torch.randint(0, 2, (2, 16, 16))}
    secs, state = profiling.step_timer(step, state, batch, n=3, warmup=1)
    assert math.isfinite(secs) and secs > 0
    assert state.step == 4


def test_trace_writes_a_chrome_trace(tmp_path):
    conv, x = _conv(), torch.randn(2, 1, 8, 8)
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        conv(x).sum().backward()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert log_dir == str(tmp_path / "trace") and len(files) == 1
    names = {e.get("name") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::conv2d" in names


def test_trace_defaults_to_the_temp_dir(tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    with profiling.trace() as log_dir:
        torch.ones(2).sum()
    assert log_dir == str(tmp_path / "torch-trace")
    assert list((tmp_path / "torch-trace").glob("*.pt.trace.json"))
