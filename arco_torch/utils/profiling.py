"""Profiling helpers (counterpart of arco_tpu/utils/profiling.py).

The reference's only profiling code is measure_fp_bp_time /
benchmark_fp_bp_time (networks/networks_other.py:203-258), timed with
``torch.cuda.Event``. These time a forward, a forward + backward and a
train step the same way, plus a ``torch.profiler`` trace context.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch


def _timed(fn: Callable, device: torch.device, n: int, warmup: int):
    """Mean seconds per call of ``fn`` after ``warmup`` calls: between two
    CUDA events on a CUDA device, by the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def measure_fp_time(apply_fn: Callable, x: torch.Tensor, n: int = 10,
                    warmup: int = 2) -> float:
    """Mean seconds per forward ``apply_fn(x)`` without autograd
    (networks_other.py:203-224 analog)."""
    @torch.no_grad()
    def fwd():
        apply_fn(x)
    return _timed(fwd, x.device, n, warmup)


def measure_fp_bp_time(loss_fn: Callable, params, x: torch.Tensor,
                       n: int = 10, warmup: int = 2) -> float:
    """Mean seconds per forward + backward (networks_other.py:226-258
    analog): ``loss_fn(params, x)`` -> scalar, then ``.backward()``.
    ``params`` (a module or tensors) has its gradients cleared before each
    call, so each backward writes fresh ones, as JAX's grad returns
    them."""
    tensors = list(params.parameters()) \
        if isinstance(params, torch.nn.Module) else list(params)

    def fwd_bwd():
        for t in tensors:
            t.grad = None
        loss_fn(params, x).backward()
    return _timed(fwd_bwd, x.device, n, warmup)


@contextlib.contextmanager
def trace(log_dir: str = None):
    """``torch.profiler`` context over CPU activity, and CUDA activity
    where there is a GPU; on exit it writes a Chrome trace
    (``<host>.<pid>.<ms>.pt.trace.json``) into ``log_dir`` (default
    ``torch-trace`` in the temp dir), which TensorBoard's profiler plugin
    and Perfetto read. Yields the directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


def step_timer(step_fn: Callable, state, batch, n: int = 10,
               warmup: int = 2):
    """Steady-state seconds/step of a (state, batch) -> (state, metrics)
    train step, by the host clock between two device synchronizations.
    Returns (seconds, state)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    for _ in range(warmup):
        state, metrics = step_fn(state, batch)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = step_fn(state, batch)
    sync()
    return (time.perf_counter() - t0) / n, state
