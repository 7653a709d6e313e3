"""Fixed-capacity ring buffers (counterpart of arco_tpu/ops/ring_buffer.py):
``enqueue_fixed`` (the random pool's and the ISD queues' in-place write)
and the generic ``RingBuffer`` with ``create`` / ``enqueue``, which return
a new buffer and leave their input alone, as JAX's do."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RingBuffer(NamedTuple):
    data: torch.Tensor    # [capacity, feat]
    ptr: torch.Tensor     # 0-d int32, the next write slot
    count: torch.Tensor   # 0-d int32, valid rows (<= capacity)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def create(capacity: int, feat: int, dtype=torch.float32,
           init: torch.Tensor = None, device=None) -> RingBuffer:
    """An empty buffer of zeros, or one full of ``init`` [capacity, feat]."""
    data = torch.zeros((capacity, feat), dtype=dtype, device=device) \
        if init is None else init
    i32 = dict(dtype=torch.int32, device=data.device)
    return RingBuffer(data=data, ptr=torch.zeros((), **i32),
                      count=torch.tensor(capacity if init is not None
                                         else 0, **i32))


def enqueue(buf: RingBuffer, keys: torch.Tensor, enable=True) -> RingBuffer:
    """``keys`` [B, feat] written at the pointer with wraparound; with
    ``enable`` False (a bool or a 0-d bool tensor) the buffer is unchanged
    (the reference skips the enqueue when no valid keys exist)."""
    b, cap = keys.shape[0], buf.capacity
    dev = buf.data.device
    idx = (buf.ptr + torch.arange(b, dtype=torch.int32, device=dev)) % cap
    written = buf.data.clone()
    written[idx.long()] = keys.to(buf.data.dtype)
    en = torch.as_tensor(enable, device=dev)
    return RingBuffer(
        data=torch.where(en, written, buf.data),
        ptr=torch.where(en, (buf.ptr + b) % cap, buf.ptr).to(torch.int32),
        count=torch.where(en, torch.clamp(buf.count + b, max=cap),
                          buf.count).to(torch.int32))


def enqueue_fixed(data: torch.Tensor, ptr: int, keys: torch.Tensor) -> int:
    """Write ``keys`` [b, ...] into ``data`` [cap, ...] at ``ptr``.

    Unlike the JAX version, which returns a new array, this writes IN PLACE
    (the random pool is GB-scale at 256² and a copy per step would double
    it) and returns only the new pointer. The capacity must be a multiple
    of the batch, as the reference asserts (train_arco_2d.py:113): a batch
    that does not divide it would have to wrap mid-write."""
    b = keys.shape[0]
    cap = data.shape[0]
    if cap % b:
        raise ValueError(
            f"ring-buffer capacity ({cap}) must be divisible by the "
            f"enqueue batch ({b}); adjust K / batch sizes")
    ptr = int(ptr)
    with torch.no_grad():
        data[ptr:ptr + b].copy_(keys.to(data.dtype))
    return (ptr + b) % cap
