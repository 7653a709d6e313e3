"""3D sliding-window inference with the whole case on the device
(counterpart of arco_tpu/eval/sliding_window_device.py).

The volume goes to the device once; the window crops, the batched forwards,
the score and count sums, the normalization and the argmax all run there,
in the window order of eval/sliding_window.py, so the scores are the same
sums. The only copy to the host is the label map at the end (the scores stay
on the device). JAX compiles the case into one program; here the loop is
eager and launches asynchronously, with no host sync inside it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from arco_torch.eval.sliding_window import case_geometry


def test_single_case_3d_device(predict_fn, image, stride_xy: int,
                               stride_z: int, patch_size, num_classes: int,
                               window_batch: int = 4, device=None):
    """Drop-in for sliding_window.test_single_case_3d on ``device`` (a
    tensor image's own device by default). image: [W, H, D] numpy or
    tensor; predict_fn: [B, 1, *patch] tensor -> softmax [B, K, *patch].
    Returns (label_map numpy int32 [W, H, D], scores [K, W, H, D] on the
    device)."""
    vol = torch.as_tensor(image, dtype=torch.float32, device=device)
    pads, padded, coords = case_geometry(tuple(vol.shape), patch_size,
                                         stride_xy, stride_z)
    # F.pad takes the last dim first
    vol = F.pad(vol, [p for pair in reversed(pads) for p in pair])
    pw, ph, pd = patch_size
    score = torch.zeros((num_classes,) + padded, dtype=torch.float32,
                        device=vol.device)
    cnt = torch.zeros(padded, dtype=torch.float32, device=vol.device)
    for i in range(0, len(coords), window_batch):
        chunk = coords[i:i + window_batch]
        windows = torch.stack([vol[x:x + pw, y:y + ph, z:z + pd]
                               for x, y, z in chunk])[:, None]
        probs = predict_fn(windows)
        for (x, y, z), p in zip(chunk, probs):
            score[:, x:x + pw, y:y + ph, z:z + pd] += p
            cnt[x:x + pw, y:y + ph, z:z + pd] += 1
    score = score / cnt.clamp(min=1.0)
    sl = tuple(slice(a, n - b) for (a, b), n in zip(pads, padded))
    score = score[(slice(None),) + sl]
    return score.argmax(0).to(torch.int32).cpu().numpy(), score
