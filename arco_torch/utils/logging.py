"""Training metric logging (counterpart of arco_tpu/utils/logging.py, a
copy).

The reference logs scalars to tensorboardX and a pickled loss list
(train_arco_2d.py:440-478). Here: JSONL scalars (always) and TensorBoard
events when tensorboardX is importable, with the reference's scalar names
(info/total_loss, info/reco_loss, ...).
"""

from __future__ import annotations

import json
import os
from typing import Dict


def log_provenance(logger=None) -> str:
    """Log the framework's git commit (+dirty marker) as the experiment's
    provenance; the reference copies its code tree into the experiment dir
    instead (train_arco_2d.py:514-517)."""
    import logging as _logging
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True,
                             timeout=10).stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain"], cwd=root,
                               capture_output=True, text=True,
                               timeout=10).stdout.strip()
        ident = (rev + ("-dirty" if dirty else "")) if rev else "unknown"
    except (OSError, subprocess.SubprocessError):
        ident = "unknown"
    (logger or _logging).info("code provenance: arco_torch @ %s", ident)
    return ident


_TB_NAME_MAP = {
    "loss": "info/total_loss",
    "reco_loss": "info/reco_loss",
    "loss_q": "info/loss_q",
    "unsup_loss": "info/unsup_loss",
    "loss_ce": "info/loss_ce",
    "loss_dice": "info/loss_dice",
    "loss_eqv": "info/loss_eqv",
    "loss_latent": "info/loss_latent",
    "loss_output": "info/loss_output",
    "lr": "info/lr",
}


class MetricLogger:
    def __init__(self, snapshot_path: str):
        self.jsonl = open(os.path.join(snapshot_path, "metrics.jsonl"), "a")
        self.tb = None
        try:
            from tensorboardX import SummaryWriter
            self.tb = SummaryWriter(os.path.join(snapshot_path, "log"))
        except ImportError:
            pass

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": step}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(_TB_NAME_MAP.get(k, k), float(v), step)

    def log_images(self, step: int, images: Dict[str, "object"]):
        """TB image grids (train_arco_2d.py:441-459 parity).

        images: name -> [H, W] / [H, W, C] float array in [0, 1] or a label
        map (int). Label maps are scaled by 50 like the reference."""
        if self.tb is None:
            return
        import numpy as np
        for name, img in images.items():
            arr = np.asarray(img)
            if arr.ndim == 2:
                arr = arr[..., None]
            if np.issubdtype(arr.dtype, np.integer):
                arr = (arr.astype(np.float32) * 50.0).clip(0, 255) / 255.0
            self.tb.add_image(name, arr.transpose(2, 0, 1), step)

    def log_history_pickle(self, snapshot_path: str, history):
        """record.pkl parity (train_arco_2d.py:477-478)."""
        import pickle
        with open(os.path.join(snapshot_path, "record.pkl"), "wb") as f:
            pickle.dump(history, f)

    def load_history_pickle(self, snapshot_path: str):
        """Previously written loss history, for resume merge ([] if none).
        The file is one this logger wrote."""
        import pickle
        path = os.path.join(snapshot_path, "record.pkl")
        if not os.path.exists(path):
            return []
        with open(path, "rb") as f:
            return list(pickle.load(f))

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
