"""Package boundary of the PyTorch port: it never imports JAX or the JAX
package, and its entry points refuse a CUDA device that is not there."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from arco_torch import resolve_device
from arco_torch.cli import pretrain_2d, test_2d, train_arco_2d
from arco_torch.config import ArcoConfig, ISDConfig
from arco_torch.data.device_bank import DeviceSliceBank
from arco_torch.models import net_factory
from arco_torch.train import arco2d, pretrain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "arco_tpu")


def _port_sources():
    return sorted((ROOT / "arco_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_cuda_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")
    mods = arco2d.make_arco_modules(net_factory("unet", class_num=4), 32, 32,
                                    batch_size=1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        arco2d.init_arco_state(mods, ArcoConfig(K=2), (1, 1, 32, 32))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        arco2d.make_arco_step(mods, ArcoConfig(use_photometric=False,
                                               use_adv_morph=False),
                              num_classes=4, max_iterations=10)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DeviceSliceBank(np.zeros((1, 8, 8), np.float32),
                        np.zeros((1, 8, 8), np.int8))
    # the CLIs take the card unless given --device cpu, and refuse before
    # they read any data
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        train_arco_2d.main(["--root_path", "/nonexistent"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        test_2d.main(["--root_path", "/nonexistent"])


def test_pretrain_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    mods = pretrain.make_isd_modules(net_factory("unet", class_num=4), 4,
                                     latent_feature_size=8,
                                     output_pooling_size=2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pretrain.init_pretrain_state(mods, ISDConfig(K=2, patch_size=16),
                                     (1, 1, 32, 32))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pretrain.make_pretrain_step(ISDConfig(), 1, 4, 10)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pretrain_2d.main(["--root_path", "/nonexistent"])
