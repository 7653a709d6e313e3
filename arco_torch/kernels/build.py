"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface. At first use each is
compiled with ``nvcc`` for ``sm_90a`` (all sources at once, one process
each), linked into one shared library under ``build/arco_torch_kernels/``
at the repository root, and loaded with ctypes. The library's name carries a
hash of the sources and their shared header, so an edit rebuilds it and an
unchanged tree reuses it.
Nothing here runs at import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("infonce.cu", "pool_sims.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arco_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F, _SZ = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float, ctypes.c_size_t)
_SIGNATURES = {
    "arco_infonce_fwd": (_I, [_P] * 6 + [_I] * 4 + [_LL, _F, _P]),
    "arco_infonce_bwd": (_I, [_P] * 6 + [_I] * 4 + [_LL, _P]),
    "arco_infonce_fwd_f32": (_I, [_P] * 6 + [_I] * 4 + [_LL, _F, _P]),
    "arco_infonce_bwd_f32": (_I, [_P] * 6 + [_I] * 4 + [_LL, _P]),
    "arco_infonce_smem": (_SZ, [_I, _I, _I]),
    "arco_infonce_group": (_I, []),
    "arco_infonce_splits": (_I, [_I] * 4),
    "arco_infonce_rows": (_I, [_I] * 6),
    "arco_pool_sims": (_I, [_P, _P, _P, _P, _I, _I, _LL, _I, _P]),
    "arco_pool_sims_f32": (_I, [_P, _P, _I, _P, _P, _I, _I, _LL, _I, _P]),
    "arco_pool_sims_blocks_per_sm": (_I, []),
}

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libarco_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile (if needed) and return the shared library's path. The
    compiler's register/shared-memory report goes to ``<lib>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for name, p in zip(SOURCES, procs):
        text = p.communicate()[0]
        logs.append(f"== {name}\n{text}")
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    for obj in objs:
        obj.unlink()
    out.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp, out)
    return out


def load_library():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, (restype, argtypes) in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, argtypes
        _lib = lib
    return _lib


def check(rc: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
