"""
Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each kernel source under ``beat_tpu_torch/csrc/`` exposes a plain C
entry point.  :func:`load` compiles it for ``sm_90a`` into
``beat_tpu_torch/_build/`` (ignored by git), named by a hash of the
source and the flags, so an unchanged source is compiled once per
checkout; then it opens the shared library and declares the argument
types.  No PyTorch headers are involved (a plain C interface builds in
seconds).  Nothing here runs at import: the CPU tests import every
module of the package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from beat_tpu_torch.profiling import count

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

#: C signatures of the entry points, by kernel source name
SIGNATURES = {
    "bilgather": {
        "beat_bilinear_rows_f32": (_I, [_P, _P, _P, _P, _P, _I64, _I, _I, _P]),
        "beat_corner_dot_f32": (_I, [_P, _P, _P, _P, _P, _I64, _I, _I, _P]),
        "beat_bilinear_contract_f32": (_I, [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P]),
        "beat_contract_corner_dot_f32": (_I, [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P]),
        "beat_contract_tile": (_I, [_I]),
    },
    "gfstack": {
        "beat_gf_stack_multilinear_f32": (_I, [_P] * 7 + [_I] * 6 + [_I64] * 7 + [_I] * 3
                                          + [_P, _P]),
        "beat_gf_stack_nearest_f32": (_I, [_P] * 5 + [_I] * 6 + [_I64] * 4 + [_I] * 3
                                      + [_P, _P]),
        "beat_gf_stack_multilinear_bf16": (_I, [_P] * 7 + [_I] * 6 + [_I64] * 7 + [_I] * 3
                                           + [_P, _P]),
        "beat_gf_stack_nearest_bf16": (_I, [_P] * 5 + [_I] * 6 + [_I64] * 4 + [_I] * 3
                                       + [_P, _P]),
        "beat_gf_stack_fold_f32": (_I, [_P] * 6 + [_I] * 4 + [_I64] * 5 + [_I] * 2 + [_P]),
    },
    "eikonal": {
        "beat_eikonal_f32": (_I, [_P] * 5 + [_I] * 3 + [_F] * 2 + [_I, _P]),
    },
    "rowgather": {
        "beat_gather_rows_f32": (_I, [_P, _P, _I, _I64, _P, _I64, _I64, _I, _P]),
    },
}


@dataclass
class BuildInfo:
    """What :func:`load` did for one kernel library."""

    path: Path
    seconds: float      # nvcc wall-clock; 0.0 when the library was cached
    cached: bool
    log: str            # nvcc's output, including ``-Xptxas -v``


_loaded: dict = {}  # (name, defines) -> (ctypes.CDLL, BuildInfo), per process


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    candidates = [os.path.join(os.environ[k], "bin", "nvcc")
                  for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                           "the CUDA kernels are built from source at first use")
    return found


def build(name: str, defines: tuple = ()) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>-<hash>.so``
    unless that file exists already.  ``defines`` are extra ``-D`` flags
    (measurement builds: ``tools/bench_torch_stack.py --ablate``)."""
    src = CSRC_DIR / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(defines)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, True, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, False, log)


def build_all(names) -> dict:
    """Compile several kernel sources at once, one ``nvcc`` process each,
    all started together: ``{name: BuildInfo}``."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str, defines: tuple = ()):
    """The loaded ``ctypes`` library of kernel ``name`` (built on first
    use, with ``defines`` as for :func:`build`) and its
    :class:`BuildInfo`."""
    key = (name, tuple(defines))
    if key not in _loaded:
        info = build(name, defines)
        lib = ctypes.CDLL(str(info.path))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[key] = (lib, info)
    return _loaded[key]


def _stream(torch, device) -> int:
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(device.index) if raw is not None else torch.cuda.current_stream(device).cuda_stream


def launch(device, entry, *args) -> int:
    """Call the C entry ``entry(*args, stream)`` with ``device`` current
    and ``stream`` PyTorch's current stream on it; returns the entry's
    code.  The device guard is entered only where ``device`` is not the
    current one already, and the stream comes as a plain integer: a
    launch-sized kernel is bounded by this path.  Every launch of the
    port goes through here, and one whose entry returns 0 counts
    ``launches.<entry name>`` (a counter of
    :mod:`beat_tpu_torch.profiling`: nothing while spans are off)."""
    import torch

    if device.index == torch.cuda.current_device():
        rc = entry(*args, _stream(torch, device))
    else:
        with torch.cuda.device(device):
            rc = entry(*args, _stream(torch, device))
    if rc == 0:
        count("launches." + entry.__name__)
    return rc
