"""
Device policy, dtype and numeric settings of the port.

* Work in float32 (:data:`DTYPE`).
* TF32 is OFF for matmuls and cuDNN: TF32 rounds at about 1e-3, and the
  data-covariance whitening of the likelihood amplifies that rounding
  far past sampler noise (measured for bf16 spectra in the JAX package,
  ``beat_tpu/heart/gftable.py:180-190``).
* There is no "CUDA if present, else CPU": code runs where its
  ``device`` argument says, and :func:`require_cuda` raises when a GPU
  run finds no card.
"""

from __future__ import annotations

import torch

DTYPE = torch.float32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve(device) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` is refused, so no
    caller silently lands on a default device."""
    if device is None:
        raise ValueError("an explicit device is required (e.g. 'cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:   # "cuda" -> "cuda:<current>", as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


#: bytes a batch may take on the CPU (:func:`chunk_budget`)
HOST_CHUNK_BYTES = 4e9


def chunk_budget(device: torch.device) -> float:
    """Bytes one batch of a chunked device computation may take: a fifth
    of a card's memory, :data:`HOST_CHUNK_BYTES` on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 5
    return HOST_CHUNK_BYTES


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this path needs an NVIDIA GPU "
                           "and does not fall back to the CPU")
    return torch.device("cuda", 0)
