"""
Version and runtime information of the port (copied from
``beat_tpu/info.py``, reporting torch and the card instead of JAX and its
devices): ``beat-tpu-torch --version``.
"""

from __future__ import annotations

import subprocess

from beat_tpu_torch import __version__ as version


def card_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    why they could not be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or f"nvidia-smi failed ({out.stderr.strip()})"


def runtime_info(device=None) -> str:
    """The port's version, torch and its CUDA version, and — when
    ``device`` is a CUDA device — the card's name and power limit."""
    import torch

    lines = [f"beat_tpu_torch {version} — Bayesian earthquake-source inversion on PyTorch",
             f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none'}"]
    if device is not None and torch.device(device).type == "cuda":
        lines.append(f"device {device}: {torch.cuda.get_device_name(device)}")
        lines.append(f"card (name, power limit): {card_power_limit()}")
    elif device is not None:
        lines.append(f"device {device}")
    return "\n".join(lines)
