"""
Custom colormaps for slip and velocity-perturbation plots (copied from
``beat_tpu/plotting/colormap.py``; reference ``beat/colormap.py``:
``slip_colormap``, ``roma_colormap``).

Both maps are *generated* from a handful of anchor colors instead of
embedding the reference's 256-row tables: the slip map is the standard
white-blue-green-yellow-red earthquake-slip ramp, and roma is Crameri's
published scientific colormap (anchors sampled from the public data,
perceptually close at plotting resolution).
"""

from __future__ import annotations

import numpy as np
from matplotlib.colors import LinearSegmentedColormap

#: white → blue → green → yellow → red ramp of the reference slip map
_SLIP_ANCHORS = [
    (1.0, 1.0, 1.0),
    (0.0, 0.7, 1.0),
    (0.0, 0.8, 0.0),
    (0.5, 1.0, 0.0),
    (1.0, 1.0, 0.0),
    (1.0, 0.5, 0.0),
    (1.0, 0.0, 0.0),
]

#: Crameri "roma" (diverging red→yellow→teal→blue), 9 anchors
_ROMA_ANCHORS = [
    (0.497, 0.100, 0.000),
    (0.628, 0.372, 0.105),
    (0.751, 0.625, 0.229),
    (0.882, 0.872, 0.536),
    (0.800, 0.922, 0.784),
    (0.477, 0.814, 0.843),
    (0.282, 0.596, 0.771),
    (0.195, 0.391, 0.683),
    (0.104, 0.200, 0.600),
]


def _build(name, anchors, nbins, return_numpy, reverse=False):
    anchors = anchors[::-1] if reverse else anchors
    cmap = LinearSegmentedColormap.from_list(name, anchors, N=nbins)
    if return_numpy:
        return np.array([cmap(i)[:3] for i in range(nbins)])
    return cmap


def slip_colormap(nbins: int = 256, return_numpy: bool = False):
    """Distributed-slip colormap (reference ``slip_colormap``)."""
    return _build("slipcolor", _SLIP_ANCHORS, nbins, return_numpy)


def roma_colormap(nbins: int = 256, return_numpy: bool = False,
                  reverse: bool = False):
    """Crameri roma diverging map for velocity perturbations
    (reference ``roma_colormap``)."""
    return _build("roma_r" if reverse else "roma", _ROMA_ANCHORS, nbins,
                  return_numpy, reverse)
