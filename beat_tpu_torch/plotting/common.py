"""Shared plotting utilities (copied from ``beat_tpu/plotting/common.py``;
reference ``beat/plotting/common.py``)."""

from __future__ import annotations

import os
from dataclasses import dataclass

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


@dataclass
class PlotOptions:
    """Reference ``PlotOptions``: output format/dpi, stage selection,
    point of reference."""

    outformat: str = "png"
    dpi: int = 150
    load_stage: int = -1
    force: bool = False
    reference: dict | None = None
    #: restrict marginal/corner plots to these variables (reference
    #: ``beat plot --varnames``); None = all
    varnames: list | None = None


def figures_dir(outfolder: str) -> str:
    d = os.path.join(outfolder, "figures")
    os.makedirs(d, exist_ok=True)
    return d


def save_figure(fig, outfolder: str, name: str, po: PlotOptions | None = None) -> str:
    po = po or PlotOptions()
    path = os.path.join(figures_dir(outfolder), f"{name}.{po.outformat}")
    fig.savefig(path, dpi=po.dpi, bbox_inches="tight")
    plt.close(fig)
    return path


def format_axes(ax):
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)


def histplot_op(ax, samples, reference=None, color="#2c7fb8", bins=40):
    """Marginal histogram with optional reference line
    (reference ``plotting/common.py`` histplot_op)."""
    ax.hist(samples, bins=bins, color=color, alpha=0.8, density=True)
    if reference is not None:
        ax.axvline(reference, color="crimson", lw=1.5)
    format_axes(ax)


def add_geographic_context(ax, event, color="0.45"):
    """
    Geographic context for local-km map axes (the reference draws full
    GMT basemaps in ``station_map``/``scene_fits``,
    ``beat/plotting/``): a lat/lon graticule derived from the event
    origin is always drawn; coastlines are overlaid when cartopy AND a
    locally cached Natural Earth dataset are available (fully gated —
    offline/hermetic runs keep the graticule-only fallback).

    ax : matplotlib axes in local east/north kilometres about the event
    event : object with ``lat``/``lon`` [deg]
    """
    import numpy as np

    from beat_tpu_torch.heart.geodesy import D2R, EARTH_RADIUS

    lat0, lon0 = float(event.lat), float(event.lon)
    # km per degree MUST match the spherical projection the datasets'
    # local coords were built with (heart/geodesy.py:73-82) or the
    # graticule/coastlines sit ~600 m/deg off the plotted data
    ky = D2R * EARTH_RADIUS / 1e3            # km per degree latitude
    kx = ky * np.cos(np.deg2rad(lat0))       # km per degree longitude
    x0, x1 = ax.get_xlim()
    y0, y1 = ax.get_ylim()

    def ticks(lo, hi):
        span = hi - lo
        for step in (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0):
            if span / step <= 6:
                break
        start = np.ceil(lo / step) * step
        return np.arange(start, hi + 1e-9, step)

    for lon in ticks(lon0 + x0 / kx, lon0 + x1 / kx):
        x = (lon - lon0) * kx
        ax.axvline(x, color=color, lw=0.4, ls=":", zorder=0)
        ax.annotate(f"{abs(lon):.2f}°{'E' if lon >= 0 else 'W'}",
                    (x, y1), fontsize=6, color=color,
                    ha="center", va="bottom", clip_on=False)
    for lat in ticks(lat0 + y0 / ky, lat0 + y1 / ky):
        y = (lat - lat0) * ky
        ax.axhline(y, color=color, lw=0.4, ls=":", zorder=0)
        ax.annotate(f"{abs(lat):.2f}°{'N' if lat >= 0 else 'S'}",
                    (x1, y), fontsize=6, color=color,
                    ha="left", va="center", clip_on=False)

    # coastlines: best effort, never required (natural_earth may try to
    # download — treat any failure as "no basemap available")
    try:
        import cartopy.io.shapereader as shpreader

        path = shpreader.natural_earth(resolution="50m",
                                       category="physical",
                                       name="coastline")
        lon_lo, lon_hi = lon0 + x0 / kx, lon0 + x1 / kx
        lat_lo, lat_hi = lat0 + y0 / ky, lat0 + y1 / ky
        for geom in shpreader.Reader(path).geometries():
            for line in getattr(geom, "geoms", [geom]):
                lons, lats = np.asarray(line.coords).T
                if (lons.max() < lon_lo or lons.min() > lon_hi
                        or lats.max() < lat_lo or lats.min() > lat_hi):
                    continue
                ax.plot((lons - lon0) * kx, (lats - lat0) * ky,
                        color=color, lw=0.8, zorder=1)
    except Exception:
        pass
    ax.set_xlim(x0, x1)
    ax.set_ylim(y0, y1)
    return ax
