"""
Default prior bounds of every sampleable parameter name (copied from
``beat_tpu/defaults.py``, trimmed to what the port calls).

Every name maps to a ``Bounds(physical_bounds, default_bounds, unit)``
record; :func:`default_bounds` seeds ``Parameter.from_defaults``.  Names
outside the registry (the noise hyperparameters ``h_<wavemap>``) take the
``hypers`` record.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

SQRT2 = math.sqrt(2.0)
PI = math.pi
INF = float("inf")

u_n = "[N]"
u_nm = "[Nm]"
u_km = "[km]"
u_km_s = "[km/s]"
u_deg = "[deg]"
u_deg_myr = "[deg/myr]"
u_m = "[m]"
u_v = "[m^3]"
u_s = "[s]"
u_rad = "[rad]"
u_hyp = ""
u_percent = "[%]"
u_nanostrain = "[nstrain]"
u_pa = "[MPa]"


@dataclass(frozen=True)
class Bounds:
    physical_bounds: tuple
    default_bounds: tuple
    unit: str = u_hyp


_mdiag = (-SQRT2, SQRT2)
_moff = (-1.0, 1.0)

#: Full registry of known parameter names.
parameter_info: dict[str, Bounds] = {
    # --- geometry ---
    "east_shift": Bounds((-500.0, 500.0), (-10.0, 10.0), u_km),
    "north_shift": Bounds((-500.0, 500.0), (-10.0, 10.0), u_km),
    "depth": Bounds((0.0, 1000.0), (0.0, 5.0), u_km),
    "strike": Bounds((-90.0, 420.0), (0.0, 180.0), u_deg),
    "strike1": Bounds((-90.0, 420.0), (0.0, 180.0), u_deg),
    "strike2": Bounds((-90.0, 420.0), (0.0, 180.0), u_deg),
    "dip": Bounds((-45.0, 135.0), (45.0, 90.0), u_deg),
    "dip1": Bounds((-45.0, 135.0), (45.0, 90.0), u_deg),
    "dip2": Bounds((-45.0, 135.0), (45.0, 90.0), u_deg),
    "rake": Bounds((-180.0, 270.0), (-90.0, 90.0), u_deg),
    "rake1": Bounds((-180.0, 270.0), (-90.0, 90.0), u_deg),
    "rake2": Bounds((-180.0, 270.0), (-90.0, 90.0), u_deg),
    "length": Bounds((0.0, 7000.0), (5.0, 30.0), u_km),
    "width": Bounds((0.0, 500.0), (5.0, 20.0), u_km),
    "slip": Bounds((0.0, 150.0), (0.1, 8.0), u_m),
    "opening_fraction": Bounds(_moff, (0.0, 0.0), u_hyp),
    "diameter": Bounds((0.0, 100.0), (5.0, 10.0), u_km),
    "sign": Bounds((-1.0, 1.0), (-1.0, 1.0), u_hyp),
    "delta_depth": Bounds((0.0, 1000.0), (0.0, 10.0), u_km),
    "volume_change": Bounds((-1e12, 1e12), (1e8, 1e10), u_v),
    "azimuth": Bounds((0.0, 360.0), (0.0, 180.0), u_deg),
    "amplitude": Bounds((1.0, 10e25), (1e10, 1e20), u_nm),
    "locking_depth": Bounds((0.1, 100.0), (1.0, 10.0), u_km),
    "mix": Bounds((0.0, 1.0), (0.0, 1.0), u_hyp),
    # --- source time ---
    "time": Bounds((-200.0, 200.0), (-5.0, 5.0), u_s),
    "time_shift": Bounds((-20.0, 20.0), (-5.0, 5.0), u_s),
    "delta_time": Bounds((0.0, 100.0), (0.0, 10.0), u_s),
    "duration": Bounds((0.0, 600.0), (1.0, 30.0), u_s),
    "peak_ratio": Bounds((0.0, 1.0), (0.0, 1.0), u_hyp),
    # --- moment tensor ---
    "mnn": Bounds(_mdiag, _mdiag, u_nm),
    "mee": Bounds(_mdiag, _mdiag, u_nm),
    "mdd": Bounds(_mdiag, _mdiag, u_nm),
    "mne": Bounds(_moff, _moff, u_nm),
    "mnd": Bounds(_moff, _moff, u_nm),
    "med": Bounds(_moff, _moff, u_nm),
    "magnitude": Bounds((-5.0, 10.0), (4.0, 7.0), u_hyp),
    # --- forces ---
    "fn": Bounds((-1e20, 1e20), (-1e20, 1e20), u_n),
    "fe": Bounds((-1e20, 1e20), (-1e20, 1e20), u_n),
    "fd": Bounds((-1e20, 1e20), (-1e20, 1e20), u_n),
    # --- Tape & Tape 2015 lune parameterisation ---
    "w": Bounds((-3.0 / 8.0 * PI, 3.0 / 8.0 * PI), (-3.0 / 8.0 * PI, 3.0 / 8.0 * PI), u_rad),
    "v": Bounds((-1.0 / 3.0, 1.0 / 3.0), (-1.0 / 3.0, 1.0 / 3.0), u_rad),
    "kappa": Bounds((0.0, 2 * PI), (0.0, 2 * PI), u_rad),
    "sigma": Bounds((-PI / 2.0, PI / 2.0), (-PI / 2.0, PI / 2.0), u_rad),
    "h": Bounds((0.0, 1.0), (0.0, 1.0), u_hyp),
    # --- FFI / distributed slip ---
    "uparr": Bounds((-1.0, 150.0), (-0.05, 6.0), u_m),
    "uperp": Bounds((-150.0, 150.0), (-0.3, 4.0), u_m),
    "utens": Bounds((-150.0, 150.0), (0.0, 0.0), u_m),
    "durations": Bounds((0.0, 600.0), (0.5, 29.5), u_s),
    "velocities": Bounds((0.0, 20.0), (0.5, 4.2), u_km_s),
    "nucleation_strike": Bounds((0.0, INF), (0.0, 10.0), u_km),
    "nucleation_dip": Bounds((0.0, INF), (0.0, 7.0), u_km),
    "nucleation_x": Bounds(_moff, _moff, u_hyp),
    "nucleation_y": Bounds(_moff, _moff, u_hyp),
    "coupling": Bounds((0.0, 100.0), (0.0, 1.0), u_percent),
    # --- hierarchicals / corrections ---
    "ramp": Bounds((-0.1, 0.1), (-0.005, 0.005), u_rad),
    "offset": Bounds((-0.05, 0.05), (-0.05, 0.05), u_m),
    "lat": Bounds((-90.0, 90.0), (30.0, 30.5), u_deg),
    "lon": Bounds((-180.0, 180.0), (30.0, 30.5), u_deg),
    "omega": Bounds((-10.0, 10.0), (0.5, 0.6), u_deg_myr),
    "exx": Bounds((-INF, INF), (-200.0, 200.0), u_nanostrain),
    "eyy": Bounds((-INF, INF), (-200.0, 200.0), u_nanostrain),
    "exy": Bounds((-INF, INF), (-200.0, 200.0), u_nanostrain),
    "rotation": Bounds((-INF, INF), (-200.0, 200.0), u_nanostrain),
    # --- BEM ---
    "traction": Bounds((0.0, 1000.0), (0.0, 50.0), u_pa),
    "strike_traction": Bounds((-15000.0, 15000.0), (-50.0, 50.0), u_pa),
    "dip_traction": Bounds((-15000.0, 15000.0), (-50.0, 50.0), u_pa),
    "normal_traction": Bounds((-15000.0, 15000.0), (-50.0, 50.0), u_pa),
    "a_half_axis": Bounds((0.01, 100.0), (0.01, 10.0), u_km),
    "b_half_axis": Bounds((0.01, 100.0), (0.01, 10.0), u_km),
    "a_half_axis_bottom": Bounds((0.01, 100.0), (0.01, 10.0), u_km),
    "b_half_axis_bottom": Bounds((0.01, 100.0), (0.01, 10.0), u_km),
    "plunge": Bounds((0.0, 90.0), (0.0, 20.0), u_deg),
    "delta_east_shift_bottom": Bounds((-500.0, 500.0), (-10.0, 10.0), u_km),
    "delta_north_shift_bottom": Bounds((-500.0, 500.0), (-10.0, 10.0), u_km),
    "curv_amplitude_bottom": Bounds(_moff, _moff, u_hyp),
    "curv_location_bottom": Bounds((0.0, 1.0), (0.0, 1.0), u_hyp),
    "bend_location": Bounds((0.0, 1.0), (0.0, 1.0), u_hyp),
    "bend_amplitude": Bounds(_moff, _moff, u_hyp),
    "height": Bounds((0.0, 100.0), (0.1, 4.0), u_km),   # ring-fault vertical extent
    # --- misc ---
    "depth_bottom": Bounds((0.0, 300.0), (0.0, 10.0), u_km),
    "distance": Bounds((0.0, 300.0), (0.0, 10.0), u_km),
    "hypers": Bounds((-10.0, 10.0), (-2.0, 6.0), u_hyp),
    "like": Bounds((-INF, INF), (0.0, 1.0), u_hyp),
}


def hypername(varname: str) -> str:
    """Map a variable name to its registry key (unknown names → 'hypers')."""
    return varname if varname in parameter_info else "hypers"


def default_bounds(varname: str) -> tuple:
    return parameter_info[hypername(varname)].default_bounds


def physical_bounds(varname: str) -> tuple:
    return parameter_info[hypername(varname)].physical_bounds
