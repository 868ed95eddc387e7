"""
Post-processing plots (matplotlib backend), copied from
``beat_tpu/plotting/``; re-design of ``beat/plotting/`` (``plots_catalog``
``beat/plotting/__init__.py:7-25``).  GMT-based map plots of the
reference are re-implemented in matplotlib; each plot function takes a
Problem + stage trace and writes a PNG/PDF into
``<outfolder>/figures/``.
"""

from beat_tpu_torch.plotting.marginals import plot_correlation_hist, plot_stage_posteriors
from beat_tpu_torch.plotting.geodetic import (plot_geodetic_covariances, plot_gnss_fits,
    plot_scene_fits, plot_station_map)
from beat_tpu_torch.plotting.seismic import (plot_station_variance_reductions,
    plot_velocity_models, plot_waveform_fits)
from beat_tpu_torch.plotting.ffi import (plot_fault_geometry, plot_moment_rate,
    plot_slip_distribution)
from beat_tpu_torch.plotting.bem import plot_slip_distribution_3d
from beat_tpu_torch.plotting.mt import (plot_fuzzy_beachball, plot_fuzzy_mt_decomp,
    plot_hudson, plot_lune)

#: per-plot availability (reference mode/datatype matrices,
#: ``beat/plotting/__init__.py:27-56``)
plots_availability = {
    "stage_posteriors": {"modes": ["geometry", "ffi", "bem"], "datatypes": None},
    "correlation_hist": {"modes": ["geometry", "ffi", "bem"], "datatypes": None},
    "scene_fits": {"modes": ["geometry", "ffi", "bem"], "datatypes": ["geodetic"]},
    "gnss_fits": {"modes": ["geometry", "ffi", "bem"], "datatypes": ["geodetic"]},
    "station_map": {"modes": ["geometry", "ffi", "bem"], "datatypes": None},
    "geodetic_covariances": {"modes": ["geometry", "ffi", "bem"],
                             "datatypes": ["geodetic"]},
    "waveform_fits": {"modes": ["geometry", "ffi"], "datatypes": ["seismic"]},
    "station_variance_reductions": {"modes": ["geometry", "ffi"],
                                    "datatypes": ["seismic"]},
    "velocity_models": {"modes": ["geometry", "ffi"],
                        "datatypes": ["seismic", "polarity"]},
    "slip_distribution": {"modes": ["ffi"], "datatypes": None},
    "fault_geometry": {"modes": ["ffi"], "datatypes": None},
    "slip_distribution_3d": {"modes": ["ffi", "bem"], "datatypes": None},
    "moment_rate": {"modes": ["ffi"], "datatypes": ["seismic"]},
    "hudson": {"modes": ["geometry"], "datatypes": ["seismic", "polarity"]},
    "lune": {"modes": ["geometry"], "datatypes": ["seismic", "polarity"]},
    "fuzzy_beachball": {"modes": ["geometry"],
                        "datatypes": ["seismic", "polarity"]},
    "fuzzy_mt_decomp": {"modes": ["geometry"],
                        "datatypes": ["seismic", "polarity"]},
}

#: name -> plot function — reference plots_catalog parity
plots_catalog = {
    "stage_posteriors": plot_stage_posteriors,
    "correlation_hist": plot_correlation_hist,
    "scene_fits": plot_scene_fits,
    "gnss_fits": plot_gnss_fits,
    "station_map": plot_station_map,
    "geodetic_covariances": plot_geodetic_covariances,
    "waveform_fits": plot_waveform_fits,
    "station_variance_reductions": plot_station_variance_reductions,
    "velocity_models": plot_velocity_models,
    "slip_distribution": plot_slip_distribution,
    "fault_geometry": plot_fault_geometry,
    "slip_distribution_3d": plot_slip_distribution_3d,
    "moment_rate": plot_moment_rate,
    "hudson": plot_hudson,
    "lune": plot_lune,
    "fuzzy_beachball": plot_fuzzy_beachball,
    "fuzzy_mt_decomp": plot_fuzzy_mt_decomp,
}
