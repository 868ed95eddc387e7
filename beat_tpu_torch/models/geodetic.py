"""
Geodetic composites: static surface-displacement likelihoods (port of
``beat_tpu/models/geodetic.py``), batched over a leading chain axis.

One evaluation, for C chains at once:

    point → surface displacements of every source, summed (C, N, 3)
    → LOS projection (C, N) → minus the corrections (ramps, plate
    rotation, strain rate) → residual × overlap weights
    → per dataset the Cholesky-whitened Gaussian with its noise
    hyperparameter, summed over datasets (C,)

The analytic halfspace forwards are :mod:`beat_tpu_torch.heart.okada`:
rectangles through Okada, explosions through Mogi, the moment-tensor
families through the 9-crack expansion, evaluated in
:data:`~beat_tpu_torch.heart.okada.FORWARD_DTYPE` (float64); the LOS
synthetics and the likelihood are float32.  With a ``static_table``
(:class:`~beat_tpu_torch.heart.statictable.StaticGFTable`) every source
goes through the table instead: point MTs directly, rectangles as a
fixed patch grid of point MTs with the local µ and λ.  An
:class:`~beat_tpu_torch.heart.viscoelastic.EpochStaticGFTable` is such a
table whose every observation reads its own acquisition epoch's slab
(``heart.viscoelastic.epoch_table_for_datasets`` builds it from the
datasets' times).  A source made of
K point sources (the couples of a DoubleDC, the ring of a Ringfault, the
patches of a rectangle on a table) is one more leading axis of one table
gather.  On the halfspace the K moment-tensor expansions are summed one
sub-source at a time instead: one expansion at 2000 chains and 3000
points peaks at 47.7 GB on an 80 GB card (``PERF.md`` §5), so two at
once do not fit.

A sampled ``point`` maps names to (C,) tensors, or (C, n_sources) where
several sources share a name; the likelihoods return (C,).  The
diagnostics take one point without a chain axis and return numpy.  Every
data array is a registered buffer; :meth:`GeodeticComposite.update_weights`
copies new weights into them in place, so the device data a sampler
holds stay current.  The JAX package's jit cache of ``synthetics_los_np``
is not ported: the diagnostics run the forward under ``torch.no_grad()``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from beat_tpu_torch.covariance import GeodeticNoiseAnalyser, geodetic_cov_velocity_models
from beat_tpu_torch.device import resolve
from beat_tpu_torch.distributions import multivariate_normal_chol
from beat_tpu_torch.heart.corrections import (EulerPoleCorrection, RampCorrection,
                                              StrainRateCorrection)
from beat_tpu_torch.heart.geodesy import DatasetStack
from beat_tpu_torch.heart import okada
from beat_tpu_torch.models.base import Composite, dataset_hyper_terms
from beat_tpu_torch.models.seismic import double_dc_sub_sources, point_getter, source_m6
from beat_tpu_torch.sources import (CLVDSource, DCSource, DoubleDCSource, ExplosionSource,
                                    MTQTSource, MTSource, RectangularSource, RingfaultSource,
                                    rectangular_patch_grid, sdr_to_m6, tensile_m6)

logger = logging.getLogger("beat_tpu_torch.models.geodetic")

#: the point sources whose moment tensor ``source_m6`` gives
MT_FAMILIES = (MTSource, MTQTSource, DCSource, CLVDSource)

class GeodeticComposite(Composite):
    """Dataset stacking, weights, hyperparameters and corrections; the
    forward (``synthetics_los``) comes from a subclass."""

    name = "geodetic"

    def __init__(self, datasets, noise_structure="import", hp_specific=False,
                 corrections=None, *, device):
        super().__init__()
        dev = resolve(device)
        self.datasets = list(datasets)
        self.stack = DatasetStack.from_datasets(self.datasets)
        self.hp_specific = hp_specific
        self.noise_analyser = GeodeticNoiseAnalyser(structure=noise_structure)
        self.corrections = list(corrections or [])
        for key, arr in (("data", self.stack.displacement), ("los", self.stack.los),
                         ("odw", self.stack.odw), ("coords", self.stack.coords)):
            self.register_buffer(key, torch.as_tensor(np.asarray(arr, dtype=np.float32),
                                                      device=dev))
        for i, arrays in enumerate(self._weight_arrays()):
            for key, arr in arrays.items():
                self.register_buffer(f"dataset{i}_{key}", torch.as_tensor(arr, device=dev))
        logger.info("Geodetic composite: %i datasets, %i data points", len(self.datasets),
                    self.stack.samples)

    # -- weights ----------------------------------------------------------------

    def _weight_arrays(self) -> list:
        return [{"weights": np.asarray(ds.covariance.chol_inverse, dtype=np.float32),
                 "slog_pdet": np.asarray(ds.covariance.log_pdet, dtype=np.float32)}
                for ds in self.datasets]

    def _update_device_arrays(self) -> None:
        """Copy the datasets' current weights into the buffers in place."""
        for i, arrays in enumerate(self._weight_arrays()):
            for key, arr in arrays.items():
                buf = getattr(self, f"dataset{i}_{key}")
                buf.copy_(torch.as_tensor(arr, device=buf.device))

    def device_data(self) -> dict:
        """The buffers the likelihood reads, weights as per-dataset lists."""
        n = len(self.datasets)
        return {"data": self.data, "los": self.los, "odw": self.odw, "coords": self.coords,
                "weights": [getattr(self, f"dataset{i}_weights") for i in range(n)],
                "slog_pdets": [getattr(self, f"dataset{i}_slog_pdet") for i in range(n)]}

    def batch_of_one(self, point: dict) -> dict:
        """A point without a chain axis as one chain, in the buffers'
        dtype and on their device."""
        return {k: torch.as_tensor(np.asarray(v), dtype=self.data.dtype,
                                   device=self.data.device)[None]
                for k, v in point.items()}

    def update_weights(self, point: dict) -> None:
        """Non-Toeplitz covariances of the residuals at ``point`` (no chain
        axis), the sampled corrections subtracted as the likelihood does."""
        if self.noise_analyser.structure == "import":
            return
        synth = self.synthetics_np(point)
        corrs = self._corrections_np(point)
        for ds, slc, corr in zip(self.datasets, self.stack.slices, corrs):
            residual = self.stack.displacement[slc] - synth[slc] - corr
            ds.covariance.data = self.noise_analyser.get_data_covariance(
                ds.coords, ds.displacement, residual=residual)
        self._update_device_arrays()

    # -- hyperparameters and hierarchicals --------------------------------------

    def _hypername(self, i: int, ds) -> str:
        return f"h_{ds.typ}_{i}" if self.hp_specific else f"h_{ds.typ}"

    def get_hypernames(self):
        if self.hp_specific:
            return [self._hypername(i, ds) for i, ds in enumerate(self.datasets)]
        return sorted({self._hypername(i, ds) for i, ds in enumerate(self.datasets)})

    def get_hierarchical_names(self):
        names = []
        for corr in self.corrections:
            for n in corr.parameter_names:
                # per-dataset instances of one correction share hierarchicals
                if n not in names:
                    names.append(n)
        return names

    def _correction_displacement(self, point: dict, ds, slc, data: dict):
        """Summed correction displacement (C, M) of one dataset (LOS), or 0."""
        out = 0.0
        for corr in self.corrections:
            if isinstance(corr, RampCorrection):
                if corr.dataset_name == ds.name:
                    out = out + corr.displacement(point, data["coords"][slc])
            elif isinstance(corr, (EulerPoleCorrection, StrainRateCorrection)):
                # a None dataset_name applies to every GNSS dataset
                if ds.typ == "GNSS" and corr.dataset_name in (None, ds.name):
                    out = out + corr.displacement(point, data["los"][slc])
        return out

    def _corrections_np(self, point: dict) -> list:
        """Each dataset's correction displacement at one point, numpy."""
        batched, data = self.batch_of_one(point), self.device_data()
        with torch.no_grad():
            corrs = [self._correction_displacement(batched, ds, slc, data)
                     for ds, slc in zip(self.datasets, self.stack.slices)]
        return [np.zeros(ds.samples) if isinstance(c, float) else c[0].double().cpu().numpy()
                for ds, c in zip(self.datasets, corrs)]

    # -- likelihood -------------------------------------------------------------

    def synthetics_los(self, point: dict, data=None) -> torch.Tensor:
        raise NotImplementedError

    def _residuals(self, point: dict, synth: torch.Tensor, data: dict) -> list:
        return [(data["data"][slc] - synth[:, slc]
                 - self._correction_displacement(point, ds, slc, data)) * data["odw"][slc]
                for ds, slc in zip(self.datasets, self.stack.slices)]

    def _loglike(self, point: dict, residuals: list, data: dict) -> torch.Tensor:
        total = 0.0
        for i, (ds, res) in enumerate(zip(self.datasets, residuals)):
            total = total + multivariate_normal_chol(res, data["weights"][i],
                                                     data["slog_pdets"][i],
                                                     point.get(self._hypername(i, ds), 0.0))
        return total

    def loglike(self, point: dict, data=None) -> torch.Tensor:
        """(C,) data log-likelihood of a batch of chains."""
        data = self.device_data() if data is None else data
        return self._loglike(point, self._residuals(point, self.synthetics_los(point, data),
                                                    data), data)

    def hyper_loglike(self, point: dict, fixed_point: dict, data=None) -> torch.Tensor:
        """(C,) log-likelihood of the chains' hyperparameters with the
        residuals of one ``fixed_point`` (no chain axis)."""
        data = self.device_data() if data is None else data
        fixed = self.batch_of_one(fixed_point)
        residuals = self._residuals(fixed, self.synthetics_los(fixed, data), data)
        return self._loglike(point, residuals, data)

    def hyper_data(self, fixed_point: dict, data=None) -> tuple:
        """The fixed-residual terms of the hyper-only posterior at
        ``fixed_point`` (no chain axis): one forward, after which a draw
        of the hyperparameters costs O(datasets)."""
        data = self.device_data() if data is None else data
        fixed = self.batch_of_one(fixed_point)
        with torch.no_grad():
            residuals = self._residuals(fixed, self.synthetics_los(fixed, data), data)
        return dataset_hyper_terms(
            [r[0] for r in residuals], data["weights"], data["slog_pdets"],
            [float(ds.samples) for ds in self.datasets],
            [self._hypername(i, ds) for i, ds in enumerate(self.datasets)])

    # -- diagnostics --------------------------------------------------------------

    def synthetics_np(self, point: dict) -> np.ndarray:
        """(N,) LOS synthetics of one point (no chain axis), numpy."""
        with torch.no_grad():
            return self.synthetics_los(self.batch_of_one(point))[0].double().cpu().numpy()

    def get_synthetics(self, point: dict) -> dict:
        synth = self.synthetics_np(point)
        return {ds.name: synth[slc] for ds, slc in zip(self.datasets, self.stack.slices)}

    def get_standardized_residuals(self, point: dict) -> dict:
        """Residuals whitened by the covariances' inverse Cholesky factors."""
        synth, corrs = self.synthetics_np(point), self._corrections_np(point)
        return {ds.name: ds.covariance.chol_inverse
                @ ((self.stack.displacement[slc] - synth[slc] - corr) * self.stack.odw[slc])
                for ds, slc, corr in zip(self.datasets, self.stack.slices, corrs)}

    def get_variance_reductions(self, point: dict) -> dict:
        synth, corrs = self.synthetics_np(point), self._corrections_np(point)
        out = {}
        for ds, slc, corr in zip(self.datasets, self.stack.slices, corrs):
            obs = self.stack.displacement[slc]
            res = obs - synth[slc] - corr
            out[ds.name] = 1.0 - (res @ res) / max(obs @ obs, 1e-30)
        return out


class GeodeticGeometryComposite(GeodeticComposite):
    """Nonlinear source-geometry forward: the summed displacements of the
    sources, on the analytic halfspace or through a ``static_table``.

    ensemble_nus / ensemble_tables : the earth-model ensemble (Poisson
    ratios on the halfspace, perturbed static tables on the table path)
    whose synthetics' spread becomes ``Covariance.pred_v`` at
    :meth:`update_weights`."""

    def __init__(self, datasets, sources, nu=0.25, shear_modulus=33e9, static_table=None,
                 finite_patches=(4, 4), ensemble_nus=None, ensemble_tables=None, *, device,
                 **kwargs):
        super().__init__(datasets, device=device, **kwargs)
        self.sources = list(sources)
        for src in self.sources:
            if not isinstance(src, (ExplosionSource, DoubleDCSource, RingfaultSource,
                                    RectangularSource) + MT_FAMILIES):
                raise NotImplementedError(
                    f"Geodetic statics for {type(src).__name__} (use the BEM composite "
                    "for meshed sources: models/bem.py::GeodeticBEMComposite)")
        self.nu = nu
        self.shear_modulus = shear_modulus
        self.static_table = static_table
        self.finite_patches = tuple(finite_patches)
        self.ensemble_nus = tuple(ensemble_nus) if ensemble_nus else None
        self.ensemble_tables = list(ensemble_tables or [])
        for table in [static_table] + self.ensemble_tables:
            if table is not None and table.values.device != self.data.device:
                raise ValueError(f"static table on {table.values.device}, composite on "
                                 f"{self.data.device}")
            # an epoch table (heart.viscoelastic.EpochStaticGFTable) indexes
            # the stacked observations: one epoch per data point
            n_obs = getattr(table, "n_observations", None)
            if n_obs is not None and n_obs != self.stack.samples:
                raise ValueError(f"the epoch table indexes {n_obs} observations, the "
                                 f"datasets hold {self.stack.samples}")

    def device_data(self) -> dict:
        data = super().device_data()
        if self.static_table is not None:
            data["static_table"] = self.static_table
        return data

    def update_weights(self, point: dict) -> None:
        super().update_weights(point)
        if not self.ensemble_nus and not self.ensemble_tables:
            return
        pred_vs = geodetic_cov_velocity_models(self, point,
                                               nus=self.ensemble_nus or (0.2, 0.25, 0.3),
                                               ensemble_tables=self.ensemble_tables)
        for ds, pv in zip(self.datasets, pred_vs):
            ds.covariance.pred_v = pv
        self._update_device_arrays()

    def _getter(self, point: dict, i: int, n_chains: int):
        return point_getter(self.sources[i], point, i, len(self.sources), n_chains,
                            self.data.device, self.data.dtype)

    def _mt_sum(self, coords, m6s, east, north, depth):
        """Σ over K sub-sources of the MT forward, one at a time: m6s
        (C, K, 6), positions (C, K) → (C, N, 3)."""
        disp = 0.0
        for k in range(m6s.shape[1]):
            disp = disp + okada.mt_surface_displacement(
                coords, m6s[:, k], east[:, k], north[:, k], depth[:, k], nu=self.nu,
                shear_modulus=self.shear_modulus)
        return disp

    def synthetics_los(self, point: dict, data=None) -> torch.Tensor:
        """(C, N) LOS-projected synthetic displacements of a batch."""
        data = self.device_data() if data is None else data
        if data.get("static_table") is not None:
            return self._synthetics_los_table(point, data)
        dtype = okada.FORWARD_DTYPE
        coords = data["coords"].to(dtype)
        n_chains = next(iter(point.values())).shape[0]
        disp = 0.0
        for i, src in enumerate(self.sources):
            get32 = self._getter(point, i, n_chains)

            def get(name, get32=get32):
                return get32(name).to(dtype)

            e, n, d = get("east_shift"), get("north_shift"), get("depth")
            if isinstance(src, ExplosionSource):
                disp = disp + okada.mogi_surface_displacement(coords, e, n, d, get("volume_change"),
                                                        nu=self.nu)
            elif isinstance(src, DoubleDCSource):
                # two separated point DCs, as the waveforms see them
                m6s, de, dn, dz, _ = double_dc_sub_sources(get)
                disp = disp + self._mt_sum(coords, m6s, e[:, None] + de, n[:, None] + dn,
                                           d[:, None] + dz)
            elif isinstance(src, MT_FAMILIES):
                disp = disp + okada.mt_surface_displacement(coords, source_m6(src, get), e, n,
                                                            d, nu=self.nu,
                                                            shear_modulus=self.shear_modulus)
            elif isinstance(src, RingfaultSource):
                m6s, de, dn, dz = src.sub_sources(get)
                disp = disp + self._mt_sum(coords, m6s, e[:, None] + de, n[:, None] + dn,
                                           d[:, None] + dz)
            else:
                frac, slip = get("opening_fraction"), get("slip")
                disp = disp + okada.okada_surface_displacement(
                    coords, e, n, d, get("strike"), get("dip"), get("rake"), get("length"),
                    get("width"), slip=slip * (1.0 - torch.abs(frac)), opening=slip * frac,
                    nu=self.nu, anchor=src.anchor)
        return torch.sum(disp * data["los"].to(dtype), dim=-1).to(data["los"].dtype)

    def _synthetics_los_table(self, point: dict, data: dict) -> torch.Tensor:
        """Layered-media statics through the static table: point MTs one
        gather each; rectangles as ``finite_patches`` grids of point MTs
        with the µ and λ of each patch's depth."""
        table, coords = data["static_table"], data["coords"]
        obs_e, obs_n = coords[:, 0], coords[:, 1]
        n_chains = next(iter(point.values())).shape[0]
        disp = 0.0
        for i, src in enumerate(self.sources):
            get = self._getter(point, i, n_chains)
            e, n, d = get("east_shift"), get("north_shift"), get("depth")
            if isinstance(src, RectangularSource):
                np_l, np_w = self.finite_patches
                strike, dip = get("strike")[:, None], get("dip")[:, None]
                length, width = get("length"), get("width")
                east_p, north_p, depth_p, _, _ = rectangular_patch_grid(
                    get("strike"), get("dip"), length, width, e, n, d, np_l, np_w,
                    anchor=src.anchor)
                area = (length * width / (np_l * np_w))[:, None]
                slip, frac = get("slip")[:, None], get("opening_fraction")[:, None]
                mu_z, lam_z = table.shear_modulus(depth_p), table.lame_lambda(depth_p)
                m6s = (sdr_to_m6(strike, dip, get("rake")[:, None],
                                 mu_z * area * slip * (1.0 - torch.abs(frac)))
                       + tensile_m6(strike, dip, area * slip * frac, lam=lam_z, mu=mu_z))
                disp = disp + table.synthesize_enu(m6s, east_p, north_p, depth_p, obs_e,
                                                   obs_n).sum(dim=1)
            elif isinstance(src, RingfaultSource):
                m6s, de, dn, dz = src.sub_sources(get)
                disp = disp + table.synthesize_enu(m6s, e[:, None] + de, n[:, None] + dn,
                                                   d[:, None] + dz, obs_e, obs_n).sum(dim=1)
            elif isinstance(src, DoubleDCSource):
                m6s, de, dn, dz, _ = double_dc_sub_sources(get)
                disp = disp + table.synthesize_enu(m6s, e[:, None] + de, n[:, None] + dn,
                                                   d[:, None] + dz, obs_e, obs_n).sum(dim=1)
            else:
                disp = disp + table.synthesize_enu(source_m6(src, get), e, n, d, obs_e,
                                                   obs_n)
        return torch.sum(disp * data["los"], dim=-1)
