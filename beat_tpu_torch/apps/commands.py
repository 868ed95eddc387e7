"""
Subcommand registrations of the port's command line (copied from
``beat_tpu/apps/commands.py``; reference ``beat/apps/beat.py``
``command_*`` functions).

Each ``register_<name>(subparsers)`` wires one subcommand with the JAX
package's options and defaults.  Every handler runs on ``args.device``,
which :func:`beat_tpu_torch.apps.cli.main` resolves once from
``BEAT_TPU_PLATFORM`` (the card unless it says ``cpu``): the GF builders,
``load_model``, the samplers and the MAP fit all take it explicitly.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("beat_tpu_torch.cli")


def register_init(sub):
    p = sub.add_parser("init", help="create a new project directory + config")
    p.add_argument("name")
    p.add_argument("project_dir", nargs="?", default=None)
    p.add_argument("--mode", default="geometry", choices=["geometry", "ffi", "bem"])
    p.add_argument("--source_types", default="RectangularSource",
                   help="comma-separated source types")
    p.add_argument("--n_sources", default="1")
    p.add_argument("--datatypes", default="geodetic",
                   help="comma-separated: geodetic,seismic,polarity")
    p.add_argument("--sampler", default="SMC", choices=["SMC", "PT", "Metropolis"])
    p.add_argument("--gcmt_ndk", default=None, metavar="FILE",
                   help="GlobalCMT NDK file: fill the event (and MT prior "
                        "test values) from a catalog solution — offline "
                        "analogue of the reference's GCMT catalog search")
    p.add_argument("--event_name", default=None,
                   help="event to pick from the NDK file (substring)")
    p.add_argument("--event_date", default=None,
                   help="event date prefix to pick from the NDK file "
                        "(YYYY-MM-DD)")
    p.set_defaults(handler=_cmd_init)


def _cmd_init(args):
    import os

    from beat_tpu_torch.config import EventConfig, init_config

    event = None
    gcmt = None
    if args.gcmt_ndk:
        import calendar
        import time as _time

        from beat_tpu_torch.inputf import read_gcmt_ndk, select_gcmt_event

        gcmt = select_gcmt_event(read_gcmt_ndk(args.gcmt_ndk),
                                 name=args.event_name, date=args.event_date)
        epoch = calendar.timegm(_time.strptime(gcmt["date"], "%Y-%m-%d")) \
            + gcmt["time_s"]
        event = EventConfig(name=gcmt["name"], lat=gcmt["lat"],
                            lon=gcmt["lon"], depth=gcmt["depth"],
                            time=epoch, magnitude=float(gcmt["magnitude"]))
        print(f"GCMT event {gcmt['name']}: lat {gcmt['lat']}, lon "
              f"{gcmt['lon']}, depth {gcmt['depth'] / 1e3:.1f} km, "
              f"Mw {gcmt['magnitude']:.2f}")

    project_dir = args.project_dir or os.path.join(os.getcwd(), args.name)
    config = init_config(
        args.name, project_dir, mode=args.mode,
        source_types=args.source_types.split(","),
        n_sources=[int(x) for x in args.n_sources.split(",")],
        datatypes=args.datatypes.split(","),
        sampler=args.sampler, event=event)

    if gcmt is not None:
        # seed MT prior test values with the catalog mechanism
        from beat_tpu_torch.config import dump_config

        priors = config.problem_config.priors
        changed = False

        def seed(comp, value):
            # testvalue must match the prior's dimension (n_sources > 1:
            # one entry per source) or the config fails bound validation
            dim = len(priors[comp].get("lower", [0.0]))
            priors[comp]["testvalue"] = [float(value)] * dim

        for i, comp in enumerate(("mnn", "mee", "mdd", "mne", "mnd", "med")):
            if comp in priors:
                seed(comp, gcmt["m6"][i])
                changed = True
        if "magnitude" in priors:
            seed("magnitude", gcmt["magnitude"])
            changed = True
        if changed:
            dump_config(config, project_dir)
    print(f"Initialised project in {project_dir}")
    return 0


def register_import(sub):
    p = sub.add_parser(
        "import", help="import data into the project (reference formats: "
        "SAR matlab/CSV, kite, GLOBK GNSS, mseed via obspy, native npz)")
    p.add_argument("project_dir")
    p.add_argument("--geodetic_npz", default=None,
                   help="npz with <name>:coords/<name>:displacement/<name>:los arrays")
    p.add_argument("--sar_csv", nargs="*", default=None,
                   help="CSV scenes (east,north,displacement[,incidence,heading])")
    p.add_argument("--sar_matlab", default=None,
                   help="directory with quad_<scene>.mat/CovMatrix_<scene>.mat")
    p.add_argument("--scenes", default=None,
                   help="comma-separated scene names for --sar_matlab/--kite")
    p.add_argument("--kite", nargs="*", default=None, help="kite scene files")
    p.add_argument("--gnss_globk", default=None, help="GLOBK ascii file")
    p.add_argument("--gnss_csv", default=None, help="GNSS CSV file")
    p.add_argument("--blacklist", default="",
                   help="comma-separated station names to drop")
    p.add_argument("--seismic_mseed", default=None,
                   help="directory of waveform files (requires obspy)")
    p.add_argument("--inventory", default=None, help="StationXML for response "
                   "removal + station coordinates (with --seismic_mseed)")
    p.add_argument("--from_beat", default=None, metavar="DIR",
                   help="migrate a reference-BEAT project directory: parse "
                   "its guts-YAML config, decode the pyrocko data pickles / "
                   "marker files, write the native project, build the GF "
                   "tables and grid the traces (beat_tpu_torch.interop)")
    p.add_argument("--no_build", action="store_true",
                   help="with --from_beat: skip the GF-table build + trace "
                   "gridding (run 'beat-tpu build_gfs' later)")
    p.add_argument("--results", action="store_true",
                   help="import a previous run's posterior as priors: HDI "
                   "bounds + posterior-mean test values for every matching "
                   "variable (sources, hypers, hierarchicals, ffi slips)")
    p.add_argument("--import_from_mode", default="geometry",
                   help="mode whose posterior to import (with --results)")
    p.add_argument("--hdi_alpha", type=float, default=0.06,
                   help="1 - HDI mass used for the new bounds")
    p.add_argument("--mode", default="geometry")
    p.set_defaults(handler=_cmd_import)


def _cmd_import(args):
    import shutil
    import os

    import numpy as np

    from beat_tpu_torch import inputf
    from beat_tpu_torch.config import save_geodetic_datasets

    if args.from_beat:
        from beat_tpu_torch.interop import import_beat_project

        config, notes = import_beat_project(args.from_beat, args.project_dir,
                                            build=not args.no_build)
        print(f"Imported BEAT project {args.from_beat} -> "
              f"{args.project_dir} (mode {config.problem_config.mode}, "
              f"datatypes {', '.join(config.problem_config.datatypes)})")
        for note in notes:
            print(f"  note: {note}")
        return 0

    if args.results:
        from beat_tpu_torch.config import import_results_as_priors

        updated = import_results_as_priors(
            args.project_dir, args.mode, args.import_from_mode,
            alpha=args.hdi_alpha)
        print(f"Imported {args.import_from_mode} posterior into "
              f"config_{args.mode}: narrowed priors for "
              f"{', '.join(updated) or 'no matching variables'}")
        return 0

    blacklist = tuple(b for b in args.blacklist.split(",") if b)
    geodetic = []
    if args.geodetic_npz:
        # validate the file satisfies the dataset schema, then install it
        from beat_tpu_torch.config import GeodeticConfig, load_geodetic_datasets

        dst = os.path.join(args.project_dir, "geodetic_data.npz")
        shutil.copy(args.geodetic_npz, dst)
        datasets = load_geodetic_datasets(args.project_dir, GeodeticConfig())
        print(f"Imported {len(datasets)} geodetic datasets "
              f"({sum(d.samples for d in datasets)} samples) -> {dst}")
        return 0

    if args.sar_csv:
        geodetic += [inputf.load_sar_csv(p) for p in args.sar_csv]
    if args.sar_matlab:
        names = (args.scenes or "").split(",")
        if not any(names):
            print("--sar_matlab needs --scenes name1,name2,...")
            return 1
        geodetic += inputf.load_sar_matlab(args.sar_matlab, names)
    if args.kite:
        geodetic += [inputf.load_kite_scene(p) for p in args.kite]
    if args.gnss_globk:
        geodetic += inputf.load_ascii_gnss_globk(
            os.path.dirname(args.gnss_globk) or ".",
            os.path.basename(args.gnss_globk), blacklist=blacklist)
    if args.gnss_csv:
        geodetic += inputf.load_gnss_csv(args.gnss_csv, blacklist=blacklist)

    if geodetic:
        # project geographic station coordinates (GNSS imports) to local
        # east/north relative to the configured event (reference
        # ``update_local_coords``, ``heart.py:1127``) so corrections and
        # synthetics see real station positions
        event = None
        try:
            from beat_tpu_torch.config import load_config

            event = load_config(args.project_dir, args.mode).event
        except (FileNotFoundError, ValueError):
            pass
        for ds in geodetic:
            if ds.lats is not None and ds.lons is not None:
                if event is None:
                    raise SystemExit(
                        f"dataset {ds.name} carries lat/lon station "
                        "coordinates but no readable project config "
                        "provides the event to project them against — "
                        "run 'beat-tpu init' (and 'beat-tpu update' if "
                        "prompted) first")
                ds.update_local_coords(event.lat, event.lon)
            # odw/covariance defaults are guaranteed by
            # GeodeticDataset.__post_init__ (ones / diag displacement
            # variance) — importers that know better set them explicitly
        path = save_geodetic_datasets(geodetic, args.project_dir)
        print(f"Imported {len(geodetic)} geodetic datasets -> {path}")

    if args.seismic_mseed:
        inventory = args.inventory
        if inventory is None:
            # fall back to the config's responses_path (reference
            # ``SeismicConfig.responses_path`` config.py:628)
            try:
                from beat_tpu_torch.config import load_config

                sc = load_config(args.project_dir, args.mode).seismic_config
                if sc is not None and sc.responses_path:
                    inventory = (sc.responses_path
                                 if os.path.isabs(sc.responses_path)
                                 else os.path.join(args.project_dir,
                                                   sc.responses_path))
            except (FileNotFoundError, ValueError):
                # no config yet, or one awaiting 'beat-tpu update' — the
                # responses fallback is best-effort either way
                pass
        traces, stations = inputf.load_obspy_traces(args.seismic_mseed,
                                                    inventory)
        print(f"Loaded {len(traces)} stations of waveforms; run "
              "beat-tpu-down prepare (or prepare_local_traces) to grid them")

    if not geodetic and not args.seismic_mseed:
        print("Nothing to import: pass --geodetic_npz / --sar_csv / "
              "--sar_matlab / --kite / --gnss_globk / --gnss_csv / "
              "--seismic_mseed")
    return 0


def register_clone(sub):
    p = sub.add_parser("clone", help="clone a project (config + data)")
    p.add_argument("project_dir")
    p.add_argument("clone_dir")
    p.add_argument("--mode", default="geometry")
    p.add_argument("--new_mode", default=None,
                   help="derive the clone's config for a different mode "
                        "(e.g. geometry -> ffi: the reference staged "
                        "workflow `beat clone ... --new_mode ffi`)")
    p.set_defaults(handler=_cmd_clone)


def _cmd_clone(args):
    import os
    import shutil

    from beat_tpu_torch.config import clone_config_to_mode, dump_config, load_config

    os.makedirs(args.clone_dir, exist_ok=True)
    config = load_config(args.project_dir, args.mode)
    config.name = os.path.basename(os.path.normpath(args.clone_dir))
    dump_config(config, args.clone_dir)
    data_files = ("geodetic_data.npz", "seismic_data.npz",
                  "seismic_data_raw.npz", "polarity_data.npz",
                  "velocity_model.nd", "velocity_model.npz",
                  "gf_table.npz", "static_gf_table.npz")
    for fname in data_files:
        src = os.path.join(args.project_dir, fname)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.clone_dir, fname))
    if args.new_mode and args.new_mode != args.mode:
        clone_config_to_mode(args.clone_dir, args.new_mode,
                             from_mode=args.mode)
        print(f"Cloned {args.project_dir} -> {args.clone_dir} "
              f"(+ config_{args.new_mode}.yaml)")
    else:
        print(f"Cloned {args.project_dir} -> {args.clone_dir}")
    return 0


def register_build_gfs(sub):
    p = sub.add_parser("build_gfs", help="build Green's function libraries")
    p.add_argument("project_dir")
    p.add_argument("--mode", default="ffi")
    p.add_argument("--datatypes", default="geodetic",
                   help="comma-separated: geodetic,seismic")
    p.add_argument("--patch_length", type=float, default=2.0, help="[km]")
    p.add_argument("--patch_width", type=float, default=2.0, help="[km]")
    p.add_argument("--extension_length", type=float, default=0.1,
                   help="fractional fault extension along strike around "
                        "the reference source (reference "
                        "DiscretizationConfig, config.py:351-373)")
    p.add_argument("--extension_width", type=float, default=0.1,
                   help="fractional fault extension down dip")
    p.add_argument("--discretization", default="uniform",
                   choices=["uniform", "resolution"],
                   help="'resolution' = Atzori-style iterative division "
                        "by the model-resolution matrix with epsilon-"
                        "elbow damping search (geodetic only; reference "
                        "ffi/fault.py:1520,2057)")
    p.add_argument("--epsilon", type=float, default=0.005,
                   help="resolution discretization damping (start of "
                        "the elbow search)")
    p.add_argument("--epsilon_search_runs", type=int, default=6)
    p.add_argument("--earth_model", default=None,
                   help="geometry mode: velocity model for native GF "
                        "store building — 'homogeneous', 'default_crust' "
                        "or a .nd/.npz model file (overrides "
                        "gf_config['earth_model'])")
    p.add_argument("--seismic_tracestore", default=None, metavar="NPZ",
                   help="convert a trace-store npz (write_trace_store "
                        "schema; any wavefield code can produce it) into "
                        "<project>/gf_table.npz and exit")
    p.add_argument("--nt", type=int, default=512,
                   help="table time samples (with --seismic_tracestore)")
    p.add_argument("--dt", type=float, default=0.5,
                   help="table sample interval [s] (with --seismic_tracestore)")
    p.add_argument("--t0", type=float, default=0.0,
                   help="table start time after origin [s] "
                        "(with --seismic_tracestore)")
    p.set_defaults(handler=_cmd_build_gfs)


def _cmd_build_gfs(args):
    import os

    from beat_tpu_torch.config import load_config, load_geodetic_datasets, save_fault_geometry

    if args.seismic_tracestore:
        from beat_tpu_torch.heart.store_convert import greens_table_from_traces

        table = greens_table_from_traces(args.seismic_tracestore, nt=args.nt, dt=args.dt,
                                         t0=args.t0, device=args.device)
        out = os.path.join(args.project_dir, "gf_table.npz")
        table.save(out)
        print(f"Converted trace store -> {out}: "
              f"{len(table.distances)} x {len(table.depths)} grid, "
              f"nt={table.nt} dt={table.dt}")
        return 0

    if args.mode == "geometry":
        return _build_geometry_stores(args)
    from beat_tpu_torch.ffi import discretize_sources, geo_construct_gf_linear
    from beat_tpu_torch.heart.geodesy import DatasetStack

    config = load_config(args.project_dir, "geometry") \
        if not os.path.exists(os.path.join(args.project_dir, "config_ffi.yaml")) \
        else load_config(args.project_dir, "ffi")
    datatypes = args.datatypes.split(",")

    ref = _reference_source_from_project(args.project_dir, config, device=args.device)
    discretization = getattr(args, "discretization", "uniform")
    if discretization == "resolution":
        # resolution-based (Atzori) discretization needs the data
        # geometry; geodetic only, as in the reference
        # (SeismicLinearGFConfig forbids it, config.py:530-533)
        from beat_tpu_torch.ffi.discretization import (
            ResolutionDiscretizationConfig, optimize_damping)
        from beat_tpu_torch.ffi.fault import extend_plane

        if "geodetic" not in datatypes:
            print("--discretization resolution needs geodetic data")
            return 1
        gc = config.geodetic_config
        datasets = load_geodetic_datasets(args.project_dir, gc,
                                          event=config.event)
        stack = DatasetStack.from_datasets(datasets)
        plane = extend_plane(ref, args.extension_width,
                             args.extension_length)
        rcfg = ResolutionDiscretizationConfig(
            epsilon=args.epsilon,
            epsilon_search_runs=args.epsilon_search_runs,
            patch_lengths_min=args.patch_length * 1e3 / 2,
            patch_lengths_max=args.patch_length * 1e3 * 2,
            patch_widths_min=args.patch_width * 1e3 / 2,
            patch_widths_max=args.patch_width * 1e3 * 2)
        fault, epsilon, results = optimize_damping(
            plane, stack.coords, stack.los, rcfg, device=args.device)
        print(f"Resolution discretization: {fault.npatches} patches at "
              f"elbow epsilon {epsilon:.4g} "
              f"({len(results)} damping candidates)")
    else:
        fault = discretize_sources(
            [ref], patch_length=args.patch_length * 1e3,
            patch_width=args.patch_width * 1e3,
            extension_width=getattr(args, "extension_width", 0.0),
            extension_length=getattr(args, "extension_length", 0.0))
    outdir = os.path.join(args.project_dir, "ffi", "linear_gfs")
    os.makedirs(outdir, exist_ok=True)
    save_fault_geometry(fault, os.path.join(outdir, "fault_geometry.pkl"))

    if "geodetic" in datatypes:
        gc = config.geodetic_config
        datasets = load_geodetic_datasets(args.project_dir, gc,
                                          event=config.event)
        stack = DatasetStack.from_datasets(datasets)
        lib = geo_construct_gf_linear(fault, stack.coords, stack.los,
                                      components=("uparr", "uperp"), device=args.device)
        lib.save(os.path.join(outdir, "geodetic_gfs.npz"))
        print(f"Built geodetic GF library: {fault.npatches} patches -> {outdir}")

    if "seismic" in datatypes:
        from beat_tpu_torch.config import ffi_seismic_grid_bounds
        from beat_tpu_torch.ffi import seis_construct_gf_linear
        from beat_tpu_torch.models.seismic import build_seismic_composite

        comp = build_seismic_composite(config.seismic_config,
                                       args.project_dir, [], device=args.device)
        (dur_lo, dur_hi), dur_step, (st_lo, st_hi), st_step = \
            ffi_seismic_grid_bounds(config, fault)
        for wmap in comp.wavemaps:
            for component in ("uparr", "uperp"):
                lib = seis_construct_gf_linear(
                    wmap.table, wmap, fault, component=component,
                    duration_bounds=(dur_lo, dur_hi), duration_sampling=dur_step,
                    starttime_bounds=(st_lo, st_hi), starttime_sampling=st_step,
                    stf_type=config.problem_config.stf_type)
                lib.save(outdir, f"seismic_{component}_{wmap.mapid}")
        print(f"Built seismic GF libraries for {len(comp.wavemaps)} wavemaps "
              f"-> {outdir}")
    return 0


def _resolve_earth_model(name, project_dir, gf):
    """Velocity model from a gf_config/CLI spec: 'homogeneous' (with
    optional vp/vs/rho overrides), 'default_crust', or a .nd/.npz file
    (relative paths resolve against the project dir)."""
    import os

    from beat_tpu_torch.heart.velocity_model import LayeredModel

    if name in (None, "", "homogeneous"):
        return LayeredModel.homogeneous(vp=gf.get("vp", 6000.0),
                                        vs=gf.get("vs", 3500.0),
                                        rho=gf.get("rho", 2700.0))
    if name == "default_crust":
        return LayeredModel.default_crust()
    path = name if os.path.isabs(name) else os.path.join(project_dir, name)
    model = (LayeredModel.load(path) if path.endswith(".npz")
             else LayeredModel.from_nd(path))
    if gf.get("earth_flattening"):
        # spherical base model (e.g. joined ak135): apply the
        # earth-flattening transform so the flat-geometry DWN solver
        # reproduces spherical travel times, as the reference's
        # qseis/qssp stores do
        model = model.earth_flattened()
    return model


def _build_geometry_stores(args):
    """Native geometry-mode GF store construction (the reference shells
    out to qseis/psgrn via fomosto here, ``apps/beat.py:1366`` +
    ``heart.py:2230,2426``): seismic waveform tables by the discrete
    wavenumber method (layered) or the analytic far-field builder
    (homogeneous), geodetic static tables by the Hankel-domain layered
    solver.  Grid/axis parameters come from each datatype's
    ``gf_config`` dict in the geometry config."""
    import os

    import numpy as np

    from beat_tpu_torch.config import load_config

    config = load_config(args.project_dir, "geometry")
    datatypes = args.datatypes.split(",")
    missing = [dt for dt in datatypes
               if getattr(config, f"{dt}_config", None) is None]
    if missing:
        print(f"No {'/'.join(missing)} config section in this project — "
              f"nothing to build for --datatypes {args.datatypes}")
        return 1

    if "seismic" in datatypes and config.seismic_config is not None:
        gf = dict(config.seismic_config.gf_config or {})
        model = _resolve_earth_model(args.earth_model or gf.get("earth_model"),
                                     args.project_dir, gf)
        distances = np.linspace(gf.get("distance_min", 10e3),
                                gf.get("distance_max", 150e3),
                                int(gf.get("n_distances", 15)))
        depths = np.linspace(gf.get("depth_min", 2e3),
                             gf.get("depth_max", 25e3),
                             int(gf.get("n_depths", 8)))
        nt = int(gf.get("nt", 512))
        dt = float(gf.get("dt", 0.5))
        t0 = float(gf.get("t0", 0.0))

        def build_one(m):
            if m.nlayers == 1 and m.qp is None and m.qs is None:
                from beat_tpu_torch.heart.gftable import build_homogeneous_table

                return build_homogeneous_table(
                    distances, depths, nt=nt, dt=dt, t0=t0,
                    vp=float(m.vp[0]), vs=float(m.vs[0]),
                    rho=float(m.rho[0]), device=args.device), "homogeneous analytic"
            from beat_tpu_torch.heart.layered_waveforms import (
                build_layered_waveform_table, nudge_depths_off_interfaces)

            zgrid = nudge_depths_off_interfaces(m, depths)
            return build_layered_waveform_table(
                m, distances, zgrid, nt=nt, dt=dt, t0=t0,
                fmax=gf.get("fmax"),
                tail_coeff=float(gf.get("tail_coeff", 50.0)),
                zeta_cycles=float(gf.get("zeta_cycles", 1.0)), device=args.device), \
                (f"DWN layered ({m.nlayers} layers"
                 + (", anelastic Q" if m.qp is not None
                    or m.qs is not None else "") + ")")

        table, kind = build_one(model)
        out = os.path.join(args.project_dir, "gf_table.npz")
        table.save(out)
        print(f"Built seismic GF table ({kind}) -> {out}: "
              f"{distances.size} x {depths.size} grid, nt={nt} dt={dt}")

        # velocity-model uncertainty ensemble: one perturbed table per
        # crust variation, consumed as Covariance.pred_v at update_weights
        # (reference n_variations, heart.py:1856 + covariance.py:561)
        n_var = int(gf.get("n_variations", 0) or 0)
        if n_var > 0:
            from beat_tpu_torch.heart.velocity_model import ensemble_earthmodels

            ens = ensemble_earthmodels(
                model, num_vary=n_var,
                error_depth=float(gf.get("error_depth", 0.1)),
                error_velocities=float(gf.get("error_velocities", 0.1)),
                rng=np.random.default_rng(int(gf.get("variation_seed", 13))))
            for k, vm in enumerate(ens, start=1):
                vtable, _ = build_one(vm)
                vout = os.path.join(args.project_dir, f"gf_table.var{k}.npz")
                vtable.save(vout)
            print(f"Built {n_var} velocity-model variation tables "
                  f"(gf_table.var*.npz) for prediction covariances")

    if "geodetic" in datatypes and config.geodetic_config is not None:
        gf = dict(config.geodetic_config.gf_config or {})
        model = _resolve_earth_model(args.earth_model or gf.get("earth_model"),
                                     args.project_dir, gf)
        rheology = gf.get("rheology")
        if model.nlayers == 1 and not rheology:
            print("Geodetic geometry mode with a homogeneous elastic model "
                  "needs no table (direct Okada/Mogi kernels) — skipping")
        else:
            from beat_tpu_torch.heart.statictable import build_static_table

            distances = np.linspace(gf.get("distance_min", 1e3),
                                    gf.get("distance_max", 120e3),
                                    int(gf.get("n_distances", 40)))
            depths = np.linspace(gf.get("depth_min", 0.5e3),
                                 gf.get("depth_max", 25e3),
                                 int(gf.get("n_depths", 12)))
            if rheology:
                # time-dependent statics (the psgrn time axis): Burgers
                # rheology per layer + snapshot epochs; acquisition-epoch
                # evaluation is exact via the stored Prony coefficients
                from beat_tpu_torch.heart.viscoelastic import (
                    DAY, BurgersRheology, build_viscoelastic_static_table)

                rheo = BurgersRheology(
                    eta1=rheology.get("eta1", [0.0] * model.nlayers),
                    eta2=rheology.get("eta2", [0.0] * model.nlayers),
                    alpha=rheology.get("alpha", [1.0] * model.nlayers))
                epochs = sorted({0.0} | {
                    float(d) * DAY
                    for d in (gf.get("epochs_days")
                              or (gf.get("times_days") or {}).values())})
                if len(epochs) == 1:
                    print("gf_config.rheology needs acquisition epochs: set "
                          "gf_config.epochs_days: [t1, t2, ...] or "
                          "gf_config.times_days: {dataset: days}")
                    return 1
                ttable = build_viscoelastic_static_table(
                    model, rheo, distances, depths, times=epochs,
                    s_per_decade=int(gf.get("s_per_decade", 8)), device=args.device)
                vout = os.path.join(args.project_dir,
                                    "static_gf_table_visco.npz")
                ttable.save(vout)
                print(f"Built viscoelastic static GF table -> {vout}: "
                      f"{distances.size} x {depths.size} grid, "
                      f"{len(epochs)} epochs, Prony resid "
                      f"{ttable.prony.max_resid if ttable.prony else 0:.1e}")
                return 0
            table = build_static_table(model, distances, depths, device=args.device)
            out = os.path.join(args.project_dir, "static_gf_table.npz")
            table.save(out)
            print(f"Built layered static GF table -> {out}: "
                  f"{distances.size} x {depths.size} grid")
            n_var = int(gf.get("n_variations", 0) or 0)
            if n_var > 0:
                from beat_tpu_torch.heart.velocity_model import ensemble_earthmodels

                ens = ensemble_earthmodels(
                    model, num_vary=n_var,
                    error_depth=float(gf.get("error_depth", 0.1)),
                    error_velocities=float(gf.get("error_velocities", 0.1)),
                    rng=np.random.default_rng(
                        int(gf.get("variation_seed", 13))))
                for k, vm in enumerate(ens, start=1):
                    build_static_table(vm, distances, depths, device=args.device).save(
                        os.path.join(args.project_dir,
                                     f"static_gf_table.var{k}.npz"))
                print(f"Built {n_var} static-table variations "
                      f"(static_gf_table.var*.npz) for prediction "
                      f"covariances")

    return 0


def _reference_source_from_project(project_dir, config, *, device):
    """
    FFI reference source from the geometry-mode posterior when available
    (reference staged workflow: ``beat import --results ...
    --import_from_mode geometry --mode ffi``, ``apps/beat.py:543-770``);
    falls back to the geometry config's fixed parameters.
    """
    import os

    import numpy as np

    from beat_tpu_torch.config import load_config
    from beat_tpu_torch.sources import RectangularSource

    kwargs = {}
    geom_cfg_path = os.path.join(project_dir, "config_geometry.yaml")
    if os.path.exists(geom_cfg_path):
        geom_cfg = load_config(project_dir, "geometry")
        kwargs.update(geom_cfg.problem_config.get_fixed_params(to_si=True))
        stage_dir = os.path.join(project_dir, "geometry", "stage_-1")
        if os.path.isdir(stage_dir):
            from beat_tpu_torch.config import problem_from_config

            problem = problem_from_config(geom_cfg, project_dir, device=device)
            from beat_tpu_torch.backend import SampleStage

            handler = SampleStage(problem.outfolder, ordering=problem.ordering)
            trace = handler.load_trace(-1)
            pop, llks = trace.end_points()
            map_point = problem.ordering.to_point(pop[int(np.argmax(llks))])
            for name in ("east_shift", "north_shift", "depth", "strike",
                         "dip", "rake", "length", "width"):
                if name in map_point:
                    kwargs[name] = float(np.atleast_1d(map_point[name])[0])
            print("FFI reference source from geometry MAP: "
                  + ", ".join(f"{k}={v:.3g}" for k, v in kwargs.items()))
    allowed = {"east_shift", "north_shift", "depth", "strike", "dip",
               "rake", "length", "width"}
    kwargs = {k: v for k, v in kwargs.items() if k in allowed}
    if "length" not in kwargs or "width" not in kwargs:
        raise ValueError(
            "FFI needs a reference fault geometry but the project has "
            "neither a geometry-mode posterior (geometry/stage_-1) nor "
            "fixed length/width priors — run "
            "`beat-tpu sample <project> --mode geometry` first "
            "(reference staged workflow, apps/beat.py:543-770)")
    kwargs.setdefault("depth", config.event.depth)
    return RectangularSource(**kwargs)


def register_plot(sub):
    p = sub.add_parser("plot", help="create result plots")
    p.add_argument("project_dir")
    p.add_argument("plot_names", help="comma-separated names or 'all'")
    p.add_argument("--mode", default="geometry")
    p.add_argument("--stage", type=int, default=-1)
    p.add_argument("--format", default="png")
    p.add_argument("--varnames", default=None,
                   help="comma-separated variables for marginal/corner "
                        "plots (reference `beat plot --varnames`)")
    p.set_defaults(handler=_cmd_plot)


def _cmd_plot(args):
    from beat_tpu_torch.models import load_model
    from beat_tpu_torch.plotting import plots_catalog
    from beat_tpu_torch.plotting.common import PlotOptions

    problem = load_model(args.project_dir, args.mode, device=args.device)
    po = PlotOptions(outformat=args.format, load_stage=args.stage,
                     varnames=(args.varnames.split(",")
                               if getattr(args, "varnames", None) else None))
    names = list(plots_catalog) if args.plot_names == "all" \
        else args.plot_names.split(",")
    for name in names:
        if name not in plots_catalog:
            print(f"Unknown plot '{name}'; available: {sorted(plots_catalog)}")
            continue
        try:
            path = plots_catalog[name](problem, po)
            print(f"{name}: {path}")
        except Exception as e:
            print(f"{name}: skipped ({e})")
    return 0


def register_export(sub):
    p = sub.add_parser("export", help="export synthetics/residuals at best point")
    p.add_argument("project_dir")
    p.add_argument("--mode", default="geometry")
    p.add_argument("--stage", type=int, default=-1)
    p.add_argument("--csv", action="store_true",
                   help="also write the stage trace as chain CSV files "
                        "(reference TextChain interop)")
    p.add_argument("--post_llk", default="max", choices=["max", "mean"],
                   help="reference point: MAP ('max') or posterior mean")
    p.set_defaults(handler=_cmd_export)


def _cmd_export(args):
    import os

    import numpy as np

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.models import load_model

    problem = load_model(args.project_dir, args.mode, device=args.device)
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    trace = handler.load_trace(args.stage)
    pop, llks = trace.end_points()
    post_llk = getattr(args, "post_llk", "max")
    if post_llk == "mean":
        flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
        q_ref = flat.mean(axis=0)
    else:
        q_ref = pop[int(np.argmax(llks))]
    point = problem.ordering.to_point(q_ref)
    synths = problem.get_synthetics(point)
    vrs = problem.get_variance_reductions(point)
    out = os.path.join(problem.outfolder, "export.npz")
    arrays = {"map_point": q_ref}
    for comp, d in synths.items():
        for name, arr in d.items():
            arrays[f"synth:{comp}:{name}"] = np.asarray(arr)
    # standardized residuals per composite (reference apps/beat.py:2422)
    for cname, comp in problem.composites.items():
        get_stdz = getattr(comp, "get_standardized_residuals", None)
        if get_stdz is None:
            continue
        for name, arr in get_stdz(point).items():
            arrays[f"stdz_res:{cname}:{name}"] = np.asarray(arr)
    np.savez_compressed(out, **arrays)

    # solution point as YAML (reference solution_<post_llk>.yaml)
    import yaml

    sol_path = os.path.join(problem.outfolder, f"solution_{post_llk}.yaml")
    with open(sol_path, "w") as f:
        yaml.safe_dump({k: np.asarray(v).tolist() for k, v in point.items()},
                       f, sort_keys=True)

    # ffi: rupture evolution at the reference point (reference
    # rupture_evolution_<llk>.yaml, apps/beat.py:2381)
    fault = next((c.fault for c in problem.composites.values()
                  if hasattr(c, "fault")), None)
    if fault is not None and "uparr" in point:
        import torch

        uparr = np.asarray(np.atleast_1d(point["uparr"]))
        uperp = np.resize(np.asarray(point.get("uperp", 0.0)), uparr.shape)
        slip_mag = np.sqrt(uparr**2 + uperp**2)
        evo = {"slip": slip_mag.tolist(),
               "uparr": uparr.tolist(), "uperp": uperp.tolist(),
               "magnitude": float(fault.magnitude(slip_mag))}
        if "velocities" in point and "nucleation_strike" in point:
            onsets = []
            for i in range(fault.nsubfaults):
                slc = fault.ordering.slices[i]
                onsets.extend(fault.point2starttimes(
                    i, torch.as_tensor(np.asarray(point["velocities"])[slc][None],
                                       device=args.device),
                    torch.as_tensor([float(np.atleast_1d(point["nucleation_strike"])[i])],
                                    device=args.device),
                    torch.as_tensor([float(np.atleast_1d(point["nucleation_dip"])[i])],
                                    device=args.device),
                )[0].cpu().numpy().tolist())
            evo["rupture_onsets"] = onsets
            evo["durations"] = np.asarray(point["durations"]).tolist()
        evo_path = os.path.join(problem.outfolder,
                                f"rupture_evolution_{post_llk}.yaml")
        with open(evo_path, "w") as f:
            yaml.safe_dump(evo, f, sort_keys=True)
        print(f"Exported rupture evolution to {evo_path}")

    print(f"Exported {post_llk}-point synthetics to {out}, solution to "
          f"{sol_path}; variance reductions: {vrs}")

    if getattr(args, "csv", False):
        csvdir = os.path.join(problem.outfolder, "csv")
        os.makedirs(csvdir, exist_ok=True)
        # flat header like the reference TextChain (backend.py:65)
        names = []
        for spec in problem.ordering.vmap:
            k = max(1, int(np.prod(spec.shape, dtype=int)))
            names.extend([spec.name if spec.shape == () else
                          f"{spec.name}__{i}" for i in range(k)])
        header = ",".join(names + ["like"])
        for chain in range(trace.n_chains):
            rows = np.column_stack([trace.q_trace[:, chain, :],
                                    trace.llk_trace[:, chain]])
            path = os.path.join(csvdir, f"chain-{chain}.csv")
            np.savetxt(path, rows, delimiter=",", header=header, comments="")
        print(f"Wrote {trace.n_chains} chain CSVs to {csvdir}")
    return 0


def register_update(sub):
    p = sub.add_parser("update", help="migrate/refresh a project config")
    p.add_argument("project_dir")
    p.add_argument("--mode", default="geometry")
    p.add_argument("--parameters", default="",
                   help="'hypers' refreshes the config hyperparameter "
                   "section from the current problem (reference "
                   "`beat update --parameters hypers`)")
    p.set_defaults(handler=_cmd_update)


def _cmd_update(args):
    from beat_tpu_torch.upgrade import upgrade_config_file

    diff = upgrade_config_file(args.project_dir, args.mode, apply=True)
    print(diff if diff else "Config already at the current schema")
    if "hypers" in args.parameters:
        from beat_tpu_torch.config import (dump_config, load_config,
                                     problem_from_config,
                                     update_hypers_in_config)

        config = load_config(args.project_dir, args.mode)
        problem = problem_from_config(config, args.project_dir, device=args.device)
        added = update_hypers_in_config(config, problem)
        dump_config(config, args.project_dir)
        print(f"Hyperparameter section: added {added or 'nothing new'}")
    return 0


def register_sample(sub):
    p = sub.add_parser("sample", help="sample the solution space of a problem")
    p.add_argument("project_dir")
    p.add_argument("--mode", default="geometry", choices=["geometry", "ffi", "bem"])
    p.add_argument("--hypers", action="store_true", help="sample hyperparameters only")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a profiler trace (Chrome trace format) to DIR and "
                        "print per-stage timings and the program's spans after sampling")
    p.set_defaults(handler=_cmd_sample)


def _cmd_sample(args):
    from beat_tpu_torch import profiling
    from beat_tpu_torch.models import load_model

    profile = getattr(args, "profile", None)
    if profile:
        os.environ["BEAT_TPU_PROFILE_DIR"] = profile
        spans_before = profiling.enable_spans()
        profiling.reset_spans()
    try:
        problem = load_model(args.project_dir, args.mode, device=args.device)
        if args.hypers:
            problem.estimate_hypers()
        else:
            # between-stage covariance re-estimation when any composite uses a
            # residual-based noise model or an earth-model uncertainty
            # ensemble (reference 'update' hook, smc.py:492)
            update = any(
                getattr(getattr(c, "noise_analyser", None), "structure", "")
                == "non-toeplitz"
                or getattr(c, "ensemble_tables", None)
                or getattr(c, "ensemble_nus", None)
                for c in problem.composites.values())
            problem.sample(update_weights=update)
    finally:
        if profile:
            profiling.enable_spans(spans_before)
    if profile:
        print(profiling.timings.summary())
        print(profiling.span_summary())
    return 0


def register_map(sub):
    p = sub.add_parser(
        "map", help="gradient-based MAP estimate + Laplace approximation "
                    "(seconds instead of an MCMC run; autodiff — the "
                    "reference has no optimizer)")
    p.add_argument("project_dir")
    p.add_argument("--mode", default="geometry")
    p.add_argument("--n_restarts", type=int, default=32,
                   help="lockstep random restarts (all advanced per step "
                        "in one batched gradient)")
    p.add_argument("--n_steps", type=int, default=150)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(handler=_cmd_map)


def _cmd_map(args):
    import json
    import os

    import numpy as np

    from beat_tpu_torch.models import load_model
    from beat_tpu_torch.optimize import laplace_approximation, map_estimate

    problem = load_model(args.project_dir, args.mode, device=args.device)
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    start = problem.priors.test_array()[None]
    q_map, llk, all_llks = map_estimate(
        logp, lower, upper, n_restarts=args.n_restarts,
        n_steps=args.n_steps, seed=args.seed, logp_args=(data,),
        start=start, device=args.device)
    lap = laplace_approximation(logp, q_map, lower, upper,
                                logp_args=(data,), device=args.device)
    point = problem.ordering.to_point(q_map)
    sd_point = problem.ordering.to_point(lap["sd"])
    for name in point:
        v = np.atleast_1d(point[name])
        s = np.atleast_1d(sd_point[name])
        print(f"{name:24s} " + "  ".join(
            f"{vi:+.5g} ± {si:.3g}" for vi, si in zip(v, s)))
    print(f"{'log_likelihood_map':24s} {llk:+.4f}")
    print(f"{'laplace_log_evidence':24s} {lap['log_evidence']:+.4f}"
          + ("" if lap["curvature_ok"] else "  (curvature not PD — "
             "MAP on a bound or saddle; treat as approximate)"))
    spread = float(all_llks.max() - np.median(all_llks))
    if spread > 2.0:
        print(f"note: restart llk spread {spread:.1f} — posterior looks "
              "multimodal; MCMC recommended")
    out = os.path.join(problem.outfolder, "map.json")
    os.makedirs(problem.outfolder, exist_ok=True)
    with open(out, "w") as f:
        json.dump({"point": {k: np.atleast_1d(v).tolist()
                             for k, v in point.items()},
                   "sd": {k: np.atleast_1d(v).tolist()
                          for k, v in sd_point.items()},
                   "llk_map": llk,
                   "laplace_log_evidence": lap["log_evidence"],
                   "curvature_ok": lap["curvature_ok"],
                   "restart_llks": all_llks.tolist()}, f, indent=1)
    logger.info("Wrote %s", out)
    return 0


def register_summarize(sub):
    p = sub.add_parser("summarize", help="summarize sampled posterior")
    p.add_argument("project_dir")
    p.add_argument("--mode", default="geometry")
    p.add_argument("--stage", default="-1")
    p.add_argument("--calc_derived", action="store_true",
                   help="append derived variables (nodal planes, magnitude)")
    p.set_defaults(handler=_cmd_summarize)


def _cmd_summarize(args):
    import json
    import os

    from beat_tpu_torch.backend import SampleStage, summarize_trace
    from beat_tpu_torch.models import load_model

    problem = load_model(args.project_dir, args.mode, device=args.device)
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    trace = handler.load_trace(int(args.stage))
    summary = summarize_trace(trace)
    if getattr(args, "calc_derived", False):
        from beat_tpu_torch.backend import hdi

        for name, samples in problem.derived_samples(int(args.stage)).items():
            lo, hi = hdi(samples)
            summary[name] = {"mean": float(samples.mean()),
                             "sd": float(samples.std(ddof=1)),
                             "hdi_94%_lower": lo, "hdi_94%_upper": hi,
                             "ess": float("nan"), "r_hat": float("nan")}
    out = os.path.join(problem.outfolder, "summary.txt")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    for name, rec in summary.items():
        print(f"{name:24s} mean={rec['mean']:+.4g} sd={rec['sd']:.4g} "
              f"r_hat={rec['r_hat']:.3f}")
    # SMC runs carry the transitional-MCMC marginal-likelihood estimate
    # (Ching & Chen 2007) in the final-stage state — print it for model
    # comparison across source parameterizations
    try:
        state = handler.load_state(int(args.stage))
        if "log_evidence" in state:
            print(f"{'log_marginal_likelihood':24s} "
                  f"{float(state['log_evidence']):+.4f}")
    except FileNotFoundError:
        pass
    logger.info("Wrote %s", out)
    return 0


def register_check(sub):
    p = sub.add_parser("check", help="check problem setup")
    p.add_argument("project_dir")
    p.add_argument("--mode", default="geometry")
    p.add_argument("--what", default="traces")
    p.set_defaults(handler=_cmd_check)


def _cmd_check(args):
    import os

    import numpy as np

    from beat_tpu_torch.models import load_model

    if args.what == "traces":
        # trace checking only needs the outfolder — no config load, so
        # it works even on a config awaiting 'beat-tpu update'
        from beat_tpu_torch.backend import SampleStage

        outfolder = os.path.join(args.project_dir, args.mode)
        handler = SampleStage(outfolder)
        top = handler.highest_sampled_stage()
        if top == -2:
            print("No sampled stages found")
        else:
            stages = [s for s in ([-1] if top == -1 else range(top + 1))]
            for s in stages:
                ok = handler.check_stage(s)
                print(f"stage_{s}: {'OK' if ok else 'CORRUPT'}")
        return 0

    if args.what == "stores":
        # validate every GF store of the project: NaN/Inf and empty
        # (all-zero) traces (reference check_problem_stores,
        # apps/beat.py:2027 + heart.py)
        import glob

        candidates = (
            [os.path.join(args.project_dir, "gf_table.npz"),
             os.path.join(args.project_dir, "static_gf_table.npz")]
            + sorted(glob.glob(os.path.join(args.project_dir, "ffi",
                                            "linear_gfs", "*.npz"))))
        found = corrupted = 0
        for path in candidates:
            if not os.path.exists(path):
                continue
            found += 1
            with np.load(path) as z:
                bad = []
                for key in z.files:
                    arr = z[key]
                    if not np.issubdtype(arr.dtype, np.number):
                        continue
                    if arr.size and not np.isfinite(arr).all():
                        bad.append(f"{key}: NaN/Inf")
                    elif arr.ndim >= 2 and arr.size and \
                            not np.abs(arr).sum():
                        bad.append(f"{key}: empty traces")
            if bad:
                corrupted += 1
                print(f"{path}: CORRUPT ({'; '.join(bad)})")
            else:
                print(f"{path}: OK")
        if not found:
            print("No GF stores found — run build_gfs (or place gf_table.npz)")
            return 1
        return 1 if corrupted else 0

    if args.what == "library":
        from beat_tpu_torch.ffi import GeodeticGFLibrary

        path = os.path.join(args.project_dir, "ffi", "linear_gfs",
                            "geodetic_gfs.npz")
        if not os.path.exists(path):
            print(f"No GF library at {path} — run build_gfs")
            return 1
        lib = GeodeticGFLibrary.load(path, device=args.device)
        print(f"Geodetic GF library: {lib.npatches} patches x {lib.nsamples} "
              f"samples, components {lib.component_names}")
        return 0

    if args.what == "discretization":
        from beat_tpu_torch.config import load_fault_geometry

        path = os.path.join(args.project_dir, "ffi", "linear_gfs",
                            "fault_geometry.pkl")
        if not os.path.exists(path):
            print(f"No fault geometry at {path} — run build_gfs")
            return 1
        fault = load_fault_geometry(path)
        for i in range(fault.nsubfaults):
            sf = fault.get_subfault(i)
            print(f"subfault {i}: {sf.npatches} patches")
        return 0

    # default: forward model at the test point (reference --what geometry)
    problem = load_model(args.project_dir, args.mode, device=args.device)
    point = problem.priors.test_point()
    synths = problem.get_synthetics(point)
    print(f"Forward model OK at test point; outputs: "
          f"{ {k: {n: getattr(v, 'shape', v) for n, v in d.items()} for k, d in synths.items()} }")
    return 0
