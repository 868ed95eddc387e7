#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (``beat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs the port's main paths in phases that each print one line; any
failure ends the run non-zero.  The paths: the geometry-mode FullMT
moment-tensor inversion at real size (206 × 15 × nt 1024 GF table, 10
stations / 30 targets, 2000 chains) with random-walk SMC, with MALA-SMC,
with HMC and with MAP + Laplace; every other source type and composite
option of the geometry mode on the same table and data, a DCSource
MALA-SMC, a covariance update and a finite RectangularSource SMC; and
the kinematic finite-fault inversion (FFI) at the scale of
``examples/laquila_scale_ffi.py`` (12 targets × 500 patches × 10
durations × 32 starttimes × 512 samples: a 3.9 GiB library on the card,
2000 chains, 1504 dimensions), with its options and a bf16 copy of the
library; the geodetic modes; parallel tempering on the joint seismic +
geodetic problem; the trans-dimensional sampler on the static FFI;
first-motion polarities joint with the FullMT waveforms; bem mode (the
float64 triangular-dislocation assembly on the card, the linear and the
geometry composites); the table builders: a layered waveform table, a
layered static table and a viscoelastic one built on the card, the FullMT
SMC on the first and a post-seismic geodetic SMC on the last.

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: every kernel source under ``beat_tpu_torch/csrc/`` (K1, K2,
   K1c and K2c ``bilgather.cu``, K3 and K4 ``gfstack.cu``, K5
   ``rowgather.cu``), one ``nvcc`` each, all started together;
3. [k1] K1 against its plain PyTorch version at the main path's shapes
   (60,000 queries), max |err| <= 1e-6 · max|ref|; its time, the plain
   time, the one-call library time (``embedding_bag``) and its bound;
4. [k2] K2 against its plain version on the same queries with a random
   cotangent, per query |err| <= 1e-5 · Σ_j|g_ij| · max_c|row_cj|; its
   time, the plain time, the one-call library time (the per-sample-weights
   backward of ``embedding_bag``) and its bound;
5. [k1c], [k2c] K1c (the gather fused with the m6 contraction) and K2c
   (its transpose) against their plain versions on the main path's own
   60,000 queries (captured from one likelihood over the prior) and on
   random ones, per query |err| <= 1e-5 · Σ|A_i| · max|rows_i| and
   1e-5 · Σ|G_i| · max|rows_i|, each equal to itself on a second call;
   their times, ``previous_ms`` (the unfused path in turns: K1 and the
   matmul; the matmul's backward and K2), the plain times, the one-call
   library times (``embedding_bag`` over the table's component segments,
   24 a query, and its per-sample-weights backward, held to the same
   bars), the bounds, the table rows read and the corner-block groups;
6. [llk] the 2000-chain log-likelihood through K1c against the plain
   versions, rtol 2e-5;
7. [grad] the 2000-chain gradient ∂llk/∂q through K1c and K2c against
   the plain versions', per parameter rtol 5e-3 and atol 5e-3 · that
   parameter's max|grad|; then [grad_profile]: one value-and-grad
   profiled through K1c/K2c and through the unfused path (K1 and a
   matmul, ``gather_spectra``'s path), with the CUDA calls of a forward
   and of a value-and-grad and the peak memory of each;
8. [smc] ``Problem.sample()`` with SMC (2000 chains, 60 steps per
   stage): β = 1 with finite llks, K1c launched, the true depth (±500 m)
   and magnitude (±0.05) recovered;
9. [mala_smc] the same with ``proposal_name="MALA"``, which must launch
   K2c as well;
10. [hmc] one 10-step HMC stage (5 leapfrog steps, the step size
    retuned after 5) at β = 1 from the MALA-SMC posterior: acceptance in
    (0, 1], finite positions and llks, K1c and K2c launched;
11. [map] ``map_estimate`` (32 restarts, 150 steps, from the test point)
    within 600 m of the depth and 0.15 of Mw, then
    ``laplace_approximation`` with a finite evidence, its Hessian through
    K1c and K2c and no plain version;
12. [k5] K5 against its plain version (a copy: equal exactly) at the
    shape the SMC's resampling gives it (2000 × 1504), on the FullMT
    table's rows and at a ragged row length, with ``int64`` and ``int32``
    indices and with indices of ±2^40, which must clip; its time and
    ``index_select``'s in turns, the plain time, its bound, the device
    operations one call makes (must be 1) and the kernel's device time;
13. [k3], [k4] K3 and K4 against their plain version at the GF-stack
    bench shape (C=2000, T=8, P=12, D=6, S=16, N=256, the inputs of
    ``tools/bench_gfstack.py``) and, after [ffi_build], on the real
    library with durations and starttimes on and beyond the grid; per
    (chain, target) |err| <= 1e-5 · Σ_p |slip_p| · Σ_corners |w| ·
    max|data|, for the variant ``plan_stack`` chose and for every other
    one that can run (``tiled`` and ``gather``, which must equal each
    other bit for bit; ``mma`` for K3 on a bf16 library), each equal to itself
    on a second call; every variant's time in turns, the chosen one's as
    ``ms`` and the ``gather`` variant's as ``previous_ms``; plain time
    and bound; the library yardstick, a
    dense ``bmm`` over the scattered corner weights (four corners for K3,
    one for K4), alone and with its scatter, at the bench shape and on the
    real library (15.4 GB of weights: the kernels line's ``library_ms``).  On the
    real library also K3 with the onsets shared by the targets, (C, 1, P)
    operands as the main path passes them, which must allocate the
    output and nothing else, and K3 with all chains on one cell and on
    eight cells;
11b. [sources_llk] MTQT, DC, Explosion, CLVD, DoubleDC, Ringfault and
    Rectangular sources, and a DC composite with station corrections,
    with one hyperparameter per target, in the ``spectrum`` domain and
    with two events, each on the real-size table and data: one
    2000-chain llk through K1c against the plain versions (chunked over
    the chains at 60,000 queries a call), rtol 2e-5, and one
    value-and-grad through K1c and K2c against theirs, per parameter
    rtol 5e-3 / atol 5e-3 · max of its column; launches, times, peaks;
11c. [dc_mala_smc] a DCSource MALA-SMC to β = 1 (2000 chains, 60 steps):
    Mw within 0.05 of the truth, the posterior mean depth within 500 m of
    the MAP's (from the test point, the best sample and 32 restarts over
    the prior; with free
    east/north shifts the data put the mode's depth where they do, the
    truth's llk is printed beside the best sample's), finite llks, the
    best sample's variance reduction over all windows >= 0.9 and its llk
    at least the true source's, K1c, K2c and K5 launched;
11d. [update_weights] ``Problem.update_weights`` at that best sample with
    a non-Toeplitz analyser and two real-size ensemble tables (velocities
    -3 % and +3 %), then one 2000-chain llk: finite, every wavemap's
    weights changed, K1c launched;
11e. [k1c_finite], [rect_smc] the finite RectangularSource (8 × 5
    patches: 2.4 M K1c queries an evaluation): K1c on one likelihood's
    queries as the composite lays them out, (K, C, T), and permuted to
    (C, K, T), against its plain version chunk by chunk (the per-query
    bar of phase 5), its time, the plain and ``embedding_bag`` times,
    the bound, the llk's time and peak memory; then a random-walk SMC
    capped at 3 stages × 20 steps: β strictly increasing, finite llks,
    K1c launched;
14. [ffi_build] the real-size FFI problem, its library built on the card
    through K1c;
15. [ffi_llk] the 2000-chain FFI log-likelihood through K3 against the
    plain stack on 128 chains spread over the batch: |err| <= 2e-5 ·
    (|llk| + |llk0|), llk0 being the likelihood's residual-free part (the
    llk is the difference of llk0 and the whitened misfit and passes
    through 0, so a bar on |llk| alone is ill-posed); its time, the
    eikonal solve's time and kernel launches within it;
15b. the runtime (slice 13): [parallel_ffi_llk] the library split by
    targets on a ``make_gf_mesh(2, 2)`` of 4 ranks started here (spawn),
    sharing the card over gloo (NCCL refuses two ranks on one device):
    each rank holds 6 of the 12 targets, a block copied from [ffi_build]'s
    library and handed over by CUDA IPC, and 1000 of phase 15's 2000
    chains; K3 on its block, the partial llks summed over ``targets``:
    within phase 15's bar of the one-process llk of the seismic composite
    through K3, K3 launched on every rank, each rank's peak memory;
16. [ffi_smc] ``Problem.sample(SMCParams(n_chains=2000, n_steps=20,
    max_stages=4, seed=1))`` as the example runs it: the stage cap ends
    it (the one expected exception); β strictly increasing, finite llks,
    K3 launched; the cost of the stage files;
17. [ffi_recover] a small FFI problem (12 targets, 6 × 3 patches) sampled
    to β = 1 with each interpolation (multilinear: K3; nearest
    neighbour: K4): the magnitude of the rupture behind the data within
    0.05, the best sample's variance reduction >= 0.9, and the posterior
    above a rupture with 2.5 times the slip;
17b. the geodetic slice (no kernel of its own; its SMCs resample through
    K5): [geo_llk] every source type of the geometry problem (two InSAR
    scenes of 1500 points) and a 60-station GNSS network with Euler-pole
    and strain-rate corrections: the 2000-chain llk within 2e-5 · (|llk|
    + Σ |log det C| + n·|2h + log 2π|) of the same code in float64 on the
    host (64 chains), the value-and-grad per parameter as in phase 7;
    beside it a control reading, not a gate: the same llk with the
    analytic forward in float32 (``okada.FORWARD_DTYPE``), its time and
    its error under the same bar; [geo_table] the rectangle through a
    homogeneous static table built on the card, as [geo_llk];
    [geo_smc] the geometry SMC to β = 1 (position, variance reductions,
    ramps) and ``update_weights``; [static_ffi_build] the real-size
    static library against float64 on the host per column, 1e-4 ·
    max|G|, with a float32 build's time and error as a control reading;
    [static_ffi_llk] as [geo_llk]; [static_ffi_smc] the capped
    1002-dimension SMC from the NNLS start; [static_ffi_recover] a small
    static FFI to β = 1 (Mw within 0.05, variance reduction >= 0.9);
    [discretization] the resolution discretization on the card and on
    the host, equal;
17c. slice 8: [joint_llk] the joint seismic + geodetic problem (BASELINE
    config 3: the geodetic rectangle's two InSAR scenes and the FullMT
    stations' waveforms of the same rectangle on 8 × 5 patches, on the
    FullMT table) at 64 and 2000 chains: the llk equal to its composites'
    llks evaluated alone (rtol 1e-6), the waveform composite within rtol
    2e-5 of the plain versions and the InSAR composite within [geo_llk]'s
    bar of float64 on the host, on 64 chains; [pt_joint]
    ``Problem.sample(PTParams(...))`` on it (64 replicas, 16 at β = 1,
    3000 samples, random walk): the ladder, finite llks, the temperature
    scale moved, the mean edge exchange acceptance in [0.02, 0.98], K1c
    launched, the median position of the second half of the β = 1 draws
    within 500 m (depth 1 km) of the truth and the best draw's variance
    reduction >= 0.9 per scene (after [rect_smc]); [ffi_extras] the
    Laquila-scale kinematic llk with a station time shift per target, a
    second wavemap in the ``spectrum`` domain and ``hp_specific``, through
    K3, against the plain stack as [ffi_llk]; [k3_bf16], [k4_bf16] the
    bf16 copy of the library (built on the card a target at a time: half
    the bytes, no third copy), K3 and K4 on it against their plain version
    on the same copy at phase 13's bar in every variant (K3's ``mma``,
    the tensor-core one, ``tiled``, ``gather``: their times in turns, the
    distinct cells of each 8-chain group's rows), the planned one timed in
    turns with the float32 kernels, within 0.02 · max of the float32
    stack and not equal to it, and the dense ``bmm`` yardstick on it (bf16
    operands, float32 accumulation) as their ``library_ms``; their bound
    counts the operations at the tensor cores' bf16 rate; [ffi_llk_bf16]
    one llk of the FFI flagship on the bf16 library with each
    interpolation (after [ffi_smc]); [ffi_smc_bf16] the multilinear one
    through [ffi_smc]'s capped SMC (2000 chains × 20 steps, stage cap 4):
    β strictly increasing, finite llks, K3 on the bf16 library at every
    step in the planned variant and no float32 K3 or K4 launch, the
    distinct cells of each 8-chain group in each stage's population;
    [ffi_extras]
    ``Problem.estimate_hypers`` on the static FFI (after
    [static_ffi_smc]); [transd_ffi] ``Problem.sample(TransDParams(...))``
    on the static FFI fault with a two-level slip (1024 chains, 4000
    steps): the posterior-mean slip's correlation with the truth >= 0.8,
    mean k below k_max, acceptance in (0, 1), finite llks, the saved stage
    loading with the per-patch ordering; and the constant-likelihood run
    of tests/test_transd.py:40, every k level within 0.045 of uniform;
17d. slice 9 (no kernel of its own: K1c synthesizes the waveforms, K5
    resamples): [polarity_llk] the FullMT problem with two polarity maps
    (60 P and 20 SH stations, per-draw takeoffs through 33 × 64 tables of
    the default crust): ms and CUDA calls of the 2000-chain llk of the
    polarity composite alone and of the joint problem, the polarity llk of
    64 chains within rtol 2e-5 of the same code in float64 on the host;
    [polarity_smc] SMC of the joint problem to β = 1 (2000 chains, 60
    steps): [smc]'s depth and Mw gates, and the best draw right on every
    first motion whose true amplitude exceeds 0.1 of the largest (after
    [pt_joint]); [bem_build] the linear BEM composite of the example's
    disk (1 km radius, 3 km deep, meshed at 100 m, levels (2, 6)) over the
    geodetic scenes: the interaction matrix, the displacement matrix and
    the SVD solve timed apart with their peaks, a random 64 × 64 block of
    each matrix within 1e-9 of the block's max of the element functions in
    float64 on the host, the float32 unit responses within 1e-6 of the
    host's float64 solve; [bem_smc] the traction to β = 1 within 10 %;
    [bem_geometry] the geometry composite (depth and traction sampled,
    300 m mesh, levels (1, 5)): the llk of a batch, a capped SMC (3 stages
    × 10 steps, β strictly increasing, finite llks, the count of invalid
    draws) and the −99 fill of a draw above the surface (after the
    geodetic phases);
17e. slice 10, the table builders (no kernel of their own: their device
    math is float64/complex128 torch; K1c and K5 run the paths through
    their tables), last, after [transd_ffi]: [layered_build] the FullMT
    table's grid (206 × 15 nodes, nt 1024, dt 0.5 s) as a layered waveform
    table of the default crust joined with ak135-f and earth-flattened (31
    layers) by the Kennett recursion on the card: its seconds, peak, depth
    buckets and the bins recomputed on the host in ``np.clongdouble`` (and
    their global-matrix fallbacks); two seeded depth nodes of one bucket
    recomputed by the same code on the host CPU, every trace within 1e-7
    of its max ([layered_host_check], after [visco_smc], so that it runs
    beside no timed phase); the
    ω → 0 limit at those nodes against the layered static solver (the
    bars of tests/test_layered_waveforms.py:40-50); the port's Bessel
    functions within 1e-12 of scipy's over the build's (r, k) ranges, and
    ``torch.special``'s error beside them; [layered_smc] the FullMT SMC on
    that table (2000 chains, 60 steps): [smc]'s depth and Mw gates, K1c and
    K5 launched; [trace_store] the table's traces written as a trace store
    at dt 0.25 s and read back at 0.5 s, within 1e-5 of the spectra's max
    below Nyquist, and a store of the analytic full-space oracle's traces
    (``heart/analytic.py``, no code shared with the solvers) read on the
    card, a moment tensor synthesized through it at azimuth 122° within
    1e-5 of the oracle's waveform; [static_build] build_gfs' geodetic grid (40 × 12) for
    the same model: two depth nodes on the host CPU within 1e-9 of max, a
    uniform model within 1 % of the analytic table; [visco_build] the
    default crust with Maxwell viscosities (0, 1e19, 1e18) Pa·s at 0, 30
    and 365 days, 8 s nodes a decade: the Prony residual ≤ 1e-3,
    ``at_time(0)`` equal to the elastic build; [visco_smc] the geodetic
    problem's two scenes acquired at 30 and 365 days through the epoch
    table (each scene's synthetics of the true source equal to those
    through its own epoch's table, and the true source's LOS at 30 and at
    365 days differing by more than 1e-3 of max), SMC to β = 1 (2000 chains,
    40 steps) within 300 m (depth 500 m), K5 launched;
17f. slice 11, the project and results layer (after [visco_smc], before
    [layered_host_check]): [project] the real-size FullMT problem written
    as a project directory by the port's writers (config, seismic data,
    ``gf_table.npz``) and loaded with ``load_model(..., device="cuda")``:
    its 2000-chain llk within rtol 2e-5 of the directly built problem's;
    ``sample()`` with the project's sampler settings (2000 chains, 60
    steps) under [smc]'s gates, K1c and K5 launched; ``summarize()``'s
    means equal to the stage's (rtol 1e-6); ``derived_samples()`` within
    1e-5 of the host's ``mt_utils`` on the host's m6 of the same draws
    (angles as a share of 360°); the best draw's variance reduction over
    all windows >= 0.9 (each wavemap's printed) and its Kagan angle to the
    truth (printed, no gate);
    [project_seis_derivative] ``seis_derivative`` at the best draw for
    depth and the six MT components: K1c launched by its forward-mode
    rule, every JVP within 1e-5 · Σ|tangent| · max|rows| per query of the
    plain version on the same tangent, the autodiff within the 3-point
    stencil's error bar of ``mode="fd"`` (4 × (|fd3 − fd5| + float32
    roundoff over the step), printed); [project_modes] the geodetic
    geometry, static FFI and linear BEM problems written as projects and
    loaded, each 2000-chain llk within rtol 1e-6 of the direct build's
    (the kinematic FFI project is left out on the card: its config path is
    held on the CPU);
17g. slice 12, the command line (after [project_modes], before
    [layered_host_check]): [cli] ``beat_tpu_torch.apps.cli.main`` driven in
    this process on the real-size FullMT problem, ``BEAT_TPU_PLATFORM``
    unset (the card): ``init``, the config and data by the port's writers,
    ``build_gfs`` (the table built on the card), ``check --what
    geometry``, ``sample`` under [smc]'s gates, ``summarize`` (the means of
    ``summary.txt`` equal to the stage's), ``export``, ``map`` under
    [map]'s gates and, when matplotlib imports, ``plot``; each command's
    seconds and K1c, K2c and K5 launches, none of ``jax`` or ``beat_tpu``
    imported;
17h. slice 13, the runtime (last, after [layered_host_check]):
    [parallel_smc] [project]'s FullMT project sampled by 2 ranks started
    here, sharing the card over gloo, through ``load_model`` and
    ``Problem.sample()`` (``_auto_mesh`` shards the 2000 chains, 1000 a
    rank): [smc]'s depth and Mw gates, the first population's llks per
    chain within rtol 2e-5 of [project]'s one-process run, the stage files
    written by rank 0 alone and read back through ``load_model``, K1c and
    K5 launched on each rank (each rank's counts printed), its seconds
    beside [smc]'s (ranks sharing one card: overhead, not a speed-up);
    [parallel_nccl] one rank over NCCL on ``make_chain_mesh(1)``: the
    capped SMC (stage 0 and one stage of 2000 chains × 60 steps) equal to
    the meshless run of the same seed (q atol 1e-6, llk atol 1e-5); a
    rank that fails, or ranks still running after 240 s, end the script;
18. [done] the script's seconds, a JSON line of the kernels, then
    ``{"ok": true, "device": ...}`` last.

Phase 12 and the bench-shape half of 13 run right after phase 4, phase 5
after them (the profiler's device records of launch-sized calls go
missing later in the process).  Every launch count is read from counters set to 0 just before
the path it counts.  It needs CUDA and exits non-zero without it; it never falls
back to the CPU.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

os.environ.pop("BEAT_TPU_PLATFORM", None)

N_CHAINS = 2000
N_STEPS = 60
K1_RTOL = 1e-6          # K1 vs plain: max |err| <= K1_RTOL · max|ref|
K2_RTOL = 1e-5          # K2 vs plain, per query: see phase 4 above
CONTRACT_RTOL = 1e-5    # K1c/K2c vs plain, per query: see phase 5 above
LLK_RTOL = 2e-5         # the JAX package's per-chain llk bar
GRAD_RTOL = 5e-3        # the JAX package's bar between its gather paths' gradients
DEPTH_TOL, MAG_TOL = 500.0, 0.05
MAP_DEPTH_TOL, MAP_MAG_TOL = 600.0, 0.15        # tests/test_optimize.py:115-116
STACK_RTOL = 1e-5        # K3/K4 vs plain, per (chain, target): see phase 12 above
K3_BENCH_SHAPE = dict(C=2000, T=8, P=12, D=6, S=16, N=256)     # tools/bench_gfstack.py
FFI_STEPS, FFI_MAX_STAGES = 20, 4                 # examples/laquila_scale_ffi.py
FFI_PLAIN_CHAINS = 128           # chains of the [ffi_llk] comparison with the plain stack
FFI_RECOVER_SIZE = dict(n_targets=12, n_strike=6, n_dip=3, nt=256, nwin=96)
FFI_RECOVER_STEPS = 20
FFI_MAG_TOL, FFI_VR_MIN = 0.05, 0.9
#: [sources_llk]: the other source types, each on the flagship's table and data
SOURCE_TYPES = ("MTQTSource", "DCSource", "ExplosionSource", "CLVDSource", "DoubleDCSource",
                "RingfaultSource", "RectangularSource")
PLAIN_QUERIES = 60000           # K1c queries per call of the plain version (5.9 GB of rows)
DC_VR_MIN = 0.9                 # [dc_mala_smc]: the best sample's variance reduction
RECT_STEPS, RECT_MAX_STAGES = 20, 4                # [rect_smc]: 3 stages × 20 steps
#: [geo_llk]: the source types of the geodetic geometry problem, and a GNSS
#: network with an Euler-pole and a strain-rate correction
GEO_CASES = ("RectangularSource", "ExplosionSource", "MTSource", "MTQTSource", "DCSource",
             "CLVDSource", "DoubleDCSource", "RingfaultSource", "gnss")
GEO_GNSS_STATIONS = 60
GEO_REF_CHAINS = 64             # chains of the float64 host evaluation of the llk
GEO_GRAD_CHAINS = 16            # ... and of the gradient
#: the value-and-grad's chains where 2000 do not fit the card: the
#: moment-tensor families evaluate 9 float64 cracks per point source,
#: (C, 9, 4, 3000) float64 temporaries; the table path 16 patch gathers
GEO_VG_CHAINS = {"MTSource": 500, "MTQTSource": 500, "DCSource": 500, "CLVDSource": 500,
                 "DoubleDCSource": 250, "RingfaultSource": 60, "table": 500}
GEO_TABLE_GRID = dict(distances=(0.0, 90e3, 181), depths=(0.5e3, 20e3, 40))
GEO_TABLE_PATCHES = (4, 4)
GEO_STEPS = 40
GEO_POS_TOL, GEO_DEPTH_TOL, GEO_VR_MIN = 300.0, 500.0, 0.9
STATIC_BUILD_PATCHES, STATIC_BUILD_RTOL = 20, 1e-4
STATIC_FFI_STEPS, STATIC_FFI_MAX_STAGES, STATIC_FFI_THINNING = 20, 4, 10
STATIC_RECOVER_SIZE = dict(n_strike=8, n_dip=4, n_points=300)
STATIC_RECOVER_STEPS = 20
DISCRETIZATION_PLANE = dict(depth=2e3, strike=135.0, dip=50.0, rake=-90.0, length=24e3,
                            width=12e3)
DISCRETIZATION_POINTS = 400
DISCRETIZATION_SPREAD_RTOL = 1e-9
#: [joint_llk], [pt_joint]: BASELINE config 3
JOINT_CHECK_CHAINS = 64         # chains of the checks against the plain and float64 evaluations
JOINT_SUM_RTOL = 1e-6           # the joint llk against its composites' llks evaluated alone
PT_JOINT = dict(n_chains=64, n_chains_posterior=16, n_samples=3000, swap_interval=(10, 30),
                tune_interval=100, beta_tune_interval=1500, t_scale=1.2, seed=0)
PT_PROPOSAL = "MultivariateNormal"
PT_POS_TOL, PT_DEPTH_TOL = 500.0, 1000.0          # median east/north and depth of the truth
PT_SWAP_BAND = (0.02, 0.98)                       # mean edge-pair exchange acceptance
#: [transd_ffi]: the trans-dimensional sampler on the static FFI fault, and
#: the constant-likelihood run of tests/test_transd.py:40 with its bar
TRANSD = dict(k_max=20, k_min=1, n_chains=1024, n_steps=4000, record_every=20, seed=0)
TRANSD_CORR_MIN = 0.8
TRANSD_PRIOR = dict(k_max=8, k_min=1, n_chains=96, n_steps=4000, record_every=20, seed=1)
TRANSD_PRIOR_ATOL = 0.045
#: [k3_bf16], [k4_bf16]: the bf16 stack against the float32 one
#: (tests/test_gfstack_pallas.py:176-179)
BF16_LOSS_MAX = 0.02
ESTIMATE_HYPERS_STEPS, ESTIMATE_HYPERS_CHAINS = 2000, 20      # [ffi_extras], static FFI
#: [bem_build]: the random blocks of the matrices held against the host's
#: float64 (rtol of the block's max, the CPU tests' bar) and the unit
#: responses against the float64 solve on the host (float32 cast)
BEM_BLOCK, BEM_BLOCK_RTOL, BEM_LOS_RTOL = 64, 1e-9, 1e-6
BEM_RECOVERY = 0.1                               # tests/test_bem_inversion.py:100
#: [bem_geometry]: chains of the llk batch and of the capped SMC (3 stages ×
#: 10 steps).  A chain costs about 0.3 s on an H100 80GB HBM3 (1.2 M
#: nested-jacfwd and 20 M surface triples), so 2000 chains (10 minutes an
#: llk) do not fit the run's time limit
BEM_GEO_CHAINS, BEM_GEO_SMC_CHAINS, BEM_GEO_STEPS, BEM_GEO_MAX_STAGES = 16, 4, 10, 4
#: [layered_build] ... [visco_smc]: the table builders (slice 10)
LAYERED_REL_STEP = 1e-3          # the builders' dipole step (rel_step)
LAYERED_NODE_SEED = 10           # picks the depth nodes recomputed on the host CPU
LAYERED_HOST_RTOL = 1e-7         # card vs host CPU, per trace of max|trace|
BESSEL_RTOL = 1e-12              # ops.bessel against scipy, of max|J|
STATIC_LIMIT_IMAG, STATIC_LIMIT_RTOL = 2e-3, 5e-3      # tests/test_layered_waveforms.py:40-50
#: the static side of that gate: Hankel points per half cycle, 10 × the default,
#: which misses the deep interfaces' effect near k = 0 by a few % (PERF.md)
STATIC_LIMIT_DENSITY = 200.0
TRACE_STORE_RTOL = 1e-5          # the trace store's round trip, of max|spectrum|
#: build_gfs' geodetic grid (beat_tpu/apps/commands.py:570-575)
STATIC_GRID = dict(distances=(1e3, 120e3, 40), depths=(0.5e3, 25e3, 12))
STATIC_HOST_RTOL = 1e-9          # card vs host CPU, of max|values|
#: tests/test_layered_statics.py:123-138: a uniform model against the analytic table
HOMO_STATIC = dict(vp=6000.0, vs=3500.0, rho=2700.0, distances=(2e3, 60e3, 6),
                   depths=(4e3, 9e3))
HOMO_STATIC_RTOL = 0.01
PRONY_RESID_MAX = 1e-3           # the builder's own warning level (viscoelastic.py:464)
EPOCH_SLAB_MIN = 1e-3            # the true source's LOS at the two epochs differs by more
#: [project]: the derived samples against the host's mt_utils (normalised
#: MT components absolute, nodal-plane angles as a share of 360°), the
#: best draw's variance reduction over all windows, the autodiff/fd bar's factor
#: and the other modes' projects against their direct builds
DERIVED_TOL, VR_MIN, FD_BAR_FACTOR, PROJECT_MODES_RTOL = 1e-5, 0.9, 4.0, 1e-6
# [project]: each wavemap's variance reduction at the best draw may fall
# this far below the same wavemap's at the true source
VR_TRUTH_MARGIN = 0.02
#: [parallel_smc]: ranks sharing the card over gloo; [parallel_ffi_llk]: the
#: (chains, targets) mesh; a phase's ranks are killed after the deadline
PARALLEL_SMC_RANKS, PARALLEL_FFI_MESH, PARALLEL_DEADLINE_S = 2, (2, 2), 240.0
#: [parallel_nccl]: the mesh run against the meshless one (tests/test_parallel.py:91-92)
PARALLEL_Q_ATOL, PARALLEL_LLK_ATOL = 1e-6, 1e-5
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM, bf16 on the tensor cores (dense)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def ms_or_none(x: float):
    """A device time for the JSON line: ``None`` where it was not measured."""
    return None if math.isnan(x) else x


def fmt_ms(x) -> str:
    return "not_measured" if x is None else f"{x:.4f}"


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float, flops_per_s: float = FP32_FLOPS_PER_S) -> tuple:
    """The least time the card could take for the work: ``(ms, "bytes" or
    "operations")``, whichever bounds it; the operations at
    ``flops_per_s`` (float32 outside the tensor cores unless said)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_queries(table, n: int, gen):
    """Random K1 queries over all three channel blocks, with top-edge
    nodes (fd or fz exactly 1.0) among them."""
    import torch

    nd, nz = table.distances.size, table.depths.size
    dev = table.packed.device
    comp = torch.randint(0, 3, (n,), generator=gen, device=dev)
    d0 = torch.randint(0, nd - 1, (n,), generator=gen, device=dev)
    z0 = torch.randint(0, nz - 1, (n,), generator=gen, device=dev)
    fd = torch.rand(n, generator=gen, device=dev)
    fz = torch.rand(n, generator=gen, device=dev)
    edge = torch.arange(n, device=dev) % 7 == 0
    d0 = torch.where(edge, nd - 2, d0)
    fd = torch.where(edge, 1.0, fd)
    z0 = torch.where(edge, nz - 2, z0)
    fz = torch.where(edge, 1.0, fz)
    w4 = torch.stack([(1 - fd) * (1 - fz), (1 - fd) * fz, fd * (1 - fz), fd * fz], dim=-1)
    return comp * (table.packed.shape[0] // 3) + d0, z0, w4


#: the CUDA calls by which a host thread hands work to the device; the
#: profiler records them on the host side of a trace
DEVICE_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                "cuMemset", "cudaGraphLaunch")


def device_kernels(fn) -> tuple:
    """``(launches, ms, {kernel name: ms})`` of the device operations one
    call of ``fn`` runs, from ``torch.profiler``.

    ``launches`` counts what the call hands to the device: the launches,
    copies and fills among the CUDA calls on the host side of the trace.
    The times are the device's own records.  Those can miss from a trace (CUPTI
    hands out a new record buffer in mid-trace and the records in it do
    not come back with this trace; seen a minute into a process): the
    trace is then taken again, four times at most, and if the records
    still miss ``ms`` is NaN and the dictionary empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        if kernels:
            break
    launches = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CPU
                   and e.key.startswith(DEVICE_CALLS))
    by_name = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    return launches, (sum(by_name.values()) if kernels else float("nan")), by_name


def stack_inputs(lib, n_chains: int, duration_range, starttime_range, gen) -> tuple:
    """Random (durations, starttimes, slips) of a GF-stack call on
    ``lib``'s device: uniform over the given ranges [s], slips in [0, 3)."""
    import torch

    dev = lib.data.device
    T, P = lib.ntargets, lib.npatches

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    return (uniform((n_chains, P), *duration_range), uniform((n_chains, T, P), *starttime_range),
            uniform((n_chains, P), 0.0, 3.0))


def stack_gate(data, slips, rtf, stf, got, ref) -> float:
    """Worst |got - ref| per (chain, target) over its bar, STACK_RTOL ·
    Σ_p |slip_p| · Σ_corners |w| · max|data| (the float32 sums of P ·
    corners products differ in order)."""
    wabs = 1.0
    if rtf is not None:
        wabs = (rtf.abs() + (1 - rtf).abs())[:, None, :] * (stf.abs() + (1 - stf).abs())
    bar = STACK_RTOL * (slips.abs()[:, None, :] * wabs).sum(-1) * data.abs().max().float()
    return float(((got - ref).abs().amax(-1) / bar).max())


def times_in_turns(fns: dict, iters: int) -> dict:
    """Mean CUDA-event milliseconds of each of ``fns`` timed in turns
    a, b, c, ..., c, b, a."""
    times = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        times[k].append(cuda_ms(fns[k], iters=iters))
    return {k: sum(v) / len(v) for k, v in times.items()}


def time_in_turns(fn_a, fn_b, iters: int) -> tuple:
    """Mean CUDA-event milliseconds of ``fn_a`` and ``fn_b`` timed a, b, b, a."""
    t = times_in_turns({"a": fn_a, "b": fn_b}, iters)
    return t["a"], t["b"]


#: the GF stack's kernel variants, in the order they are tried beside the plan's
STACK_VARIANTS = ("mma", "tiled", "gather")


def check_stack(lib, durations, starttimes, slips, interpolation: str, iters: int) -> dict:
    """One GF-stack kernel (K3 for multilinear, K4 for nearest neighbour)
    against its plain version on the same inputs: the variant the plan
    chose and every other one that can run here (``mma``: K3 on a bf16
    library only); their times in turns, the plain time and the bound.
    ``tiled`` and ``gather`` must be equal bit for bit, every variant
    equal to itself on a second call.  Raises SystemExit when a check
    fails."""
    import torch

    from beat_tpu_torch.ops.gfstack import (_clamp_cells, group_cells, plan_stack,
                                            stack_batched, stack_batched_reference)

    data = lib.data
    T, P, D, S, N = data.shape
    C = durations.shape[0]
    didx, rtf = lib.durations2idxs(durations, interpolation)
    sidx, stf = lib.starttimes2idxs(starttimes, interpolation)
    multilinear = rtf is not None
    corners = 4 if multilinear else 1
    bf16 = data.dtype == torch.bfloat16
    plan = plan_stack(T, P, D, S, N, C, corners, aligned=data.data_ptr() % 16 == 0,
                      elem_bytes=data.element_size())
    variants = [plan.variant]
    for v in STACK_VARIANTS:
        if v == plan.variant:
            continue
        try:
            plan_stack(T, P, D, S, N, C, corners, variant=v, elem_bytes=data.element_size())
            variants.append(v)
        except ValueError:      # tiled or mma cannot run here
            pass

    def run(variant):
        return stack_batched(data, didx, sidx, slips, rtf, stf, variant=variant)

    ref = stack_batched_reference(data, didx, sidx, slips, rtf, stf)
    got = {v: run(v) for v in variants}
    deterministic = {v: bool(torch.equal(run(v), got[v])) for v in variants}
    torch.cuda.synchronize()
    errs = {v: float((g - ref).abs().max()) for v, g in got.items()}
    over = {v: stack_gate(data, slips, rtf, stf, g, ref) for v, g in got.items()}
    out = {"variant": plan.variant, "why": plan.why, "variants": variants,
           "max_ref": float(ref.abs().max()), "max_abs_err": errs[plan.variant],
           "worst_err_over_bar": max(over.values()),
           "variants_err_over_bar": over, "variants_max_abs_err": errs,
           "deterministic": all(deterministic.values()),
           "variants_equal": ("tiled" not in got or "gather" not in got
                              or bool(torch.equal(got["tiled"], got["gather"])))}
    del got, ref
    torch.cuda.empty_cache()
    # every variant in turns; ``previous_ms`` is the gather variant (the
    # kernel before the tiled one)
    times = times_in_turns({v: (lambda v=v: run(v)) for v in variants}, iters)
    out["variants_ms"] = times
    out["ms"], out["previous_ms"] = times[plan.variant], times["gather"]
    out["device_ms"] = ms_or_none(device_kernels(lambda: run(plan.variant))[1])
    out["previous_device_ms"] = ms_or_none(device_kernels(lambda: run("gather"))[1])
    out["plain_ms"] = cuda_ms(
        lambda: stack_batched_reference(data, didx, sidx, slips, rtf, stf), iters=2, warmup=1)
    # bytes: the library cells these indices touch, the indices and weights, the output
    touched = torch.zeros(T * P * D * S, dtype=torch.bool, device=data.device)
    tp = (torch.arange(T, device=data.device)[:, None] * P
          + torch.arange(P, device=data.device)[None, :])
    for dd, ss in ((0, 0), (0, 1), (1, 0), (1, 1)) if multilinear else ((0, 0),):
        touched[((tp * D + (didx.long()[:, None, :] - dd)) * S + (sidx.long() - ss))] = True
    out["cells_read"] = int(touched.sum())
    per_entry = 8 if multilinear else 4          # sidx (+ stf); didx, slips (+ rtf)
    n_bytes = (out["cells_read"] * N * data.element_size() + sidx.numel() * per_entry
               + C * P * (per_entry + 4) + C * T * N * 4)
    # a bf16 library's products fit the tensor cores (bf16 operands, float32
    # sums), a float32 library's the CUDA cores
    out["bound_ms"], out["bound_by"] = bound_ms(
        n_bytes, 2.0 * corners * C * T * P * N, BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S)
    if "mma" in variants:
        out["group_cells"] = group_cells(*_clamp_cells(data, didx, sidx, True))
    if not (out["worst_err_over_bar"] <= 1.0 and out["variants_equal"]
            and out["deterministic"]):
        raise SystemExit(f"the {interpolation} GF stack disagrees with its plain version (or "
                         f"tiled with gather, or a variant with itself on a second call): err/bar "
                         f"{over}, tiled == gather {out['variants_equal']}, deterministic "
                         f"{deterministic}")
    return out


def say_stack(key: str, shape: str, dims: dict, r: dict, **extra) -> None:
    fields = dict(variant=r["variant"], max_abs_err=f"{r['max_abs_err']:.3e}",
                  max_ref=f"{r['max_ref']:.3e}",
                  worst_err_over_bar=f"{r['worst_err_over_bar']:.3e}",
                  variants_equal=r["variants_equal"], deterministic=r["deterministic"],
                  ms=f"{r['ms']:.4f}",
                  previous_ms=f"{r['previous_ms']:.4f}", device_ms=fmt_ms(r["device_ms"]),
                  previous_device_ms=fmt_ms(r["previous_device_ms"]))
    fields.update({f"{v}_ms": f"{t:.4f}" for v, t in r["variants_ms"].items()})
    fields["err_over_bar"] = json.dumps({v: float(f"{e:.3e}")
                                         for v, e in r["variants_err_over_bar"].items()})
    if "group_cells" in r:
        fields["group_cells"] = json.dumps(r["group_cells"])
    library_ms = "none" if r.get("library_ms") is None else f"{r['library_ms']:.4f}"
    say(key, shape=shape, **dims, **fields, plain_ms=f"{r['plain_ms']:.4f}", library_ms=library_ms,
        cells_read=r["cells_read"], bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
        share_of_bound=f"{r['bound_ms'] / r['ms']:.3f}", why=json.dumps(r["why"]), **extra)


def dense_bmm_ms(lib, durations, starttimes, slips, interpolation: str = "multilinear"
                 ) -> tuple:
    """The GF stack as one dense ``torch.bmm`` over the scattered corner
    weights, (T, C, P·D·S) @ (T, P·D·S, N): the library yardstick of K3
    (``multilinear``: four corners a patch) and K4 (``nearest_neighbor``:
    one), not a path of the port; on a bf16 library the weights are bf16
    too (a corner's weight is written once, never summed).  The cells are clamped as the plain
    version clamps them.  Returns (ms of the bmm alone, ms with the scatter
    that builds the weights, max |err| against the plain version)."""
    import torch

    from beat_tpu_torch.ops.gfstack import _clamp_cells, stack_batched_reference

    data = lib.data
    T, P, D, S, N = data.shape
    C = durations.shape[0]
    didx, rtf = lib.durations2idxs(durations, interpolation)
    sidx, stf = lib.starttimes2idxs(starttimes, interpolation)
    d, s = _clamp_cells(data, didx, sidx, rtf is not None)
    d = d[:, None, :]
    p = torch.arange(P, device=data.device)
    flat = data.reshape(T, P * D * S, N)
    if rtf is None:
        corners = ((0, 0, torch.ones_like(slips)[:, None, :]),)
    else:
        rf = rtf[:, None, :]
        corners = ((1, 1, rf * stf), (1, 0, rf * (1 - stf)), (0, 1, (1 - rf) * stf),
                   (0, 0, (1 - rf) * (1 - stf)))

    def weights():
        w = torch.zeros((C, T, P * D * S), dtype=data.dtype, device=data.device)
        for dd, ss, wc in corners:
            idx = ((p * D + (d - dd)) * S + (s - ss)).expand(C, T, P)
            w.scatter_add_(2, idx, (wc * slips[:, None, :]).to(data.dtype).expand(C, T, P))
        return w.transpose(0, 1).contiguous()

    w = weights()
    got = torch.bmm(w, flat).transpose(0, 1)
    err = float((got - stack_batched_reference(data, didx, sidx, slips, rtf, stf)).abs().max())
    del got
    return (cuda_ms(lambda: torch.bmm(w, flat), iters=10),
            cuda_ms(lambda: torch.bmm(weights(), flat), iters=10), err)


def unfused_point_spectra(table):
    """``table.point_spectra`` as it was before K1c: K1's blended (…, 6,
    nf, 2) rows (``gather_spectra``), then the m6 contraction as a matmul,
    whose backward is a gemm, a gemv and K2.  The yardstick of
    [grad_profile]; not a path of the port."""
    import torch

    from beat_tpu_torch.heart.gftable import rotate_m6_to_ray_frame
    from beat_tpu_torch.ops.cplx import cmul

    def point_spectra(m6, east_shift, north_shift, depth, station_east, station_north,
                      comp_idx, filter_response=None):
        de = station_east - east_shift[..., None]
        dn = station_north - north_shift[..., None]
        g = table.gather_spectra(torch.sqrt(de**2 + dn**2), depth, comp_idx)
        m6_ray = rotate_m6_to_ray_frame(m6[..., None, :], torch.atan2(de, dn))
        spec = (m6_ray.to(g.dtype)[..., None, :]
                @ g.reshape(g.shape[:-3] + (6, 2 * table.nf))).reshape(g.shape[:-3]
                                                                      + (table.nf, 2))
        return spec if filter_response is None else cmul(spec, filter_response)

    return point_spectra


def check_contract(tbl, queries: dict, gen) -> dict:
    """K1c and K2c against their plain versions on one set of (..., T)
    queries (``cd``, ``z0`` and ``A = w4 ⊗ m6`` (..., T, 4, 6), with its
    factors), per query within CONTRACT_RTOL · Σ|A| (or Σ|G|) · max|rows|;
    their times, the unfused path's in turns (``previous_ms``: K1 and the
    matmul for K1c, the matmul's backward and K2 for K2c), the plain times,
    the one-call library times and the bounds.  The library call is
    ``embedding_bag`` over the table's component segments, one bag of 24
    segments a query weighted by A, and for K2c its per-sample-weights
    backward; it is held to the same bar.  Raises SystemExit when a kernel
    or the library call disagrees."""
    import torch

    from beat_tpu_torch.kernels.build import load
    from beat_tpu_torch.ops.bilgather import (bilinear_contract, bilinear_contract_reference,
                                              bilinear_rows, contract_corner_dot,
                                              contract_corner_dot_reference, corner_dot,
                                              corner_rows_reference)

    CD, NZ, M = tbl.shape
    L = M // 6
    cd, z0, A = queries["cd"], queries["z0"], queries["A"]
    T, n = cd.shape[-1], cd.numel()
    w4, m6 = queries["w4"].reshape(n, 4), queries["m6"].reshape(n, 6)
    G = torch.randn(cd.shape + (L,), generator=gen, device=tbl.device)
    cdf, z0f, Af, Gf = cd.reshape(n), z0.reshape(n), A.reshape(n, 4, 6), G.reshape(n, L)
    cdc, z0c = cdf.clamp(0, CD - 2), z0f.clamp(0, NZ - 2)       # the plain versions do not clamp
    rows = corner_rows_reference(tbl, cdc, z0c)
    row_max = rows.abs().amax(dim=(1, 2))
    row = cdc * NZ + z0c
    rows_read = int(torch.unique(torch.cat([row, row + 1, row + NZ, row + NZ + 1])).numel())
    del rows
    # groups: distinct corner blocks of each (chain tile, target), what the
    # kernels bring from L2 once each; the tiles are the built kernels' own
    lib, _ = load("bilgather")
    q = torch.arange(n, device=tbl.device)
    groups = {}
    for key, kernel_id in (("k1c", 0), ("k2c", 1)):
        tile = lib.beat_contract_tile(kernel_id)
        block = (q // T) // tile * T + q % T
        groups[key] = int(torch.unique(block * (CD * NZ) + row).numel())
    out = {"queries": n, "targets": T, "table_rows_read": rows_read, "groups": groups}

    # the library yardstick: the table as (CD·NZ·6, L) segment rows, a bag
    # of the 24 segments (corner c, component k) of each query
    seg = tbl.view(CD * NZ * 6, L)
    corners = torch.stack([row, row + 1, row + NZ, row + NZ + 1], dim=1)
    idx24 = (corners[:, :, None] * 6 + torch.arange(6, device=tbl.device)).reshape(n, 24)
    offsets = torch.arange(0, 24 * n, 24, device=tbl.device)
    offset2bag = torch.arange(n, device=tbl.device).repeat_interleave(24)
    ind = idx24.reshape(-1)
    A24 = Af.reshape(n, 24)

    def library_forward():
        return torch.nn.functional.embedding_bag(idx24, seg, per_sample_weights=A24, mode="sum")

    def library_backward():
        return torch.ops.aten._embedding_bag_per_sample_weights_backward(
            Gf, seg, ind, offsets, offset2bag, 0, -1).view(n, 4, 6)

    def unfused_forward():
        blended = bilinear_rows(tbl, cdf, z0f, w4)                     # K1, (n, 6·L)
        return (m6[:, None, :] @ blended.view(n, 6, L)).view(n, L)

    blended = bilinear_rows(tbl, cdf, z0f, w4).view(n, 6, L)

    def unfused_backward():
        d_rows = m6[:, :, None] @ Gf[:, None, :]                       # gemm, (n, 6, L)
        dm6 = blended @ Gf[:, :, None]                                 # gemv
        return corner_dot(tbl, cdf, z0f, d_rows.view(n, M)), dm6       # K2

    for key, kernel, plain, unfused, library, x, x_abs, sum_dims in (
            ("k1c", bilinear_contract, bilinear_contract_reference, unfused_forward,
             library_forward, A, Af.abs().sum((1, 2)), -1),
            ("k2c", contract_corner_dot, contract_corner_dot_reference, unfused_backward,
             library_backward, G, Gf.abs().sum(-1), (1, 2))):
        got = kernel(tbl, cd, z0, x)
        again = kernel(tbl, cd, z0, x)
        xf = Af if key == "k1c" else Gf
        ref = plain(tbl, cdc, z0c, xf)
        lib_got = library()
        torch.cuda.synchronize()
        bar = CONTRACT_RTOL * x_abs * row_max
        err = (got.reshape(ref.shape) - ref).abs().amax(sum_dims)
        r = {"max_abs_err": float(err.max()), "max_ref": float(ref.abs().max()),
             "worst_err_over_bar": float((err / bar).max()),
             "deterministic": bool(torch.equal(got, again)),
             "library_worst_err_over_bar": float(
                 ((lib_got - ref).abs().amax(sum_dims) / bar).max())}
        del got, again, ref, err, lib_got, bar
        torch.cuda.empty_cache()
        r["ms"], r["previous_ms"] = time_in_turns(lambda: kernel(tbl, cd, z0, x), unfused, 20)
        r["library_ms"] = cuda_ms(library, iters=20)
        r["plain_ms"] = cuda_ms(lambda: plain(tbl, cdc, z0c, xf), iters=3, warmup=1)
        # bytes: the touched table rows, the int32 indices, the coefficients
        # (A in, or P out), the spectra (out) or their cotangent (G in)
        r["bound_ms"], r["bound_by"] = bound_ms(rows_read * M * 4 + n * 8 + n * 24 * 4
                                                + n * L * 4, 2.0 * 24 * L * n)
        out[key] = r
    del blended, idx24, ind, offsets, offset2bag
    torch.cuda.empty_cache()
    for key in ("k1c", "k2c"):
        r = out[key]
        if not (r["worst_err_over_bar"] <= 1.0 and r["deterministic"]):
            raise SystemExit(f"{key} disagrees with its plain version (or with itself): "
                             f"worst err/bar {r['worst_err_over_bar']}, "
                             f"deterministic {r['deterministic']}")
        if not r["library_worst_err_over_bar"] <= 1.0:
            raise SystemExit(f"{key}'s library yardstick computes another function: "
                             f"worst err/bar {r['library_worst_err_over_bar']}")
    return out


def say_contract(shape: str, r: dict) -> None:
    for key in ("k1c", "k2c"):
        k = r[key]
        say(key, shape=shape, queries=r["queries"], targets=r["targets"],
            max_abs_err=f"{k['max_abs_err']:.3e}", max_ref=f"{k['max_ref']:.3e}",
            worst_err_over_bar=f"{k['worst_err_over_bar']:.3e}",
            deterministic=k["deterministic"], ms=f"{k['ms']:.4f}",
            previous_ms=f"{k['previous_ms']:.4f}", plain_ms=f"{k['plain_ms']:.4f}",
            library_ms=f"{k['library_ms']:.4f}",
            library_worst_err_over_bar=f"{k['library_worst_err_over_bar']:.3e}",
            table_rows_read=r["table_rows_read"], groups=r["groups"][key],
            bound_ms=f"{k['bound_ms']:.4f}", bound_by=k["bound_by"],
            share_of_bound=f"{k['bound_ms'] / k['ms']:.3f}")


def chunked_value(fn, q, chunk: int):
    """``fn`` over the chains of ``q`` in chunks of ``chunk``, concatenated
    (the plain versions at the finite layouts outgrow the card in one call)."""
    import torch

    outs = [fn(q[i:i + chunk]) for i in range(0, q.shape[0], chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def grad_gate(grad, grad_plain) -> tuple:
    """Worst |err| over the per-parameter bar GRAD_RTOL · (|ref| + max of its
    column), and whether every entry is finite and within it."""
    import torch

    diff = (grad - grad_plain).abs()
    bar = GRAD_RTOL * grad_plain.abs() + GRAD_RTOL * grad_plain.abs().amax(0)
    worst = float((diff / bar.clamp_min(torch.finfo(bar.dtype).tiny)).max())
    return worst, bool(torch.isfinite(grad).all() and (diff <= bar).all())


def queries_per_chain(comp) -> int:
    """K1c queries one chain of a geometry composite makes per evaluation."""
    from beat_tpu_torch.sources import DoubleDCSource, RectangularSource, RingfaultSource

    def points(src):
        if isinstance(src, RectangularSource):
            return comp.finite_patches[0] * comp.finite_patches[1]
        if isinstance(src, RingfaultSource):
            return src.npointsources
        return 2 if isinstance(src, DoubleDCSource) else 1

    return sum(w.ntargets * sum(points(s) for _, s, _ in comp._selected_sources(w))
               for w in comp.wavemaps)


def check_finite_layout(tbl, cd, z0, A, gen) -> dict:
    """K1c on the queries of one finite-source likelihood (millions: the
    patches as one more leading axis) against its plain version chunk by
    chunk, per query within CONTRACT_RTOL · Σ|A| · max|rows|; its time,
    the plain version's over all chunks, the ``embedding_bag`` yardstick's
    and the bound.  Raises SystemExit when K1c disagrees."""
    import torch

    from beat_tpu_torch.ops.bilgather import (bilinear_contract, bilinear_contract_reference,
                                              corner_rows_reference)

    CD, NZ, M = tbl.shape
    L = M // 6
    n = cd.numel()
    cdc = cd.reshape(n).clamp(0, CD - 2)
    z0c = z0.reshape(n).clamp(0, NZ - 2)
    Af = A.reshape(n, 4, 6)
    row = cdc * NZ + z0c
    rows_read = int(torch.unique(torch.cat([row, row + 1, row + NZ, row + NZ + 1])).numel())
    chunk = 60000
    got = bilinear_contract(tbl, cd, z0, A).reshape(n, L)
    worst, max_err = 0.0, 0.0
    for i in range(0, n, chunk):
        sl = slice(i, i + chunk)
        ref = bilinear_contract_reference(tbl, cdc[sl], z0c[sl], Af[sl])
        row_max = corner_rows_reference(tbl, cdc[sl], z0c[sl]).abs().amax(dim=(1, 2))
        err = (got[sl] - ref).abs().amax(-1)
        max_err = max(max_err, float(err.max()))
        worst = max(worst, float((err / (CONTRACT_RTOL * Af[sl].abs().sum((1, 2))
                                         * row_max)).max()))
    del got, ref, row_max, err
    torch.cuda.empty_cache()
    out = {"queries": n, "shape": tuple(cd.shape), "max_abs_err": max_err,
           "worst_err_over_bar": worst, "table_rows_read": rows_read}
    out["ms"] = cuda_ms(lambda: bilinear_contract(tbl, cd, z0, A), iters=5, warmup=1)
    out["plain_ms"] = cuda_ms(lambda: [bilinear_contract_reference(
        tbl, cdc[i:i + chunk], z0c[i:i + chunk], Af[i:i + chunk]) for i in range(0, n, chunk)],
        iters=1, warmup=1)
    seg = tbl.view(CD * NZ * 6, L)
    corners = torch.stack([row, row + 1, row + NZ, row + NZ + 1], dim=1)
    idx24 = (corners[:, :, None] * 6 + torch.arange(6, device=tbl.device)).reshape(n, 24)
    out["library_ms"] = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        idx24, seg, per_sample_weights=Af.reshape(n, 24), mode="sum"), iters=3, warmup=1)
    del idx24, corners
    torch.cuda.empty_cache()
    out["bound_ms"], out["bound_by"] = bound_ms(rows_read * M * 4 + n * 8 + n * 24 * 4
                                                + n * L * 4, 2.0 * 24 * L * n)
    if not worst <= 1.0:
        raise SystemExit(f"K1c disagrees with its plain version at the finite layout "
                         f"{tuple(cd.shape)}: worst err/bar {worst}")
    return out


def ffi_recover(interpolation: str, dev, workdir: str, n_chains: int) -> dict:
    """Sample the small FFI problem to β = 1 and hold the posterior
    against the rupture behind its data.  Raises SystemExit on a miss."""
    import numpy as np
    import torch

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.flagship import build_ffi_flagship
    from beat_tpu_torch.samplers import SMCParams

    problem = build_ffi_flagship(**FFI_RECOVER_SIZE, seed=0, device=dev,
                                 interpolation=interpolation,
                                 outfolder=os.path.join(workdir, f"ffi_recover_{interpolation}"))
    comp = problem.composites["seismic"]
    t0 = time.perf_counter()
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=n_chains, n_steps=FFI_RECOVER_STEPS,
                                            seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    true = problem.true_point
    mean = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    best = problem.ordering.to_point(q_tr[-1][np.argmax(llk_tr[-1])])
    mag, true_mag = comp.fault.magnitude(mean["uparr"]), comp.fault.magnitude(true["uparr"])
    vr = comp.get_variance_reductions(best)[comp.wavemaps[0].mapid]
    logp, data = problem.make_logp_fn()
    big = dict(true, uparr=np.asarray(true["uparr"]) * 2.5, h_any_P_0=0.0, h_laplacian=0.0)
    llk_big = float(logp(torch.as_tensor(problem.ordering.to_array(big), dtype=torch.float32,
                                         device=dev)[None], data))
    out = dict(interpolation=interpolation, dims=problem.ordering.size, chains=n_chains,
               steps=FFI_RECOVER_STEPS, wall_s=f"{wall:.2f}", stages=len(state["acceptance"]),
               beta=float(state["beta"]), magnitude=f"{mag:.4f}", true_magnitude=f"{true_mag:.4f}",
               variance_reduction_best=f"{vr:.4f}",
               llk_median=f"{float(np.median(llk_tr[-1])):.1f}", llk_slip_x2_5=f"{llk_big:.1f}")
    say("ffi_recover", **out)
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit(f"FFI SMC ({interpolation}) did not reach beta = 1 with finite llks")
    if abs(mag - true_mag) >= FFI_MAG_TOL or vr < FFI_VR_MIN:
        raise SystemExit(f"FFI posterior ({interpolation}) misses the rupture: Mw {mag} against "
                         f"{true_mag}, variance reduction {vr}")
    if not np.median(llk_tr[-1]) > llk_big:
        raise SystemExit(f"FFI posterior ({interpolation}) no better than 2.5 times the slip")
    return out


def llk_scale(problem, point: dict):
    """The magnitude of the residual-free terms of a geodetic problem's llk
    at a batch ``point``: Σ |log det C_d| + n_d · |2h + log 2π| over the
    datasets, and the same terms of the Laplacian prior.  They are the
    scale beside |llk| in the llk bars: in float32 each is rounded to
    about 6e-8 of itself (the log-determinants are float32 device data in
    both packages), while at a large hyperparameter they cancel each
    other and the llk to a few units."""
    import torch

    log2pi = math.log(2 * math.pi)
    total = 0.0
    for comp in problem.composites.values():
        if comp.name == "laplacian":
            h = point.get("h_laplacian", 0.0)
            total = total + len(comp.slip_varnames) * (
                abs(comp.slog_det) + comp.npatches * torch.abs(2.0 * h + log2pi))
            continue
        for i, ds in enumerate(comp.datasets):
            h = point.get(comp._hypername(i, ds), 0.0)
            pdet = float(getattr(comp, f"dataset{i}_slog_pdet"))
            total = total + abs(pdet) + ds.samples * torch.abs(2.0 * h + log2pi)
    return torch.as_tensor(total)


class forward_dtype:
    """The port's analytic geodetic forwards evaluated in ``dtype`` inside
    the block (``okada.FORWARD_DTYPE``, the one place that chooses it):
    for control readings of what another precision would cost and miss."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __enter__(self):
        from beat_tpu_torch.heart import okada

        self.saved, okada.FORWARD_DTYPE = okada.FORWARD_DTYPE, self.dtype

    def __exit__(self, *exc):
        from beat_tpu_torch.heart import okada

        okada.FORWARD_DTYPE = self.saved


def geo_llk_case(problem, case: str, vg_chains: int, gen_seed: int = 5,
                 control: bool = False) -> dict:
    """One 2000-chain llk and one value-and-grad (at ``vg_chains``) of a
    geodetic problem on the card, held against a float64 evaluation of
    the same code on the host: the llk on GEO_REF_CHAINS chains within
    LLK_RTOL · (|llk| + the scale of its residual-free terms, ``llk_scale``),
    the gradient on GEO_GRAD_CHAINS chains at the per-parameter bar.  Raises
    SystemExit on a miss.  With ``control``, also the llk with the analytic
    forward in float32: its time, peak and error over the same bar (a
    reading, not a gate)."""
    import copy

    import numpy as np
    import torch

    from beat_tpu_torch.device import DTYPE
    from beat_tpu_torch.samplers import value_and_grad

    dev = next(iter(problem.composites.values())).data.device
    logp, data = problem.make_logp_fn()
    lo, hi = problem.priors.bounds_arrays()
    span = hi - lo
    q = torch.as_tensor(np.random.default_rng(gen_seed).uniform(
        lo + 0.01 * span, hi - 0.01 * span, size=(N_CHAINS, lo.size)), dtype=DTYPE, device=dev)

    def fwd(x=q):
        with torch.no_grad():
            return logp(x, data)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    llk = fwd()
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    llk_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    # as many timed calls as fit in about 0.2 s (1 for the slow MT families)
    iters = max(1, min(5, int(200.0 / max(first_ms, 1e-3))))
    llk_ms = cuda_ms(fwd, iters=iters, warmup=1 if iters > 1 else 0)
    calls_fwd, kernel_fwd, by_name = device_kernels(fwd)
    qv = q[:vg_chains]
    torch.cuda.reset_peak_memory_stats()
    _, grad = value_and_grad(logp, qv, (data,))
    torch.cuda.synchronize()
    vg_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    vg_ms = cuda_ms(lambda: value_and_grad(logp, qv, (data,)), iters=iters,
                    warmup=1 if iters > 1 else 0)
    calls_vg, kernel_vg, _ = device_kernels(lambda: value_and_grad(logp, qv, (data,)))

    refs = [copy.deepcopy(c).to("cpu", torch.float64) for c in problem.composites.values()]

    def logp64(x):
        point = problem.ordering.to_point(x)
        return sum(c.loglike(point) for c in refs)

    q64 = q[:GEO_REF_CHAINS].double().cpu()
    t0 = time.perf_counter()
    with torch.no_grad():
        llk64 = logp64(q64)
    n_grad = min(GEO_GRAD_CHAINS, vg_chains)
    _, grad64 = value_and_grad(logp64, q64[:n_grad])
    ref_s = time.perf_counter() - t0
    scale = llk_scale(problem, problem.ordering.to_point(q64))
    diff = (llk[:GEO_REF_CHAINS].double().cpu() - llk64).abs()
    rel = float((diff / llk64.abs()).max())
    worst = float((diff / (LLK_RTOL * (llk64.abs() + scale))).max())
    worst_g, grad_ok = grad_gate(grad[:n_grad].double().cpu(), grad64)
    finite = bool(torch.isfinite(llk).all() and torch.isfinite(grad).all())
    ctl = {}
    if control:
        with forward_dtype(torch.float32):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            llk32 = fwd()
            torch.cuda.synchronize()
            ctl_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            ctl_ms = cuda_ms(fwd, iters=iters, warmup=1 if iters > 1 else 0)
        diff32 = (llk32[:GEO_REF_CHAINS].double().cpu() - llk64).abs()
        worst32 = float((diff32 / (LLK_RTOL * (llk64.abs() + scale))).max())
        ctl = dict(float32_forward_llk_ms=f"{ctl_ms:.3f}",
                   float32_forward_peak_GB=f"{ctl_peak:.2f}",
                   float32_forward_worst_err_over_bar=f"{worst32:.3e}",
                   float32_forward_max_rel_err=f"{float((diff32 / llk64.abs()).max()):.3e}")
        del llk32
    r = dict(case=case, dims=lo.size, chains=N_CHAINS, points=problem.composites[
        "geodetic"].stack.samples, ref_chains=GEO_REF_CHAINS, max_rel_err=f"{rel:.3e}",
        worst_err_over_bar=f"{worst:.3e}", vg_chains=vg_chains, grad_chains=n_grad,
        grad_worst_err_over_bar=f"{worst_g:.3e}", finite=finite, llk_ms=f"{llk_ms:.3f}",
        value_and_grad_ms=f"{vg_ms:.3f}", llk_peak_GB=f"{llk_peak:.2f}",
        value_and_grad_peak_GB=f"{vg_peak:.2f}", calls_forward=calls_fwd,
        calls_value_and_grad=calls_vg, kernel_ms_forward=fmt_ms(ms_or_none(kernel_fwd)),
        kernel_ms_value_and_grad=fmt_ms(ms_or_none(kernel_vg)), host_f64_ref_s=f"{ref_s:.1f}",
        top_forward=json.dumps([[k[:50], round(v, 4)] for k, v in list(by_name.items())[:5]]),
        **ctl)
    if not (worst <= 1.0 and grad_ok and finite):
        say("geo_llk_failed", **r)
        raise SystemExit(f"[geo_llk] {case}: llk or gradient disagrees with the float64 "
                         f"evaluation (llk worst/bar {worst}, gradient worst/bar {worst_g})")
    del llk, grad, q, qv, refs
    torch.cuda.empty_cache()
    return r


def geodetic_phases(dev, workdir: str, k5_launches: dict) -> dict:
    """The geodetic slice: [geo_llk], [geo_table], [geo_smc],
    [static_ffi_build], [static_ffi_llk], [static_ffi_smc],
    [static_ffi_recover], [discretization].  Adds the SMC paths' K5
    launches to ``k5_launches``; returns the phases' results.  Raises
    SystemExit at the first gate missed."""
    import numpy as np
    import torch

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.covariance import GeodeticNoiseAnalyser
    from beat_tpu_torch.device import DTYPE
    from beat_tpu_torch.ffi.discretization import (ResolutionDiscretizationConfig, _build_G,
                                                   model_resolution,
                                                   normalized_resolution_spread,
                                                   optimize_discretization)
    from beat_tpu_torch.ffi.gflibrary import geo_construct_gf_linear
    from beat_tpu_torch.flagship import (GEO_REAL_SIZE, GEO_TRUE, STATIC_FFI_REAL_SIZE,
                                         build_geodetic_flagship, build_static_ffi_flagship,
                                         scatter_points)
    from beat_tpu_torch.heart.okada import okada_surface_displacement
    from beat_tpu_torch.heart.statictable import build_homogeneous_static_table
    from beat_tpu_torch.ops.rowgather import gather_rows
    from beat_tpu_torch.samplers import SMCParams
    from beat_tpu_torch.sources import RectangularSource, moment_to_magnitude

    out = {}

    # [geo_llk] every source type, and a GNSS network with its corrections
    for case in GEO_CASES:
        problem = build_geodetic_flagship(
            **GEO_REAL_SIZE, seed=0, device=dev, outfolder=os.path.join(workdir, "geo_llk"),
            source="RectangularSource" if case == "gnss" else case,
            gnss_stations=GEO_GNSS_STATIONS if case == "gnss" else 0)
        out[f"geo_llk_{case}"] = r = geo_llk_case(problem, case,
                                                  GEO_VG_CHAINS.get(case, N_CHAINS), control=True)
        say("geo_llk", **r)
        del problem

    # [geo_table] the rectangle through a homogeneous static table built on the card
    d0, d1, nd = GEO_TABLE_GRID["distances"]
    z0, z1, nz = GEO_TABLE_GRID["depths"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = build_homogeneous_static_table(np.linspace(d0, d1, nd), np.linspace(z0, z1, nz),
                                           device=dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    problem = build_geodetic_flagship(**GEO_REAL_SIZE, seed=0, device=dev, static_table=table,
                                      finite_patches=GEO_TABLE_PATCHES,
                                      outfolder=os.path.join(workdir, "geo_table"))
    out["geo_table"] = r = geo_llk_case(problem, "table", GEO_VG_CHAINS["table"])
    say("geo_table", table=tuple(table.values.shape), build_s=f"{table_s:.3f}",
        patches=json.dumps(GEO_TABLE_PATCHES), **r)
    del problem, table

    # [geo_smc] the geometry inversion to beta = 1, then update_weights at its best sample
    problem = build_geodetic_flagship(**GEO_REAL_SIZE, seed=0, device=dev,
                                      outfolder=os.path.join(workdir, "geo_smc"))
    comp = problem.composites["geodetic"]
    gather_rows.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=GEO_STEPS, seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5_launches["geo_smc"] = gather_rows.launches
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    post, llk_post = q_tr[-1], llk_tr[-1]
    mean = problem.ordering.to_point(post.mean(axis=0))
    sd = problem.ordering.to_point(post.std(axis=0))
    best = problem.ordering.to_point(post[int(np.argmax(llk_post))])
    true = problem.true_point
    vr = comp.get_variance_reductions(best)
    ramp_z = {n: abs(float(mean[n]) - true[n]) / max(float(sd[n]), 1e-30)
              for n in comp.get_hierarchical_names()}
    logp, data = problem.make_logp_fn()
    with torch.no_grad():
        llk_true = float(logp(torch.as_tensor(problem.point_to_array(true), dtype=DTYPE,
                                              device=dev)[None], data)[0])
    n_stages = len(state["acceptance"])
    # update_weights: non-Toeplitz data covariances and a Poisson-ratio ensemble
    comp.noise_analyser = GeodeticNoiseAnalyser("non-toeplitz")
    comp.ensemble_nus = (0.2, 0.25, 0.3)
    before = [w.clone() for w in data[0]["weights"]]
    t0 = time.perf_counter()
    problem.update_weights(best)
    uw_s = time.perf_counter() - t0
    changed = [not torch.equal(a, b) for a, b in zip(before, data[0]["weights"])]
    with torch.no_grad():
        llk_uw = logp(torch.as_tensor(post, dtype=DTYPE, device=dev), data)
    finite_uw = bool(torch.isfinite(llk_uw).all())
    pos_err = {k: float(mean[k]) - GEO_TRUE[k] for k in ("east_shift", "north_shift", "depth")}
    out["geo_smc"] = r = dict(
        chains=N_CHAINS, steps=GEO_STEPS, dims=problem.ordering.size, wall_s=f"{wall:.2f}",
        stages=n_stages, beta=float(state["beta"]),
        evals_per_s=f"{N_CHAINS * GEO_STEPS * n_stages / wall:.0f}",
        acceptance=json.dumps([round(float(a), 3) for a in state["acceptance"]]),
        position_err_m=json.dumps({k: round(v, 1) for k, v in pos_err.items()}),
        mean=json.dumps({k: round(float(mean[k]), 4) for k in GEO_TRUE}),
        variance_reduction_best=json.dumps({k: round(float(v), 4) for k, v in vr.items()}),
        ramp_err_over_sd=json.dumps({k: round(v, 2) for k, v in ramp_z.items()}),
        llk_best=f"{float(llk_post.max()):.2f}", llk_true=f"{llk_true:.2f}",
        k5_launches=k5_launches["geo_smc"], update_weights_s=f"{uw_s:.2f}",
        weights_changed=json.dumps(changed), llk_after_update_finite=finite_uw,
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    say("geo_smc", **r)
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("[geo_smc] did not reach beta = 1 with finite llks")
    if not (abs(pos_err["east_shift"]) <= GEO_POS_TOL and abs(pos_err["north_shift"])
            <= GEO_POS_TOL and abs(pos_err["depth"]) <= GEO_DEPTH_TOL):
        raise SystemExit(f"[geo_smc] posterior mean position misses the truth: {pos_err}")
    if min(vr.values()) < GEO_VR_MIN or max(ramp_z.values()) > 3.0:
        raise SystemExit(f"[geo_smc] variance reduction {vr} or ramps {ramp_z} miss")
    if not (all(changed) and finite_uw) or k5_launches["geo_smc"] == 0:
        raise SystemExit("[geo_smc] update_weights left a scene's weights unchanged, the llk "
                         "is not finite after it, or K5 was never launched")
    del problem, comp, logp, data, llk_uw
    torch.cuda.empty_cache()

    # [static_ffi_build] the real-size static library on the card, against float64
    # on the host for 20 patches
    problem = build_static_ffi_flagship(**STATIC_FFI_REAL_SIZE, seed=0, device=dev,
                                        outfolder=os.path.join(workdir, "static_ffi_smc"))
    comp = problem.composites["geodetic"]
    lib, fault = comp.gflibrary, comp.fault
    coords, los = comp.stack.coords, comp.stack.los
    build_ms = cuda_ms(lambda: geo_construct_gf_linear(fault, coords, los, device=dev),
                       iters=3, warmup=1)
    with forward_dtype(torch.float32):
        build32_ms = cuda_ms(lambda: geo_construct_gf_linear(fault, coords, los, device=dev),
                             iters=3, warmup=1)
        lib32 = geo_construct_gf_linear(fault, coords, los, device=dev)
    patches = fault.get_all_patches()
    idx = np.linspace(0, len(patches) - 1, STATIC_BUILD_PATCHES).astype(int)
    worst = {}
    for c in lib.component_names:
        prm = {a: torch.tensor([getattr(patches[i], a) for i in idx], dtype=torch.float64)
               for a in ("east_shift", "north_shift", "depth", "strike", "dip", "rake",
                         "length", "width")}
        if c == "uperp":
            prm["rake"] = prm["rake"] + 90.0
        with torch.no_grad():
            ref = torch.sum(okada_surface_displacement(
                torch.as_tensor(coords), **prm, slip=1.0, anchor="top")
                * torch.as_tensor(los), dim=-1)
        G = lib.gf(c).double().cpu()
        bar = STATIC_BUILD_RTOL * float(G.abs().max())
        worst[c] = float((G[idx] - ref).abs().max()) / bar
        worst[c + "_float32_build"] = float((lib32.gf(c).double().cpu()[idx] - ref).abs().max()
                                            ) / bar
    out["static_ffi_build"] = r = dict(
        library=json.dumps([len(lib.component_names), lib.npatches, lib.nsamples]),
        library_MB=f"{len(lib.component_names) * lib.npatches * lib.nsamples * 4 / 1e6:.1f}",
        build_ms=f"{build_ms:.3f}", build_float32_ms=f"{build32_ms:.3f}",
        checked_patches=STATIC_BUILD_PATCHES,
        worst_err_over_bar=json.dumps({k: round(v, 4) for k, v in worst.items()}))
    say("static_ffi_build", **r)
    if max(v for k, v in worst.items() if not k.endswith("float32_build")) > 1.0:
        raise SystemExit(f"[static_ffi_build] library columns disagree with float64: {worst}")
    del lib32

    # [static_ffi_llk] the distributer + Laplacian llk and value-and-grad
    out["static_ffi_llk"] = r = geo_llk_case(problem, "static_ffi", N_CHAINS)
    say("static_ffi_llk", **r)

    # [static_ffi_smc] lsq start, capped at STATIC_FFI_MAX_STAGES - 1 stages
    gather_rows.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=STATIC_FFI_STEPS,
                                 max_stages=STATIC_FFI_MAX_STAGES,
                                 buffer_thinning=STATIC_FFI_THINNING, seed=1))
        capped = False
    except RuntimeError as e:
        if "did not reach beta=1" not in str(e):
            raise
        capped = True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5_launches["static_ffi_smc"] = gather_rows.launches
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    stages = list(range(1, STATIC_FFI_MAX_STAGES)) if capped else [-1]
    states = [handler.load_state(st) for st in stages]
    betas = [0.0] + [float(st["beta"]) for st in states]
    finite = all(np.isfinite(st["likelihoods"]).all() for st in states)
    out["static_ffi_smc"] = r = dict(
        chains=N_CHAINS, steps=STATIC_FFI_STEPS, dims=problem.ordering.size,
        buffer_thinning=STATIC_FFI_THINNING, wall_s=f"{wall:.2f}",
        nnls_s=f"{problem.lsq_seconds:.2f}", stages_run=len(states), capped=capped,
        betas=json.dumps([round(x, 6) for x in betas]), finite=finite,
        acceptance=json.dumps([round(float(a), 3) for a in states[-1]["acceptance"]]),
        k5_launches=k5_launches["static_ffi_smc"],
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    say("static_ffi_smc", **r)
    if not (all(b1 > b0 for b0, b1 in zip(betas, betas[1:])) and finite):
        raise SystemExit("[static_ffi_smc] beta not strictly increasing, or non-finite llks")
    if k5_launches["static_ffi_smc"] == 0:
        raise SystemExit("[static_ffi_smc] K5 was never launched")

    # [ffi_extras] the hyper-only posterior of the static FFI (distributer +
    # Laplacian): Problem.estimate_hypers rewrites both hyperparameters' bounds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bounds = problem.estimate_hypers(n_steps=ESTIMATE_HYPERS_STEPS,
                                     n_chains=ESTIMATE_HYPERS_CHAINS)
    torch.cuda.synchronize()
    hyper_s = time.perf_counter() - t0
    finite = all(np.isfinite(lo).all() and np.isfinite(hi).all() and (lo < hi).all()
                 for lo, hi in bounds.values())
    out["estimate_hypers"] = r = dict(
        case="static_ffi_estimate_hypers", steps=ESTIMATE_HYPERS_STEPS,
        chains=ESTIMATE_HYPERS_CHAINS, seconds=f"{hyper_s:.2f}", finite=finite,
        bounds=json.dumps({k: [round(float(np.min(lo)), 3), round(float(np.max(hi)), 3)]
                           for k, (lo, hi) in bounds.items()}))
    say("ffi_extras", **r)
    if not (finite and set(bounds) == {"h_SAR", "h_laplacian"}):
        raise SystemExit(f"[ffi_extras] estimate_hypers on the static FFI: {bounds}")
    del problem, comp, lib
    torch.cuda.empty_cache()

    # [static_ffi_recover] a small static FFI to beta = 1
    problem = build_static_ffi_flagship(**STATIC_RECOVER_SIZE, seed=0, device=dev,
                                        outfolder=os.path.join(workdir, "static_recover"))
    comp = problem.composites["geodetic"]
    gather_rows.launches = 0
    t0 = time.perf_counter()
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=STATIC_RECOVER_STEPS,
                                            seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5_launches["static_ffi_recover"] = gather_rows.launches
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    mean = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    best = problem.ordering.to_point(q_tr[-1][int(np.argmax(llk_tr[-1]))])
    true = problem.true_point

    def mw(point):
        return comp.fault.magnitude(np.hypot(point["uparr"], point["uperp"]))

    vr = comp.get_variance_reductions(best)
    out["static_ffi_recover"] = r = dict(
        dims=problem.ordering.size, chains=N_CHAINS, steps=STATIC_RECOVER_STEPS,
        wall_s=f"{wall:.2f}", stages=len(state["acceptance"]), beta=float(state["beta"]),
        nnls_s=f"{problem.lsq_seconds:.3f}", magnitude=f"{mw(mean):.4f}",
        true_magnitude=f"{mw(true):.4f}",
        variance_reduction_best=json.dumps({k: round(float(v), 4) for k, v in vr.items()}),
        k5_launches=k5_launches["static_ffi_recover"])
    say("static_ffi_recover", **r)
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("[static_ffi_recover] did not reach beta = 1 with finite llks")
    if abs(mw(mean) - mw(true)) >= FFI_MAG_TOL or min(vr.values()) < FFI_VR_MIN:
        raise SystemExit(f"[static_ffi_recover] misses the slip: Mw {mw(mean)} against "
                         f"{mw(true)}, variance reduction {vr}")
    if k5_launches["static_ffi_recover"] == 0:
        raise SystemExit("[static_ffi_recover] K5 was never launched")
    del problem, comp

    # [discretization] the static problem's plane at a small size, G on the card
    # against G on the host
    ref_src = RectangularSource(**DISCRETIZATION_PLANE)
    rng = np.random.default_rng(0)
    d_coords = scatter_points(DISCRETIZATION_POINTS, rng, 30e3, 30e3)
    d_los = np.tile([0.38, -0.08, 0.92], (DISCRETIZATION_POINTS, 1))
    config = ResolutionDiscretizationConfig(patch_widths_min=2e3, patch_lengths_min=2e3)
    runs = {}
    for label, where in (("card", dev), ("host", "cpu")):
        t0 = time.perf_counter()
        fault, r_diag, quality = optimize_discretization(ref_src, d_coords, d_los, config,
                                                         device=where)
        secs = time.perf_counter() - t0
        patches = fault.get_all_patches()
        G = _build_G(patches, d_coords, d_los, device=where)
        centers = np.stack([p.center() for p in patches]) / 1e3
        runs[label] = dict(
            patches=len(patches), quality=quality, seconds=secs,
            spread=normalized_resolution_spread(model_resolution(G, centers, config.epsilon)))
    card, host = runs["card"], runs["host"]
    spread_rel = abs(card["spread"] - host["spread"]) / abs(host["spread"])
    out["discretization"] = r = dict(
        patches=card["patches"], patches_cpu=host["patches"], spread=f"{card['spread']:.6e}",
        spread_cpu=f"{host['spread']:.6e}", spread_rel_diff=f"{spread_rel:.2e}",
        seconds=f"{card['seconds']:.2f}", seconds_cpu=f"{host['seconds']:.2f}")
    say("discretization", **r)
    if card["patches"] != host["patches"] or spread_rel > DISCRETIZATION_SPREAD_RTOL:
        raise SystemExit(f"[discretization] the card's run differs from the host's: {runs}")
    return out


def joint_phases(dev, table, workdir: str) -> dict:
    """BASELINE config 3 on the FullMT table: [joint_llk] (the joint llk at
    64 and 2000 chains, equal to its composites' llks evaluated alone, each
    composite against its plain or float64 evaluation) and [pt_joint]
    (parallel tempering to the PT_JOINT settings through
    ``Problem.sample``).  Returns the phases' results with K1c's launches
    on each; raises SystemExit at the first gate missed."""
    import copy
    import types

    import numpy as np
    import torch

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.device import DTYPE
    from beat_tpu_torch.flagship import JOINT_REAL_SIZE, build_joint_flagship
    from beat_tpu_torch.ops.bilgather import (bilinear_contract, bilinear_contract_reference,
                                              bilinear_rows, bilinear_rows_reference)
    from beat_tpu_torch.samplers import MetropolisState, PTParams, run_metropolis_stage

    out = {}
    problem = build_joint_flagship(**JOINT_REAL_SIZE, seed=0, device=dev, table=table,
                                   outfolder=os.path.join(workdir, "pt_joint"))
    seis, geo = problem.composites["seismic"], problem.composites["geodetic"]
    logp, data = problem.make_logp_fn()
    lo, hi = problem.priors.bounds_arrays()
    span = hi - lo
    q_all = torch.as_tensor(np.random.default_rng(7).uniform(
        lo + 0.01 * span, hi - 0.01 * span, size=(N_CHAINS, lo.size)), dtype=DTYPE, device=dev)

    # [joint_llk] at the PT batch and at the SMC batch
    for n in (PT_JOINT["n_chains"], N_CHAINS):
        q = q_all[:n]

        def fwd(x=q):
            with torch.no_grad():
                return logp(x, data)

        bilinear_contract.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        llk = fwd()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        launches = bilinear_contract.launches
        point = problem.ordering.to_point(q)
        with torch.no_grad():
            parts = {name: c.loglike(point, d) for (name, c), d in
                     zip(problem.composites.items(), data)}
        sum_err = float(((llk - sum(parts.values())).abs() / llk.abs()).max())
        ms = cuda_ms(fwd, iters=5, warmup=1)
        calls, kernel_ms, by_name = device_kernels(fwd)
        r = dict(chains=n, dims=lo.size, k1c_queries=n * queries_per_chain(seis),
                 points=geo.stack.samples, sum_max_rel_err=f"{sum_err:.3e}", llk_ms=f"{ms:.3f}",
                 kernel_ms=fmt_ms(ms_or_none(kernel_ms)), calls=calls,
                 peak_GB=f"{peak:.2f}", k1c_launches=launches,
                 finite=bool(torch.isfinite(llk).all()),
                 top=json.dumps([[k[:50], round(v, 4)] for k, v in list(by_name.items())[:5]]))
        if n == JOINT_CHECK_CHAINS:
            qc = q[:JOINT_CHECK_CHAINS]
            pc = problem.ordering.to_point(qc)
            # the seismic composite through the plain versions of K1 and K1c
            tbl = seis.tables[0]
            tbl.rows_fn, tbl.contract_fn = bilinear_rows_reference, bilinear_contract_reference
            try:
                with torch.no_grad():
                    seis_plain = seis.loglike(pc)
            finally:
                tbl.rows_fn, tbl.contract_fn = bilinear_rows, bilinear_contract
            seis_rel = float(((parts["seismic"][:JOINT_CHECK_CHAINS] - seis_plain).abs()
                              / seis_plain.abs()).max())
            # the geodetic composite in float64 on the host, at [geo_llk]'s bar
            ref = copy.deepcopy(geo).to("cpu", torch.float64)
            p64 = problem.ordering.to_point(qc.double().cpu())
            with torch.no_grad():
                geo64 = ref.loglike(p64)
            scale = llk_scale(types.SimpleNamespace(composites={"geodetic": geo}), p64)
            geo_worst = float(((parts["geodetic"][:JOINT_CHECK_CHAINS].double().cpu() - geo64)
                               .abs() / (LLK_RTOL * (geo64.abs() + scale))).max())
            r.update(seismic_plain_max_rel_err=f"{seis_rel:.3e}",
                     geodetic_f64_worst_err_over_bar=f"{geo_worst:.3e}")
            del ref
        out[f"joint_llk_{n}"] = r
        say("joint_llk", **r)
        if not (sum_err <= JOINT_SUM_RTOL and r["finite"] and launches > 0):
            raise SystemExit(f"[joint_llk] {n} chains: the joint llk is not its composites' sum "
                             f"({sum_err}), not finite, or K1c was not launched")
        if n == JOINT_CHECK_CHAINS and not (seis_rel <= LLK_RTOL and geo_worst <= 1.0):
            raise SystemExit(f"[joint_llk] a composite misses its bar: seismic {seis_rel} "
                             f"(rtol {LLK_RTOL}), geodetic worst/bar {geo_worst}")
        del llk, parts
        torch.cuda.empty_cache()
    del q_all

    # [pt_joint] parallel tempering on the joint problem
    params = PTParams(**PT_JOINT, proposal_name=PT_PROPOSAL)
    bilinear_contract.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_tr, llk_tr, history = problem.sample(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bilinear_contract.launches
    n_post = params.n_chains_posterior
    betas = np.asarray(history["betas"])
    # the CUDA calls and kernel time of one PT step: a 10-step segment at
    # the final ladder, from the final population
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    seg = MetropolisState(
        q=torch.as_tensor(state["population"], dtype=DTYPE, device=dev),
        llk=torch.as_tensor(state["likelihoods"], dtype=DTYPE, device=dev),
        scaling=torch.ones(params.n_chains, dtype=DTYPE, device=dev),
        accepted=torch.zeros(params.n_chains, dtype=DTYPE, device=dev),
        acc_total=torch.zeros(params.n_chains, dtype=DTYPE, device=dev))
    cov_chol = torch.as_tensor(np.linalg.cholesky(state["cov"]), dtype=DTYPE, device=dev)
    seg_calls, seg_kernel_ms, _ = device_kernels(lambda: run_metropolis_stage(
        logp, seg, torch.as_tensor(betas, dtype=DTYPE, device=dev), cov_chol,
        torch.as_tensor(lo, dtype=DTYPE, device=dev), torch.as_tensor(hi, dtype=DTYPE, device=dev),
        n_steps=10, generator=torch.Generator(device=dev).manual_seed(0), logp_args=(data,)))
    scales, swaps = history["scale_history"], history["swap_acceptance"]
    kept = q_tr[q_tr.shape[0] // 2:].reshape(-1, q_tr.shape[-1])
    median = problem.ordering.to_point(np.median(kept, axis=0))
    true = problem.true_point
    pos_err = {k: float(median[k]) - true[k] for k in ("east_shift", "north_shift", "depth")}
    i_best = np.unravel_index(int(np.argmax(llk_tr)), llk_tr.shape)
    best = problem.ordering.to_point(q_tr[i_best])
    vr = geo.get_variance_reductions(best)
    out["pt_joint"] = r = dict(
        chains=params.n_chains, posterior_chains=n_post, samples=params.n_samples,
        proposal=params.proposal_name, dims=problem.ordering.size, draws=q_tr.shape[0],
        wall_s=f"{wall:.2f}", steps_per_s=f"{q_tr.shape[0] / wall:.1f}",
        evals_per_s=f"{q_tr.shape[0] * params.n_chains / wall:.0f}", k1c_launches=launches,
        betas=json.dumps([round(float(b), 5) for b in betas]),
        t_scale_history=json.dumps([round(float(x), 4) for x in scales]),
        swap_acceptance=json.dumps([round(float(x), 3) for x in swaps]),
        swap_acceptance_mean=f"{float(np.mean(swaps)) if len(swaps) else float('nan'):.3f}",
        position_err_m=json.dumps({k: round(v, 1) for k, v in pos_err.items()}),
        variance_reduction_best=json.dumps({k: round(float(v), 4) for k, v in vr.items()}),
        llk_best=f"{float(llk_tr[i_best]):.2f}", stage_betas=state["betas"].shape[0],
        calls_per_step=f"{seg_calls / 10:.1f}",
        kernel_ms_per_step=fmt_ms(ms_or_none(seg_kernel_ms / 10)),
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    say("pt_joint", **r)
    if not (np.all(betas[:n_post] == 1.0) and np.all(np.diff(betas[n_post - 1:]) < 0)):
        raise SystemExit(f"[pt_joint] the ladder is not {n_post} ones and descending: {betas}")
    if not (np.isfinite(llk_tr).all() and launches > 0):
        raise SystemExit("[pt_joint] non-finite llks, or K1c was never launched")
    if not (len(set(scales)) > 1 and len(swaps)
            and PT_SWAP_BAND[0] <= float(np.mean(swaps)) <= PT_SWAP_BAND[1]):
        raise SystemExit(f"[pt_joint] the temperature scale never moved ({scales}) or the edge "
                         f"exchange acceptance {swaps} left {PT_SWAP_BAND}")
    if not (abs(pos_err["east_shift"]) <= PT_POS_TOL and abs(pos_err["north_shift"]) <= PT_POS_TOL
            and abs(pos_err["depth"]) <= PT_DEPTH_TOL and min(vr.values()) >= GEO_VR_MIN):
        raise SystemExit(f"[pt_joint] the posterior misses the rectangle: {pos_err}, "
                         f"variance reductions {vr}")
    del problem, seis, geo, logp, data
    torch.cuda.empty_cache()
    return out


def ffi_extra_phases(dev, problem, workdir: str) -> dict:
    """The kinematic FFI options and the bf16 library on the Laquila-scale
    problem ``problem`` (its library and wavemap): [ffi_extras] (the
    2000-chain llk with a station time shift per target, a second wavemap
    in the ``spectrum`` domain and a hyperparameter per target, through K3,
    against the plain stack), [k3_bf16] and [k4_bf16] (K3 and K4 on the
    bf16 copy of the library, built on the card in target chunks, against
    the plain version on that copy, beside the float32 kernels in turns)
    and one llk of the FFI flagship with the bf16 library.  Returns the
    results; raises SystemExit at the first gate missed."""
    import dataclasses

    import numpy as np
    import torch

    from beat_tpu_torch.covariance import Covariance
    from beat_tpu_torch.device import DTYPE
    from beat_tpu_torch.flagship import ffi_priors
    from beat_tpu_torch.models.distributer import SeismicDistributerComposite
    from beat_tpu_torch.models.problem import Problem
    from beat_tpu_torch.ops.gfstack import stack_batched, stack_batched_reference

    out = {}
    comp = problem.composites["seismic"]
    lap = problem.composites["laplacian"]
    lib = comp.libs[0]["uparr"]
    wmap = comp.wavemaps[0]
    sub = comp.fault.get_subfault(0)

    def problem_with(wavemaps_libs, **options):
        c = SeismicDistributerComposite(wavemaps_libs, comp.fault,
                                        interpolation=comp.interpolation, device=dev, **options)
        return Problem(ffi_priors(sub.n_strike, sub.n_dip), {"seismic": c, "laplacian": lap},
                       device=dev, outfolder=os.path.join(workdir, "ffi_extras"))

    def batch(p, seed):
        lo, hi = p.priors.bounds_arrays()
        return torch.as_tensor(np.random.default_rng(seed).uniform(
            lo, hi, size=(N_CHAINS, lo.size)), dtype=DTYPE, device=dev)

    # [ffi_extras] time shifts on every target, hp_specific, a spectrum wavemap
    shifted = dataclasses.replace(wmap, station_corrections=True)
    sd = float(np.sqrt(wmap.datasets[0].covariance.data[0, 0]))
    nfit = wmap.nsamples_win // 2 + 1
    spec_sets = [dataclasses.replace(ds, covariance=Covariance(
        data=np.eye(nfit) * (sd * np.sqrt(wmap.nsamples_win / 2.0)) ** 2))
        for ds in wmap.datasets]
    spectrum = dataclasses.replace(wmap, domain="spectrum", mapnumber=1, datasets=spec_sets)
    xp = problem_with([(shifted, {"uparr": lib}), (spectrum, {"uparr": lib})], hp_specific=True)
    xcomp = xp.composites["seismic"]
    xlogp, xdata = xp.make_logp_fn()
    q = batch(xp, 11)
    stack_batched.launches_multilinear = 0
    with torch.no_grad():
        llk = xlogp(q, xdata)
    launched = stack_batched.launches_multilinear
    idx = torch.arange(0, N_CHAINS, max(1, N_CHAINS // FFI_PLAIN_CHAINS),
                       device=dev)[:FFI_PLAIN_CHAINS]
    lib.stack_fn = stack_batched_reference
    try:
        with torch.no_grad():
            llk_plain = xlogp(q[idx], xdata)
    finally:
        lib.stack_fn = stack_batched
    # the residual-free part of the llk: residuals of 0
    pt = xp.ordering.to_point(q[idx])
    llk0 = xcomp._loglike(pt, [d["data"].expand(len(idx), -1, -1) for d in xdata[0]], xdata[0])
    llk0 = llk0 + lap.loglike({**pt, "uparr": torch.zeros_like(pt["uparr"])})
    worst = float(((llk[idx] - llk_plain).abs()
                   / (LLK_RTOL * (llk_plain.abs() + llk0.abs()))).max())

    def fwd():
        with torch.no_grad():
            return xlogp(q, xdata)

    ms = cuda_ms(fwd, iters=3, warmup=1)
    calls, kernel_ms, by_name = device_kernels(fwd)
    out["ffi_extras"] = r = dict(
        case="kinematic", chains=N_CHAINS, dims=xp.ordering.size,
        time_shifts=len(xcomp.get_hierarchical_names()), hypers=len(xcomp.get_hypernames()),
        domains=json.dumps([w.domain for w in xcomp.wavemaps]), plain_chains=len(idx),
        worst_err_over_bar=f"{worst:.3e}", k3_launches=launched, llk_ms=f"{ms:.3f}",
        kernel_ms=fmt_ms(ms_or_none(kernel_ms)), calls=calls,
        k3_ms=f"{sum(v for k, v in by_name.items() if 'gf_stack' in k):.4f}",
        finite=bool(torch.isfinite(llk).all()))
    say("ffi_extras", **r)
    if not (worst <= 1.0 and launched > 0 and r["finite"]):
        raise SystemExit(f"[ffi_extras] the llk with time shifts, a spectrum wavemap and "
                         f"hp_specific disagrees with the plain stack (worst/bar {worst}), is "
                         f"not finite, or K3 was not launched")
    del xp, xcomp, xlogp, xdata, q, llk, llk_plain
    torch.cuda.empty_cache()

    # [k3_bf16], [k4_bf16]: the bf16 copy, built one target at a time
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lib16 = lib.to_dtype(torch.bfloat16)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    convert_extra = torch.cuda.max_memory_allocated() - base
    bytes32, bytes16 = lib.data.nbytes, lib16.data.nbytes
    gen = torch.Generator(device=dev).manual_seed(13)
    real_in = stack_inputs(lib, N_CHAINS, (0.2, 5.5), (-0.5, 9.0), gen)
    for key, interpolation in (("k3", "multilinear"), ("k4", "nearest_neighbor")):
        rb = check_stack(lib16, *real_in, interpolation, iters=10)
        didx, rtf = lib.durations2idxs(real_in[0], interpolation)
        sidx, stf = lib.starttimes2idxs(real_in[1], interpolation)

        def run(data):
            return stack_batched(data, didx, sidx, real_in[2], rtf, stf)

        s16, s32 = run(lib16.data), run(lib.data)
        loss = float((s16 - s32).abs().max() / s32.abs().max())
        rb["ms"], rb["float32_ms"] = time_in_turns(lambda: run(lib16.data),
                                                   lambda: run(lib.data), 10)
        del s16, s32
        torch.cuda.empty_cache()
        # the library yardstick on the bf16 library: bf16 operands, float32
        # accumulation (reduced-precision reductions off)
        reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        try:
            bmm_ms, bmm_scatter_ms, bmm_err = dense_bmm_ms(lib16, *real_in, interpolation)
        finally:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
        torch.cuda.empty_cache()
        rb.update(loss_vs_float32=loss, library_bytes=bytes16, float32_library_bytes=bytes32,
                  convert_s=convert_s, convert_extra_GB=convert_extra / 1e9,
                  library_ms=bmm_ms, library_with_scatter_ms=bmm_scatter_ms,
                  library_max_abs_err=bmm_err)
        out[key + "_bf16"] = rb
        say_stack(key + "_bf16", "real", dict(C=N_CHAINS, T=lib.ntargets, P=lib.npatches,
                                              D=lib.ndurations, S=lib.nstarttimes,
                                              N=lib.nsamples), rb,
                  float32_ms=f"{rb['float32_ms']:.4f}", loss_vs_float32=f"{loss:.3e}",
                  library_GB=f"{bytes16 / 1e9:.3f}", float32_library_GB=f"{bytes32 / 1e9:.3f}",
                  convert_s=f"{convert_s:.3f}", convert_extra_GB=f"{convert_extra / 1e9:.3f}",
                  library_with_scatter_ms=f"{bmm_scatter_ms:.4f}",
                  library_max_abs_err=f"{bmm_err:.3e}")
        if not (0.0 < loss < BF16_LOSS_MAX and 2 * bytes16 == bytes32
                and convert_extra <= bytes16 + 2**21):
            raise SystemExit(f"[{key}_bf16] the bf16 stack is {loss} of max off the float32 "
                             f"one, or the library is not half the bytes, or its conversion "
                             f"took {convert_extra} bytes beside the copy")
        del didx, rtf, sidx, stf
    del real_in
    torch.cuda.empty_cache()

    # one llk of the FFI flagship with the bf16 library, with each interpolation
    logp, data = problem.make_logp_fn()
    for interpolation, key in (("multilinear", "k3_bf16"), ("nearest_neighbor", "k4_bf16")):
        c16 = SeismicDistributerComposite([(wmap, {"uparr": lib16})], comp.fault,
                                          interpolation=interpolation, device=dev)
        bp = Problem(ffi_priors(sub.n_strike, sub.n_dip), {"seismic": c16, "laplacian": lap},
                     device=dev, outfolder=os.path.join(workdir, f"ffi_bf16_{interpolation}"))
        blogp, bdata = bp.make_logp_fn()
        q = batch(bp, 4)
        stack_batched.launches_bf16 = stack_batched.launches_mma = 0
        with torch.no_grad():
            llk16 = blogp(q, bdata)
        launched16 = stack_batched.launches_bf16
        r = dict(interpolation=interpolation, chains=N_CHAINS, bf16_launches=launched16,
                 mma_launches=stack_batched.launches_mma,
                 finite=bool(torch.isfinite(llk16).all()),
                 llk_ms=f"{cuda_ms(lambda: blogp(q, bdata), iters=3, warmup=1):.3f}")
        if interpolation == comp.interpolation:
            with torch.no_grad():
                llk32 = logp(q, data)
            r.update(max_abs_diff_vs_float32=f"{float((llk16 - llk32).abs().max()):.3e}",
                     median_abs_llk=f"{float(llk32.abs().median()):.3e}")
        out[f"ffi_llk_bf16_{interpolation}"] = r
        say("ffi_llk_bf16", **r)
        if not (r["finite"] and launched16 > 0):
            raise SystemExit(f"[ffi_llk_bf16] {interpolation}: non-finite llks, or the kernel "
                             f"on the bf16 library never ran")
        out[key]["launches"] = launched16
        out[key]["mma_launches"] = r["mma_launches"]
        if interpolation == "multilinear":
            out["ffi_smc_bf16"] = ffi_smc_bf16(bp)
        del bp, c16, blogp, bdata, q, llk16
    del lib16
    torch.cuda.empty_cache()
    return out


def ffi_smc_bf16(problem) -> dict:
    """[ffi_smc_bf16]: the kinematic FFI problem on the bf16 library
    (multilinear) through [ffi_smc]'s capped SMC (``N_CHAINS`` chains ×
    ``FFI_STEPS`` steps, stage cap ``FFI_MAX_STAGES``): β strictly
    increasing, finite llks, K3 on the bf16 library launched at every
    step and no float32 K3 (nor K4) launch.  Also the distinct cells of
    the mma variant's 8-chain groups in the population of each stage (a
    diagnostic: what compacting a group's rows would save as the
    population concentrates).  Returns its launches and seconds; raises
    SystemExit at a gate missed."""
    import numpy as np
    import torch

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.ops.gfstack import _clamp_cells, group_cells, plan_stack, stack_batched
    from beat_tpu_torch.samplers import SMCParams

    lib = problem.composites["seismic"].libs[0]["uparr"]
    cells = []                # group_cells of each K3 call's operands, in order

    def stack_and_count_cells(data, didx, sidx, slips, rtf, stf):
        cells.append(group_cells(*_clamp_cells(data, didx, sidx, True)))
        return stack_batched(data, didx, sidx, slips, rtf, stf)

    counters = ("launches_multilinear", "launches_nearest", "launches_bf16", "launches_mma")
    for c in counters:
        setattr(stack_batched, c, 0)
    lib.stack_fn = stack_and_count_cells
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=FFI_STEPS,
                                 max_stages=FFI_MAX_STAGES, seed=1))
        capped = False
    except RuntimeError as e:
        if "did not reach beta=1" not in str(e):
            raise
        capped = True
    finally:
        lib.stack_fn = stack_batched
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the first call evaluates the prior draws, then FFI_STEPS calls a stage
    by_stage = [("prior", cells[:1])] + [
        (f"stage_{i}", cells[1 + i * FFI_STEPS:1 + (i + 1) * FFI_STEPS])
        for i in range(-(-(len(cells) - 1) // FFI_STEPS))]
    group_cells_by_stage = [
        {"population": name, "rows": part[0]["rows"],
         "mean": round(sum(c["mean"] for c in part) / len(part), 3),
         "max": max(c["max"] for c in part)} for name, part in by_stage if part]
    k3, k4, bf16, mma = (getattr(stack_batched, c) for c in counters)
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    stages = list(range(1, FFI_MAX_STAGES)) if capped else [-1]
    states = [handler.load_state(st) for st in stages]
    betas = [0.0] + [float(st["beta"]) for st in states]
    finite = all(np.isfinite(st["likelihoods"]).all() for st in states)
    r = dict(chains=N_CHAINS, steps=FFI_STEPS, dims=problem.ordering.size, wall_s=wall,
             stages_run=len(states), capped=capped, betas=[round(b, 6) for b in betas],
             finite=finite, k3_launches=k3, k3_bf16_launches=bf16, k4_launches=k4,
             mma_launches=mma, group_cells_by_stage=group_cells_by_stage,
             acceptance=[round(float(a), 3) for a in states[-1]["acceptance"]])
    say("ffi_smc_bf16", **{k: (json.dumps(v) if isinstance(v, list) else
                               f"{v:.2f}" if isinstance(v, float) else v) for k, v in r.items()})
    if not (all(b1 > b0 for b0, b1 in zip(betas, betas[1:])) and finite):
        raise SystemExit("[ffi_smc_bf16] beta not strictly increasing, or non-finite llks")
    planned = plan_stack(*lib.data.shape, N_CHAINS, 4, elem_bytes=2).variant
    if not (bf16 == k3 and k4 == 0 and bf16 >= len(states) * FFI_STEPS
            and mma == (bf16 if planned == "mma" else 0)):
        raise SystemExit(f"[ffi_smc_bf16] K3 on the bf16 library launched {bf16} times "
                         f"({mma} mma, planned {planned}) in {len(states)} stages of {FFI_STEPS} "
                         f"steps, with {k3 - bf16} float32 K3 and {k4} K4 launches")
    return r


def transd_phases(dev, workdir: str) -> dict:
    """[transd_ffi]: (a) ``Problem.sample(TransDParams(**TRANSD))`` on the
    static FFI fault with a two-level slip (``build_transd_flagship``),
    (b) the constant-likelihood run of tests/test_transd.py:40 on the
    card.  Returns the results; raises SystemExit at the first gate
    missed."""
    import numpy as np
    import torch

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.ffi.transd import TransDParams, transd_sample
    from beat_tpu_torch.flagship import STATIC_FFI_REAL_SIZE, build_transd_flagship
    from beat_tpu_torch.models.distributer import transd_sample_ffi
    from beat_tpu_torch.utility import Ordering

    out = {}
    problem = build_transd_flagship(**STATIC_FFI_REAL_SIZE, seed=0, device=dev,
                                    outfolder=os.path.join(workdir, "transd"))
    comp = problem.composites["geodetic"]
    params = TransDParams(**TRANSD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = problem.sample(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = comp.fault.npatches
    mean_slip = res["slip_trace"].reshape(-1, n).mean(axis=0)
    true = problem.true_point["uparr"]
    corr = float(np.corrcoef(mean_slip, true)[0, 1])
    k_mean = float(res["k_trace"].mean())
    trace = SampleStage(problem.outfolder,
                        ordering=Ordering([("uparr", (n,))])).load_trace(-1)
    calls, kernel_ms, _ = device_kernels(
        lambda: comp.loglike({"uparr": torch.as_tensor(res["slip_trace"][-1], device=dev)}))
    # the CUDA calls and kernel time of a step: 20 steps, the start's llk and one record
    step_calls, step_kernel_ms, _ = device_kernels(lambda: transd_sample_ffi(
        comp, TransDParams(**dict(TRANSD, n_steps=20, record_every=20))))
    out["transd_ffi"] = r = dict(
        case="static_ffi", chains=params.n_chains, steps=params.n_steps, patches=n,
        points=comp.stack.samples, k_max=params.k_max, wall_s=f"{wall:.2f}",
        ms_per_step=f"{1e3 * wall / params.n_steps:.3f}", correlation=f"{corr:.4f}",
        k_mean=f"{k_mean:.2f}", accept_rate=f"{res['accept_rate']:.4f}",
        finite=bool(np.isfinite(res["llk_trace"]).all()),
        slip_trace_MB=f"{res['slip_trace'].nbytes / 1e6:.1f}",
        stage_trace=json.dumps(list(trace.q_trace.shape)), llk_calls=calls,
        llk_kernel_ms=fmt_ms(ms_or_none(kernel_ms)), calls_per_step=f"{step_calls / 20:.1f}",
        kernel_ms_per_step=fmt_ms(ms_or_none(step_kernel_ms / 20)),
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    say("transd_ffi", **r)
    if not (corr >= TRANSD_CORR_MIN and k_mean < params.k_max and 0.0 < res["accept_rate"] < 1.0
            and r["finite"] and trace.q_trace.shape == res["slip_trace"].shape):
        raise SystemExit(f"[transd_ffi] correlation {corr}, mean k {k_mean}, acceptance "
                         f"{res['accept_rate']} or the saved stage misses")
    del problem, comp, res
    torch.cuda.empty_cache()

    prior = TransDParams(**TRANSD_PRIOR)
    t0 = time.perf_counter()
    res = transd_sample(lambda slips: torch.zeros(slips.shape[0], device=dev),
                        patch_s=np.linspace(0, 10, 12), patch_d=np.linspace(0, 4, 12),
                        extent_s=(0, 10), extent_d=(0, 4), value_bounds=(0, 1), params=prior,
                        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    freqs = np.bincount(res["k_trace"].ravel().astype(int),
                        minlength=prior.k_max + 1)[prior.k_min:]
    freqs = freqs / freqs.sum()
    dev_uniform = float(np.abs(freqs - 1.0 / len(freqs)).max())
    out["transd_prior"] = r = dict(
        case="constant_likelihood", chains=prior.n_chains, steps=prior.n_steps,
        wall_s=f"{wall:.2f}", k_freqs=json.dumps([round(float(f), 4) for f in freqs]),
        max_dev_from_uniform=f"{dev_uniform:.4f}", accept_rate=f"{res['accept_rate']:.4f}")
    say("transd_ffi", **r)
    if not dev_uniform <= TRANSD_PRIOR_ATOL:
        raise SystemExit(f"[transd_ffi] the constant-likelihood run misses the uniform prior on "
                         f"k: {freqs}")
    return out


def polarity_phases(dev, table, workdir: str, k5_launches: dict) -> dict:
    """Slice 9's polarity paths on the FullMT table: [polarity_llk] (ms and
    CUDA calls of a 2000-chain llk, the polarity composite alone and the
    joint problem; the polarity llk at 64 chains against the same code in
    float64 on the host) and [polarity_smc] (SMC of the joint problem to
    β = 1).  Adds the SMC's K5 launches to ``k5_launches``; returns K1c's
    launches on each path.  Raises SystemExit at the first gate missed."""
    import numpy as np
    import torch

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.device import DTYPE
    from beat_tpu_torch.flagship import (POLARITY_REAL_SIZE, TRUE_DEPTH, TRUE_MAGNITUDE,
                                         build_polarity_flagship)
    from beat_tpu_torch.models.polarity import PolarityComposite, PolarityMapping
    from beat_tpu_torch.ops.bilgather import bilinear_contract
    from beat_tpu_torch.ops.rowgather import gather_rows
    from beat_tpu_torch.samplers import SMCParams

    out = {}
    t0 = time.perf_counter()
    problem = build_polarity_flagship(**POLARITY_REAL_SIZE, seed=0, device=dev, table=table,
                                      outfolder=os.path.join(workdir, "polarity_smc"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pol = problem.composites["polarity"]
    logp, data = problem.make_logp_fn()
    lo, hi = problem.priors.bounds_arrays()
    span = hi - lo
    q = torch.as_tensor(np.random.default_rng(9).uniform(
        lo + 0.01 * span, hi - 0.01 * span, size=(N_CHAINS, lo.size)), dtype=DTYPE, device=dev)
    point = problem.ordering.to_point(q)

    def pol_fwd():
        with torch.no_grad():
            return pol.loglike(point, data[1])

    def joint_fwd():
        with torch.no_grad():
            return logp(q, data)

    r = {}
    for name, fn in (("polarity", pol_fwd), ("joint", joint_fwd)):
        bilinear_contract.launches = 0
        llk = fn()
        torch.cuda.synchronize()
        launches = bilinear_contract.launches
        calls, kernel_ms, _ = device_kernels(fn)
        r[name] = dict(llk_ms=cuda_ms(fn, iters=10, warmup=2), calls=calls,
                       kernel_ms=ms_or_none(kernel_ms), k1c_launches=launches,
                       finite=bool(torch.isfinite(llk).all()))
    # the same code in float64 on the host, on the first 64 chains
    n = JOINT_CHECK_CHAINS
    twin = PolarityComposite(sources=pol.sources, device="cpu", maps=[
        PolarityMapping(m.wavename, m.targets, event_idx=m.event_idx, mapnumber=m.mapnumber,
                        takeoff_table=m.takeoff_table.to("cpu"), device="cpu")
        for m in pol.maps])
    data64 = [{k: v.double() for k, v in d.items()} for d in twin.device_data()]
    with torch.no_grad():
        llk64 = twin.loglike({k: v[:n].double().cpu() for k, v in point.items()}, data64)
    llk32 = pol_fwd()[:n].double().cpu()
    rel = float(((llk32 - llk64).abs() / llk64.abs()).max())
    say("polarity_llk", chains=N_CHAINS, dims=lo.size,
        targets=sum(len(m.targets) for m in pol.maps),
        takeoff_grid=tuple(pol.maps[0].takeoff_table.angles_rad.shape),
        build_s=f"{build_s:.2f}",
        **{f"{k}_{f}": (fmt_ms(v) if f == "kernel_ms" else
                        f"{v:.3f}" if isinstance(v, float) else v)
           for k, d in r.items() for f, v in d.items()},
        host64_chains=n, host64_max_rel_err=f"{rel:.3e}")
    if not (r["polarity"]["finite"] and r["joint"]["finite"]):
        raise SystemExit("polarity llk: non-finite values")
    if not rel <= LLK_RTOL:
        raise SystemExit(f"polarity llk off float64 on the host: {rel} > {LLK_RTOL}")
    if r["joint"]["k1c_launches"] == 0:
        raise SystemExit("the joint polarity llk never launched K1c")
    out["polarity_llk"] = {"k1c_launches": r["joint"]["k1c_launches"]}

    # [polarity_smc] the joint problem to beta = 1: every step re-derives the takeoffs
    bilinear_contract.launches = 0
    gather_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1c = bilinear_contract.launches
    k5_launches["polarity_smc"] = gather_rows.launches
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    depth, mag = float(np.asarray(est["depth"])), float(np.asarray(est["magnitude"]))
    flat_q, flat_llk = q_tr.reshape(-1, q_tr.shape[-1]), llk_tr.reshape(-1)
    syn = pol.get_synthetics(problem.ordering.to_point(flat_q[np.argmax(flat_llk)]))
    wrong, clear = 0, 0
    for m in pol.maps:
        amps = problem.polarity_amplitudes[m.wavename]
        big = np.abs(amps) > 0.1 * np.abs(amps).max()
        obs = np.array([t.polarity for t in m.targets])
        wrong += int(np.sum(syn[f"{m.wavename}_pol_{m.mapnumber}"][big] != obs[big]))
        clear += int(big.sum())
    say("polarity_smc", chains=N_CHAINS, steps=N_STEPS, wall_s=f"{wall:.2f}",
        stages=len(state["acceptance"]), beta=float(state["beta"]), k1c_launches=k1c,
        k5_launches=k5_launches["polarity_smc"],
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", depth_m=f"{depth:.1f}",
        magnitude=f"{mag:.4f}", clear_polarities=clear, best_draw_wrong=wrong,
        acceptance_final=f"{state['acceptance'][-1]:.3f}")
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("polarity SMC did not reach beta = 1 with finite llks")
    if k1c == 0 or k5_launches["polarity_smc"] == 0:
        raise SystemExit("the polarity SMC never launched K1c (or K5, its resampling gather)")
    if abs(depth - TRUE_DEPTH) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"polarity SMC posterior misses the truth: depth {depth}, Mw {mag}")
    if wrong:
        raise SystemExit(f"the best draw mispredicts {wrong} of {clear} clear first motions")
    out["polarity_smc"] = {"k1c_launches": k1c}
    return out


def timed_peak(fn) -> tuple:
    """``(result, seconds, peak GB above the memory held before)`` of one
    call on the card."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - base) / 1e9)


def bem_blocks(engine, meshes, coords, G, D, gen) -> dict:
    """A random 64 × 64 block of the interaction matrix ``G`` and of the
    displacement matrix ``D`` of one mesh against the same functions in
    float64 on the host: the block's receiver and source elements as two
    meshes of their own, the receivers' BC reading the sources.  Returns
    max |err| / max |block| of each."""
    import numpy as np
    import torch

    from beat_tpu_torch.bem import BoundaryCondition, tde
    from beat_tpu_torch.bem.sources import TriangleMesh

    mesh, component = meshes[0], engine.boundary_conditions[0].slip_component
    rows = np.sort(torch.randperm(G.shape[0], generator=gen)[:BEM_BLOCK].numpy())
    cols = np.sort(torch.randperm(G.shape[1], generator=gen)[:BEM_BLOCK].numpy())
    sub = [TriangleMesh(mesh.vertices, mesh.faces[rows]),
           TriangleMesh(mesh.vertices, mesh.faces[cols])]
    bc = [BoundaryCondition(component, source_idxs=[1], receiver_idxs=[0])]
    host = tde.interaction_matrix(sub, bc, nu=engine.nu, mu=engine.mu,
                                  level=engine.quadrature_level,
                                  near_level=engine.near_quadrature_level, medium=engine.medium,
                                  device="cpu").numpy()
    g_block = G[rows][:, cols].cpu().numpy()
    d_rows = torch.randperm(D.shape[0], generator=gen)[:BEM_BLOCK].numpy()
    obs, inv = np.unique(d_rows // 3, return_inverse=True)
    dhost = tde.displacement_matrix(sub[1:], coords[obs], nu=engine.nu, mu=engine.mu,
                                    boundary_conditions=[BoundaryCondition(component)],
                                    medium=engine.medium, device="cpu").numpy()
    dhost = dhost[3 * inv + d_rows % 3]
    d_block = D[d_rows][:, cols].cpu().numpy()
    return {"G": float(np.abs(g_block - host).max() / np.abs(host).max()),
            "D": float(np.abs(d_block - dhost).max() / np.abs(dhost).max())}


def bem_phases(dev, workdir: str, k5_launches: dict) -> dict:
    """Slice 9's BEM paths: [bem_build] (the linear composite of the
    example's disk at real size: the interaction matrix, the displacement
    matrix and the solve timed apart, float64 blocks and the unit
    responses against the host), [bem_smc] (the traction to β = 1) and
    [bem_geometry] (the geometry composite's llk, a capped SMC and the −99
    fill).  Adds the SMCs' K5 launches to ``k5_launches``.  Raises
    SystemExit at the first gate missed."""
    import numpy as np
    import torch

    import beat_tpu_torch.models.bem as models_bem
    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.bem import tde
    from beat_tpu_torch.bem.base import BEMEngine, BEMResponse
    from beat_tpu_torch.device import DTYPE
    from beat_tpu_torch.flagship import (BEM_GEOMETRY_REAL_SIZE, BEM_REAL_SIZE,
                                         BEM_TRUE_TRACTION, build_bem_flagship)
    from beat_tpu_torch.ops.rowgather import gather_rows
    from beat_tpu_torch.samplers import SMCParams

    # the flagship's own assembly, its three parts timed where the linear
    # composite's unit responses call them (models.bem.unit_los_responses)
    parts = {}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            res, sec, gb = timed_peak(lambda: fn(*args, **kwargs))
            parts[key] = (res, sec, gb, args)
            return res
        return wrapper

    saved = (BEMEngine.get_interaction_matrix, tde.displacement_matrix,
             models_bem.lstsq_robust)
    BEMEngine.get_interaction_matrix = timed("G", saved[0])
    tde.displacement_matrix = timed("D", saved[1])
    models_bem.lstsq_robust = timed("solve", saved[2])
    try:
        problem, build_s, _ = timed_peak(lambda: build_bem_flagship(
            **BEM_REAL_SIZE, seed=0, device=dev, outfolder=os.path.join(workdir, "bem_smc")))
    finally:
        BEMEngine.get_interaction_matrix, tde.displacement_matrix = saved[:2]
        models_bem.lstsq_robust = saved[2]
    comp = problem.composites["geodetic"]
    engine = comp.engine
    meshes = engine.discretize(comp.sources)
    (G, g_s, g_GB, _), (D, d_s, d_GB, _) = parts["G"], parts["D"]
    _, solve_s, solve_GB, (_, neg_rhs) = parts["solve"]
    gen = torch.Generator().manual_seed(11)
    t0 = time.perf_counter()
    blocks = bem_blocks(engine, meshes, comp.stack.coords, G, D, gen)
    host_s = time.perf_counter() - t0
    # the unit responses against the float64 solve on the host of the same matrices
    G64, D64, rhs64 = G.cpu().numpy(), D.cpu().numpy(), neg_rhs.cpu().numpy()
    host_los = np.einsum("nib,ni->nb", (D64 @ np.linalg.lstsq(G64, rhs64, rcond=None)[0])
                         .reshape(-1, 3, 1), comp.stack.los)
    los_err = float(np.abs(comp.unit_los.cpu().numpy() - host_los).max()
                    / np.abs(host_los).max())
    near = int(sum((np.linalg.norm(
        (meshes[0].centroids + (0.5 * np.sqrt(meshes[0].areas))[:, None] * meshes[0].normals)
        [:, None] - meshes[0].centroids[None], axis=2) < 2.0 * np.sqrt(meshes[0].areas)[None])
        .ravel()))
    K = meshes[0].ntriangles
    triples = ((K * K - near) * 4**engine.quadrature_level
               + near * 4**engine.near_quadrature_level)
    say("bem_build", triangles=K, points=comp.stack.samples,
        levels=(engine.quadrature_level, engine.near_quadrature_level), near_pairs=near,
        stress_triples=triples, surface_triples=comp.stack.samples * K * 64,
        build_s=f"{build_s:.2f}", interaction_s=f"{g_s:.3f}",
        ns_per_stress_triple=f"{1e9 * g_s / triples:.1f}",
        interaction_peak_GB=f"{g_GB:.2f}", displacement_s=f"{d_s:.3f}",
        displacement_peak_GB=f"{d_GB:.2f}", solve_ms=f"{1e3 * solve_s:.2f}",
        solve_peak_GB=f"{solve_GB:.3f}", block_G_err=f"{blocks['G']:.3e}",
        block_D_err=f"{blocks['D']:.3e}", host_blocks_s=f"{host_s:.1f}",
        unit_los_err=f"{los_err:.3e}")
    if not (blocks["G"] <= BEM_BLOCK_RTOL and blocks["D"] <= BEM_BLOCK_RTOL):
        raise SystemExit(f"BEM matrices off the host's float64: {blocks}")
    if not los_err <= BEM_LOS_RTOL:
        raise SystemExit(f"BEM unit responses off the host's float64 solve: {los_err}")
    del G, D, G64, D64

    # [bem_smc] the traction of the linear composite to beta = 1
    gather_rows.launches = 0
    t0 = time.perf_counter()
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5_launches["bem_smc"] = gather_rows.launches
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    est = float(np.asarray(problem.ordering.to_point(q_tr[-1].mean(axis=0))["normal_traction"]))
    say("bem_smc", chains=N_CHAINS, steps=N_STEPS, wall_s=f"{wall:.2f}",
        stages=len(state["acceptance"]), beta=float(state["beta"]),
        k5_launches=k5_launches["bem_smc"], normal_traction_MPa=f"{est:.3f}",
        truth_MPa=BEM_TRUE_TRACTION, acceptance_final=f"{state['acceptance'][-1]:.3f}")
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("BEM SMC did not reach beta = 1 with finite llks")
    if abs(est - BEM_TRUE_TRACTION) >= BEM_RECOVERY * BEM_TRUE_TRACTION:
        raise SystemExit(f"BEM SMC traction {est} misses {BEM_TRUE_TRACTION} by 10 % or more")
    if k5_launches["bem_smc"] == 0:
        raise SystemExit("the BEM SMC never launched K5")
    del problem, comp

    # [bem_geometry] depth and traction sampled: host meshes, card solves
    problem, build_s, _ = timed_peak(lambda: build_bem_flagship(
        **BEM_GEOMETRY_REAL_SIZE, seed=0, device=dev, geometry=True,
        outfolder=os.path.join(workdir, "bem_geometry")))
    comp = problem.composites["geodetic"]
    logp, data = problem.make_logp_fn()
    lo, hi = problem.priors.bounds_arrays()
    q = torch.as_tensor(np.random.default_rng(4).uniform(lo, hi, (BEM_GEO_CHAINS, lo.size)),
                        dtype=DTYPE, device=dev)
    with torch.no_grad():
        llk, llk_s, llk_GB = timed_peak(lambda: logp(q, data))
    # one chain's llk profiled: the device's share of the wall-clock, CUDA
    # calls and the kernels that take the time (torch.func's intermediates)
    def one_chain():
        with torch.no_grad():
            return logp(q[:1], data)

    one_ms = cuda_ms(one_chain, iters=2, warmup=1)
    calls, kernel_ms, by_name = device_kernels(one_chain)
    breach = problem.point_to_array(dict(problem.true_point, depth=-500.0))
    with torch.no_grad():
        bad = comp.synthetics_los(problem.ordering.to_point(
            torch.as_tensor(breach, dtype=DTYPE, device=dev)[None]))
    filled = bool((bad == BEMResponse.INVALID).all())
    gather_rows.launches = 0
    t0 = time.perf_counter()
    try:
        problem.sample(SMCParams(n_chains=BEM_GEO_SMC_CHAINS, n_steps=BEM_GEO_STEPS,
                                 max_stages=BEM_GEO_MAX_STAGES, seed=1))
        capped = False
    except RuntimeError as e:
        if "did not reach beta=1" not in str(e):
            raise
        capped = True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5_launches["bem_geometry"] = gather_rows.launches
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    states = [handler.load_state(st) for st in
              (range(1, BEM_GEO_MAX_STAGES) if capped else [-1])]
    betas = [0.0] + [float(st["beta"]) for st in states]
    finite = all(np.isfinite(st["likelihoods"]).all() for st in states)
    pops = np.concatenate([st["population"] for st in states])
    invalid = sum(comp.engine.is_invalid(comp.engine.discretize(comp._apply_point_np(
        {n: p[problem.ordering[n].slc] for n in ("depth",)}))) for p in pops)
    say("bem_geometry", chains=BEM_GEO_CHAINS, triangles=comp.engine.discretize(
        comp.sources)[0].ntriangles, points=comp.stack.samples,
        levels=(comp.engine.quadrature_level, comp.engine.near_quadrature_level),
        build_s=f"{build_s:.2f}", llk_s=f"{llk_s:.3f}",
        llk_ms_per_chain=f"{1e3 * llk_s / BEM_GEO_CHAINS:.2f}", llk_peak_GB=f"{llk_GB:.2f}",
        finite=bool(torch.isfinite(llk).all()), one_chain_ms=f"{one_ms:.1f}",
        one_chain_kernel_ms=fmt_ms(ms_or_none(kernel_ms)), one_chain_calls=calls,
        top=json.dumps([[k[:50], round(v, 2)] for k, v in list(by_name.items())[:4]]),
        breach_filled=filled,
        smc_chains=BEM_GEO_SMC_CHAINS, smc_steps=BEM_GEO_STEPS, smc_stages=len(states),
        capped=capped,
        betas=json.dumps([round(x, 6) for x in betas]), smc_finite=finite,
        invalid_draws=invalid, smc_wall_s=f"{wall:.2f}", k5_launches=k5_launches["bem_geometry"])
    if not (bool(torch.isfinite(llk).all()) and filled):
        raise SystemExit("BEM geometry llk: non-finite, or a breaching draw not -99 filled")
    if not (all(b1 > b0 for b0, b1 in zip(betas, betas[1:])) and finite):
        raise SystemExit("BEM geometry SMC: beta not strictly increasing, or non-finite llks")
    if k5_launches["bem_geometry"] == 0:
        raise SystemExit("the BEM geometry SMC never launched K5")
    return {}


def layered_node_check(card, grid: dict, plan: dict, nodes: list, model) -> dict:
    """Depth nodes of one bucket of the layered table recomputed by the
    same port code on the host CPU (the bucket's wavenumber grid and dipole
    step; one Kennett solve serves them all; all distances and
    frequencies) against the card's (6, 3, nd, len(nodes), nf, 2) spectra
    ``card`` of those nodes, trace by trace: ``{"worst": {node: max |Δ| /
    max|trace| over its traces}, "host_s": host seconds}``."""
    import numpy as np
    import torch

    from beat_tpu_torch.heart.layered_waveforms import (mt_spectra_kennett_bucket,
                                                        undamp_to_spectra)

    bucket = next(b for b in plan["buckets"] if nodes[0] in b["depth_idx"])
    t0 = time.perf_counter()
    spec = mt_spectra_kennett_bucket(model, grid["depths"][nodes], grid["distances"],
                                     plan["w_band"], bucket["k_grid"],
                                     d=LAYERED_REL_STEP * bucket["zs_min"], device="cpu")
    damped = torch.zeros(spec.shape[:-1] + (plan["freqs"].size,), dtype=spec.dtype)
    damped[..., torch.as_tensor(np.flatnonzero(plan["in_band"]))] = spec
    host = undamp_to_spectra(damped, grid["nt"], grid["dt"], plan["zeta"], grid["t0"])
    host_s = time.perf_counter() - t0
    host32 = torch.view_as_real(host).to(torch.float32).movedim(0, 3)    # as the table's
    tr_host = torch.fft.irfft(torch.view_as_complex(host32.double()), n=grid["nt"])
    tr_card = torch.fft.irfft(torch.view_as_complex(card.double()), n=grid["nt"])
    peak = tr_host.abs().amax(-1)
    err = (tr_card - tr_host).abs().amax(-1)
    worst = torch.where(peak > 0, err / torch.where(peak > 0, peak, 1.0),
                        torch.where(err > 0, torch.inf, 0.0))
    return {"worst": {n: float(worst[:, :, :, i].max()) for i, n in enumerate(nodes)},
            "host_s": host_s}


def analytic_store_check(dev, workdir: str) -> float:
    """The trace store against an oracle that shares no code with the
    solvers (``heart/analytic.py``, Aki & Richards 4.29): full-space
    elementary traces of a Gaussian moment pulse at dt/2 (3 distances × 2
    depths), read on the card by ``greens_table_from_traces`` at dt, and a
    moment tensor synthesized through the table at a node at azimuth 122°
    (``point_spectra``) against the oracle's own waveform there:
    max |Δ| / max |waveform| (tests/test_external_validation.py's
    resampling case)."""
    import numpy as np
    import torch

    from beat_tpu_torch.heart.analytic import fullspace_mt_displacement, gaussian_pulse
    from beat_tpu_torch.heart.store_convert import greens_table_from_traces, write_trace_store

    nt, dt, vp, vs, rho = 256, 0.1, 6000.0, 3464.0, 2700.0
    distances, depths = np.array([25e3, 35e3, 45e3]), np.array([10e3, 12e3])
    stf = gaussian_pulse(1.0, 8.0)
    t_store = np.arange(2 * nt) * dt / 2
    traces = np.zeros((6, 3, distances.size, depths.size, t_store.size))
    for (i, d), (j, z), k in ((a, b, c) for a in enumerate(distances)
                              for b in enumerate(depths) for c in range(6)):
        u = fullspace_mt_displacement(np.eye(6)[k], [d, 0.0, 0.0], [0.0, 0.0, z], t_store, vp,
                                      vs, rho, stf=stf)
        traces[k, :, i, j] = np.stack([-u[:, 2], u[:, 0], u[:, 1]])
    path = os.path.join(workdir, "analytic_traces.npz")
    write_trace_store(path, traces, np.zeros((distances.size, depths.size)), distances, depths,
                      dt / 2, vp=vp, vs=vs, rho=rho)
    table = greens_table_from_traces(path, nt=nt, dt=dt, t0=0.0, device=dev)
    m6 = np.array([0.3, -1.1, 0.8, 0.5, -0.2, 0.9]) * 1e17
    d, z0, az = 35e3, 10e3, np.deg2rad(122.0)

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    with torch.no_grad():
        spec = table.point_spectra(f32(m6[None]), f32([0.0]), f32([0.0]), f32([z0]),
                                   f32([d * np.sin(az)] * 3), f32([d * np.cos(az)] * 3),
                                   torch.arange(3, device=dev))
        got = table.to_time_domain(spec)[0].double().cpu().numpy()
    t = np.arange(nt) * dt
    u = fullspace_mt_displacement(m6, [d * np.cos(az), d * np.sin(az), 0.0], [0.0, 0.0, z0], t,
                                  vp, vs, rho, stf=stf)
    want = np.stack([-u[:, 2], u[:, 0] * np.cos(az) + u[:, 1] * np.sin(az),
                     -u[:, 0] * np.sin(az) + u[:, 1] * np.cos(az)])
    os.remove(path)
    return float(np.abs(got - want).max() / np.abs(want).max())


def same_points_llk(direct, loaded, n_chains: int, seed: int) -> tuple:
    """The two problems' llks of the same ``n_chains`` draws from the
    direct problem's priors (each problem's own ordering, matched by
    name): ``(direct (C,), loaded (C,))`` as float64 numpy."""
    import numpy as np
    import torch

    lo, hi = direct.priors.bounds_arrays()
    q = np.random.default_rng(seed).uniform(lo, hi, (n_chains, lo.size))
    point = direct.ordering.to_point(q)
    missing = set(loaded.ordering.names) - set(point)
    if missing:
        raise SystemExit(f"[project] the loaded problem samples {sorted(missing)}, which the "
                         "direct one does not")
    q_loaded = np.concatenate([point[n].reshape(n_chains, -1) for n in loaded.ordering.names],
                              axis=1)
    out = []
    for problem, qq in ((direct, q), (loaded, q_loaded)):
        logp, data = problem.make_logp_fn()
        with torch.no_grad():
            out.append(logp(torch.as_tensor(qq, dtype=torch.float32, device=problem.device),
                            data).double().cpu().numpy())
    return tuple(out)


def project_phases(dev, workdir: str, k5_launches: dict) -> dict:
    """The project and results layer on the card ([project], after the
    timed table builders): the real-size FullMT problem written as a
    project directory by the port's writers and loaded with
    ``load_model(project_dir, "geometry", device="cuda")``; its 2000-chain
    llk against the directly built flagship's (LLK_RTOL); ``sample()``
    with the project's sampler settings under [smc]'s gates, K1c and K5
    counted; ``summarize()`` (posterior means equal to the stage's own),
    ``derived_samples()`` against the host's ``mt_utils`` on the host's own
    m6 of the same draws, the best draw's ``get_variance_reductions``
    per wavemap against the same wavemap's at the true source (less
    VR_TRUTH_MARGIN) and over all windows (VR_MIN), its Kagan angle to
    the truth printed; ``seis_derivative`` at the best draw for depth and
    the six MT components: every K1c call with a tangent launching K1c
    exactly twice (the primal and the tangent), the JVP launches counted
    apart from the forwards of the ``fd`` stencils and the synthetics,
    each captured JVP within CONTRACT_RTOL per query of the plain version
    on the same tangent, autodiff against the ``fd`` stencil within the
    stencil's error bar.  Then [project_modes]: the geodetic geometry
    (GEO_REAL_SIZE), the static FFI (the 50 × 10 fault) and the linear BEM
    (the example's disk) problems written as projects and loaded, their
    2000-chain llks within rtol 1e-6 of the direct builds.  Left out on
    the card: the kinematic FFI project (its 3.93 GB library written and
    read back); its config path is held on the CPU
    (``tests/test_torch_config.py``).  Adds the SMC's K5 launches to
    ``k5_launches``; returns K1c's launches of the SMC and of the
    derivatives.  Raises SystemExit at the first gate missed."""
    import pickle

    import numpy as np
    import torch
    import torch.autograd.forward_ad as fwAD

    from beat_tpu_torch import mt_utils
    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.config import (BEMConfig, GeodeticConfig, RampConfig, dump_config,
                                       init_config, save_geodetic_datasets)
    from beat_tpu_torch.flagship import (BEM_REAL_SIZE, BEM_SOURCE, GEO_REAL_SIZE, REAL_SIZE,
                                         STATIC_FFI_REAL_SIZE, TRUE_DEPTH, TRUE_DURATION,
                                         TRUE_MAGNITUDE, TRUE_SDR, build_bem_flagship,
                                         build_flagship, build_geodetic_flagship,
                                         build_static_ffi_flagship, set_config_priors,
                                         write_fullmt_project)
    from beat_tpu_torch.models.problem import load_model
    from beat_tpu_torch.models.seismic import M6_NAMES, point_getter, source_m6
    from beat_tpu_torch.ops.bilgather import bilinear_contract, bilinear_contract_reference
    from beat_tpu_torch.ops.rowgather import gather_rows
    from beat_tpu_torch.parameter import Parameter
    from beat_tpu_torch.sources import magnitude_to_moment, sdr_to_m6

    out = {}
    pdir = os.path.join(workdir, "project_fullmt")
    direct = build_flagship(**REAL_SIZE, seed=0, device=dev,
                            outfolder=os.path.join(workdir, "project_direct"))
    t0 = time.perf_counter()
    write_fullmt_project(direct, pdir, dict(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    problem = load_model(pdir, "geometry", device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    llk_direct, llk_loaded = same_points_llk(direct, problem, N_CHAINS, seed=3)
    llk_err = float((np.abs(llk_loaded - llk_direct) / np.abs(llk_direct)).max())
    del direct
    torch.cuda.empty_cache()

    bilinear_contract.launches = 0
    gather_rows.launches = 0
    (res, wall, peak) = timed_peak(lambda: problem.sample())
    q_tr, llk_tr = res
    k1c = bilinear_contract.launches
    k5_launches["project"] = gather_rows.launches
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    state = handler.load_state(-1)
    trace = handler.load_trace(-1)
    est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    depth, mag = float(np.asarray(est["depth"])), float(np.asarray(est["magnitude"]))

    # the results read back: the summary's means against the stage's own
    summary = problem.summarize(-1)
    mean_err = max(abs(summary[name]["mean"] - float(trace.get_values(name).mean()))
                   / max(abs(float(trace.get_values(name).mean())), 1e-30)
                   for name in problem.ordering.names)
    # derived samples against the host's mt_utils on the host's m6 of the same draws
    derived = problem.derived_samples(-1)
    flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
    idx = np.linspace(0, flat.shape[0] - 1, min(2000, flat.shape[0])).astype(int)
    host_q = torch.as_tensor(flat[idx], dtype=torch.float32)
    template = problem.composites["seismic"].sources[0]
    host_m6 = source_m6(template, point_getter(template, problem.ordering.to_point(host_q), 0, 1,
                                               host_q.shape[0], host_q.device)).double().numpy()
    derived_err = 0.0
    for j, m6 in enumerate(host_m6):
        m6n = m6 / max(mt_utils.scalar_moment(m6), 1e-30)
        want = dict(zip((f"{c}_derived" for c in M6_NAMES), m6n))
        for (s, d, r), k in zip(mt_utils.both_strike_dip_rake(m6), "12"):
            want.update({f"strike{k}": s, f"dip{k}": d, f"rake{k}": r})
        for name, v in want.items():
            delta = float(derived[name][j]) - v
            if name[:3] in ("str", "dip", "rak"):       # angles: the difference modulo 360°
                delta = ((delta + 180.0) % 360.0 - 180.0) / 360.0
            derived_err = max(derived_err, abs(delta))
    best = problem.ordering.to_point(flat[int(np.argmax(trace.llk_trace.reshape(-1)))])
    best = {k: np.asarray(v) for k, v in best.items()}
    best_m6 = source_m6(template, point_getter(
        template, {k: torch.as_tensor(v)[None] for k, v in best.items()}, 0, 1, 1,
        torch.device("cpu"))).double().numpy()[0]
    kagan = mt_utils.kagan_angle(best_m6, sdr_to_m6(*TRUE_SDR, magnitude_to_moment(
        TRUE_MAGNITUDE)).double().numpy())
    vrs = problem.get_variance_reductions(best)["seismic"]
    truth = dict(zip(M6_NAMES, sdr_to_m6(*TRUE_SDR).double().numpy()), magnitude=TRUE_MAGNITUDE,
                 depth=TRUE_DEPTH, time=0.0, duration=TRUE_DURATION, east_shift=0.0,
                 north_shift=0.0)
    true_point = dict(best, **{k: np.full(np.shape(best[k]), v, dtype=best[k].dtype)
                               for k, v in truth.items() if k in best})
    vrs_true = problem.get_variance_reductions(true_point)["seismic"]
    synths = problem.get_synthetics(best)["seismic"]
    obs = {w.mapid: w.data_windows for w in problem.composites["seismic"].wavemaps}
    vr_all = 1.0 - (sum(float(((obs[k] - synths[k]) ** 2).sum()) for k in obs)
                    / sum(float((o ** 2).sum()) for o in obs.values()))
    say("project", chains=N_CHAINS, steps=N_STEPS, write_s=f"{write_s:.2f}",
        load_s=f"{load_s:.2f}", llk_worst_rel_err=f"{llk_err:.2e}", wall_s=f"{wall:.2f}",
        stages=len(state["acceptance"]), beta=float(state["beta"]), k1c_launches=k1c,
        k5_launches=k5_launches["project"], peak_GB=f"{peak:.2f}", depth_m=f"{depth:.1f}",
        magnitude=f"{mag:.4f}", summary_mean_worst_rel_err=f"{mean_err:.2e}",
        derived_draws=len(idx), derived_worst_err=f"{derived_err:.2e}",
        best_kagan_deg=f"{kagan:.2f}",
        best_variance_reduction=f"{vr_all:.4f}",
        best_variance_reduction_by_wavemap=json.dumps({k: round(v, 4) for k, v in vrs.items()}),
        true_variance_reduction_by_wavemap=json.dumps({k: round(v, 4)
                                                       for k, v in vrs_true.items()}))
    if not llk_err <= LLK_RTOL:
        raise SystemExit(f"[project] the loaded problem's llk is off the direct one's: {llk_err}")
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("[project] did not reach beta = 1 with finite llks")
    if k1c == 0 or k5_launches["project"] == 0:
        raise SystemExit("[project] never launched K1c (or K5, its resampling gather)")
    if abs(depth - TRUE_DEPTH) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"[project] posterior misses the truth: depth {depth}, Mw {mag}")
    if not mean_err <= 1e-6:
        raise SystemExit(f"[project] summarize()'s means are off the stage's: {mean_err}")
    if not derived_err <= DERIVED_TOL:
        raise SystemExit(f"[project] derived_samples() off the host's mt_utils: {derived_err}")
    if not all(vrs[k] >= vrs_true[k] - VR_TRUTH_MARGIN for k in vrs_true):
        raise SystemExit(f"[project] the best draw's variance reductions {vrs} fall more than "
                         f"{VR_TRUTH_MARGIN} below the true source's {vrs_true}")
    if not vr_all >= VR_MIN:
        raise SystemExit(f"[project] the best draw's variance reduction: {vr_all} ({vrs})")
    out["project"] = {"k1c_launches": k1c}

    # [project_seis_derivative] at the best draw: forward mode through K1c
    comp = problem.composites["seismic"]
    table = comp.tables[0]
    captured, jvp_launches = [], []

    def capture(tbl, cd, z0, A):
        before = bilinear_contract.launches
        res = bilinear_contract(tbl, cd, z0, A)
        tangent = fwAD.unpack_dual(A).tangent
        if tangent is not None:
            # the primal and the tangent: two launches of K1c, none plain
            jvp_launches.append(bilinear_contract.launches - before)
            captured.append((cd, z0, tangent.detach().clone(),
                             fwAD.unpack_dual(res).tangent.detach().clone()))
        return res

    CD, NZ, _ = table.packed.shape
    jvp_worst, fd = 0.0, {}
    bilinear_contract.launches = 0
    table.contract_fn = capture
    try:
        for name in ("depth",) + M6_NAMES:
            J = [comp.seis_derivative(best, name, wmap_idx=w) for w in range(len(comp.wavemaps))]
            scale = max(float(np.abs(j).max()) for j in J)
            # the step: the default, but the 5-point stencil must not reach
            # across a depth node of the table, where the bilinear gather kinks
            h = 1e-3 * max(abs(float(best[name])), 1.0)
            if name == "depth":
                h = min(h, float(np.abs(table.depths - float(best[name])).min()) / 4.0)
            err = {}
            for order in (3, 5):
                F = [comp.seis_derivative(best, name, wmap_idx=w, mode="fd", h=h,
                                          stencil_order=order)
                     for w in range(len(comp.wavemaps))]
                err[order] = max(float(np.abs(f - j).max()) for f, j in zip(F, J)) / scale
                err[f"fd{order}"] = F
            # the bar: the 3-point stencil's truncation error, estimated
            # against the 5-point one, plus float32 roundoff over the step
            wmax = max(float(np.abs(w).max()) for w in comp.get_synthetics(best).values())
            trunc = max(float(np.abs(a - b).max()) for a, b in zip(err["fd3"], err["fd5"]))
            bar = FD_BAR_FACTOR * (trunc + 2.0 ** -23 * wmax / h) / scale
            fd[name] = (err[3], bar)
    finally:
        table.contract_fn = bilinear_contract
    k1c_all = bilinear_contract.launches
    k1c_jvp = len(jvp_launches)             # one tangent launch per call with a tangent
    for cd, z0, tA, got in captured:
        cdc, z0c = cd.clamp(0, CD - 2), z0.clamp(0, NZ - 2)
        ref = bilinear_contract_reference(table.packed, cdc, z0c, tA)
        rows = torch.stack([table.packed[cdc, z0c], table.packed[cdc, z0c + 1],
                            table.packed[cdc + 1, z0c], table.packed[cdc + 1, z0c + 1]], dim=-2)
        bar = CONTRACT_RTOL * tA.abs().sum((-2, -1)) * rows.abs().amax((-2, -1))
        jvp_worst = max(jvp_worst, float(((got - ref).abs().amax(-1) / bar).max()))
    say("project_seis_derivative", parameters=json.dumps(["depth", *M6_NAMES]),
        k1c_launches=k1c_all, k1c_jvp_launches=k1c_jvp,
        k1c_forward_launches=k1c_all - k1c_jvp, jvps_checked=len(captured),
        jvp_worst_err_over_bar=f"{jvp_worst:.3e}",
        fd3_vs_autodiff=json.dumps({k: f"{v[0]:.2e}" for k, v in fd.items()}),
        fd_bar=json.dumps({k: f"{v[1]:.2e}" for k, v in fd.items()}))
    if not captured or any(n != 2 for n in jvp_launches):
        raise SystemExit(f"[project_seis_derivative] a call with a tangent did not launch K1c "
                         f"for its primal and its tangent: {jvp_launches}")
    if not jvp_worst <= 1.0:
        raise SystemExit(f"[project_seis_derivative] K1c's JVP off the plain version's: "
                         f"{jvp_worst}")
    if not all(e <= b for e, b in fd.values()):
        raise SystemExit(f"[project_seis_derivative] autodiff and fd disagree: {fd}")
    out["project_seis_derivative"] = {"k1c_launches": k1c_all, "k1c_jvp_launches": k1c_jvp}
    del problem, comp, table, captured
    torch.cuda.empty_cache()

    # [project_modes] the other modes as projects, by llk only
    modes = {}
    geo = build_geodetic_flagship(**GEO_REAL_SIZE, seed=0, device=dev,
                                  outfolder=os.path.join(workdir, "geo_direct"))
    gdir = os.path.join(workdir, "project_geodetic")
    cfg = init_config("geo", gdir, datatypes=("geodetic",), source_types=("RectangularSource",))
    cfg.geodetic_config = GeodeticConfig()
    cfg.geodetic_config.corrections.ramps = RampConfig(enabled=True)
    ramps = {n: p for n, p in geo.priors.parameters.items()
             if n.endswith(("_ramp", "_offset"))}
    set_config_priors(cfg, {n: p for n, p in geo.source_priors.parameters.items()
                            if n not in ramps}, ramps)
    dump_config(cfg, gdir)
    save_geodetic_datasets(geo.composites["geodetic"].datasets, gdir)
    modes["geodetic"] = (geo, gdir, "geometry")

    static = build_static_ffi_flagship(**STATIC_FFI_REAL_SIZE, device=dev,
                                       outfolder=os.path.join(workdir, "static_direct"))
    sdir = os.path.join(workdir, "project_static_ffi")
    cfg = init_config("sffi", sdir, mode="ffi", datatypes=("geodetic",))
    set_config_priors(cfg, {n: Parameter(n, [p.lower.min()], [p.upper.max()])
                            for n, p in static.source_priors.parameters.items()})
    dump_config(cfg, sdir)
    scomp = static.composites["geodetic"]
    save_geodetic_datasets(scomp.datasets, sdir)
    gfdir = os.path.join(sdir, "ffi", "linear_gfs")
    os.makedirs(gfdir, exist_ok=True)
    with open(os.path.join(gfdir, "fault_geometry.pkl"), "wb") as f:
        pickle.dump(scomp.fault, f)
    scomp.gflibrary.save(os.path.join(gfdir, "geodetic_gfs.npz"))
    modes["static_ffi"] = (static, sdir, "ffi")

    bem = build_bem_flagship(**BEM_REAL_SIZE, device=dev,
                             outfolder=os.path.join(workdir, "bem_direct"))
    bdir = os.path.join(workdir, "project_bem")
    cfg = init_config("bem", bdir, mode="bem", source_types=("DiskBEMSource",))
    cfg.bem_config = BEMConfig(mesh_size=BEM_REAL_SIZE["mesh_size"] / 1e3,
                               quadrature_level=BEM_REAL_SIZE["quadrature_level"],
                               near_quadrature_level=BEM_REAL_SIZE["near_quadrature_level"])
    fixed = dict(east_shift=0.0, north_shift=0.0, depth=BEM_SOURCE["depth"],
                 a_half_axis=BEM_SOURCE["a_half_axis"], b_half_axis=BEM_SOURCE["a_half_axis"],
                 strike=0.0, dip=0.0, plunge=0.0)
    set_config_priors(cfg, dict({n: Parameter(n, [v], [v]) for n, v in fixed.items()},
                                **bem.source_priors.parameters))
    dump_config(cfg, bdir)
    save_geodetic_datasets(bem.composites["geodetic"].datasets, bdir)
    modes["bem_linear"] = (bem, bdir, "bem")

    for key, (direct, mdir, mode) in modes.items():
        t0 = time.perf_counter()
        loaded = load_model(mdir, mode, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        a, b = same_points_llk(direct, loaded, N_CHAINS, seed=4)
        modes[key] = {"load_s": round(load_s, 2),
                      "worst_rel_err": float((np.abs(b - a) / np.abs(a)).max()),
                      "composite": type(loaded.composites["geodetic"]).__name__,
                      "finite": bool(np.isfinite(b).all())}
        del loaded
    say("project_modes", chains=N_CHAINS, modes=json.dumps(modes))
    for key, r in modes.items():
        if not (r["finite"] and r["worst_rel_err"] <= PROJECT_MODES_RTOL):
            raise SystemExit(f"[project_modes] {key}: the project's llk is off the direct "
                             f"build's: {r}")
    del geo, static, bem
    torch.cuda.empty_cache()
    return out


def cli_phases(dev, workdir: str, k5_launches: dict) -> dict:
    """[cli] the port's command line driven in this process
    (``beat_tpu_torch.apps.cli.main``, so that the launch counters can be
    read) on the real-size FullMT problem, ``BEAT_TPU_PLATFORM`` unset: the
    card.  ``init`` a geometry project, its config (the flagship's priors,
    wavemaps, taper, filter, GF grid and sampler settings) and data written
    by the port's writers, ``build_gfs`` (the homogeneous table built on the
    card), ``check --what geometry`` (a forward at the test point),
    ``sample`` under [smc]'s gates (β = 1, depth within DEPTH_TOL and Mw
    within MAG_TOL of the truth), ``summarize`` (the means of
    ``summary.txt`` equal to the last stage's, rtol 1e-6), ``export``,
    ``map`` (32 restarts × 150 steps) under [map]'s gates and, when
    matplotlib imports, ``plot`` of the geometry plots.  Each command's
    seconds and its K1c, K2c and K5 launches are printed; K1c must run in
    ``sample``, ``map`` and ``export``, K2c in ``map`` and K5 in
    ``sample``; neither ``jax`` nor ``beat_tpu`` may be imported.  Adds the
    SMC's K5 launches to ``k5_launches``; returns the launches by
    command."""
    import contextlib
    import importlib.util
    import io

    import numpy as np
    import torch

    from beat_tpu_torch.apps.cli import main as cli_main
    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.config import (ArrivalTaperConfig, FilterConfig, WaveformFitConfig,
                                       dump_config, load_config)
    from beat_tpu_torch.flagship import (DEPTH_RANGE, DISTANCE_RANGE, DT, FILTER, REAL_SIZE,
                                         TAPER, TRUE_DEPTH, TRUE_MAGNITUDE, WAVEMAPS,
                                         build_flagship, flagship_datasets,
                                         set_config_priors)
    from beat_tpu_torch.inputf import save_seismic_datasets
    from beat_tpu_torch.ops.bilgather import bilinear_contract, contract_corner_dot
    from beat_tpu_torch.ops.rowgather import gather_rows

    pdir = os.path.join(workdir, "cli_fullmt")
    seconds, launches = {}, {}

    def run(name, *argv):
        bilinear_contract.launches = contract_corner_dot.launches = gather_rows.launches = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli_main(list(argv))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 2)
        launches[name] = {"k1c": bilinear_contract.launches, "k2c": contract_corner_dot.launches,
                          "k5": gather_rows.launches}
        if rc != 0:
            print(log.getvalue()[-3000:])
            raise SystemExit(f"[cli] {name} exited {rc}")
        return log.getvalue()

    run("init", "init", "fullmt", pdir, "--datatypes", "seismic", "--source_types", "MTSource")
    # the project's config and data, by the port's writers
    direct = build_flagship(**REAL_SIZE, seed=0, device=dev,
                            outfolder=os.path.join(workdir, "cli_direct"))
    cfg = load_config(pdir)
    cfg.event.depth = TRUE_DEPTH
    set_config_priors(cfg, direct.source_priors.parameters)
    cfg.seismic_config.waveforms = [
        WaveformFitConfig(name=name, channels=list(channels), filterer=FilterConfig(**FILTER),
                          arrival_taper=ArrivalTaperConfig(**TAPER))
        for name, channels in WAVEMAPS.items()]
    cfg.seismic_config.gf_config = dict(
        distance_min=DISTANCE_RANGE[0], distance_max=DISTANCE_RANGE[1],
        n_distances=REAL_SIZE["n_distances"], depth_min=DEPTH_RANGE[0],
        depth_max=DEPTH_RANGE[1], n_depths=REAL_SIZE["n_depths"], nt=REAL_SIZE["nt"], dt=DT,
        t0=0.0, vp=6000.0, vs=3500.0, rho=2700.0, earth_model="homogeneous")
    cfg.sampler_config.parameters = dict(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0)
    dump_config(cfg, pdir)
    st_e, st_n, raw = direct.observations
    save_seismic_datasets([ds for dsets in flagship_datasets(st_e, st_n, raw).values()
                           for ds in dsets], pdir)
    del direct
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run("build_gfs", "build_gfs", pdir, "--mode", "geometry", "--datatypes", "seismic")
    run("check", "check", pdir, "--what", "geometry")
    run("sample", "sample", pdir)
    k5_launches["cli_sample"] = launches["sample"]["k5"]
    handler = SampleStage(os.path.join(pdir, "geometry"))
    state, trace = handler.load_state(-1), handler.load_trace(-1)
    names = trace.varnames
    last = trace.q_trace[-1].mean(axis=0)
    depth = float(last[names.index("depth")])
    mag = float(last[names.index("magnitude")])
    run("summarize", "summarize", pdir)
    with open(os.path.join(pdir, "geometry", "summary.txt")) as f:
        summary = json.load(f)
    flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
    mean_err = max(abs(summary[n]["mean"] - float(flat[:, i].mean()))
                   / max(abs(float(flat[:, i].mean())), 1e-30)
                   for i, n in enumerate(names) if n in summary)
    run("export", "export", pdir)
    with np.load(os.path.join(pdir, "geometry", "export.npz")) as z:
        export_finite = all(np.isfinite(z[k]).all() for k in z.files)
    run("map", "map", pdir)
    with open(os.path.join(pdir, "geometry", "map.json")) as f:
        est = json.load(f)
    map_depth, map_mag = est["point"]["depth"][0], est["point"]["magnitude"][0]
    plot = "not_run (no matplotlib)"
    if importlib.util.find_spec("matplotlib") is not None:
        out = run("plot", "plot", pdir, "stage_posteriors,waveform_fits,hudson,fuzzy_beachball")
        plot = json.dumps(sorted(os.listdir(os.path.join(pdir, "geometry", "figures"))))
        if "skipped" in out:
            print(out[-3000:])
            raise SystemExit("[cli] plot skipped a plot")
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "beat_tpu"))
    say("cli", chains=N_CHAINS, steps=N_STEPS, seconds=json.dumps(seconds),
        total_s=f"{sum(seconds.values()):.2f}", launches=json.dumps(launches),
        beta=float(state["beta"]), stages=len(state["acceptance"]), depth_m=f"{depth:.1f}",
        magnitude=f"{mag:.4f}", summary_mean_worst_rel_err=f"{mean_err:.2e}",
        export_finite=export_finite, map_depth_m=f"{map_depth:.1f}",
        map_magnitude=f"{map_mag:.4f}", plot=plot, foreign_modules=json.dumps(foreign))
    if not (float(state["beta"]) == 1.0 and np.isfinite(trace.llk_trace).all()):
        raise SystemExit("[cli] sample did not reach beta = 1 with finite llks")
    if abs(depth - TRUE_DEPTH) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"[cli] posterior misses the truth: depth {depth}, Mw {mag}")
    if not mean_err <= 1e-6:
        raise SystemExit(f"[cli] summary.txt's means are off the stage's: {mean_err}")
    if not export_finite:
        raise SystemExit("[cli] export wrote non-finite synthetics or residuals")
    if abs(map_depth - TRUE_DEPTH) >= MAP_DEPTH_TOL or abs(map_mag - TRUE_MAGNITUDE) >= MAP_MAG_TOL:
        raise SystemExit(f"[cli] MAP misses the truth: depth {map_depth}, Mw {map_mag}")
    if not (launches["sample"]["k1c"] and launches["sample"]["k5"] and launches["map"]["k1c"]
            and launches["map"]["k2c"] and launches["export"]["k1c"]):
        raise SystemExit(f"[cli] a command did not launch its kernels: {launches}")
    if foreign:
        raise SystemExit(f"[cli] imported the JAX side: {foreign}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"cli": launches}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(phase: str, fn, n_ranks: int, args: tuple, deadline: float) -> float:
    """Start ``fn(rank, n_ranks, port, *args)`` in ``n_ranks`` spawned
    processes (CUDA tensors among ``args`` reach them by CUDA IPC) and join
    them; returns the seconds from the start to the last exit.  A rank
    that raises or exits non-zero ends the others and the script; ranks
    still running after ``deadline`` seconds are killed, and so is the
    script.  Stops every process it started."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(fn, args=(n_ranks, _free_port()) + tuple(args), nprocs=n_ranks,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > deadline:
                raise SystemExit(f"[{phase}] ranks still running after the {deadline} s "
                                 "deadline: killed")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise SystemExit(f"[{phase}] a rank failed:\n{e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return time.perf_counter() - t0


def join_group(rank: int, n_ranks: int, port: int, device_type: str, backend: str) -> None:
    """A rank of this script joins its phase's process group (on card 0:
    the ranks of a phase share the one card), with its share of the
    host's cores for the host work."""
    from datetime import timedelta

    import torch

    from beat_tpu_torch.parallel import init_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))

    init_distributed(f"tcp://localhost:{port}", n_ranks, rank, local_rank=0,
                     device=device_type, backend=backend,
                     timeout=timedelta(seconds=PARALLEL_DEADLINE_S))


def rank_timed(fn, device_type: str) -> tuple:
    """``(fn(), seconds, this process's peak GB on the card)`` (peak 0 on
    the CPU, where the phases are rehearsed)."""
    import torch

    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    if cuda:
        torch.cuda.synchronize()
    return (res, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0)


def write_rank(resdir: str, rank: int, result: dict) -> None:
    with open(os.path.join(resdir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def read_ranks(resdir: str, n_ranks: int) -> list:
    out = []
    for r in range(n_ranks):
        with open(os.path.join(resdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def parallel_smc_rank(rank: int, n_ranks: int, port: int, device_type: str, pdir: str,
                      resdir: str) -> None:
    """A rank of [parallel_smc]: gloo on the shared card; loads the FullMT
    project and runs ``Problem.sample()``, which shards the chains over the
    ranks (``_auto_mesh``); writes its counts, seconds and stage writes."""
    import numpy as np
    import torch.distributed as dist

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.models.problem import load_model
    from beat_tpu_torch.ops.bilgather import bilinear_contract
    from beat_tpu_torch.ops.rowgather import gather_rows

    join_group(rank, n_ranks, port, device_type, "gloo")
    try:
        t0 = time.perf_counter()
        problem = load_model(pdir, "geometry", device=device_type)
        load_s = time.perf_counter() - t0
        mesh = problem._auto_mesh(problem.sampler_params.n_chains)
        saves = []
        save_stage = SampleStage.save_stage

        def counted(self, stage, *a, **k):
            saves.append(stage)
            return save_stage(self, stage, *a, **k)

        SampleStage.save_stage = counted
        bilinear_contract.launches = gather_rows.launches = 0
        (q_tr, llk_tr), wall, peak = rank_timed(problem.sample, device_type)
        result = dict(rank=rank, mesh_size=mesh.size(), device=str(problem.device),
                      load_s=load_s, wall_s=wall, k1c_launches=bilinear_contract.launches,
                      k5_launches=gather_rows.launches, saves=saves,
                      chains=int(q_tr.shape[1]), finite=bool(np.isfinite(llk_tr).all()),
                      q_mean=q_tr[-1].mean(axis=0).tolist(), peak_GB=peak)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    write_rank(resdir, rank, result)


def parallel_nccl_rank(rank: int, n_ranks: int, port: int, device_type: str, pdir: str,
                       resdir: str, n_chains: int, n_steps: int) -> None:
    """The one rank of [parallel_nccl]: NCCL on the card (gloo on the
    CPU), a capped FullMT SMC (stage 0 and one stage) meshless and on
    ``make_chain_mesh(1)``, both from the same seed; writes the stage
    files' differences."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.models.problem import load_model
    from beat_tpu_torch.ops.bilgather import bilinear_contract
    from beat_tpu_torch.ops.rowgather import gather_rows
    from beat_tpu_torch.parallel import make_chain_mesh
    from beat_tpu_torch.samplers import SMCParams, smc_sample

    join_group(rank, n_ranks, port, device_type, "nccl" if device_type == "cuda" else "gloo")
    try:
        backend = dist.get_backend()
        problem = load_model(pdir, "geometry", device=device_type)
        logp, data = problem.make_logp_fn()
        lower, upper = problem.priors.bounds_arrays()
        params = SMCParams(n_chains=n_chains, n_steps=n_steps, max_stages=2, seed=0)
        runs = {}
        for key, mesh in (("meshless", None), ("mesh", make_chain_mesh(1))):
            home = os.path.join(resdir, key)
            bilinear_contract.launches = gather_rows.launches = 0

            def capped():
                try:
                    smc_sample(logp, lower, upper, params, device=problem.device,
                               homepath=home, ordering=problem.ordering, logp_args=(data,),
                               mesh=mesh)
                except RuntimeError as e:
                    if "did not reach beta=1" not in str(e):
                        raise

            _, wall, _ = rank_timed(capped, device_type)
            handler = SampleStage(home, ordering=problem.ordering)
            st = handler.load_state(handler.highest_sampled_stage())
            runs[key] = (np.asarray(st["population"]), np.asarray(st["likelihoods"]), wall,
                         bilinear_contract.launches, gather_rows.launches, float(st["beta"]))
        (q0, l0, wall0, *_), (q1, l1, wall1, k1c, k5, beta) = runs["meshless"], runs["mesh"]
        nccl = torch.cuda.nccl.version() if device_type == "cuda" else ()
        result = dict(backend=backend, nccl=".".join(map(str, nccl)),
                      max_abs_dq=float(np.abs(q1 - q0).max()),
                      max_abs_dllk=float(np.abs(l1 - l0).max()), beta=beta,
                      meshless_s=wall0, mesh_s=wall1, k1c_launches=k1c, k5_launches=k5)
    finally:
        dist.destroy_process_group()
    write_rank(resdir, rank, result)


def ffi_partial_llk(lib, durations, starttimes, slips, hyper, data, weights, slog_pdets,
                    nsamples, interpolation: str = "multilinear"):
    """The kinematic FFI data llk of a block of targets for a block of
    chains: ``SeismicDistributerComposite._loglike`` of one time-domain
    wavemap without time shifts, on the block."""
    from beat_tpu_torch.distributions import multivariate_normal_chol_batched

    synth = lib.stack_all(durations, starttimes[:, None, :], slips, interpolation)
    return multivariate_normal_chol_batched(data - synth, weights, slog_pdets, hyper,
                                            nsamples).sum(-1)


def parallel_ffi_rank(rank: int, n_ranks: int, port: int, device_type: str, blocks: list,
                      grid: dict, inputs: tuple, interpolation: str, resdir: str) -> None:
    """A rank of [parallel_ffi_llk]: gloo on the shared card, a
    ``make_gf_mesh(2, 2)``; this rank's block of targets (by CUDA IPC from
    the parent) and of chains; K3 on the block, the partial llks summed
    over ``targets``, the chains gathered."""
    import functools

    import numpy as np
    import torch
    import torch.distributed as dist

    from beat_tpu_torch.ffi import SeismicGFLibrary
    from beat_tpu_torch.ops.gfstack import stack_batched
    from beat_tpu_torch.parallel import (CHAIN_AXIS, TARGET_AXIS, all_gather, axis_index,
                                         make_gf_mesh, sharded_gf_logp)

    join_group(rank, n_ranks, port, device_type, "gloo")
    try:
        mesh = make_gf_mesh(*PARALLEL_FFI_MESH)
        t = axis_index(mesh, TARGET_AXIS)
        lib = SeismicGFLibrary(blocks[t], **grid, device=blocks[t].device)
        llk_fn = sharded_gf_logp(
            mesh, functools.partial(ffi_partial_llk, interpolation=interpolation),
            in_specs=(None, ("chains",), ("chains",), ("chains",), ("chains", "targets"),
                      ("targets",), ("targets",), ("targets",), ("targets",)))
        stack_batched.launches_multilinear = stack_batched.launches_nearest = 0
        with torch.no_grad():
            llk, first_s, peak = rank_timed(lambda: llk_fn(lib, *inputs), device_type)
            launches = (stack_batched.launches_multilinear, stack_batched.launches_nearest)
            llk_all = all_gather(llk, mesh, CHAIN_AXIS)
            # a second call, warm: the first one pays the rank's CUDA and
            # cuBLAS start-up
            _, seconds, _ = rank_timed(lambda: llk_fn(lib, *inputs), device_type)
        result = dict(rank=rank, coords=[axis_index(mesh, CHAIN_AXIS), t],
                      targets=lib.ntargets, local_chains=int(llk.shape[0]),
                      block_bytes=blocks[t].untyped_storage().nbytes(),
                      lib_is_the_block=lib.data.data_ptr() == blocks[t].data_ptr(),
                      k3_launches=launches[0], k4_launches=launches[1], first_s=first_s,
                      seconds=seconds, peak_GB=peak)
        if rank == 0:
            np.save(os.path.join(resdir, "llk.npy"), llk_all.double().cpu().numpy())
        dist.barrier()
    finally:
        dist.destroy_process_group()
    write_rank(resdir, rank, result)


def parallel_smc_phases(dev, workdir: str, k5_launches: dict, smc_wall: float) -> dict:
    """[parallel_smc] the [project] FullMT project's ``sample()`` (2000
    chains, 60 steps, seed 0) in PARALLEL_SMC_RANKS ranks sharing the
    card over gloo, through ``Problem.sample()`` (``_auto_mesh`` shards
    the chains): [smc]'s depth and Mw gates; the first population's llks
    per chain within LLK_RTOL of [project]'s one-process run of the same
    population; the stage files written by rank 0 alone (every stage
    once) and read back through ``load_model``; K1c and K5 launched on
    every rank; every rank's result equal to the files'.  [parallel_nccl]
    one rank over NCCL on ``make_chain_mesh(1)``: a capped SMC (stage 0
    and one stage) equal to the meshless run of the same seed in the same
    process (PARALLEL_Q_ATOL, PARALLEL_LLK_ATOL).  The seconds are those of
    ranks sharing one card, printed beside [smc]'s ``smc_wall``: overhead,
    not a speed-up.  Adds the ranks' K5
    launches to ``k5_launches``; returns the ranks' K1c launches.  Raises
    SystemExit at the first gate missed."""
    import shutil

    import numpy as np

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.flagship import TRUE_DEPTH, TRUE_MAGNITUDE
    from beat_tpu_torch.models.problem import load_model

    pdir = os.path.join(workdir, "project_fullmt")
    ppdir = os.path.join(workdir, "parallel_project")
    shutil.copytree(pdir, ppdir, ignore=shutil.ignore_patterns("geometry"))
    resdir = os.path.join(workdir, "parallel_smc")
    os.makedirs(resdir)
    n = PARALLEL_SMC_RANKS
    phase_s = run_ranks("parallel_smc", parallel_smc_rank, n, (dev.type, ppdir, resdir),
                        PARALLEL_DEADLINE_S)
    ranks = read_ranks(resdir, n)
    loaded = load_model(ppdir, "geometry", device=dev)
    handler = SampleStage(loaded.outfolder, ordering=loaded.ordering)
    llk_two = np.asarray(handler.load_state(0)["likelihoods"])
    llk_one = np.asarray(SampleStage(os.path.join(pdir, "geometry"), ordering=loaded.ordering)
                         .load_state(0)["likelihoods"])
    llk_err = float((np.abs(llk_two - llk_one) / np.abs(llk_one)).max())
    state = handler.load_state(-1)
    trace = handler.load_trace(-1)
    summary = loaded.summarize(-1)
    q_mean = trace.q_trace[-1].mean(axis=0)
    est = loaded.ordering.to_point(q_mean)
    depth, mag = float(np.asarray(est["depth"])), float(np.asarray(est["magnitude"]))
    stages = len(state["acceptance"])
    say("parallel_smc", ranks=n, backend="gloo", one_card_shared=True, chains=N_CHAINS,
        chains_per_rank=N_CHAINS // n, steps=N_STEPS, stages=stages, beta=float(state["beta"]),
        wall_s_by_rank=json.dumps([round(r["wall_s"], 2) for r in ranks]),
        phase_s=f"{phase_s:.2f}", one_process_smc_s=f"{smc_wall:.2f}",
        seconds_are="overhead_of_ranks_sharing_one_card_not_a_speedup",
        load_s_by_rank=json.dumps([round(r["load_s"], 2) for r in ranks]),
        k1c_launches_by_rank=json.dumps([r["k1c_launches"] for r in ranks]),
        k5_launches_by_rank=json.dumps([r["k5_launches"] for r in ranks]),
        stage_writes_by_rank=json.dumps([len(r["saves"]) for r in ranks]),
        peak_GB_by_rank=json.dumps([round(r["peak_GB"], 2) for r in ranks]),
        stage0_llk_worst_rel_err=f"{llk_err:.2e}", depth_m=f"{depth:.1f}",
        magnitude=f"{mag:.4f}", summary_parameters=len(summary))
    for r in ranks:
        k5_launches[f"parallel_smc_rank{r['rank']}"] = r["k5_launches"]
        if not (r["mesh_size"] == n and r["chains"] == N_CHAINS and r["finite"]
                and r["device"] == str(dev)):
            raise SystemExit(f"[parallel_smc] rank {r['rank']} did not shard {N_CHAINS} chains "
                             f"over {n} ranks on the card to finite llks: {r}")
        if r["k1c_launches"] == 0 or r["k5_launches"] == 0:
            raise SystemExit(f"[parallel_smc] rank {r['rank']} never launched K1c or K5")
        if not np.allclose(r["q_mean"], q_mean, rtol=1e-6, atol=0.0):
            raise SystemExit(f"[parallel_smc] rank {r['rank']}'s trace is not the files'")
    if not (ranks[0]["saves"][0] == 0 and ranks[0]["saves"][-1] == -1
            and len(ranks[0]["saves"]) == stages + 1
            and all(r["saves"] == [] for r in ranks[1:])):
        raise SystemExit(f"[parallel_smc] the stage files were not written once, by rank 0: "
                         f"{[r['saves'] for r in ranks]}")
    if not llk_err <= LLK_RTOL:
        raise SystemExit(f"[parallel_smc] the first population's llks are {llk_err} off the "
                         "one-process run's")
    if float(state["beta"]) != 1.0:
        raise SystemExit("[parallel_smc] did not reach beta = 1")
    if abs(depth - TRUE_DEPTH) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"[parallel_smc] posterior misses the truth: depth {depth}, Mw {mag}")

    resdir = os.path.join(workdir, "parallel_nccl")
    os.makedirs(resdir)
    phase_s = run_ranks("parallel_nccl", parallel_nccl_rank, 1,
                        (dev.type, ppdir, resdir, N_CHAINS, N_STEPS), PARALLEL_DEADLINE_S)
    (r,) = read_ranks(resdir, 1)
    say("parallel_nccl", ranks=1, backend=r["backend"], nccl=r["nccl"], chains=N_CHAINS,
        steps=N_STEPS, stages_run=1, max_abs_dq=f"{r['max_abs_dq']:.3e}",
        max_abs_dllk=f"{r['max_abs_dllk']:.3e}", meshless_s=f"{r['meshless_s']:.2f}",
        mesh_s=f"{r['mesh_s']:.2f}", phase_s=f"{phase_s:.2f}",
        k1c_launches=r["k1c_launches"], k5_launches=r["k5_launches"])
    k5_launches["parallel_nccl"] = r["k5_launches"]
    if (r["backend"] != ("nccl" if dev.type == "cuda" else "gloo") or r["k1c_launches"] == 0
            or r["k5_launches"] == 0):
        raise SystemExit(f"[parallel_nccl] not NCCL, or K1c/K5 never launched: {r}")
    if not (r["max_abs_dq"] <= PARALLEL_Q_ATOL and r["max_abs_dllk"] <= PARALLEL_LLK_ATOL):
        raise SystemExit(f"[parallel_nccl] the mesh run is off the meshless one: {r}")
    return {"parallel_smc": {"k1c_launches": [r["k1c_launches"] for r in ranks]},
            "parallel_nccl": {"k1c_launches": r["k1c_launches"]}}


def parallel_ffi_phase(dev, problem, q, workdir: str) -> dict:
    """[parallel_ffi_llk] the Laquila-scale library split by targets on a
    ``make_gf_mesh(2, 2)`` of 4 ranks sharing the card over gloo: each
    rank holds 6 of the 12 targets (a block copied from [ffi_build]'s
    library here and handed over by CUDA IPC, not built again) and 1000
    of the 2000 chains ``q``; K3 on its block, the partial llks summed
    over ``targets``.  Gates: the gathered llk within [ffi_llk]'s bar,
    LLK_RTOL · (|llk| + |llk0|), of the one-process llk of the seismic
    composite through K3; K3 launched on every rank; every rank's library
    its block alone.  Returns the ranks' K3 launches."""
    import numpy as np
    import torch

    from beat_tpu_torch.ops.gfstack import stack_batched

    comp = problem.composites["seismic"]
    lib, wmap = comp.libs[0]["uparr"], comp.wavemaps[0]
    if (comp.interpolation != "multilinear" or wmap.domain != "time"
            or wmap.time_shift_names() or len(comp.wavemaps) != 1):
        raise SystemExit("[parallel_ffi_llk] expects one time-domain wavemap, multilinear, "
                         "without time shifts")
    n_chain, n_target = PARALLEL_FFI_MESH
    n = n_chain * n_target
    per = lib.ntargets // n_target
    dd = comp.device_data()[0]
    point = problem.ordering.to_point(q)
    with torch.no_grad():
        starttimes = comp.point2starttimes(point)
        hyper = comp._hyper_vector(point, wmap, q.shape[0], dev).contiguous()
        before = stack_batched.launches_multilinear
        llk_one = comp.loglike(point).double().cpu().numpy()
        one_k3 = stack_batched.launches_multilinear - before
        one_ms = (cuda_ms(lambda: comp.loglike(point), iters=3, warmup=1)
                  if dev.type == "cuda" else float("nan"))
    llk0 = (-0.5 * (dd["slog_pdets"].sum() + (dd["nsamples"] * (
        2.0 * hyper + math.log(2.0 * math.pi))).sum(-1))).double().cpu().numpy()
    blocks = [lib.target_block(slice(i * per, (i + 1) * per)).data for i in range(n_target)]
    grid = dict(duration_min=lib.duration_min, duration_sampling=lib.duration_sampling,
                starttime_min=lib.starttime_min, starttime_sampling=lib.starttime_sampling)
    inputs = (point["durations"], starttimes, point["uparr"], hyper, dd["data"], dd["weights"],
              dd["slog_pdets"], dd["nsamples"])
    resdir = os.path.join(workdir, "parallel_ffi_llk")
    os.makedirs(resdir)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    phase_s = run_ranks("parallel_ffi_llk", parallel_ffi_rank, n,
                        (dev.type, blocks, grid, inputs, comp.interpolation, resdir),
                        PARALLEL_DEADLINE_S)
    ranks = read_ranks(resdir, n)
    llk = np.load(os.path.join(resdir, "llk.npy"))
    worst = float((np.abs(llk - llk_one) / (LLK_RTOL * (np.abs(llk_one) + np.abs(llk0)))).max())
    say("parallel_ffi_llk", ranks=n, mesh=f"{n_chain}x{n_target}", backend="gloo",
        one_card_shared=True, chains=q.shape[0], targets=lib.ntargets,
        targets_per_rank=json.dumps([r["targets"] for r in ranks]),
        chains_per_rank=json.dumps([r["local_chains"] for r in ranks]),
        block_GB=f"{blocks[0].nbytes / 1e9:.3f}", library_GB=f"{lib.data.nbytes / 1e9:.3f}",
        blocks_from="parent_library_by_cuda_ipc",
        k3_launches_by_rank=json.dumps([r["k3_launches"] for r in ranks]),
        one_process_k3_launches=one_k3,
        own_peak_GB_by_rank=json.dumps([round(r["peak_GB"], 3) for r in ranks]),
        first_call_s_by_rank=json.dumps([round(r["first_s"], 3) for r in ranks]),
        warm_ms_by_rank=json.dumps([round(1e3 * r["seconds"], 2) for r in ranks]),
        one_process_ms=f"{one_ms:.2f}",
        phase_s=f"{phase_s:.2f}", worst_err_over_bar=f"{worst:.3e}",
        max_rel_err=f"{float((np.abs(llk - llk_one) / np.abs(llk_one)).max()):.3e}")
    for r in ranks:
        if not (r["targets"] == per and r["block_bytes"] == lib.data.nbytes // n_target
                and r["lib_is_the_block"] and r["local_chains"] == q.shape[0] // n_chain):
            raise SystemExit(f"[parallel_ffi_llk] rank {r['rank']} did not hold its block "
                             f"alone: {r}")
        if r["k3_launches"] == 0:
            raise SystemExit(f"[parallel_ffi_llk] rank {r['rank']} never launched K3")
    if not (np.isfinite(llk).all() and worst <= 1.0):
        raise SystemExit(f"[parallel_ffi_llk] the all-reduced llk is off the one-process "
                         f"llk: {worst} of the bar")
    del blocks, inputs
    if dev.type == "cuda":
        torch.cuda.ipc_collect()     # the blocks the ranks mapped
        torch.cuda.empty_cache()
    return {"k3_launches": [r["k3_launches"] for r in ranks]}


def table_builder_phases(dev, workdir: str, k5_launches: dict) -> dict:
    """Slice 10's table builders on the card and the paths through their
    tables: [layered_build] (the FullMT grid as a layered waveform table of
    the 31-layer crust + ak135 model by the Kennett recursion; two seeded
    depth nodes recomputed on the host CPU, the ω → 0 limit against the
    layered static solver, the Bessel functions against scipy),
    [layered_smc] (the FullMT SMC on it), [trace_store] (its traces written
    as a trace store at dt 0.25 s and read back at 0.5 s), [static_build]
    (build_gfs' geodetic grid, the same model; two depth nodes on the host
    CPU; a homogeneous model against the analytic table), [visco_build]
    (the default crust with Maxwell layers at the scenes' epochs) and
    [visco_smc] (the geodetic problem's scenes at 30 and 365 days through
    the epoch table), then the project phases (:func:`project_phases`)
    and [layered_host_check] (the host CPU's two nodes, after the timed
    phases).  Adds the SMCs' K5 launches to ``k5_launches``;
    returns K1c's launches on [layered_smc] and the project phases.  Raises SystemExit at the
    first gate missed."""
    import numpy as np
    import scipy.special
    import torch

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.flagship import (GEO_TRUE, LAYERED_REAL_SIZE, TRUE_DEPTH,
                                         TRUE_MAGNITUDE, VISCO_EPOCH_DAYS, VISCO_REAL_SIZE,
                                         VISCO_S_PER_DECADE, build_layered_flagship,
                                         build_visco_flagship, layered_earth_model,
                                         layered_flagship_table, visco_model, visco_time_table)
    from beat_tpu_torch.heart.layered_statics import PTS_PER_HALFCYCLE, _mt_displacement
    from beat_tpu_torch.heart.layered_waveforms import elementary_mt_spectra, kennett_plan
    from beat_tpu_torch.heart.statictable import (build_homogeneous_static_table,
                                                  build_static_table, static_table_values)
    from beat_tpu_torch.heart.store_convert import greens_table_from_traces, write_trace_store
    from beat_tpu_torch.heart.velocity_model import LayeredModel
    from beat_tpu_torch.heart.viscoelastic import DAY, laplace_nodes
    from beat_tpu_torch.ops.bessel import bessel_j0, bessel_j1
    from beat_tpu_torch.ops.bilgather import bilinear_contract
    from beat_tpu_torch.ops.rowgather import gather_rows
    from beat_tpu_torch.samplers import SMCParams
    from beat_tpu_torch.sources import sdr_to_m6

    out = {}
    model = layered_earth_model()

    # [layered_build]
    stats = {}
    n_d, n_z, nt = (LAYERED_REAL_SIZE[k] for k in ("n_distances", "n_depths", "nt"))
    (table, build_s, peak) = timed_peak(lambda: layered_flagship_table(
        n_d, n_z, nt, device=dev, model=model, stats=stats))
    plan = kennett_plan(model, table.distances, table.depths, table.nt, table.dt)
    # the Bessel functions over the build's (r, k) ranges against scipy on the host
    k_top = max(b["k_grid"][-1] for b in plan["buckets"])
    r = np.linspace(0.0, table.distances[-1] * 1.01, 1500)
    k = np.linspace(0.0, k_top, 1500)
    kr_host = np.outer(r, k)
    kr = torch.as_tensor(kr_host, device=dev)
    bessel = {}
    for name, ours, theirs, ref in (("j0", bessel_j0, torch.special.bessel_j0, scipy.special.j0),
                                    ("j1", bessel_j1, torch.special.bessel_j1, scipy.special.j1)):
        want = ref(kr_host)
        scale = np.abs(want).max()
        bessel[name] = (float(np.abs(ours(kr).cpu().numpy() - want).max() / scale),
                        float(np.abs(theirs(kr).cpu().numpy() - want).max() / scale))
    del kr
    # two seeded depth nodes of one bucket (one host solve serves both),
    # recomputed on the host CPU and gated at the end ([layered_host_check])
    rng = np.random.default_rng(LAYERED_NODE_SEED)
    shared = [b for b in plan["buckets"] if len(b["depth_idx"]) >= 2]
    nodes = sorted(int(i) for i in rng.choice(shared[rng.integers(len(shared))]["depth_idx"],
                                              2, replace=False))
    grid = dict(distances=table.distances, depths=table.depths, nt=table.nt, dt=table.dt,
                t0=table.t0)
    card_nodes = table.spectra[:, :, :, nodes].cpu()
    # the omega -> 0 limit of the moment-impulse response against the static solver
    # (tests/test_layered_waveforms.py:40-50's bars), at the same nodes
    w_c = 2 * np.pi * 1e-4 - 1e-5j
    dists = table.distances[(table.distances >= 20e3) & (table.distances <= 80e3)][::10]
    m6 = sdr_to_m6(35.0, 60.0, -70.0, 1e16).double().numpy()
    static_limit = {}
    for i in nodes:
        zs = float(table.depths[i])
        k_grid = (np.arange(int(np.ceil(60.0 / zs / (np.pi / (20 * dists.max()))))) + 0.5) \
            * (np.pi / (20 * dists.max()))
        k_grid = k_grid[k_grid < 60.0 / zs]
        spec = elementary_mt_spectra(model, zs, dists, w_c, k_grid, device=dev).cpu().numpy()
        dyn = np.einsum("k,kcn->cn", m6, spec * (1j * w_c))
        obs = np.stack([np.zeros(dists.size), dists], axis=-1)
        # the static solver at its default Hankel density (the JAX package's)
        # and at STATIC_LIMIT_DENSITY, converged near k = 0 where the deep
        # interfaces of this model act
        errs = []
        for pts in (PTS_PER_HALFCYCLE, STATIC_LIMIT_DENSITY):
            stat = _mt_displacement(model, zs, obs, m6, 1e-3, dev, pts).cpu().numpy()
            want = np.stack([stat[:, 2], stat[:, 1], stat[:, 0]])
            errs.append(float(np.abs(dyn.real - want).max() / np.abs(want).max()))
        static_limit[int(i)] = (float(np.abs(dyn.imag).max() / np.abs(dyn.real).max()),
                                errs[1], errs[0])
    r = dict(grid=f"{n_d}x{n_z}x{nt}", layers=model.nlayers, build_s=f"{build_s:.2f}",
             peak_GB=f"{peak:.2f}", table_MB=f"{table.spectra.numel() * 4 / 1e6:.1f}",
             buckets=json.dumps(stats["buckets"]), host_bins=stats.get("host_bins", 0),
             host_bin_solves=stats.get("host_bin_solves", 0),
             fallback_bins=stats.get("fallback_bins", 0),
             host_bin_s=f"{stats.get('host_s', 0.0):.2f}",
             bessel_err=json.dumps({k: f"{v[0]:.2e}" for k, v in bessel.items()}),
             torch_special_bessel_err=json.dumps({k: f"{v[1]:.2e}" for k, v in bessel.items()}),
             static_limit_imag_over_real=json.dumps({i: f"{v[0]:.2e}"
                                                     for i, v in static_limit.items()}),
             static_limit_err=json.dumps({i: f"{v[1]:.2e}" for i, v in static_limit.items()}),
             static_limit_err_default_density=json.dumps({i: f"{v[2]:.2e}"
                                                          for i, v in static_limit.items()}),
             finite=bool(torch.isfinite(table.spectra).all()))
    say("layered_build", **r)
    if not r["finite"]:
        raise SystemExit("[layered_build] non-finite spectra")
    if max(v[0] for v in bessel.values()) > BESSEL_RTOL:
        raise SystemExit(f"[layered_build] Bessel functions off scipy: {bessel}")
    if any(v[0] >= STATIC_LIMIT_IMAG or v[1] > STATIC_LIMIT_RTOL
           for v in static_limit.values()):
        raise SystemExit(f"[layered_build] the omega -> 0 limit misses the static solver: "
                         f"{static_limit}")

    # [layered_smc] the FullMT inversion on the layered table
    problem = build_layered_flagship(**LAYERED_REAL_SIZE, seed=0, device=dev, table=table,
                                     outfolder=os.path.join(workdir, "layered_smc"))
    bilinear_contract.launches = 0
    gather_rows.launches = 0
    (res, wall, peak) = timed_peak(lambda: problem.sample(
        SMCParams(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0)))
    q_tr, llk_tr = res
    k1c = bilinear_contract.launches
    k5_launches["layered_smc"] = gather_rows.launches
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    depth, mag = float(np.asarray(est["depth"])), float(np.asarray(est["magnitude"]))
    say("layered_smc", chains=N_CHAINS, steps=N_STEPS, wall_s=f"{wall:.2f}",
        stages=len(state["acceptance"]), beta=float(state["beta"]), k1c_launches=k1c,
        k5_launches=k5_launches["layered_smc"], peak_GB=f"{peak:.2f}",
        depth_m=f"{depth:.1f}", magnitude=f"{mag:.4f}",
        acceptance_final=f"{state['acceptance'][-1]:.3f}")
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("[layered_smc] did not reach beta = 1 with finite llks")
    if k1c == 0 or k5_launches["layered_smc"] == 0:
        raise SystemExit("[layered_smc] never launched K1c (or K5, its resampling gather)")
    if abs(depth - TRUE_DEPTH) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"[layered_smc] posterior misses the truth: depth {depth}, Mw {mag}")
    out["layered_smc"] = {"k1c_launches": k1c}
    del problem

    # [trace_store] the table's traces at dt 0.25 s through the interchange format
    t0 = time.perf_counter()
    spec = torch.view_as_complex(table.spectra.double())
    up = torch.zeros(spec.shape[:-1] + (table.nt + 1,), dtype=spec.dtype, device=dev)
    up[..., :spec.shape[-1]] = spec
    traces = torch.fft.irfft(up, n=2 * table.nt) * 2.0
    path = os.path.join(workdir, "layered_traces.npz")
    write_trace_store(path, traces.float(), np.full((n_d, n_z), table.t0), table.distances,
                      table.depths, dt=table.dt / 2, vp=table.vp, vs=table.vs, rho=table.rho)
    write_s = time.perf_counter() - t0
    del spec, up, traces
    t0 = time.perf_counter()
    back = greens_table_from_traces(path, nt=table.nt, dt=table.dt, t0=table.t0, device=dev)
    read_s = time.perf_counter() - t0
    below = slice(0, table.nf - 1)
    err = float((back.spectra[..., below, :] - table.spectra[..., below, :]).abs().max()
                / table.spectra.abs().max())
    analytic_err = analytic_store_check(dev, workdir)
    say("trace_store", traces=f"{n_d * n_z * 18}x{2 * table.nt}", dt_store=table.dt / 2,
        write_s=f"{write_s:.2f}", read_s=f"{read_s:.2f}",
        file_MB=f"{os.path.getsize(path) / 1e6:.1f}", max_err_over_max=f"{err:.2e}",
        analytic_max_err_over_max=f"{analytic_err:.2e}")
    if not err <= TRACE_STORE_RTOL:
        raise SystemExit(f"[trace_store] the round trip misses the table: {err}")
    if not analytic_err <= TRACE_STORE_RTOL:
        raise SystemExit(f"[trace_store] the analytic store misses the oracle: {analytic_err}")
    del back
    os.remove(path)
    del table
    torch.cuda.empty_cache()

    # [static_build] build_gfs' geodetic grid for the same 31-layer model
    distances = np.linspace(*STATIC_GRID["distances"])
    depths = np.linspace(*STATIC_GRID["depths"])
    (stab, static_s, peak) = timed_peak(lambda: build_static_table(model, distances, depths,
                                                                   device=dev))
    snodes = sorted(int(i) for i in np.random.default_rng(LAYERED_NODE_SEED).choice(
        depths.size, 2, replace=False))
    t0 = time.perf_counter()
    host = static_table_values([model], distances, stab.depths[snodes], device="cpu")[0]
    host_s = time.perf_counter() - t0
    card = stab.values[..., snodes].cpu()
    static_err = float((card - host.float()).abs().max() / host.abs().max())
    homo = LayeredModel.homogeneous(vp=HOMO_STATIC["vp"], vs=HOMO_STATIC["vs"],
                                    rho=HOMO_STATIC["rho"])
    mu = HOMO_STATIC["rho"] * HOMO_STATIC["vs"] ** 2
    nu = 0.5 * (HOMO_STATIC["vp"] ** 2 - 2 * HOMO_STATIC["vs"] ** 2) / (
        HOMO_STATIC["vp"] ** 2 - HOMO_STATIC["vs"] ** 2)
    h_dist, h_depth = np.linspace(*HOMO_STATIC["distances"]), np.array(HOMO_STATIC["depths"])
    t_lay = build_static_table(homo, h_dist, h_depth, device=dev).values
    t_ref = build_homogeneous_static_table(h_dist, h_depth, nu=nu, shear_modulus=mu,
                                           device=dev).values
    homo_err = float((t_lay - t_ref).abs().max() / t_ref.abs().max())
    say("static_build", grid=f"{distances.size}x{depths.size}", layers=model.nlayers,
        build_s=f"{static_s:.2f}", peak_GB=f"{peak:.2f}",
        host_nodes=json.dumps([float(stab.depths[i]) for i in snodes]),
        host_s=f"{host_s:.2f}", host_max_err_over_max=f"{static_err:.2e}",
        homogeneous_err_over_max=f"{homo_err:.2e}")
    if not (torch.isfinite(stab.values).all() and static_err <= STATIC_HOST_RTOL):
        raise SystemExit(f"[static_build] the card's table off the host CPU's: {static_err}")
    if not homo_err < HOMO_STATIC_RTOL:
        raise SystemExit(f"[static_build] the homogeneous table off the analytic one: "
                         f"{homo_err}")
    del stab

    # [visco_build] the post-seismic table at the scenes' epochs
    n_d, n_z = VISCO_REAL_SIZE["n_distances"], VISCO_REAL_SIZE["n_depths"]
    (ttable, visco_s, peak) = timed_peak(lambda: visco_time_table(n_d, n_z, device=dev))
    elastic = build_static_table(visco_model()[0], ttable.distances, ttable.depths,
                                 device=dev).values
    exact0 = bool(torch.equal(ttable.at_time(0.0, device=dev).values, elastic))
    model_v, rheo = visco_model()
    n_s = laplace_nodes(model_v, rheo, ttable.times, VISCO_S_PER_DECADE).size
    say("visco_build", grid=f"{n_d}x{n_z}", epochs_days=json.dumps(
        [round(t / DAY, 3) for t in ttable.times]), s_nodes=n_s,
        prony_modes=ttable.prony.taus.size, prony_max_resid=f"{ttable.prony.max_resid:.2e}",
        build_s=f"{visco_s:.2f}", peak_GB=f"{peak:.2f}", at_time0_equals_elastic=exact0)
    if not ttable.prony.max_resid <= PRONY_RESID_MAX:
        raise SystemExit(f"[visco_build] Prony residual {ttable.prony.max_resid}")
    if not exact0:
        raise SystemExit("[visco_build] at_time(0) differs from the elastic build")

    # [visco_smc] the two scenes at their epochs through the epoch table
    problem = build_visco_flagship(**VISCO_REAL_SIZE, seed=0, device=dev, ttable=ttable,
                                   outfolder=os.path.join(workdir, "visco_smc"))
    comp = problem.composites["geodetic"]
    epochs = comp.static_table
    table_diff = float((epochs.values[0] - epochs.values[1]).abs().max()
                       / epochs.values.abs().max())
    # the true source's LOS at every observation point through each scene's
    # own single-epoch table: the epoch table must give each scene its own
    # (routing), and the two epochs must differ (the slab is really read)
    point = comp.batch_of_one(dict(GEO_TRUE))
    routed = comp.synthetics_los(point)[0]
    per_epoch = {}
    for name, days in VISCO_EPOCH_DAYS.items():
        comp.static_table = ttable.at_time(days * DAY, device=dev)
        per_epoch[name] = comp.synthetics_los(point)[0]
    comp.static_table = epochs
    own = torch.cat([per_epoch[ds.name][slc] for ds, slc in zip(comp.datasets,
                                                                comp.stack.slices)])
    route_err = float((routed - own).abs().max() / routed.abs().max())
    a, b = per_epoch.values()
    slab_diff = float((a - b).abs().max() / a.abs().max())
    gather_rows.launches = 0
    (res, wall, peak) = timed_peak(lambda: problem.sample(
        SMCParams(n_chains=N_CHAINS, n_steps=GEO_STEPS, seed=0)))
    q_tr, llk_tr = res
    k5_launches["visco_smc"] = gather_rows.launches
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    mean = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    pos_err = {k: float(mean[k]) - GEO_TRUE[k] for k in ("east_shift", "north_shift", "depth")}
    say("visco_smc", chains=N_CHAINS, steps=GEO_STEPS, dims=problem.ordering.size,
        epochs_days=json.dumps(VISCO_EPOCH_DAYS), los_epoch_diff_over_max=f"{slab_diff:.3e}",
        table_epoch_diff_over_max=f"{table_diff:.3e}",
        routing_err_over_max=f"{route_err:.2e}", wall_s=f"{wall:.2f}",
        stages=len(state["acceptance"]), beta=float(state["beta"]),
        k5_launches=k5_launches["visco_smc"], peak_GB=f"{peak:.2f}",
        position_err_m=json.dumps({k: round(x, 1) for k, x in pos_err.items()}))
    if not slab_diff > EPOCH_SLAB_MIN or route_err > 1e-6:
        raise SystemExit(f"[visco_smc] the epoch slabs are not read apart: {slab_diff}, "
                         f"{route_err}")
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("[visco_smc] did not reach beta = 1 with finite llks")
    if k5_launches["visco_smc"] == 0:
        raise SystemExit("[visco_smc] never launched K5")
    if not (abs(pos_err["east_shift"]) <= GEO_POS_TOL and abs(pos_err["north_shift"])
            <= GEO_POS_TOL and abs(pos_err["depth"]) <= GEO_DEPTH_TOL):
        raise SystemExit(f"[visco_smc] posterior mean position misses the truth: {pos_err}")

    # [project], [project_seis_derivative], [project_modes]
    out.update(project_phases(dev, workdir, k5_launches))
    # [cli] the command line from init to plot
    out.update(cli_phases(dev, workdir, k5_launches))

    # [layered_host_check] the layered table's two nodes on the host CPU,
    # after every timed phase, so that no timing shares the host's cores
    done = layered_node_check(card_nodes, grid, plan, nodes, model)
    say("layered_host_check", nodes=json.dumps({i: float(grid["depths"][i]) for i in nodes}),
        threads=torch.get_num_threads(),
        worst_over_trace_max=json.dumps({i: f"{w:.2e}" for i, w in done["worst"].items()}),
        host_s=f"{done['host_s']:.2f}")
    if max(done["worst"].values()) > LAYERED_HOST_RTOL:
        raise SystemExit(f"[layered_host_check] the card's table off the host CPU's: {done}")
    return out


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an NVIDIA GPU "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.covariance import SeismicNoiseAnalyser
    from beat_tpu_torch.device import DTYPE, require_cuda
    from beat_tpu_torch.ffi import SeismicGFLibrary
    from beat_tpu_torch.flagship import (FFI_REAL_SIZE, REAL_SIZE, TRUE_DEPTH, TRUE_DURATION,
                                         TRUE_MAGNITUDE, TRUE_SDR, build_ffi_flagship,
                                         build_flagship, flagship_table)
    from beat_tpu_torch.kernels.build import SIGNATURES, build_all, load
    from beat_tpu_torch.ops import bilgather
    from beat_tpu_torch.ops.bilgather import (bilinear_contract, bilinear_contract_reference,
                                              bilinear_rows, bilinear_rows_reference,
                                              contract_corner_dot, corner_dot,
                                              corner_dot_reference, corner_rows_reference)
    from beat_tpu_torch.ops.gfstack import stack_batched, stack_batched_reference
    from beat_tpu_torch.ops.rowgather import gather_rows, gather_rows_reference
    from beat_tpu_torch.optimize import laplace_approximation, map_estimate
    from beat_tpu_torch.samplers import (MetropolisState, SMCParams, run_metropolis_stage,
                                         value_and_grad)

    # 1. device
    dev = require_cuda()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    say("device", name=json.dumps(name), count=count, torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build every kernel from the checkout's sources, one nvcc each, together
    t0 = time.perf_counter()
    infos = build_all(SIGNATURES)
    build_s = time.perf_counter() - t0
    for kernel, info in infos.items():
        load(kernel)
        say("build", kernel=kernel, cached=info.cached, seconds=f"{info.seconds:.2f}",
            all_seconds=f"{build_s:.2f}", path=os.path.relpath(info.path))
        for line in info.log.splitlines():
            if ("ptxas" in line and ("registers" in line or "warning" in line)
                    or "spill" in line):
                print("  " + line.strip(), flush=True)

    # the real-size problem (its data synthesis already runs K1)
    t0 = time.perf_counter()
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    problem = build_flagship(**REAL_SIZE, seed=0, device=dev,
                             outfolder=os.path.join(workdir.name, "smc"))
    torch.cuda.synchronize()
    comp = problem.composites["seismic"]
    table = comp.tables[0]
    tbl = table.packed
    CD, NZ, M = tbl.shape
    n_targets = sum(w.ntargets for w in comp.wavemaps)
    n_queries = N_CHAINS * n_targets
    say("problem", table=tuple(tbl.shape), table_MB=f"{tbl.numel() * 4 / 1e6:.1f}",
        targets=n_targets, chains=N_CHAINS, k1_queries=n_queries,
        seconds=f"{time.perf_counter() - t0:.1f}")

    # 3. K1 against its plain version and the one-call library version
    gen = torch.Generator(device=dev).manual_seed(1)
    cd, z0, w4 = k1_queries(table, n_queries, gen)
    got = bilinear_rows(tbl, cd, z0, w4)
    ref = bilinear_rows_reference(tbl, cd, z0, w4)
    row = cd * NZ + z0
    idx4 = torch.stack([row, row + 1, row + NZ, row + NZ + 1], dim=1)
    flat = tbl.reshape(CD * NZ, M)
    lib = torch.nn.functional.embedding_bag(idx4, flat, per_sample_weights=w4, mode="sum")
    torch.cuda.synchronize()
    k1_err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    lib_err = float((lib - ref).abs().max())
    del got, ref, lib
    k1_ms = cuda_ms(lambda: bilinear_rows(tbl, cd, z0, w4), iters=20)
    k1_plain_ms = cuda_ms(lambda: bilinear_rows_reference(tbl, cd, z0, w4), iters=5)
    k1_lib_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        idx4, flat, per_sample_weights=w4, mode="sum"), iters=20)
    # bytes: the table rows these queries touch, indices and weights, the output
    rows_read = int(torch.unique(idx4).numel())
    k1_bound, k1_by = bound_ms(rows_read * M * 4 + n_queries * (4 + 4 + 16)
                               + n_queries * M * 4, n_queries * M * 7)
    say("k1", queries=n_queries, max_abs_err=f"{k1_err:.3e}", max_ref=f"{scale:.3e}",
        ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}", library_ms=f"{k1_lib_ms:.4f}",
        library_max_abs_err=f"{lib_err:.3e}", table_rows_read=rows_read,
        bound_ms=f"{k1_bound:.4f}", bound_by=k1_by, share_of_bound=f"{k1_bound / k1_ms:.3f}")
    if not k1_err <= K1_RTOL * scale:
        raise SystemExit(f"K1 disagrees with its plain version: {k1_err} > {K1_RTOL}·{scale}")

    # 4. K2 against its plain version: the same queries, a random cotangent.
    # The one-call library version is the per-sample-weights backward of
    # K1's embedding_bag yardstick (sum mode): one bag of 4 rows per query.
    g = torch.randn((n_queries, M), generator=gen, device=dev)
    offsets = torch.arange(0, 4 * n_queries, 4, device=dev)
    offset2bag = torch.arange(n_queries, device=dev).repeat_interleave(4)
    ind = idx4.reshape(-1)

    def k2_library():
        return torch.ops.aten._embedding_bag_per_sample_weights_backward(
            g, flat, ind, offsets, offset2bag, 0, -1)

    got = corner_dot(tbl, cd, z0, g)
    lib = k2_library().view(n_queries, 4)
    rows = corner_rows_reference(tbl, cd, z0)
    ref = torch.einsum("nj,ncj->nc", g, rows)
    bar = K2_RTOL * g.abs().sum(-1) * rows.abs().amax(dim=(1, 2))
    err = (got - ref).abs().amax(-1)
    k2_err = float(err.max())
    k2_worst = float((err / bar).max())
    lib_worst = float(((lib - ref).abs().amax(-1) / bar).max())
    del got, lib, ref, rows, bar, err
    torch.cuda.empty_cache()
    k2_ms = cuda_ms(lambda: corner_dot(tbl, cd, z0, g), iters=20)
    k2_plain_ms = cuda_ms(lambda: corner_dot_reference(tbl, cd, z0, g), iters=5)
    k2_lib_ms = cuda_ms(k2_library, iters=20)
    # bytes: the touched table rows, indices, the cotangent, the (n, 4) output
    k2_bound, k2_by = bound_ms(rows_read * M * 4 + n_queries * (4 + 4)
                               + n_queries * M * 4 + n_queries * 16, n_queries * 4 * M * 2)
    say("k2", queries=n_queries, max_abs_err=f"{k2_err:.3e}",
        worst_err_over_bar=f"{k2_worst:.3e}", ms=f"{k2_ms:.4f}",
        plain_ms=f"{k2_plain_ms:.4f}", library_ms=f"{k2_lib_ms:.4f}",
        library_worst_err_over_bar=f"{lib_worst:.3e}", bound_ms=f"{k2_bound:.4f}",
        bound_by=k2_by, share_of_bound=f"{k2_bound / k2_ms:.3f}")
    if not k2_worst <= 1.0:
        raise SystemExit(f"K2 disagrees with its plain version: worst err/bar {k2_worst}")
    if not lib_worst <= 1.0:
        raise SystemExit(f"K2's library yardstick computes another function: {lib_worst}")
    del cd, z0, w4, g, idx4, flat, ind, offsets, offset2bag
    torch.cuda.empty_cache()

    # 12. K5 against its plain version (a copy: equal exactly) at the shape
    # the SMC gives it (the FFI population, resampling indices ascending), on
    # the FullMT table's rows (float4 path) and at a ragged row length
    # (scalar path); index_select is the library call, timed in turns with K5.
    # This phase and 13a run here, while the process is young: later on the
    # device's records go missing from short profiler traces
    def check_k5(tbl2, idx, iters):
        ref = gather_rows_reference(tbl2, idx)
        clipped = idx.clamp(0, tbl2.shape[0] - 1)
        far = idx.clone()               # beyond the int32 range on both sides: must clip
        far[::3], far[1::3] = 2**40, -2**40
        r = {"equal": torch.equal(gather_rows(tbl2, idx), ref),
             "equal_int32": torch.equal(gather_rows(tbl2, idx.to(torch.int32)), ref),
             "clips_int64": torch.equal(gather_rows(tbl2, far),
                                        gather_rows_reference(tbl2, far)),
             "library_equal": torch.equal(torch.index_select(tbl2, 0, clipped), ref),
             "rows_read": int(torch.unique(clipped).numel())}
        r["ms"], r["library_ms"] = time_in_turns(
            lambda: gather_rows(tbl2, idx), lambda: torch.index_select(tbl2, 0, clipped), iters)
        r["plain_ms"] = cuda_ms(lambda: gather_rows_reference(tbl2, idx), iters=iters)
        r["device_kernels_per_call"], device_ms, _ = device_kernels(
            lambda: gather_rows(tbl2, idx))
        r["device_ms"] = ms_or_none(device_ms)
        r["library_device_ms"] = ms_or_none(device_kernels(
            lambda: torch.index_select(tbl2, 0, clipped))[1])
        n, m = idx.shape[0], tbl2.shape[1]
        r["bound_ms"], r["bound_by"] = bound_ms(r["rows_read"] * m * 4 + n * 8 + n * m * 4, 0.0)
        return r

    ffi_dims = 3 * FFI_REAL_SIZE["n_strike"] * FFI_REAL_SIZE["n_dip"] + 4
    population = torch.randn((N_CHAINS, ffi_dims), generator=gen, device=dev)
    parents = torch.sort(torch.randint(0, N_CHAINS, (N_CHAINS,), generator=gen,
                                       device=dev)).values
    flat = tbl.reshape(CD * NZ, M)
    idx = torch.randint(-2, CD * NZ + 2, (n_queries,), generator=gen, device=dev)
    ragged = flat[:97, :333].contiguous()
    k5 = {"smc": check_k5(population, parents, 100), "table": check_k5(flat, idx, 20),
          "ragged": check_k5(ragged, idx[:41], 100)}
    for shape, r in k5.items():
        say("k5", shape=shape, equal=r["equal"], equal_int32=r["equal_int32"],
            clips_int64=r["clips_int64"], ms=f"{r['ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}", device_ms=fmt_ms(r["device_ms"]),
            library_device_ms=fmt_ms(r["library_device_ms"]),
            device_kernels_per_call=r["device_kernels_per_call"],
            plain_ms=f"{r['plain_ms']:.4f}", library_equal=r["library_equal"],
            table_rows_read=r["rows_read"], bound_ms=f"{r['bound_ms']:.5f}",
            bound_by=r["bound_by"], share_of_bound=f"{r['bound_ms'] / r['ms']:.3f}")
    if not all(r["equal"] and r["equal_int32"] and r["clips_int64"] and r["library_equal"]
               for r in k5.values()):
        raise SystemExit("K5 (or its library yardstick) is not the plain row gather")
    if not all(r["device_kernels_per_call"] == 1 for r in k5.values()):
        raise SystemExit("a gather_rows call made another device operation beside K5")
    del flat, idx, ragged, population, parents

    # 13a. K3 and K4 at the GF-stack bench shape, the bench's inputs
    b = K3_BENCH_SHAPE
    bench_lib = SeismicGFLibrary(
        torch.randn((b["T"], b["P"], b["D"], b["S"], b["N"]), generator=gen, device=dev),
        duration_min=0.5, duration_sampling=0.5, starttime_min=0.0, starttime_sampling=0.25,
        device=dev)
    bench_in = stack_inputs(bench_lib, b["C"], (0.5, 2.0), (0.0, 2.0), gen)
    bench = {}
    for key, interpolation in (("k3", "multilinear"), ("k4", "nearest_neighbor")):
        bench[key] = r = check_stack(bench_lib, *bench_in, interpolation, iters=50)
        extra = {}
        if key == "k3":
            bmm_ms, bmm_scatter_ms, bmm_err = dense_bmm_ms(bench_lib, *bench_in)
            extra = dict(dense_bmm_ms=f"{bmm_ms:.4f}",
                         dense_bmm_with_scatter_ms=f"{bmm_scatter_ms:.4f}",
                         dense_bmm_max_abs_err=f"{bmm_err:.3e}")
        say_stack(key, "bench", b, r, **extra)
    del bench_lib, bench_in
    torch.cuda.empty_cache()

    # 5. K1c and K2c against their plain versions: on the main path's own
    # queries (captured from one 2000-chain likelihood over the prior, the
    # chains of a target clustered on a few depth cells) and on random ones
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    span = upper - lower
    q_prior = torch.as_tensor(np.random.default_rng(3).uniform(
        lower + 0.01 * span, upper - 0.01 * span, size=(N_CHAINS, lower.size)),
        dtype=DTYPE, device=dev)
    captured = {}

    def capture(tbl_, cd_, z0_, A_):
        captured.update(cd=cd_, z0=z0_, A=A_.detach())
        return bilinear_contract(tbl_, cd_, z0_, A_)

    table.contract_fn = capture
    try:
        logp(q_prior, data)
    finally:
        table.contract_fn = bilinear_contract
    A_main = captured["A"]
    # A = w4 ⊗ m6_ray with w4 >= 0 and Σ_c w4 = 1: its factors, up to rounding
    main_q = dict(cd=captured["cd"], z0=captured["z0"], A=A_main, m6=A_main.sum(-2),
                  w4=A_main.abs().sum(-1) / A_main.abs().sum((-2, -1))[..., None])
    cd, z0, w4 = (x.view((N_CHAINS, n_targets) + x.shape[1:])
                  for x in k1_queries(table, n_queries, gen))
    m6 = torch.randn((N_CHAINS, n_targets, 6), generator=gen, device=dev)
    random_q = dict(cd=cd, z0=z0, A=w4[..., :, None] * m6[..., None, :], w4=w4, m6=m6)
    contract = {"main_path": check_contract(tbl, main_q, gen),
                "random": check_contract(tbl, random_q, gen)}
    for shape, r in contract.items():
        say_contract(shape, r)
    del captured, A_main, main_q, random_q, cd, z0, w4, m6
    torch.cuda.empty_cache()

    def plain_gathers():
        """Swap the table's gathers for their plain versions (the parity
        checks); returns the undo."""
        table.rows_fn, table.contract_fn = bilinear_rows_reference, bilinear_contract_reference

        def undo():
            table.rows_fn, table.contract_fn = bilinear_rows, bilinear_contract
        return undo

    # 6. 2000-chain log-likelihood: K1c against the plain version
    q = torch.as_tensor(np.random.default_rng(2).uniform(
        lower, upper, size=(N_CHAINS, lower.size)), dtype=torch.float32, device=dev)
    before = bilinear_contract.launches
    llk = logp(q, data)
    launched = bilinear_contract.launches - before
    logp_ms = cuda_ms(lambda: logp(q, data), iters=10)
    undo = plain_gathers()
    try:
        llk_plain = logp(q, data)
    finally:
        undo()
    torch.cuda.synchronize()
    rel = float(((llk - llk_plain).abs() / llk_plain.abs()).max())
    say("llk", chains=N_CHAINS, max_rel_err=f"{rel:.3e}", k1c_launches=launched,
        logp_ms=f"{logp_ms:.3f}", finite=bool(torch.isfinite(llk).all()))
    if not (rel <= LLK_RTOL and launched > 0 and torch.isfinite(llk).all()):
        raise SystemExit("llk parity failed (or K1c was not launched)")
    del llk, llk_plain, q
    torch.cuda.empty_cache()

    # 7. 2000-chain gradient through K1c and K2c against the plain
    # versions'; queries kept off the box edges, where clamp passes no gradient
    q = q_prior
    bilinear_contract.launches = contract_corner_dot.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_GB = torch.cuda.memory_allocated() / 1e9
    _, grad = value_and_grad(logp, q, (data,))
    torch.cuda.synchronize()
    vg_peak_GB = torch.cuda.max_memory_allocated() / 1e9 - base_GB
    grad_launches = (bilinear_contract.launches, contract_corner_dot.launches)
    vg_ms = cuda_ms(lambda: value_and_grad(logp, q, (data,)), iters=5)
    undo = plain_gathers()
    try:
        _, grad_plain = value_and_grad(logp, q, (data,))
    finally:
        undo()
    # the bar per parameter (column): the columns' scales differ by orders
    # of magnitude, and only depth's gradient passes through K2
    diff = (grad - grad_plain).abs()
    col_max = grad_plain.abs().amax(0)
    bar = GRAD_RTOL * grad_plain.abs() + GRAD_RTOL * col_max
    worst = float((diff / bar.clamp_min(torch.finfo(bar.dtype).tiny)).max())
    grad_ok = bool(torch.isfinite(grad).all() and (diff <= bar).all())
    dz = problem.ordering["depth"].slc
    say("grad", chains=N_CHAINS, max_abs_err=f"{float(diff.max()):.3e}",
        max_abs_grad=f"{float(col_max.max()):.3e}", worst_err_over_bar=f"{worst:.3e}",
        depth_max_abs_err=f"{float(diff[:, dz].max()):.3e}",
        depth_max_abs_grad=f"{float(col_max[dz].max()):.3e}", k1c_launches=grad_launches[0],
        k2c_launches=grad_launches[1], value_and_grad_ms=f"{vg_ms:.3f}",
        forward_ms=f"{logp_ms:.3f}", value_and_grad_peak_GB=f"{vg_peak_GB:.2f}",
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if not (grad_ok and min(grad_launches) > 0):
        raise SystemExit("gradient parity failed (or K1c/K2c were not launched)")
    del grad, grad_plain, diff, bar
    torch.cuda.empty_cache()

    # one forward and one value-and-grad profiled, through K1c/K2c and,
    # as the yardstick, through the unfused path (K1, a matmul; its
    # backward a gemm, a gemv and K2) in the same process: the CUDA calls
    # each hands to the device, the kernels' device time, the peak memory
    def profile_path(name: str) -> dict:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            value_and_grad(logp, q, (data,))
            torch.cuda.synchronize()
        # kernels only: the operators' own rows repeat their kernels' device time
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        kernel_ms = {e.key: e.self_device_time_total / 1e3 for e in kernels}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        value_and_grad(logp, q, (data,))
        torch.cuda.synchronize()

        def ms_of(kernel):
            return f"{sum(v for k, v in kernel_ms.items() if '::' + kernel + '(' in k):.4f}"

        r = dict(path=name, kernel_ms=f"{sum(kernel_ms.values()):.3f}", kernels=len(kernels),
                 forward_ms=f"{cuda_ms(lambda: logp(q, data), iters=10):.3f}",
                 value_and_grad_ms=f"{cuda_ms(lambda: value_and_grad(logp, q, (data,)), 5):.3f}",
                 calls_forward=device_kernels(lambda: logp(q, data))[0],
                 calls_value_and_grad=device_kernels(
                     lambda: value_and_grad(logp, q, (data,)))[0],
                 value_and_grad_peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9 - base_GB:.2f}",
                 k1c_ms=ms_of("bilinear_contract_kernel"),
                 k2c_ms=ms_of("contract_corner_dot_kernel"),
                 k1_ms=ms_of("bilinear_rows_kernel"), k2_ms=ms_of("corner_dot_kernel"),
                 top=json.dumps([[k[:70], round(v, 4)] for k, v in list(kernel_ms.items())[:10]]))
        say("grad_profile", **r)
        return r

    fused_profile = profile_path("fused")
    bilinear_rows.launches = corner_dot.launches = 0
    table.point_spectra = unfused_point_spectra(table)
    try:
        unfused_profile = profile_path("unfused")
    finally:
        del table.point_spectra
    # K1 and K2 now run in this yardstick only (gather_spectra's path)
    gather_launches = (bilinear_rows.launches, corner_dot.launches)
    if min(gather_launches) == 0:
        raise SystemExit("the unfused path (gather_spectra) never launched K1 or K2")
    del q, q_prior
    torch.cuda.empty_cache()

    # every path's launches of K1c, K2c, K1 and K2, counted from 0 before it
    def zero_bilinear():
        bilinear_contract.launches = contract_corner_dot.launches = 0
        bilinear_rows.launches = corner_dot.launches = 0

    def bilinear_launches() -> dict:
        return dict(k1c_launches=bilinear_contract.launches,
                    k2c_launches=contract_corner_dot.launches,
                    k1_launches=bilinear_rows.launches, k2_launches=corner_dot.launches)

    # 8. the slice-1 main path: random-walk SMC at 2000 chains
    zero_bilinear()
    gather_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    smc_wall = wall
    smc_launches = bilinear_launches()
    k5_launches = {"smc": gather_rows.launches}
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    depth, mag = float(np.asarray(est["depth"])), float(np.asarray(est["magnitude"]))
    say("smc", chains=N_CHAINS, steps=N_STEPS, wall_s=f"{wall:.2f}",
        stages=len(state["acceptance"]), beta=float(state["beta"]), **smc_launches,
        k5_launches=k5_launches["smc"],
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        depth_m=f"{depth:.1f}", magnitude=f"{mag:.4f}",
        acceptance_final=f"{state['acceptance'][-1]:.3f}")
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("SMC did not reach beta = 1 with finite llks")
    if smc_launches["k1c_launches"] == 0 or k5_launches["smc"] == 0:
        raise SystemExit("the SMC run never launched K1c (or K5, its resampling gather)")
    if abs(depth - TRUE_DEPTH) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"posterior misses the truth: depth {depth}, Mw {mag}")

    # 9. the slice-2 main path: MALA-SMC at 2000 chains
    problem.outfolder = os.path.join(workdir.name, "mala_smc")
    zero_bilinear()
    gather_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0,
                                            proposal_name="MALA"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mala_launches = bilinear_launches()
    k5_launches["mala_smc"] = gather_rows.launches
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    depth, mag = float(np.asarray(est["depth"])), float(np.asarray(est["magnitude"]))
    smc_log_z = float(state["log_evidence"])
    say("mala_smc", chains=N_CHAINS, steps=N_STEPS, wall_s=f"{wall:.2f}",
        stages=len(state["acceptance"]), beta=float(state["beta"]), **mala_launches,
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        depth_m=f"{depth:.1f}", magnitude=f"{mag:.4f}",
        acceptance_final=f"{state['acceptance'][-1]:.3f}", log_evidence=f"{smc_log_z:.3f}")
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("MALA-SMC did not reach beta = 1 with finite llks")
    if min(mala_launches["k1c_launches"], mala_launches["k2c_launches"]) == 0:
        raise SystemExit("the MALA-SMC run never launched K1c or K2c")
    if abs(depth - TRUE_DEPTH) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"MALA-SMC posterior misses the truth: depth {depth}, Mw {mag}")

    # 10. one HMC stage at beta = 1 from the MALA-SMC population and covariance
    lo = torch.as_tensor(lower, dtype=DTYPE, device=dev)
    hi = torch.as_tensor(upper, dtype=DTYPE, device=dev)
    start = MetropolisState(
        q=torch.as_tensor(state["population"], dtype=DTYPE, device=dev),
        llk=torch.as_tensor(state["likelihoods"], dtype=DTYPE, device=dev),
        scaling=torch.ones(N_CHAINS, dtype=DTYPE, device=dev),
        accepted=torch.zeros(N_CHAINS, dtype=DTYPE, device=dev),
        acc_total=torch.zeros(N_CHAINS, dtype=DTYPE, device=dev))
    cov_chol = torch.as_tensor(np.linalg.cholesky(state["cov"]), dtype=DTYPE, device=dev)
    hmc_steps, n_leapfrog = 10, 5
    zero_bilinear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, _ = run_metropolis_stage(
        logp, start, 1.0, cov_chol, lo, hi, n_steps=hmc_steps,
        generator=torch.Generator(device=dev).manual_seed(0), proposal_name="HMC",
        tune_interval=5, logp_args=(data,), n_leapfrog=n_leapfrog)
    torch.cuda.synchronize()
    hmc_ms = (time.perf_counter() - t0) * 1e3 / hmc_steps
    hmc_acc = float(final.acc_total.mean()) / hmc_steps
    hmc_finite = bool(torch.isfinite(final.q).all() and torch.isfinite(final.llk).all())
    hmc_launches = bilinear_launches()
    say("hmc", chains=N_CHAINS, steps=hmc_steps, n_leapfrog=n_leapfrog,
        ms_per_transition=f"{hmc_ms:.2f}", acceptance=f"{hmc_acc:.3f}", finite=hmc_finite,
        **hmc_launches)
    if not (0.0 < hmc_acc <= 1.0 and hmc_finite):
        raise SystemExit("HMC stage failed: acceptance outside (0, 1] or non-finite state")
    if min(hmc_launches["k1c_launches"], hmc_launches["k2c_launches"]) == 0:
        raise SystemExit("the HMC stage never launched K1c or K2c")
    del start, final
    torch.cuda.empty_cache()

    # 11. MAP + Laplace; the Laplace Hessian must run through K1c and K2c
    # and call no plain version
    zero_bilinear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_map, llk_map, all_llks = map_estimate(logp, lower, upper, n_restarts=32, n_steps=150,
                                            seed=0, logp_args=(data,),
                                            start=problem.priors.test_array()[None],
                                            device=dev)
    map_s = time.perf_counter() - t0
    map_launches = bilinear_launches()
    zero_bilinear()
    plain_names = ("bilinear_contract_reference", "contract_corner_dot_reference",
                   "bilinear_rows_reference", "corner_dot_reference")
    plain_fns = {fname: getattr(bilgather, fname) for fname in plain_names}
    plain_calls = []
    for fname, fn in plain_fns.items():
        setattr(bilgather, fname, lambda *a, _fn=fn, _name=fname, **k: (
            plain_calls.append(_name), _fn(*a, **k))[1])
    t0 = time.perf_counter()
    try:
        lap = laplace_approximation(logp, q_map, lower, upper, logp_args=(data,), device=dev)
    finally:
        for fname, fn in plain_fns.items():
            setattr(bilgather, fname, fn)
    lap_s = time.perf_counter() - t0
    lap_launches = bilinear_launches()
    point = problem.ordering.to_point(q_map)
    depth, mag = float(point["depth"]), float(point["magnitude"])
    say("map", restarts=32, steps=150, wall_s=f"{map_s:.2f}", laplace_s=f"{lap_s:.2f}",
        depth_m=f"{depth:.1f}", magnitude=f"{mag:.4f}", llk_map=f"{llk_map:.3f}",
        restart_llk_spread=f"{float(all_llks.max() - np.median(all_llks)):.3f}",
        curvature_ok=lap["curvature_ok"], laplace_log_evidence=f"{lap['log_evidence']:.3f}",
        laplace_minus_smc=f"{lap['log_evidence'] - smc_log_z:.3f}", **map_launches,
        **{"hessian_" + k: v for k, v in lap_launches.items()},
        hessian_plain_calls=len(plain_calls))
    if abs(depth - TRUE_DEPTH) >= MAP_DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAP_MAG_TOL:
        raise SystemExit(f"MAP misses the truth: depth {depth}, Mw {mag}")
    if not np.isfinite(lap["log_evidence"]):
        raise SystemExit("Laplace log-evidence is not finite")
    if min(map_launches["k1c_launches"], map_launches["k2c_launches"]) == 0:
        raise SystemExit("MAP never launched K1c or K2c")
    if min(lap_launches["k1c_launches"], lap_launches["k2c_launches"]) == 0 or plain_calls:
        raise SystemExit(f"the Laplace Hessian did not run through K1c and K2c alone: "
                         f"{lap_launches}, plain calls {sorted(set(plain_calls))}")

    del lap, q_map
    torch.cuda.empty_cache()

    # 11b. [sources_llk] every other source type, and the DC composite with
    # each option, on the same table and observations: one 2000-chain
    # likelihood and one value-and-grad through K1c and K2c against the
    # plain versions (chunked over the chains where their corner rows
    # would outgrow the card)
    variants = {src: (src, {}) for src in SOURCE_TYPES}
    variants.update(dc_station_corrections=("DCSource", dict(station_corrections=True)),
                    dc_hp_specific=("DCSource", dict(hp_specific=True)),
                    dc_spectrum=("DCSource", dict(domain="spectrum")),
                    dc_two_events=("DCSource", dict(n_events=2)))
    sources_llk_launches = dict.fromkeys(bilinear_launches(), 0)
    sources_llk = {}
    for case, (src, options) in variants.items():
        vproblem = build_flagship(**REAL_SIZE, seed=0, device=dev, table=table, source=src,
                                  outfolder=os.path.join(workdir.name, case), **options)
        vcomp = vproblem.composites["seismic"]
        vlogp, vdata = vproblem.make_logp_fn()
        vlo, vhi = vproblem.priors.bounds_arrays()
        vspan = vhi - vlo
        vq = torch.as_tensor(np.random.default_rng(5).uniform(
            vlo + 0.01 * vspan, vhi - 0.01 * vspan, size=(N_CHAINS, vlo.size)), dtype=DTYPE,
            device=dev)
        per_chain = queries_per_chain(vcomp)
        chunk = max(1, PLAIN_QUERIES // per_chain)

        def no_grad_logp(x):
            with torch.no_grad():
                return vlogp(x, vdata)

        zero_bilinear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        llk = no_grad_logp(vq)
        torch.cuda.synchronize()
        llk_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        llk_launches = bilinear_contract.launches
        for k, v in bilinear_launches().items():
            sources_llk_launches[k] += v
        zero_bilinear()
        torch.cuda.reset_peak_memory_stats()
        _, grad = value_and_grad(vlogp, vq, (vdata,))
        torch.cuda.synchronize()
        vg_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        vg_launches = (bilinear_contract.launches, contract_corner_dot.launches)
        for k, v in bilinear_launches().items():
            sources_llk_launches[k] += v
        llk_ms = cuda_ms(lambda: no_grad_logp(vq), iters=3, warmup=1)
        vg_ms = cuda_ms(lambda: value_and_grad(vlogp, vq, (vdata,)), iters=2, warmup=1)
        calls_fwd, kernel_ms_fwd, by_name = device_kernels(lambda: no_grad_logp(vq))
        calls_vg, kernel_ms_vg, _ = device_kernels(lambda: value_and_grad(vlogp, vq, (vdata,)))
        undo = plain_gathers()
        try:
            llk_plain = chunked_value(no_grad_logp, vq, chunk)
            _, grad_plain = chunked_value(lambda x: value_and_grad(vlogp, x, (vdata,)), vq,
                                          chunk)
        finally:
            undo()
        torch.cuda.synchronize()
        rel = float(((llk - llk_plain).abs() / llk_plain.abs()).max())
        worst, grad_ok = grad_gate(grad, grad_plain)
        finite = bool(torch.isfinite(llk).all())
        sources_llk[case] = r = dict(
            source=src, dims=vproblem.ordering.size, chains=N_CHAINS,
            k1c_queries=per_chain * N_CHAINS, plain_chunk_chains=chunk,
            max_rel_err=f"{rel:.3e}", grad_worst_err_over_bar=f"{worst:.3e}", finite=finite,
            k1c_launches=llk_launches, vg_k1c_launches=vg_launches[0],
            vg_k2c_launches=vg_launches[1], llk_ms=f"{llk_ms:.3f}",
            value_and_grad_ms=f"{vg_ms:.3f}", llk_peak_GB=f"{llk_peak:.2f}",
            value_and_grad_peak_GB=f"{vg_peak:.2f}", calls_forward=calls_fwd,
            calls_value_and_grad=calls_vg, kernel_ms_forward=fmt_ms(ms_or_none(kernel_ms_fwd)),
            kernel_ms_value_and_grad=fmt_ms(ms_or_none(kernel_ms_vg)),
            top_forward=json.dumps([[k[:60], round(v, 4)] for k, v in list(by_name.items())[:5]]))
        say("sources_llk", case=case, **r)
        if not (rel <= LLK_RTOL and finite and llk_launches > 0):
            raise SystemExit(f"[sources_llk] {case}: llk parity failed (or K1c not launched)")
        if not (grad_ok and min(vg_launches) > 0):
            raise SystemExit(f"[sources_llk] {case}: gradient parity failed (or K1c/K2c "
                             f"not launched)")
        del vproblem, vcomp, vlogp, vdata, vq, llk, llk_plain, grad, grad_plain
        torch.cuda.empty_cache()

    # 11c. [dc_mala_smc] a DCSource MALA-SMC to beta = 1 on the flagship data
    dc = build_flagship(**REAL_SIZE, seed=0, device=dev, table=table, source="DCSource",
                        outfolder=os.path.join(workdir.name, "dc_mala_smc"))
    zero_bilinear()
    gather_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_tr, llk_tr = dc.sample(SMCParams(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0,
                                       proposal_name="MALA"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dc_launches = bilinear_launches()
    k5_launches["dc_mala_smc"] = gather_rows.launches
    dc_state = SampleStage(dc.outfolder, ordering=dc.ordering).load_state(-1)
    est = dc.ordering.to_point(q_tr[-1].mean(axis=0))
    depth, mag = float(np.asarray(est["depth"])), float(np.asarray(est["magnitude"]))
    depth_sd = float(q_tr[-1][:, dc.ordering["depth"].slc].std())
    i_best = int(np.argmax(llk_tr[-1]))
    dc_best = dc.ordering.to_point(q_tr[-1][i_best])
    vr = dc.composites["seismic"].get_variance_reductions(dc_best)
    synths = dc.composites["seismic"].get_synthetics(dc_best)
    obs = {w.mapid: w.data_windows for w in dc.composites["seismic"].wavemaps}
    vr_all = 1.0 - (sum(float(((obs[k] - synths[k]) ** 2).sum()) for k in obs)
                    / sum(float((o ** 2).sum()) for o in obs.values()))
    # the MAP from the test point, the SMC's best sample and 32 uniform
    # restarts (a better mode elsewhere would show the SMC missed it), and
    # the llk at the true source with the best sample's hyperparameters:
    # with free shifts the depth trades off with the position, time and
    # duration, and the data place the mode where they do
    dlogp, ddata = dc.make_logp_fn()
    dlo, dhi = dc.priors.bounds_arrays()
    q_dmap, llk_dmap, _ = map_estimate(dlogp, dlo, dhi, n_restarts=32, n_steps=150, seed=0,
                                       logp_args=(ddata,), device=dev,
                                       start=np.stack([dc.priors.test_array(), q_tr[-1][i_best]]))
    depth_map = float(dc.ordering.to_point(q_dmap)["depth"])
    true_q = dict(dc_best, strike=TRUE_SDR[0], dip=TRUE_SDR[1], rake=TRUE_SDR[2],
                  magnitude=TRUE_MAGNITUDE, east_shift=0.0, north_shift=0.0, depth=TRUE_DEPTH,
                  time=0.0, duration=TRUE_DURATION)
    with torch.no_grad():
        llk_true = float(dlogp(torch.as_tensor(dc.ordering.to_array(true_q), dtype=DTYPE,
                                               device=dev)[None], ddata))
    say("dc_mala_smc", chains=N_CHAINS, steps=N_STEPS, dims=dc.ordering.size,
        wall_s=f"{wall:.2f}", stages=len(dc_state["acceptance"]), beta=float(dc_state["beta"]),
        **dc_launches, k5_launches=k5_launches["dc_mala_smc"],
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", depth_m=f"{depth:.1f}",
        depth_sd_m=f"{depth_sd:.1f}", depth_map_m=f"{depth_map:.1f}", magnitude=f"{mag:.4f}",
        acceptance_final=f"{dc_state['acceptance'][-1]:.3f}",
        llk_best=f"{float(llk_tr[-1][i_best]):.3f}", llk_map=f"{llk_dmap:.3f}",
        llk_true=f"{llk_true:.3f}", variance_reduction_best=f"{vr_all:.4f}",
        variance_reduction_best_by_wavemap=json.dumps({k: round(v, 4) for k, v in vr.items()}),
        best=json.dumps({k: round(float(np.asarray(v)), 3) for k, v in dc_best.items()}))
    if not (float(dc_state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("DC MALA-SMC did not reach beta = 1 with finite llks")
    if min(dc_launches["k1c_launches"], dc_launches["k2c_launches"],
           k5_launches["dc_mala_smc"]) == 0:
        raise SystemExit("the DC MALA-SMC run never launched K1c, K2c or K5")
    # the depth is held against the data's own mode, found independently by
    # the MAP; Mw against the truth
    if abs(depth - depth_map) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"DC MALA-SMC posterior misses: depth {depth} (MAP {depth_map}), "
                         f"Mw {mag}")
    if not (vr_all >= DC_VR_MIN and float(llk_tr[-1][i_best]) >= llk_true):
        raise SystemExit(f"DC MALA-SMC best sample: variance reduction {vr_all} < {DC_VR_MIN}, "
                         f"or its llk below the true source's {llk_true}")
    dc_population = torch.as_tensor(dc_state["population"], dtype=DTYPE, device=dev)
    del dc, q_tr, llk_tr, dlogp, ddata
    torch.cuda.empty_cache()

    # 11d. [update_weights] at the DC run's best sample: non-Toeplitz data
    # covariances from its residuals and the prediction covariances of two
    # ensemble tables (velocities -3 % and +3 %), then one likelihood
    ens = [flagship_table(REAL_SIZE["n_distances"], REAL_SIZE["n_depths"], REAL_SIZE["nt"],
                          device=dev, vp=6000.0 * f, vs=3500.0 * f) for f in (0.97, 1.03)]
    uw = build_flagship(**REAL_SIZE, seed=0, device=dev, table=table, source="DCSource",
                        noise_analyser=SeismicNoiseAnalyser("non-toeplitz"),
                        ensemble_tables=ens, outfolder=os.path.join(workdir.name, "uw"))
    ulogp, udata = uw.make_logp_fn()
    before = [d["weights"].clone() for d in udata[0]]
    zero_bilinear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uw.update_weights(dc_best)
    torch.cuda.synchronize()
    uw_s = time.perf_counter() - t0
    uw_launches = bilinear_launches()
    with torch.no_grad():
        ullk = ulogp(dc_population, udata)
    torch.cuda.synchronize()
    changed = [not torch.equal(b, d["weights"]) for b, d in zip(before, udata[0])]
    say("update_weights", seconds=f"{uw_s:.2f}", ensemble_tables=len(ens),
        weights_changed=changed, llk_finite=bool(torch.isfinite(ullk).all()),
        llk_median=f"{float(ullk.median()):.1f}", **uw_launches)
    if not (torch.isfinite(ullk).all() and all(changed) and uw_launches["k1c_launches"] > 0):
        raise SystemExit("update_weights: non-finite llks, unchanged weights or no K1c launch")
    del uw, ulogp, udata, ens, before, ullk, dc_population
    torch.cuda.empty_cache()

    # 11e. [rect_smc] the finite RectangularSource: K1c at its query layout
    # and the other one (K = 40 patches), then a random-walk SMC capped at
    # RECT_MAX_STAGES - 1 stages
    rect = build_flagship(**REAL_SIZE, seed=0, device=dev, table=table,
                          source="RectangularSource",
                          outfolder=os.path.join(workdir.name, "rect_smc"))
    rcomp = rect.composites["seismic"]
    rlogp, rdata = rect.make_logp_fn()
    rlo, rhi = rect.priors.bounds_arrays()
    rq = torch.as_tensor(np.random.default_rng(6).uniform(rlo, rhi, size=(N_CHAINS, rlo.size)),
                         dtype=DTYPE, device=dev)
    # the queries of one likelihood as the composite lays them out, (K, C,
    # T), and the same queries as (C, K, T), the other layout
    captured = {}

    def capture(tbl_, cd_, z0_, A_):
        captured.update(cd=cd_, z0=z0_, A=A_.detach())
        return bilinear_contract(tbl_, cd_, z0_, A_)

    table.contract_fn = capture
    try:
        with torch.no_grad():
            rlogp(rq, rdata)
    finally:
        table.contract_fn = bilinear_contract
    kept, other = "patches_first", "chains_first"
    layouts = {kept: check_finite_layout(tbl, captured["cd"], captured["z0"], captured["A"],
                                         gen)}
    layouts[other] = check_finite_layout(
        tbl, *(captured[k].transpose(0, 1).contiguous() for k in ("cd", "z0", "A")), gen)
    del captured
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        rlogp(rq, rdata)
    torch.cuda.synchronize()
    layouts[kept]["llk_peak_GB"] = (torch.cuda.max_memory_allocated() - base) / 1e9

    def rect_llk():
        with torch.no_grad():
            return rlogp(rq, rdata)

    layouts[kept]["logp_ms"] = cuda_ms(rect_llk, iters=3, warmup=1)
    for name_, r in layouts.items():
        extra = ({} if name_ != kept else dict(logp_ms=f"{r['logp_ms']:.3f}",
                                               llk_peak_GB=f"{r['llk_peak_GB']:.2f}"))
        say("k1c_finite", layout=name_, kept=name_ == kept, shape=r["shape"],
            queries=r["queries"], max_abs_err=f"{r['max_abs_err']:.3e}",
            worst_err_over_bar=f"{r['worst_err_over_bar']:.3e}", ms=f"{r['ms']:.4f}",
            plain_ms=f"{r['plain_ms']:.4f}", library_ms=f"{r['library_ms']:.4f}",
            table_rows_read=r["table_rows_read"], bound_ms=f"{r['bound_ms']:.4f}",
            bound_by=r["bound_by"], share_of_bound=f"{r['bound_ms'] / r['ms']:.3f}", **extra)
    faster = min(layouts, key=lambda k: layouts[k]["ms"])
    del rq
    zero_bilinear()
    gather_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rect.sample(SMCParams(n_chains=N_CHAINS, n_steps=RECT_STEPS, max_stages=RECT_MAX_STAGES,
                              seed=0))
        capped = False
    except RuntimeError as e:
        if "did not reach beta=1" not in str(e):
            raise
        capped = True
    torch.cuda.synchronize()
    rect_wall = time.perf_counter() - t0
    rect_launches = bilinear_launches()
    k5_launches["rect_smc"] = gather_rows.launches
    handler = SampleStage(rect.outfolder, ordering=rect.ordering)
    rstates = [handler.load_state(st) for st in (range(1, RECT_MAX_STAGES) if capped else [-1])]
    rbetas = [0.0] + [float(st["beta"]) for st in rstates]
    rfinite = all(np.isfinite(st["likelihoods"]).all() for st in rstates)
    say("rect_smc", chains=N_CHAINS, steps=RECT_STEPS, dims=rect.ordering.size,
        patches=f"{rcomp.finite_patches[0]}x{rcomp.finite_patches[1]}",
        k1c_queries_per_eval=queries_per_chain(rcomp) * N_CHAINS, layout=kept,
        faster_layout=faster, wall_s=f"{rect_wall:.2f}", stages_run=len(rstates),
        capped=capped, betas=json.dumps([round(x, 6) for x in rbetas]), finite=rfinite,
        **rect_launches, k5_launches=k5_launches["rect_smc"],
        acceptance=json.dumps([round(float(a), 3) for a in rstates[-1]["acceptance"]]),
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if not (all(b1 > b0 for b0, b1 in zip(rbetas, rbetas[1:])) and rfinite):
        raise SystemExit("rect SMC: beta not strictly increasing, or non-finite llks")
    if rect_launches["k1c_launches"] == 0:
        raise SystemExit("the rect SMC run never launched K1c")
    del rect, rcomp, rlogp, rdata, rstates
    torch.cuda.empty_cache()

    # 11f. [joint_llk], [pt_joint]: the joint seismic + geodetic problem on the same table
    joint = joint_phases(dev, table, workdir.name)
    polarity = polarity_phases(dev, table, workdir.name, k5_launches)


    # the FullMT problem is done: free its table before the FFI library
    del problem, comp, table, tbl, logp, data, state, cov_chol, lo, hi
    torch.cuda.empty_cache()

    # 14. the real-size FFI problem: its library is built on the card, through K1c
    zero_bilinear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = build_ffi_flagship(**FFI_REAL_SIZE, seed=0, device=dev,
                                 outfolder=os.path.join(workdir.name, "ffi_smc"))
    torch.cuda.synchronize()
    ffi_build_s = time.perf_counter() - t0
    comp = problem.composites["seismic"]
    lib = comp.libs[0]["uparr"]
    fsub = comp.fault.get_subfault(0)
    say("ffi_build", library=tuple(lib.data.shape),
        library_GiB=f"{lib.data.numel() * 4 / 2**30:.2f}", seconds=f"{ffi_build_s:.2f}",
        **bilinear_launches(), patches=f"{fsub.n_strike}x{fsub.n_dip}",
        dims=problem.ordering.size, finite=bool(torch.isfinite(lib.data).all()),
        max_abs=f"{float(lib.data.abs().max()):.3e}",
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    ffi_build_launches = bilinear_launches()
    if not (torch.isfinite(lib.data).all() and ffi_build_launches["k1c_launches"] > 0
            and float(lib.data.abs().max()) > 0):
        raise SystemExit("the FFI library is not finite and non-zero (or K1c was not launched)")

    # 13b. K3 and K4 on the real library: durations and starttimes on and
    # beyond the grids (0.5–5.0 s, 0–7.75 s), so the weights leave [0, 1]
    real_in = stack_inputs(lib, N_CHAINS, (0.2, 5.5), (-0.5, 9.0), gen)
    real_dims = dict(C=N_CHAINS, T=lib.ntargets, P=lib.npatches, D=lib.ndurations,
                     S=lib.nstarttimes, N=lib.nsamples)
    real = {}
    for key, interpolation in (("k3", "multilinear"), ("k4", "nearest_neighbor")):
        real[key] = r = check_stack(lib, *real_in, interpolation, iters=10)
        say_stack(key, "real", real_dims, r)
    # their library yardstick on the real library: one dense bmm over the
    # scattered corner weights, (T, C, P·D·S) floats (15.4 GB) beside the library
    for key, interpolation in (("k3", "multilinear"), ("k4", "nearest_neighbor")):
        bmm_ms, bmm_scatter_ms, bmm_err = dense_bmm_ms(lib, *real_in, interpolation)
        real[key].update(library_ms=bmm_ms, library_with_scatter_ms=bmm_scatter_ms,
                         library_max_abs_err=bmm_err)
        say(key, shape="real_dense_bmm", dense_bmm_ms=f"{bmm_ms:.4f}",
            dense_bmm_with_scatter_ms=f"{bmm_scatter_ms:.4f}",
            dense_bmm_max_abs_err=f"{bmm_err:.3e}",
            weights_GB=f"{N_CHAINS * lib.ntargets * lib.npatches * lib.ndurations * lib.nstarttimes * 4 / 1e9:.2f}")
        torch.cuda.empty_cache()

    # K3 as the main path calls it: the onsets shared by the targets, (C, 1, P)
    # operands; the call may allocate its output and nothing else
    durations, starttimes, slips = real_in
    shared = check_stack(lib, durations, starttimes[:, :1].contiguous(), slips, "multilinear",
                         iters=10)
    didx, rtf = lib.durations2idxs(durations, "multilinear")
    sidx, stf = lib.starttimes2idxs(starttimes[:, :1].contiguous(), "multilinear")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = stack_batched(lib.data, didx, sidx, slips, rtf, stf)
    torch.cuda.synchronize()
    extra_bytes = torch.cuda.max_memory_allocated() - base
    out_bytes = out.numel() * out.element_size()
    say_stack("k3", "real_shared", real_dims, shared, operands=tuple(sidx.shape),
              allocated_MB=f"{extra_bytes / 1e6:.3f}", output_MB=f"{out_bytes / 1e6:.3f}")
    if extra_bytes > out_bytes + 2**21:
        raise SystemExit(f"K3 with shared onsets allocated {extra_bytes} bytes for an output "
                         f"of {out_bytes}")
    del out, sidx, stf

    # what bounds the gather variant: all chains on one cell (the 8 chains of
    # a block load the same rows: L1 serves 7 of 8), then eight cells, one per
    # chain of a block (no row shared within a block, few enough rows to stay
    # in cache); the tiled variant's time does not depend on the cells
    chain = torch.arange(N_CHAINS, device=dev, dtype=torch.int32)
    T, P = lib.ntargets, lib.npatches
    for shape, d_cells, s_cells in (
            ("real_one_cell", torch.full_like(didx, 5),
             torch.full((N_CHAINS, T, P), 17, dtype=torch.int32, device=dev)),
            ("real_eight_cells", (1 + chain % 8)[:, None].expand(N_CHAINS, P).contiguous(),
             (2 + 3 * (chain % 8))[:, None, None].expand(N_CHAINS, T, P).contiguous())):
        stf_full = torch.rand((N_CHAINS, T, P), generator=gen, device=dev)
        tiled_ms, gather_ms = time_in_turns(
            lambda: stack_batched(lib.data, d_cells, s_cells, slips, rtf, stf_full,
                                  variant="tiled"),
            lambda: stack_batched(lib.data, d_cells, s_cells, slips, rtf, stf_full,
                                  variant="gather"), 5)
        say("k3", shape=shape, tiled_ms=f"{tiled_ms:.4f}", gather_ms=f"{gather_ms:.4f}")
    del durations, starttimes, slips, didx, rtf, d_cells, s_cells, stf_full
    del real_in
    torch.cuda.empty_cache()

    # 15. the 2000-chain FFI log-likelihood through K3, against the plain
    # stack on chains spread over the batch
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    q = torch.as_tensor(np.random.default_rng(4).uniform(
        lower, upper, size=(N_CHAINS, lower.size)), dtype=torch.float32, device=dev)
    stack_batched.launches_multilinear = stack_batched.launches_nearest = 0
    llk = logp(q, data)
    launched = stack_batched.launches_multilinear
    sub = torch.arange(0, N_CHAINS, max(1, N_CHAINS // FFI_PLAIN_CHAINS),
                       device=dev)[:FFI_PLAIN_CHAINS]
    lib.stack_fn = stack_batched_reference
    try:
        llk_plain = logp(q[sub], data)
    finally:
        lib.stack_fn = stack_batched
    torch.cuda.synchronize()
    h = problem.ordering.to_point(q[sub])[comp.wavemaps[0].hypername]
    llk0 = -0.5 * (data[0][0]["slog_pdets"].sum()
                   + data[0][0]["nsamples"].sum() * (2.0 * h + math.log(2.0 * math.pi)))
    diff = (llk[sub] - llk_plain).abs()
    rel = float((diff / llk_plain.abs()).max())
    worst = float((diff / (LLK_RTOL * (llk_plain.abs() + llk0.abs()))).max())
    ffi_logp_ms = cuda_ms(lambda: logp(q, data), iters=5)
    point = problem.ordering.to_point(q)
    eik_ms = cuda_ms(lambda: comp.point2starttimes(point), iters=5)
    eik_launches, eik_kernel_ms, _ = device_kernels(lambda: comp.point2starttimes(point))
    n_launches, kernel_ms, by_name = device_kernels(lambda: logp(q, data))
    beyond = float((comp.point2starttimes(point) > 7.75).float().mean())
    say("ffi_llk", chains=N_CHAINS, dims=lower.size, plain_chains=len(sub),
        max_rel_err=f"{rel:.3e}", worst_err_over_bar=f"{worst:.3e}", k3_launches=launched,
        logp_ms=f"{ffi_logp_ms:.3f}",
        eikonal_ms=f"{eik_ms:.3f}", eikonal_launches=eik_launches,
        eikonal_kernel_ms=f"{eik_kernel_ms:.3f}", launches=n_launches,
        kernel_ms=f"{kernel_ms:.3f}",
        k3_ms=f"{sum(v for k, v in by_name.items() if 'gf_stack' in k):.4f}",
        onsets_beyond_grid=f"{beyond:.3f}", finite=bool(torch.isfinite(llk).all()),
        top=json.dumps([[k[:60], round(v, 4)] for k, v in list(by_name.items())[:6]]))
    if not (worst <= 1.0 and launched > 0 and torch.isfinite(llk).all()):
        raise SystemExit("FFI llk parity failed (or K3 was not launched)")
    del llk, llk_plain, point, diff
    torch.cuda.empty_cache()

    # 15b. [parallel_ffi_llk] the library split by targets over 4 ranks
    parallel_ffi = parallel_ffi_phase(dev, problem, q, workdir.name)
    del q

    # 16. the slice-3 main path: random-walk SMC at 2000 chains and 1504
    # dimensions, ended by the stage cap as the example runs it; the stage
    # files are timed where they are written
    writes = []
    save_stage = SampleStage.save_stage

    def timed_save_stage(self, stage, trace, state):
        t_w = time.perf_counter()
        save_stage(self, stage, trace, state)
        writes.append((stage, time.perf_counter() - t_w,
                       os.path.getsize(self._trace_file(stage)) / 1e6,
                       np.asarray(trace["q"]).nbytes / 1e6))

    stack_batched.launches_multilinear = stack_batched.launches_nearest = 0
    zero_bilinear()
    gather_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    SampleStage.save_stage = timed_save_stage
    t0 = time.perf_counter()
    try:
        problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=FFI_STEPS,
                                 max_stages=FFI_MAX_STAGES, seed=1))
        capped = False
    except RuntimeError as e:
        if "did not reach beta=1" not in str(e):
            raise
        capped = True
    finally:
        SampleStage.save_stage = save_stage
    torch.cuda.synchronize()
    ffi_wall = time.perf_counter() - t0
    ffi_launches = stack_batched.launches_multilinear
    k5_launches["ffi_smc"] = gather_rows.launches
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    stages = list(range(1, FFI_MAX_STAGES)) if capped else [-1]
    states = [handler.load_state(st) for st in stages]
    betas = [0.0] + [float(st["beta"]) for st in states]
    ffi_finite = all(np.isfinite(st["likelihoods"]).all() for st in states)
    big = [w for w in writes if w[0] != 0]
    say("ffi_smc", chains=N_CHAINS, steps=FFI_STEPS, dims=problem.ordering.size,
        wall_s=f"{ffi_wall:.2f}", stages_run=len(states), capped=capped,
        betas=json.dumps([round(x, 6) for x in betas]), finite=ffi_finite,
        k3_launches=ffi_launches, k4_launches=stack_batched.launches_nearest,
        k5_launches=k5_launches["ffi_smc"],
        acceptance=json.dumps([round(float(a), 3) for a in states[-1]["acceptance"]]),
        stage_write_s=json.dumps([round(w[1], 2) for w in writes]),
        stage_file_MB=json.dumps([round(w[2], 1) for w in writes]),
        stage_trace_MB=json.dumps([round(w[3], 1) for w in writes]),
        write_s_total=f"{sum(w[1] for w in writes):.2f}",
        write_MB_per_s=f"{sum(w[3] for w in big) / max(sum(w[1] for w in big), 1e-9):.1f}",
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if not (all(b1 > b0 for b0, b1 in zip(betas, betas[1:])) and ffi_finite):
        raise SystemExit("FFI SMC: beta not strictly increasing, or non-finite llks")
    if ffi_launches == 0 or k5_launches["ffi_smc"] == 0:
        raise SystemExit("the FFI SMC run never launched K3 (or K5, its resampling gather)")

    # 16b. [ffi_extras], [k3_bf16], [k4_bf16] on the same library and wavemap
    extras = ffi_extra_phases(dev, problem, workdir.name)
    del problem, comp, lib, logp, data
    torch.cuda.empty_cache()

    # 17. a small FFI problem sampled to beta = 1, with each interpolation
    recover = {}
    for interpolation in ("multilinear", "nearest_neighbor"):
        stack_batched.launches_multilinear = stack_batched.launches_nearest = 0
        gather_rows.launches = 0
        recover[interpolation] = ffi_recover(interpolation, dev, workdir.name, N_CHAINS)
        recover[interpolation]["launches"] = (stack_batched.launches_multilinear,
                                              stack_batched.launches_nearest)
        k5_launches[f"ffi_recover_{interpolation}"] = gather_rows.launches
    k4_launches = recover["nearest_neighbor"]["launches"][1]
    if recover["multilinear"]["launches"][0] == 0 or k4_launches == 0:
        raise SystemExit("the small FFI runs never launched K3 (multilinear) or K4 (nearest)")
    geodetic_phases(dev, workdir.name, k5_launches)
    bem_phases(dev, workdir.name, k5_launches)
    transd_phases(dev, workdir.name)
    builders = table_builder_phases(dev, workdir.name, k5_launches)
    # [parallel_smc], [parallel_nccl] the runtime: [project]'s FullMT project
    # sampled by ranks
    runtime = parallel_smc_phases(dev, workdir.name, k5_launches, smc_wall)
    workdir.cleanup()

    # 18. results: launches from each kernel's main path (SMC for K1 and
    # K1c, MALA-SMC for K2 and K2c, FFI SMC for K3 and K5, the
    # nearest-neighbour FFI SMC for K4), with every path's count beside
    # them (the geometry-mode paths of 11b-11e among them; K1c also
    # with its times at the finite source's two query layouts).  K1 and K2 run on no path now (0): K1c and K2c took their
    # place; their launches in [grad_profile]'s unfused yardstick, which
    # is not a path of the port, stand apart.  K1c's and K2c's times are
    # those on the main path's queries, K3's and K4's those on the real
    # library, K5's those at the FFI population's shape.
    paths = {"smc": smc_launches, "mala_smc": mala_launches, "hmc": hmc_launches,
             "map": map_launches, "laplace": lap_launches,
             "sources_llk": sources_llk_launches, "dc_mala_smc": dc_launches,
             "update_weights": uw_launches, "rect_smc": rect_launches,
             "ffi_build": ffi_build_launches}

    def by_path(key):
        return {path: counts[key] for path, counts in paths.items()}

    def bf16_entry(r, name, replaces, launches, launches_by_path):
        """K3's or K4's entry on the bf16 library: the variant the plan
        chose there (K3: ``mma``; K4: ``gather``) with every variant's time
        in turns; ``previous_ms`` is the float32 kernel's time, in turns
        with it."""
        return {"name": name, "route": "cuda", "source": "beat_tpu_torch/csrc/gfstack.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "library_with_scatter_ms": r["library_with_scatter_ms"],
                "previous_ms": r["float32_ms"], "variant": r["variant"],
                "variants_ms": r["variants_ms"], "variants_max_abs_err": r["variants_max_abs_err"],
                "worst_err_over_bar": r["worst_err_over_bar"],
                "group_cells": r.get("group_cells"),
                "loss_vs_float32": r["loss_vs_float32"], "library_bytes": r["library_bytes"],
                "launches_by_path": launches_by_path}

    def contract_entry(key, name, replaces, launches):
        main, rnd = contract["main_path"], contract["random"]
        r = main[key]
        return {"name": name, "route": "cuda", "source": "beat_tpu_torch/csrc/bilgather.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "previous_ms": r["previous_ms"],
                "table_rows_read": main["table_rows_read"], "groups": main["groups"][key],
                "random_queries": rnd[key], "launches_by_path": by_path(key + "_launches")}

    k1c_entry = contract_entry("k1c", "bilinear_contract", "beat_tpu/ops/bilgather.py:47",
                               smc_launches["k1c_launches"])
    k1c_entry["launches_by_path"].update(
        joint_llk=joint[f"joint_llk_{N_CHAINS}"]["k1c_launches"],
        pt_joint=joint["pt_joint"]["k1c_launches"],
        polarity_llk=polarity["polarity_llk"]["k1c_launches"],
        polarity_smc=polarity["polarity_smc"]["k1c_launches"],
        layered_smc=builders["layered_smc"]["k1c_launches"],
        project=builders["project"]["k1c_launches"],
        project_seis_derivative=builders["project_seis_derivative"]["k1c_launches"],
        project_seis_derivative_jvp=builders["project_seis_derivative"]["k1c_jvp_launches"],
        **{f"cli_{cmd}": n["k1c"] for cmd, n in builders["cli"].items()})
    k1c_entry["launches_by_path"].update(
        {f"parallel_smc_rank{r}": n
         for r, n in enumerate(runtime["parallel_smc"]["k1c_launches"])},
        parallel_nccl=runtime["parallel_nccl"]["k1c_launches"])
    k2c_entry = contract_entry("k2c", "contract_corner_dot", "beat_tpu/ops/bilgather.py:154",
                               mala_launches["k2c_launches"])
    k2c_entry["launches_by_path"].update(
        {f"cli_{cmd}": n["k2c"] for cmd, n in builders["cli"].items()})
    k1c_entry["finite_layouts"] = {k: {f: v for f, v in r.items() if f != "shape"}
                                   for k, r in layouts.items()}
    k1c_entry["finite_layout_kept"] = kept

    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [
        {"name": "bilinear_rows", "route": "cuda", "source": "beat_tpu_torch/csrc/bilgather.cu",
         "replaces": "beat_tpu/ops/bilgather.py:47", "launches": smc_launches["k1_launches"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib_ms, "launches_by_path": by_path("k1_launches"),
         "unfused_yardstick_launches": gather_launches[0]},
        {"name": "corner_dot", "route": "cuda", "source": "beat_tpu_torch/csrc/bilgather.cu",
         "replaces": "beat_tpu/ops/bilgather.py:154", "launches": mala_launches["k2_launches"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms, "launches_by_path": by_path("k2_launches"),
         "unfused_yardstick_launches": gather_launches[1]},
        k1c_entry,
        k2c_entry,
        {"name": "gf_stack_multilinear", "route": "cuda",
         "source": "beat_tpu_torch/csrc/gfstack.cu", "replaces": "beat_tpu/ops/gfstack.py:241",
         "launches": ffi_launches, "max_abs_err": real["k3"]["max_abs_err"],
         "ms": real["k3"]["ms"], "plain_ms": real["k3"]["plain_ms"],
         "bound_ms": real["k3"]["bound_ms"], "bound_by": real["k3"]["bound_by"],
         "library_ms": real["k3"]["library_ms"],
         "library_with_scatter_ms": real["k3"]["library_with_scatter_ms"],
         "variant": real["k3"]["variant"],
         "previous_ms": real["k3"]["previous_ms"], "shared_onsets": shared,
         "bench_shape": bench["k3"],
         "launches_by_path": {"ffi_smc": ffi_launches,
                              "ffi_recover": recover["multilinear"]["launches"][0],
                              **{f"parallel_ffi_llk_rank{r}": n
                                 for r, n in enumerate(parallel_ffi["k3_launches"])}}},
        bf16_entry(extras["k3_bf16"], "gf_stack_multilinear_bf16", "beat_tpu/ops/gfstack.py:241",
                   extras["ffi_smc_bf16"]["k3_bf16_launches"],
                   {"ffi_smc_bf16": extras["ffi_smc_bf16"]["k3_bf16_launches"],
                    "ffi_smc_bf16_mma": extras["ffi_smc_bf16"]["mma_launches"],
                    "ffi_llk_bf16": extras["k3_bf16"]["launches"],
                    "ffi_llk_bf16_mma": extras["k3_bf16"]["mma_launches"]}),
        {"name": "gf_stack_nearest", "route": "cuda",
         "source": "beat_tpu_torch/csrc/gfstack.cu", "replaces": "beat_tpu/ops/gfstack.py:218",
         "launches": k4_launches, "max_abs_err": real["k4"]["max_abs_err"],
         "ms": real["k4"]["ms"], "plain_ms": real["k4"]["plain_ms"],
         "bound_ms": real["k4"]["bound_ms"], "bound_by": real["k4"]["bound_by"],
         "library_ms": real["k4"]["library_ms"],
         "library_with_scatter_ms": real["k4"]["library_with_scatter_ms"],
         "variant": real["k4"]["variant"],
         "previous_ms": real["k4"]["previous_ms"], "bench_shape": bench["k4"],
         "launches_by_path": {"ffi_recover_nearest_neighbor": k4_launches}},
        bf16_entry(extras["k4_bf16"], "gf_stack_nearest_bf16", "beat_tpu/ops/gfstack.py:218",
                   extras["k4_bf16"]["launches"],
                   {"ffi_llk_bf16": extras["k4_bf16"]["launches"]}),
        {"name": "gather_rows", "route": "cuda", "source": "beat_tpu_torch/csrc/rowgather.cu",
         "replaces": "beat_tpu/ops/rowgather.py:34", "launches": k5_launches["ffi_smc"],
         "max_abs_err": 0.0, "ms": k5["smc"]["ms"], "plain_ms": k5["smc"]["plain_ms"],
         "bound_ms": k5["smc"]["bound_ms"], "bound_by": k5["smc"]["bound_by"],
         "library_ms": k5["smc"]["library_ms"], "variant": "flat", "previous_ms": None,
         "device_ms": k5["smc"]["device_ms"],
         "library_device_ms": k5["smc"]["library_device_ms"],
         "device_kernels_per_call": k5["smc"]["device_kernels_per_call"],
         "table_shape": k5["table"],
         "launches_by_path": k5_launches}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
