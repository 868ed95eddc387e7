"""
The port's command line (``beat_tpu_torch.apps``) against the JAX
package's (``beat_tpu.apps``):

* the parsers: the same subcommands, and for each the same options with
  the same defaults;
* the device: ``BEAT_TPU_PLATFORM`` unset means the card — without one a
  command exits 1 with the device's error, nothing falls back to the
  CPU — ``cpu`` the CPU, anything else is refused;
* the seismic lifecycle of ``tests/test_config_cli.py:90-160`` (a DC
  source, 48 chains × 30 steps), run by the port's CLI in a subprocess
  that never imports ``jax`` nor ``beat_tpu`` (init → build_gfs → check →
  sample with ``--profile`` → summarize → export → map → plot):
  ``build_gfs``'s table equals
  the JAX CLI's, built on a copy of the same project, within
  ``tests/test_torch_gftable.py``'s bar; the JAX CLI's ``summarize`` of
  the port's stage files writes the port's ``summary.txt``; the posterior
  meets that test's tolerances;
* ffi mode: ``build_gfs`` writes ``fault_geometry.pkl`` and the geodetic
  library; the JAX package's ``load_model`` reads the port's pickle, both
  packages' CLIs write the same fault and library, and the two problems'
  llks agree at the project bar (rtol 2e-5);
* ``update``: the migrated config equal to the JAX CLI's; ``clone`` to
  another mode equal to the JAX CLI's; ``completions``.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from test_torch_common import THREADS

REPO = Path(__file__).resolve().parent.parent

GF_CONFIG = dict(distance_min=20e3, distance_max=100e3, n_distances=6, depth_min=2e3,
                 depth_max=15e3, n_depths=4, nt=256, dt=0.25)
PLOTS = "stage_posteriors,waveform_fits,hudson,fuzzy_beachball"

LIFECYCLE = """
import os, shutil, sys
import numpy as np
import torch
from beat_tpu_torch.apps.cli import main
from beat_tpu_torch.config import dump_config, load_config
from beat_tpu_torch.heart.gftable import build_homogeneous_table
from beat_tpu_torch.heart.seismic import SeismicDataset
from beat_tpu_torch.inputf import save_seismic_datasets
from beat_tpu_torch.sources import magnitude_to_moment, sdr_to_m6

pdir, gf = sys.argv[1], eval(sys.argv[2])
def run(*argv):
    assert main(list(argv)) == 0, argv
run("init", "seisproj", pdir, "--datatypes", "seismic", "--source_types", "DCSource")
config = load_config(pdir)
config.seismic_config.gf_config = gf
wfc = config.seismic_config.waveforms[0]
wfc.arrival_taper.a, wfc.arrival_taper.b = -3.0, -1.5
wfc.arrival_taper.c, wfc.arrival_taper.d = 15.0, 18.0
wfc.filterer.lower_corner, wfc.filterer.upper_corner = 0.02, 0.5
config.sampler_config.parameters = {"n_chains": 48, "n_steps": 30, "seed": 2}
P = config.problem_config.priors
for name in list(P):
    if name not in ("strike", "dip", "rake", "magnitude"):
        del P[name]
P["strike"].update(lower=[0.0], upper=[90.0], testvalue=[40.0])
P["dip"].update(lower=[30.0], upper=[80.0], testvalue=[55.0])
P["rake"].update(lower=[-40.0], upper=[60.0], testvalue=[20.0])
P["magnitude"].update(lower=[5.0], upper=[6.5], testvalue=[5.8])
dump_config(config, pdir)
# synthetic data from the table the CLI will build (the port's writers)
table = build_homogeneous_table(np.linspace(20e3, 100e3, 6), np.linspace(2e3, 15e3, 4),
                                nt=256, dt=0.25, device="cpu")
rng = np.random.default_rng(0)
az = np.linspace(0, 2 * np.pi, 5, endpoint=False) + 0.2
dist = rng.uniform(40e3, 90e3, 5)
st_e, st_n = dist * np.sin(az), dist * np.cos(az)
f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
m6 = sdr_to_m6(f32(40.0), f32(55.0), f32(20.0), magnitude_to_moment(f32(5.8)))
spec = table.synthesize_spectra(m6[None], f32([0.0]), f32([0.0]), f32([10000.0]), f32([0.0]),
                                f32([1.0]), f32(st_e), f32(st_n), torch.zeros(5, dtype=torch.int64))
raw = table.to_time_domain(spec)[0].double().numpy()
raw = raw + rng.normal(0, 0.02 * np.abs(raw).max(), raw.shape)
save_seismic_datasets([SeismicDataset(station=f"S{i}", channel="Z", east=st_e[i],
                                      north=st_n[i], ydata=raw[i]) for i in range(5)], pdir)
shutil.copytree(pdir, pdir + "_jax")      # the JAX CLI's build_gfs runs on this copy
run("build_gfs", pdir, "--mode", "geometry", "--datatypes", "seismic")
run("check", pdir, "--what", "stores")
run("check", pdir, "--what", "geometry")
run("sample", pdir, "--profile", os.path.join(pdir, "profile"))
run("summarize", pdir)
run("export", pdir)
run("map", pdir, "--n_restarts", "4", "--n_steps", "20")
run("plot", pdir, sys.argv[3])
run("check", pdir)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
jax_package = sorted(m for m in sys.modules if m == "beat_tpu" or m.startswith("beat_tpu."))
assert not jax_package, jax_package
print("OK")
"""


def port_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "BEAT_TPU_PLATFORM"}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=str(THREADS),
               BEAT_TPU_PLATFORM="cpu")
    env.update(extra)
    return env


def run_port(*argv, platform="cpu"):
    """The port's ``main`` in this process with ``BEAT_TPU_PLATFORM``
    set as given (``None``: unset)."""
    from beat_tpu_torch.apps.cli import main

    old = os.environ.pop("BEAT_TPU_PLATFORM", None)
    if platform is not None:
        os.environ["BEAT_TPU_PLATFORM"] = platform
    try:
        return main(list(argv))
    finally:
        os.environ.pop("BEAT_TPU_PLATFORM", None)
        if old is not None:
            os.environ["BEAT_TPU_PLATFORM"] = old


def run_jax(*argv):
    from beat_tpu.apps.cli import main

    return main(list(argv))


# ---------------------------------------------------------------------------
# the parsers
# ---------------------------------------------------------------------------


def _subcommands(parser) -> dict:
    """{subcommand: {dest: (option strings, default, choices, nargs)}}."""
    sub = parser._subparsers._group_actions[0]
    return {name: {a.dest: (tuple(a.option_strings), a.default,
                            tuple(a.choices) if a.choices else None, a.nargs)
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


def test_parsers_have_the_same_subcommands_options_and_defaults():
    from beat_tpu.apps import cli as jcli
    from beat_tpu_torch.apps import cli as pcli

    assert pcli.SUBCOMMANDS == jcli.SUBCOMMANDS
    got, want = _subcommands(pcli.build_parser()), _subcommands(jcli.build_parser())
    assert sorted(got) == sorted(want) == sorted(jcli.SUBCOMMANDS + ["completions"])
    for name in want:
        assert got[name] == want[name], name


def test_completion_script_names_every_subcommand_and_flag():
    from beat_tpu_torch.apps.completion import completion_script

    script = completion_script()
    assert "complete -F _beat_tpu_torch beat-tpu-torch" in script
    for word in ("build_gfs", "summarize", "completions", "--n_restarts", "--seismic_tracestore",
                 "MTSource", "RectangularSource"):
        assert word in script
    assert run_port("completions") == 0


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------


def test_the_card_is_the_default_and_nothing_falls_back(tmp_path, capsys):
    pdir = str(tmp_path / "p")
    assert run_port("init", "p", pdir, "--datatypes", "geodetic") == 0
    assert run_port("check", pdir, "--what", "stores", platform="tpu") == 1
    assert "BEAT_TPU_PLATFORM='tpu'" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    assert run_port("check", pdir, platform=None) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert run_port("init", "q", str(tmp_path / "q"), platform=None) == 1
    assert not os.path.exists(tmp_path / "q")


def test_version_names_torch_and_the_device(capsys):
    from beat_tpu_torch.apps.cli import build_parser

    os.environ["BEAT_TPU_PLATFORM"] = "cpu"
    try:
        with pytest.raises(SystemExit) as e:
            build_parser().parse_args(["--version"])
    finally:
        del os.environ["BEAT_TPU_PLATFORM"]
    out = capsys.readouterr().out
    assert e.value.code == 0 and f"torch {torch.__version__}" in out and "device cpu" in out


# ---------------------------------------------------------------------------
# the seismic lifecycle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    """The port's CLI lifecycle in a subprocess without JAX, then the JAX
    CLI's ``build_gfs`` on the copy made before the port's and its
    ``summarize`` of the port's stage files."""
    root = tmp_path_factory.mktemp("lifecycle")
    pdir = str(root / "seisproj")
    proc = subprocess.run([sys.executable, "-c", LIFECYCLE, pdir, repr(GF_CONFIG), PLOTS],
                          cwd=root, env=port_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
    (root / "stdout.txt").write_text(proc.stdout)
    jdir = pdir + "_jax"
    assert run_jax("build_gfs", jdir, "--mode", "geometry", "--datatypes", "seismic") == 0
    os.makedirs(os.path.join(jdir, "geometry"))
    for name in os.listdir(os.path.join(pdir, "geometry")):
        if name.startswith("stage_"):
            shutil.copytree(os.path.join(pdir, "geometry", name),
                            os.path.join(jdir, "geometry", name))
    assert run_jax("summarize", jdir) == 0
    return pdir, jdir


def test_build_gfs_table_equals_the_jax_cli(lifecycle):
    pdir, jdir = lifecycle
    with np.load(os.path.join(pdir, "gf_table.npz")) as got, \
            np.load(os.path.join(jdir, "gf_table.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            ref = want[key]
            # the gathered spectra's bar (tests/test_torch_gftable.py)
            np.testing.assert_allclose(got[key], ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=key)


def test_summarize_writes_what_the_jax_cli_writes(lifecycle):
    pdir, jdir = lifecycle
    with open(os.path.join(pdir, "geometry", "summary.txt")) as f:
        got = json.load(f)
    with open(os.path.join(jdir, "geometry", "summary.txt")) as f:
        want = json.load(f)
    assert got == want


def test_lifecycle_recovers_the_mechanism(lifecycle):
    """The tolerances of ``tests/test_config_cli.py``'s CLI lifecycle."""
    pdir, _ = lifecycle
    with open(os.path.join(pdir, "geometry", "summary.txt")) as f:
        summary = json.load(f)
    assert abs(summary["strike"]["mean"] - 40.0) < 12.0
    assert abs(summary["magnitude"]["mean"] - 5.8) < 0.15


def test_lifecycle_outputs(lifecycle):
    """``export``'s synthetics and solution, ``map``'s estimate and the
    plots, where the JAX CLI writes them."""
    pdir, _ = lifecycle
    out = os.path.join(pdir, "geometry")
    with np.load(os.path.join(out, "export.npz")) as z:
        assert z["synth:seismic:any_P_0"].shape == (5, 84)
        assert np.isfinite(z["stdz_res:seismic:any_P_0"]).all()
    with open(os.path.join(out, "solution_max.yaml")) as f:
        solution = yaml.safe_load(f)
    assert abs(solution["magnitude"] - 5.8) < 0.15
    with open(os.path.join(out, "map.json")) as f:
        est = json.load(f)
    assert abs(est["point"]["magnitude"][0] - 5.8) < 0.15 and np.isfinite(est["llk_map"])
    traces = os.listdir(os.path.join(pdir, "profile"))     # sample --profile: one a stage
    stages = [d for d in os.listdir(out) if d.startswith("stage_") and d != "stage_0"]
    assert len(traces) == len(stages) and all(t.startswith("trace_") for t in traces)
    with open(os.path.join(out, "timings.json")) as f:
        assert len(json.load(f)["stages"]) == len(stages)
    # sample --profile turns the spans on and prints them after the stage timings
    with open(os.path.join(os.path.dirname(pdir), "stdout.txt")) as f:
        printed = f.read()
    assert printed.index("smc_stage_-1") < printed.index("smc.sample")
    for name in ("smc.stage", "stage.write", "metropolis.step", "fullmt.idft", "stage.bytes"):
        assert name in printed, name
    for trace_file in traces:
        with open(os.path.join(pdir, "profile", trace_file)) as f:
            assert any(e.get("name") == "metropolis.step" for e in json.load(f)["traceEvents"])
    figures = set(os.listdir(os.path.join(out, "figures")))
    assert {"stage_posteriors.png", "waveform_fits_any_P_0.png", "hudson.png",
            "fuzzy_beachball.png"} <= figures


# ---------------------------------------------------------------------------
# ffi mode
# ---------------------------------------------------------------------------


def _ffi_project(pdir):
    """A geometry project with the reference fault fixed and an InSAR
    scene, and its ffi config."""
    from beat_tpu_torch.config import dump_config, load_config
    from test_torch_config import write_scene

    assert run_port("init", "sffi", pdir, "--datatypes", "geodetic") == 0
    write_scene(pdir)
    cfg = load_config(pdir)
    fixed = dict(east_shift=1.0, north_shift=0.0, depth=2.0, strike=15.0, dip=60.0, rake=90.0,
                 length=8.0, width=4.0)
    for name, v in fixed.items():
        cfg.problem_config.priors[name].update(lower=[v], upper=[v], testvalue=[v])
    dump_config(cfg, pdir)
    assert run_port("init", "sffi", pdir, "--mode", "ffi", "--datatypes", "geodetic") == 0


def test_ffi_build_gfs_writes_a_fault_both_packages_read(tmp_path):
    import beat_tpu.config as jcfg
    import beat_tpu.ffi.fault as jfault
    from beat_tpu.models import load_model as jax_load_model
    from beat_tpu_torch.config import load_fault_geometry
    from beat_tpu_torch.models import load_model
    from test_torch_config import jax_llks, port_llks

    pdir, jdir = str(tmp_path / "sffi"), str(tmp_path / "sffi_jax")
    _ffi_project(pdir)
    shutil.copytree(pdir, jdir)
    argv = ("--mode", "ffi", "--datatypes", "geodetic", "--patch_length", "2",
            "--patch_width", "2")
    assert run_port("build_gfs", pdir, *argv) == 0
    assert run_jax("build_gfs", jdir, *argv) == 0
    gfdir = os.path.join("ffi", "linear_gfs")
    port_path = os.path.join(pdir, gfdir, "fault_geometry.pkl")

    # the port's pickle names the JAX package's classes: its plain loader reads it
    import pickle

    with open(port_path, "rb") as f:
        jax_reads = pickle.load(f)
    assert isinstance(jax_reads, jfault.FaultGeometry)
    with open(os.path.join(jdir, gfdir, "fault_geometry.pkl"), "rb") as f:
        jax_wrote = pickle.load(f)
    assert jax_reads == jax_wrote
    port_reads = load_fault_geometry(port_path)
    assert port_reads.npatches == jax_wrote.npatches == 10
    for a, b in zip(port_reads.get_all_patches(), jax_wrote.get_all_patches()):
        assert a.to_dict() == b.to_dict()
    with np.load(os.path.join(pdir, gfdir, "geodetic_gfs.npz")) as got, \
            np.load(os.path.join(jdir, gfdir, "geodetic_gfs.npz")) as want:
        for key in want.files:
            ref = want[key]
            np.testing.assert_allclose(got[key], ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                       err_msg=key)

    # both packages' problems on the port's files
    jp = jax_load_model(pdir, "ffi")
    pp = load_model(pdir, "ffi", device="cpu")
    assert pp.priors.names == jp.priors.names
    lo, hi = jp.priors.bounds_arrays()
    Q = np.concatenate([jp.priors.test_array()[None],
                        np.random.default_rng(0).uniform(lo, hi, (2, lo.size))])
    want, got = jax_llks(jp, Q), port_llks(pp, Q)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert run_port("check", pdir, "--what", "discretization") == 0
    assert run_port("check", pdir, "--what", "library") == 0
    assert jcfg.load_config(pdir, "ffi").problem_config.mode == "ffi"


# ---------------------------------------------------------------------------
# update, clone
# ---------------------------------------------------------------------------


OLD_CONFIG = {"version": "0.1.0", "name": "old",
              "seismic_config": {"waveforms": [{"name": "any_P", "distances": [30.0, 90.0]},
                                               {"name": "any_S", "distances": [1.0, 20.0]}]},
              "geodetic_config": {"types": ["SAR"], "names": ["all"]}}


@pytest.mark.parametrize("stamp", ["0.1.0", "0.2.0", None])
def test_upgrade_config_dict_equals_the_jax_package(stamp):
    import copy

    from beat_tpu.upgrade import upgrade_config_dict as jax_upgrade
    from beat_tpu_torch.upgrade import rename_attribute, set_attribute, upgrade_config_dict

    d = copy.deepcopy(OLD_CONFIG)
    if stamp is None:
        del d["version"]
    else:
        d["version"] = stamp
    assert upgrade_config_dict(copy.deepcopy(d)) == jax_upgrade(copy.deepcopy(d))
    rename_attribute(d, "geodetic_config", "names", "dataset_names")
    set_attribute(d, "seismic_config", "station_corrections", False)
    set_attribute(d, "missing.path", "x", 1)
    assert d["geodetic_config"]["dataset_names"] == ["all"]
    assert d["seismic_config"]["station_corrections"] is False and "missing" not in d


def test_update_cli_migrates_as_the_jax_cli(tmp_path):
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    assert run_port("init", "p", pdir, "--datatypes", "seismic") == 0
    path = os.path.join(pdir, "config_geometry.yaml")
    with open(path) as f:
        d = yaml.safe_load(f)
    d["version"] = "0.1.0"
    d["seismic_config"]["waveforms"][0]["distances"] = [30.0, 90.0]
    with open(path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=False)
    shutil.copytree(pdir, jdir)
    assert run_port("update", pdir) == 0
    assert run_jax("update", jdir) == 0
    assert (open(path).read()
            == open(os.path.join(jdir, "config_geometry.yaml")).read())
    from beat_tpu_torch.config import load_config

    assert load_config(pdir).seismic_config.waveforms[0].distances is None


def test_clone_to_ffi_equals_the_jax_cli(tmp_path):
    src = str(tmp_path / "src")
    _ffi_project(src)
    assert run_port("clone", src, str(tmp_path / "pc"), "--new_mode", "ffi") == 0
    assert run_jax("clone", src, str(tmp_path / "jc"), "--new_mode", "ffi") == 0
    for name in ("config_geometry.yaml", "config_ffi.yaml", "geodetic_data.npz"):
        assert os.path.exists(tmp_path / "pc" / name)
    for name in ("config_geometry.yaml", "config_ffi.yaml"):
        got = yaml.safe_load(open(tmp_path / "pc" / name))
        want = yaml.safe_load(open(tmp_path / "jc" / name))
        got.pop("project_dir"), want.pop("project_dir")
        got.pop("name"), want.pop("name")
        assert got == want, name
