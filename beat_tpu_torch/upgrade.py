"""
Config-file schema migration between format versions (copied from
``beat_tpu/upgrade.py``): each migration step is a pure function on the
raw YAML dict (rename / drop / set-default transformers);
``upgrade_config_file`` applies every step between the file's stamped
version and the current format and returns a unified diff
(``beat-tpu-torch update``).

A config is stamped with :data:`CONFIG_FORMAT_VERSION`, the config-file
format both packages read and write — not the port's package version:
the JAX package refuses a config stamped older than its own release.
"""

from __future__ import annotations

import difflib
import logging
import os

logger = logging.getLogger("beat_tpu_torch.upgrade")

#: the config-file format (the JAX package's release that defined it)
CONFIG_FORMAT_VERSION = "0.2.0"


# -- transformers ------------------------------------------------------------


def rename_attribute(d: dict, path: str, old: str, new: str) -> None:
    node = _walk(d, path)
    if node is not None and old in node:
        node[new] = node.pop(old)


def remove_attribute(d: dict, path: str, name: str) -> None:
    node = _walk(d, path)
    if node is not None:
        node.pop(name, None)


def set_attribute(d: dict, path: str, name: str, value) -> None:
    node = _walk(d, path)
    if node is not None and name not in node:
        node[name] = value


def _walk(d: dict, path: str):
    node = d
    for key in [p for p in path.split(".") if p]:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


# -- migrations --------------------------------------------------------------

def _migrate_0_1_0(d: dict) -> None:
    """0.1.0 -> 0.2.0: WaveformFitConfig.distances became *active*
    station weeding (it was an inert placeholder before); configs dumped
    with the old default [30.0, 90.0] deg must not suddenly weed all
    regional stations."""
    sc = _walk(d, "seismic_config")
    for wfc in (sc or {}).get("waveforms", []) or []:
        if isinstance(wfc, dict) and wfc.get("distances") == [30.0, 90.0]:
            wfc["distances"] = None
    # geodetic_config.types likewise became an active dataset filter in
    # 0.2.0; the old dumped default ['SAR'] was inert, so rewriting it to
    # the new all-types default keeps GNSS datasets loading
    gc = _walk(d, "geodetic_config")
    if gc and gc.get("types") == ["SAR"]:
        gc["types"] = ["SAR", "GNSS"]


#: ordered migrations: (from_version, migrate_fn)
MIGRATIONS: list = [
    ("0.1.0", _migrate_0_1_0),
]


def _version_tuple(v: str) -> tuple:
    return tuple(int(x) for x in v.split(".")[:3])


def upgrade_config_dict(d: dict) -> dict:
    """Apply all migrations newer than the dict's stamped version and
    stamp it with :data:`CONFIG_FORMAT_VERSION`."""
    version = d.get("version") or "0.0.0"
    for from_version, migrate in MIGRATIONS:
        if _version_tuple(version) <= _version_tuple(from_version):
            migrate(d)
    d["version"] = CONFIG_FORMAT_VERSION
    return d


def upgrade_config_file(project_dir: str, mode: str = "geometry", apply: bool = True) -> str:
    """Migrate a project config in place; returns the unified diff."""
    import yaml

    from beat_tpu_torch.config import config_file_name

    path = os.path.join(project_dir, config_file_name(mode))
    with open(path) as f:
        old_text = f.read()
    upgraded = upgrade_config_dict(yaml.safe_load(old_text))
    new_text = yaml.safe_dump(upgraded, sort_keys=False)
    diff = "\n".join(difflib.unified_diff(
        old_text.splitlines(), new_text.splitlines(),
        fromfile=path, tofile=path + " (upgraded)", lineterm=""))
    if diff:
        logger.info("Config changes:\n%s", diff)
    if apply:
        with open(path, "w") as f:
            f.write(new_text)
    return diff


def check_config_version(stamped: str | None, path: str, project_dir: str) -> None:
    """Refuse a config stamped by an older format (it must be migrated
    first with ``update``)."""
    stamped = stamped or "0.0.0"
    if _version_tuple(stamped) < _version_tuple(CONFIG_FORMAT_VERSION):
        raise ValueError(f"Config {path} was written by version {stamped} (current "
                         f"{CONFIG_FORMAT_VERSION}) — run 'beat-tpu update {project_dir}' "
                         "to migrate it")
