"""
The version gate of project configs (copied from ``beat_tpu/upgrade.py``,
trimmed to the version comparison; the migrations stay with the JAX
package's ``beat-tpu update``).

A config is stamped with :data:`CONFIG_FORMAT_VERSION`, the config-file
format both packages read and write — not the port's package version:
the JAX package refuses a config stamped older than its own release.
"""

from __future__ import annotations

#: the config-file format (the JAX package's release that defined it)
CONFIG_FORMAT_VERSION = "0.2.0"


def _version_tuple(v: str) -> tuple:
    return tuple(int(x) for x in v.split(".")[:3])


def check_config_version(stamped: str | None, path: str, project_dir: str) -> None:
    """Refuse a config stamped by an older format (it must be migrated
    first with the JAX package's ``beat-tpu update``)."""
    stamped = stamped or "0.0.0"
    if _version_tuple(stamped) < _version_tuple(CONFIG_FORMAT_VERSION):
        raise ValueError(f"Config {path} was written by version {stamped} (current "
                         f"{CONFIG_FORMAT_VERSION}) — run 'beat-tpu update {project_dir}' "
                         "to migrate it")
