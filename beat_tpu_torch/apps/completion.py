"""
Bash completion for the ``beat-tpu-torch`` CLI (copied from
``beat_tpu/apps/completion.py``; reference ships ``extras/beat`` bash
completion).  ``beat-tpu-torch completions`` prints the script;
install with::

    beat-tpu-torch completions >> ~/.bashrc     # or /etc/bash_completion.d/
"""

from __future__ import annotations

TEMPLATE = """\
# bash completion for beat-tpu-torch
_beat_tpu_torch() {
    local cur prev subcommands
    COMPREPLY=()
    cur="${COMP_WORDS[COMP_CWORD]}"
    prev="${COMP_WORDS[COMP_CWORD-1]}"
    subcommands="%(subcommands)s"

    if [[ ${COMP_CWORD} -eq 1 ]]; then
        COMPREPLY=( $(compgen -W "${subcommands}" -- "${cur}") )
        return 0
    fi

    case "${prev}" in
        --mode) COMPREPLY=( $(compgen -W "geometry ffi bem" -- "${cur}") ); return 0 ;;
        --what) COMPREPLY=( $(compgen -W "traces stores library discretization geometry" -- "${cur}") ); return 0 ;;
        --sampler) COMPREPLY=( $(compgen -W "SMC PT Metropolis" -- "${cur}") ); return 0 ;;
        --datatypes) COMPREPLY=( $(compgen -W "geodetic seismic polarity" -- "${cur}") ); return 0 ;;
        --source_types) COMPREPLY=( $(compgen -W "%(sources)s" -- "${cur}") ); return 0 ;;
    esac

    if [[ ${cur} == -* ]]; then
        COMPREPLY=( $(compgen -W "%(flags)s" -- "${cur}") )
        return 0
    fi
    COMPREPLY=( $(compgen -f -- "${cur}") )
}
complete -F _beat_tpu_torch beat-tpu-torch
"""


def completion_script() -> str:
    from beat_tpu_torch.apps.cli import SUBCOMMANDS, build_parser
    from beat_tpu_torch.sources import source_catalog

    flags = set()
    parser = build_parser()
    for action in parser._subparsers._group_actions[0].choices.values():
        for act in action._actions:
            flags.update(o for o in act.option_strings if o.startswith("--"))
    return TEMPLATE % {
        "subcommands": " ".join(SUBCOMMANDS + ["completions"]),
        "sources": " ".join(sorted(source_catalog)),
        "flags": " ".join(sorted(flags)),
    }
