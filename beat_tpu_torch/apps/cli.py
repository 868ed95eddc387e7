"""
``beat-tpu-torch`` command line interface (copied from
``beat_tpu/apps/cli.py``; reference ``beat/apps/beat.py``): the same
subcommands (init, import, update, clone, build_gfs, sample, map,
summarize, export, plot, check) with the same options, and
``completions``::

    python -m beat_tpu_torch.apps.cli <command> <project_dir> [options]

The device is resolved once, from ``BEAT_TPU_PLATFORM``: unset (or
``cuda``) means the card, ``cpu`` the CPU; any other value is refused.
Without a card and without ``BEAT_TPU_PLATFORM=cpu`` a command exits 1
with the device's error: nothing falls back to the CPU.

Under ``torchrun --nproc_per_node N`` (``WORLD_SIZE > 1``) the process
joins the process group first, so rank r resolves ``cuda`` to its own
card ``cuda:r`` (gloo ranks on the CPU with ``BEAT_TPU_PLATFORM=cpu``),
and ``sample`` shards the chains over the ranks.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

logger = logging.getLogger("beat_tpu_torch.cli")

SUBCOMMANDS = [
    "init", "import", "update", "clone", "build_gfs",
    "sample", "map", "summarize", "export", "plot", "check",
]

#: the values ``BEAT_TPU_PLATFORM`` may take: the device types they name
PLATFORMS = ("cuda", "cpu")


def platform_name() -> str:
    """The device type ``BEAT_TPU_PLATFORM`` names (``cuda`` when unset)."""
    platform = os.environ.get("BEAT_TPU_PLATFORM", "") or "cuda"
    if platform not in PLATFORMS:
        raise ValueError(f"BEAT_TPU_PLATFORM={platform!r} is not one of "
                         f"{sorted(PLATFORMS)}")
    return platform


def platform_device():
    """The device ``BEAT_TPU_PLATFORM`` names, resolved: raises when it
    names a card and there is none."""
    from beat_tpu_torch.device import resolve

    return resolve(platform_name())


class _VersionAction(argparse.Action):
    def __call__(self, parser, *a, **kw):
        from beat_tpu_torch.info import runtime_info

        try:
            device = platform_device()
        except (RuntimeError, ValueError) as e:
            print(runtime_info())
            print(f"device: {e}")
        else:
            print(runtime_info(device))
        parser.exit(0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="beat-tpu-torch",
        description="Bayesian earthquake-source inversion on PyTorch (the card by default)",
    )
    parser.add_argument("--version", nargs=0, action=_VersionAction,
                        help="framework + backend versions")
    sub = parser.add_subparsers(dest="command")

    from beat_tpu_torch.apps import commands

    for name in SUBCOMMANDS:
        register = getattr(commands, f"register_{name}", None)
        if register is not None:
            register(sub)
    p = sub.add_parser("completions", help="print the bash completion script")
    p.set_defaults(handler=_cmd_completions)
    return parser


def _cmd_completions(args) -> int:
    from beat_tpu_torch.apps.completion import completion_script

    print(completion_script())
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    handler = getattr(args, "handler", None)
    if handler is None:
        parser.error(f"subcommand {args.command} not yet implemented")
    logging.basicConfig(level=logging.INFO)
    # under torchrun, join the process group before the device is resolved
    joined = args.command != "completions" and int(os.environ.get("WORLD_SIZE", "1")) > 1
    try:
        return _run(handler, args, joined)
    finally:
        if joined:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def _run(handler, args, join: bool) -> int:
    try:
        if join:
            from beat_tpu_torch.parallel import init_distributed

            init_distributed(device=platform_name())
        if args.command != "completions":
            args.device = platform_device()
    except (RuntimeError, ValueError) as e:
        print(f"beat-tpu-torch {args.command}: {e}", file=sys.stderr)
        return 1
    try:
        return handler(args) or 0
    except (FileNotFoundError, ValueError, NotImplementedError) as e:
        print(f"beat-tpu-torch {args.command}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
