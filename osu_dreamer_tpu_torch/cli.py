"""The port's command line (``python -m osu_dreamer_tpu_torch <command>``).

Counterpart of osu_dreamer_tpu/cli/commands.py for the commands ported so
far: ``fit-denoiser``. argparse keeps the port free of click.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def _existing(path: str) -> Path:
    p = Path(path)
    if not p.exists():
        raise argparse.ArgumentTypeError(f"{path} does not exist")
    return p


def main(argv: list[str] | None = None) -> None:
    from .models.diffusion.fit import CONFIG

    parser = argparse.ArgumentParser(prog="osu_dreamer_tpu_torch")
    commands = parser.add_subparsers(dest="command", required=True)
    fit_denoiser = commands.add_parser("fit-denoiser", help="train the stage-2 latent denoiser")
    fit_denoiser.add_argument("-c", "--config", type=_existing, default=CONFIG,
                              help="training config file")
    fit_denoiser.add_argument("--ckpt-path", type=_existing, default=None,
                              help="checkpoint to resume from")
    fit_denoiser.add_argument("--device", default="cuda",
                              help="torch device (default cuda; the CPU only when asked for)")
    args = parser.parse_args(argv)

    if args.command == "fit-denoiser":
        from .models.diffusion.fit import run

        run(args.config, str(args.ckpt_path) if args.ckpt_path else None, args.device)
