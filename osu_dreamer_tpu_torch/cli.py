"""The port's command line (``python -m osu_dreamer_tpu_torch <command>``).

Counterpart of osu_dreamer_tpu/cli/commands.py for the commands ported so
far: ``fit-latent``, ``encode-latents`` and ``fit-denoiser``. argparse keeps
the port free of click.
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
    from .models.diffusion.fit import CONFIG as DENOISER_CONFIG
    from .models.latent.fit import CONFIG as LATENT_CONFIG

    parser = argparse.ArgumentParser(prog="osu_dreamer_tpu_torch")
    commands = parser.add_subparsers(dest="command", required=True)
    device_help = "torch device (default cuda; the CPU only when asked for)"
    for name, config, text in (("fit-latent", LATENT_CONFIG, "train the stage-1 chart autoencoder"),
                               ("fit-denoiser", DENOISER_CONFIG,
                                "train the stage-2 latent denoiser")):
        cmd = commands.add_parser(name, help=text)
        cmd.add_argument("-c", "--config", type=_existing, default=config,
                         help="training config file")
        cmd.add_argument("--ckpt-path", type=_existing, default=None,
                         help="checkpoint to resume from")
        cmd.add_argument("--device", default="cuda", help=device_help)
    encode = commands.add_parser(
        "encode-latents", help="cache the latent encodings (h, z, s, labels) for stages 2 and 3")
    encode.add_argument("--latent-ckpt-path", type=_existing, default=Path("runs/latent/best"),
                        help="fit-latent checkpoint directory")
    encode.add_argument("--data-dir", type=_existing, default=Path("./data"),
                        help="pre-processed dataset directory")
    encode.add_argument("--force", action="store_true", help="overwrite existing cached latents")
    encode.add_argument("--device", default="cuda", help=device_help)
    args = parser.parse_args(argv)

    if args.command == "encode-latents":
        from .models.latent.encode import encode_latents

        n = encode_latents(args.latent_ckpt_path, args.data_dir, args.force, args.device)
        print(f"encoded {n} maps")
        return
    if args.command == "fit-latent":
        from .models.latent.fit import run
    else:
        from .models.diffusion.fit import run
    run(args.config, str(args.ckpt_path) if args.ckpt_path else None, args.device)
