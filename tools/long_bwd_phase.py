#!/usr/bin/env python3
"""chip_smoke.py's phase 1g alone: the long attention backward at every head
dim and length it checks, timed beside the plain version, SDPA's backward
and (to head dim 128) the two-launch design, then split by launch:

    python3 tools/long_bwd_phase.py

from the root of a checkout, on a machine with one CUDA card and nvcc. It
builds the kernels as chip_smoke.py does and first prints the card's name
and power limit and ptxas's lines for csrc/long_attention_bwd.cu (its
registers, spills and any wgmma serialisation note).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("long_bwd_phase: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from osu_dreamer_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    smoke.log(smi)
    path, seconds = _build.build()
    smoke.log(f"kernels built in {seconds:.1f} s: {path.name}")
    log = (_build.BUILD_DIR / "build.log").read_text().split("== long_attention_bwd.cu")
    if len(log) > 1:
        smoke.log("ptxas, csrc/long_attention_bwd.cu:\n" + "\n".join(
            line for line in log[1].split("\n== ")[0].splitlines()
            if "(C75" in line or "Used" in line or "spill" in line or "Compiling entry" in line))
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    smoke.long_bwd_kernels(gen, dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
