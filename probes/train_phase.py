"""``chip_smoke.train_phase`` alone on the card: the model stack's
training half (granite-3-2b whole through the trainer's step, the card
against the CPU port, ``run_training``'s checkpoints at mamba2-130m),
without building or driving the kernels. Prints the card's name and
power limit, the phase's log and its JSON object; with ``--codec`` it
first times the storage codecs on this host (one core, random-normal
float32, level 1 as the checkpoint store writes).

    python3 probes/train_phase.py [--codec]
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import ext  # noqa: E402
from repro_torch.storage import compression  # noqa: E402


def codec_rates(nbytes: int = 256 << 20) -> dict:
    """MB/s of compress (level 1) and decompress for each codec this
    host has, on ``nbytes`` of random-normal float32."""
    data = np.random.default_rng(0).normal(
        size=nbytes // 4).astype(np.float32).tobytes()
    out = {"have_zstd": compression.HAVE_ZSTD}
    for codec in compression.CODECS:
        if codec == "zstd" and not compression.HAVE_ZSTD:
            continue
        t0 = time.perf_counter()
        comp = compression.compress(data, codec, level=1)
        t1 = time.perf_counter()
        back = compression.decompress(comp, codec, max_output_size=nbytes)
        t2 = time.perf_counter()
        assert back == data
        out[codec] = {"compress_mb_s": nbytes / (t1 - t0) / 1e6,
                      "decompress_mb_s": nbytes / (t2 - t1) / 1e6,
                      "ratio": len(comp) / nbytes}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if "--codec" in sys.argv[1:]:
        print(json.dumps({"codec": codec_rates()}), flush=True)
    t0 = time.perf_counter()
    train = chip_smoke.train_phase(torch, ext, torch.device("cuda", 0), smi)
    print(json.dumps({"train": train}))
    print(f"done {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
