"""``chip_smoke.mesh_phase`` alone on the card: the model stack over a
one-card ``DeviceMesh`` (granite-3-2b whole served and one full-width
train step against the port without a mesh, the ten reduced configs,
a checkpoint round trip of a sharded training state, and the 2×2 card
mesh where the machine has four cards), without
building or driving the kernels. Prints the card's name and power
limit, the phase's log and its JSON object.

    python3 probes/mesh_phase.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import ext  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    mesh = chip_smoke.mesh_phase(torch, ext, torch.device("cuda", 0), smi)
    print(json.dumps({"mesh": mesh}))
    print(f"done {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
