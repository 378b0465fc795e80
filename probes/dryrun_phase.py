"""``chip_smoke.dryrun_phase`` alone on the card: TPC-H planned at SF 1
through a session on the card with no worker invoked, every
(arch × shape × mesh) cell traced at full width on ``meta`` (in worker
processes that see no card), and one real step of each cell that the
dry run says fits the card, without building or driving the kernels.
Prints the card's name and power limit, the phase's log and its JSON
object, and writes every record to ``chiprun_out/dryrun_records.jsonl``.

    python3 probes/dryrun_phase.py [--sf SF]
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
from repro_torch.api import connect  # noqa: E402
from repro_torch.kernels import ext  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("dryrun_phase: no CUDA device", file=sys.stderr)
        return 2
    sf = float(sys.argv[sys.argv.index("--sf") + 1]) \
        if "--sf" in sys.argv else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    session = connect(quota=8)
    try:
        session.ensure_tpch(sf=sf)
        print(f"ensure_tpch(sf={sf}): {time.perf_counter() - t0:.1f} s",
              flush=True)
        dry = chip_smoke.dryrun_phase(
            torch, ext, torch.device("cuda", 0), smi, session, sf=sf,
            out=str(out / "dryrun_records.jsonl"))
    finally:
        session.close()
    print(json.dumps({"dryrun": dry}))
    print(f"done {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
