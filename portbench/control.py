"""The lower-precision control: the reference put in the program's place,
computed in bfloat16 where the configuration states float32 and with each
step's statistics committed as a bfloat16 product, then judged as a run
of the program is. It has to come out as not correct.

    python3 -m portbench.control --workload mesh10k.uniform \\
        --seeds 11,12,13 --rounds 1000

runs at the cell's own width for ``--rounds`` rounds (a run's warm-up
rounds included) and prints one JSON line a seed with the number compared
and its limit. It needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Optional

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import judge, spec  # noqa: E402
from portbench.generator import Traffic  # noqa: E402
from portbench.run import T0_MS  # noqa: E402


def control_reading(workload: str, seed: int, rounds: int,
                    width: Optional[int] = None) -> Dict:
    bench = spec.load_benchmark()
    cell = spec.cell(bench, workload)
    cfg = spec.load_config(cell["config"])
    mix = spec.load_traffic(cell["traffic"])
    traffic = Traffic(mix, cfg["resources"], seed, width=width)
    control = judge.Replay(cfg, traffic, T0_MS, lowered=True)
    verdicts, waits = control.verdicts(rounds)
    reference = judge.Replay(cfg, traffic, T0_MS)
    reference.run(rounds, verdicts, waits)
    snap = control.model.snapshot()
    snap["outside"] = 0
    parts = judge.compare(snap, reference.model.snapshot(), ring_seconds=128)
    parts["verdicts"] = reference.verdicts_differ
    return {"workload": workload, "seed": seed, "rounds": rounds,
            "width": traffic.width, "mismatches": sum(parts.values()),
            "limit": judge.LIMIT, "parts": parts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rounds", type=int, required=True)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(control_reading(args.workload, int(s), args.rounds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
