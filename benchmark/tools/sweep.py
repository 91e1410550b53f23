"""Run cells of the benchmark one after another, each run a process of
its own as the driver starts it, and keep every run's last line.

    python3 -m benchmark.tools.sweep OUT.json CELL:SEED:SECONDS:TRACE ...

Writes OUT.json ({"runs": [{cell, seed, seconds, trace, rc, wall_s,
result, stderr_tail}, ...], "card": nvidia-smi's name and power limit})
after every run, so a cut call keeps what it finished.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def main(argv) -> int:
    out, specs = argv[0], argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    runs = []
    for s in specs:
        cell, seed, seconds, trace = s.split(":")
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "benchmark.run",
                            "--workload", cell, "--seed", seed,
                            "--seconds", seconds, "--trace", trace],
                           capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        runs.append({"cell": cell, "seed": int(seed),
                     "seconds": float(seconds), "trace": int(trace),
                     "rc": p.returncode,
                     "wall_s": time.perf_counter() - t0, "result": result,
                     "stderr_tail": p.stderr[-3000:]})
        summary = (result or {}).get("metrics")
        print(f"{cell} seed {seed} trace {trace}: rc {p.returncode} "
              f"{time.perf_counter() - t0:.1f} s correct "
              f"{(result or {}).get('correct')} {summary} "
              f"{(result or {}).get('checks')}", flush=True)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
