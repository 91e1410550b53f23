"""Multi-experiment scheduler (counterpart of the repository's
scripts/run_experiments.py, the reference's gpu_scheduler).

Runs a list of train and / or evaluate configurations as subprocesses
over a set of slots: at most ``--slots`` at once, polled every 3 s (the
reference polls free GPUs every 3 s, scripts/gpu_scheduler.py:73-108).
The commands are the port's CLIs, ``python -m joint_tensorf_tpu_torch.train``
and ``python -m joint_tensorf_tpu_torch.evaluate``.  Each slot's process
sees one card: CUDA_VISIBLE_DEVICES is the slot's index modulo the
host's card count (slot_env), the counterpart of a TPU slot owning its
chip; on a host with one card every slot shares it.

    python -m joint_tensorf_tpu_torch.run_experiments --mode=both \
        --scenes lego chair --yaml configs/bat_blender_VM.yaml --slots 2 \
        [-- extra --k=v args]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

TRAIN = "joint_tensorf_tpu_torch.train"
EVALUATE = "joint_tensorf_tpu_torch.evaluate"


def build_commands(args, extra):
    """Per scene, the train and / or evaluate command (``args.mode``)
    with the scene, the run's name (``args.prefix`` + scene), its group
    and ``extra``."""
    cmds = []
    for scene in args.scenes:
        name = f"{args.prefix}{scene}"
        common = [f"--yaml={args.yaml}", f"--data.scene={scene}",
                  f"--name={name}", f"--group={args.group}"] + extra
        if args.mode in ("train", "both"):
            cmds.append([sys.executable, "-m", TRAIN] + common)
        if args.mode in ("eval", "both"):
            cmds.append([sys.executable, "-m", EVALUATE] + common)
    return cmds


def card_count() -> int:
    """The host's CUDA cards (0 on a host without one)."""
    import torch

    return torch.cuda.device_count()


def slot_env(slot: int, n_cards: int) -> dict:
    """The environment of a process in ``slot``: this process's, with
    CUDA_VISIBLE_DEVICES = slot mod n_cards, or unchanged without a
    card."""
    env = dict(os.environ)
    if n_cards > 0:
        env["CUDA_VISIBLE_DEVICES"] = str(slot % n_cards)
    return env


def run_scheduler(cmds, n_slots: int, poll_s: float = 3.0):
    """Run ``cmds`` over ``n_slots`` slots, each on its card (slot_env);
    returns [(command, return code)] in the order they finished."""
    n_cards = card_count()
    running: dict[int, subprocess.Popen] = {}
    queue = list(cmds)
    results = []
    while queue or running:
        for slot in list(running):
            proc = running[slot]
            if proc.poll() is not None:
                results.append((proc.args, proc.returncode))
                print(f"[sched] slot {slot} finished rc={proc.returncode}",
                      flush=True)
                del running[slot]
        while queue and len(running) < n_slots:
            slot = next(s for s in range(n_slots) if s not in running)
            cmd = queue.pop(0)
            print(f"[sched] slot {slot} <- {' '.join(cmd[:4])} ...",
                  flush=True)
            running[slot] = subprocess.Popen(cmd,
                                             env=slot_env(slot, n_cards))
        time.sleep(poll_s)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--yaml", required=True)
    ap.add_argument("--scenes", nargs="+", required=True)
    ap.add_argument("--mode", choices=["train", "eval", "both"],
                    default="both")
    ap.add_argument("--slots", type=int, default=1)
    ap.add_argument("--group", default="experiments")
    ap.add_argument("--prefix", default="")
    args, extra = ap.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]
    cmds = build_commands(args, extra)
    results = run_scheduler(cmds, args.slots)
    failed = [(c, rc) for c, rc in results if rc != 0]
    print(f"[sched] done: {len(results) - len(failed)} ok, "
          f"{len(failed)} failed")
    for c, rc in failed:
        print(f"  rc={rc}: {' '.join(map(str, c))}")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
