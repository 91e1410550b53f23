"""The planar 2D alignment entry point of the port (counterpart of the
repository's planar.py:14-87, the reference's train_2d.py).

    python -m joint_tensorf_tpu_torch.planar --yaml=configs/planar_bat.yaml \
        [--device=cpu] [--key=value ...] [--pdb]

Trains the SVD, FFT or MLP image (``model: planar_svd``, ``planar_fft``,
``planar``) with its per-patch warps (train/planar_trainer.py) and writes
into ``output_root/group/name/``: ``log.jsonl`` (one row per freq.scalar
iterations: loss, mse, psnr, sigma, rank, it, warp_error, wall),
``quant.json`` (iters, warp_error, the last logged psnr) and
``reconstruction.png`` of the whole image when imageio imports; otherwise
one ``[vis] skipped`` line, as planar.py prints.

Runs on ``cuda`` unless ``--device=cpu`` is given, planar_fft included:
JAX's planar.py pins planar_fft to its CPU because complex FFTs are
unimplemented on the TPU backend, while torch.fft runs on the card, so
nothing moves to the CPU here.
"""
from __future__ import annotations

import json
import os
import sys


def main(argv) -> dict:
    """Run the planar pipeline; returns the quant.json dict."""
    yaml_path, device, rest = None, None, []
    for a in argv:
        if a.startswith("--yaml="):
            yaml_path = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if not yaml_path:
        raise SystemExit("usage: python -m joint_tensorf_tpu_torch.planar "
                         "--yaml=configs/planar_*.yaml [--device=cpu]")

    from .config import set_options
    from .train.planar_trainer import PlanarTrainer

    opt = set_options(yaml_path, rest)
    out_dir = os.path.join(opt.get("output_root", "output"),
                           str(opt.get("group", "default")),
                           str(opt.get("name", "planar")))
    os.makedirs(out_dir, exist_ok=True)
    tr = PlanarTrainer(opt, device=device)
    print(f"[planar] model={opt.model} device={tr.device} patches={tr.B} "
          f"dof={tr.dof} max_iter={tr.max_iter}", flush=True)

    log_path = os.path.join(out_dir, "log.jsonl")

    def on_log(t, m):
        with open(log_path, "a") as f:
            f.write(json.dumps(m) + "\n")
        print(f"it {t.it:6d} | loss {m['loss']:.5f} | psnr {m['psnr']:.2f} "
              f"| warp_err {m['warp_error']:.4f} | sigma {m['sigma']:.1f}",
              flush=True)

    tr.run(log_every=int(opt.freq.get("scalar", 20)), callback=on_log)
    result = {"iters": tr.it, "warp_error": tr.warp_error(),
              "psnr": tr.metrics_history[-1]["psnr"] if tr.metrics_history
              else None}
    with open(os.path.join(out_dir, "quant.json"), "w") as f:
        json.dump(result, f, indent=2)
    print("[done]", json.dumps(result), flush=True)

    try:
        import imageio.v2 as imageio
        import numpy as np

        img = tr.predict_entire_image()
        imageio.imwrite(os.path.join(out_dir, "reconstruction.png"),
                        (np.clip(img, 0, 1) * 255).astype(np.uint8))
    except Exception as e:  # noqa: BLE001 - the image is optional, as in planar.py
        print(f"[vis] skipped: {e}", flush=True)
    return result


if __name__ == "__main__":
    from .utils import run_cli

    run_cli(main, sys.argv[1:])
