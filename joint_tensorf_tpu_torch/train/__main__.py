"""Training CLI of the port (counterpart of the repository's train.py).

    python -m joint_tensorf_tpu_torch.train --yaml=configs/bat_blender_VM.yaml \
        --data.dataset=synthetic [--key=value ...] [--device=cpu]

Loads the config (dotted overrides as in train.py), renders the procedural
scene on the device, and trains BAT through its whole schedule (voxel
upsamples, alpha-mask updates, bbox shrink), printing one line per log
interval (freq.scalar) and one per phase transition.  It writes no
checkpoint and runs no validation yet.
"""
from __future__ import annotations

import sys


def main(argv):
    yaml_path, device, rest = None, None, []
    for a in argv:
        if a.startswith("--yaml="):
            yaml_path = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if not yaml_path:
        raise SystemExit("usage: python -m joint_tensorf_tpu_torch.train "
                         "--yaml=configs/<cfg>.yaml [--k=v ...]")

    from ..config import set_options
    from ..data import load_dataset
    from .trainer import Trainer

    opt = set_options(yaml_path, rest)
    print(f"[data] rendering {opt.data.dataset} "
          f"{opt.data.image_size} x {opt.data.get('n_views', 12)} views",
          flush=True)
    data = load_dataset(opt, "train", subset=opt.data.get("train_sub"),
                        device=device)
    trainer = Trainer(opt, data, device=device)
    print(f"[train] {opt.model} | device={trainer.device} "
          f"views={data.n_views} res={trainer.resolution} "
          f"n_samples={trainer.n_samples} max_iter={trainer.max_iter}",
          flush=True)

    phase = [trainer.resolution, trainer.n_samples, None]

    def on_log(tr, m):
        print(f"it {tr.it:6d} | loss {m['loss']:.5f} | psnr {m['psnr']:.2f} "
              f"| lr {tr.lr_index:.2e} | {m['wall']:.1f}s", flush=True)

    def on_step(tr, m):
        if m is not None:       # after the step; report after the update
            return
        mask_res = (tr.alphamask_resolution if tr.alpha_mask is not None
                    else None)
        now = [tr.resolution, tr.n_samples, mask_res]
        if now != phase:
            phase[:] = now
            aabb = tr.state.field.aabb.cpu().numpy().round(4).tolist()
            print(f"[phase] after it {tr.it}: res={tr.resolution} "
                  f"n_samples={tr.n_samples} mask_res={mask_res} "
                  f"aabb={aabb}", flush=True)

    trainer.run(log_every=int(opt.freq.get("scalar", 200)), callback=on_log,
                on_step=on_step)


if __name__ == "__main__":
    main(sys.argv[1:])
