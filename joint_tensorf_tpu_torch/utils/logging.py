"""Structured metric logging with optional TensorBoard / wandb sinks
(counterpart of joint_tensorf_tpu/utils/logging.py:14-93).

The primary sink is ``log.jsonl`` (always written, one row per call with
``it`` and ``split``); TensorBoard and wandb attach when their packages
are importable and enabled in the config (tb_logging, default on; wandb,
default off).  JAX's log_image is not ported: images go with viz/.
"""
from __future__ import annotations

import json
import os
from typing import Any


class MetricLogger:
    def __init__(self, out_dir: str, opt=None):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl_path = os.path.join(out_dir, "log.jsonl")
        self.tb = None
        self.wandb = None
        if opt is not None and opt.get("tb_logging", True):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir=os.path.join(out_dir, "tb"))
            except Exception:   # not installed, or its protobuf mismatches
                self.tb = None
        if opt is not None and opt.get("wandb", False):
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                wandb.init(project=str(opt.get("wandb_name",
                                               "joint_tensorf_tpu")),
                           group=str(opt.get("group", "default")),
                           name=str(opt.get("name", "run")),
                           config=opt.to_dict(),
                           resume=bool(opt.get("resume", False)))
                self.wandb = wandb

    def log_scalars(self, metrics: dict[str, Any], step: int,
                    split: str = "train"):
        line = {k: (float(v) if hasattr(v, "__float__") else v)
                for k, v in metrics.items()}
        line["it"] = step
        line["split"] = split
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(line) + "\n")
        if self.tb is not None:
            for k, v in metrics.items():
                if hasattr(v, "__float__"):
                    self.tb.add_scalar(f"{split}/{k}", float(v), step)
        if self.wandb is not None:
            self.wandb.log({f"{split}.{k}": v for k, v in metrics.items()},
                           step=step)

    def summary(self, metrics: dict[str, Any]):
        with open(os.path.join(self.out_dir, "summary.json"), "w") as f:
            json.dump({k: float(v) if hasattr(v, "__float__") else v
                       for k, v in metrics.items()}, f, indent=2)
        if self.wandb is not None:
            for k, v in metrics.items():
                self.wandb.run.summary[k] = v

    def close(self):
        if self.tb is not None:
            self.tb.flush()
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()
