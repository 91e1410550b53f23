"""Structured metric logging with optional TensorBoard / wandb sinks
(counterpart of joint_tensorf_tpu/utils/logging.py:14-93).

The primary sink is ``log.jsonl`` (always written, one row per call with
``it`` and ``split``); TensorBoard and wandb attach when their packages
are importable and enabled in the config (tb_logging, default on; wandb,
default off).  Images (log_image) go to those two sinks only.
profile_trace wraps a block in torch.profiler and writes its trace.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any

import numpy as np


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

    def log_image(self, name: str, image, step: int, split: str = "train"):
        """image: [H, W, 3] in [0, 1] (numpy or a tensor on any device),
        clipped; TensorBoard takes it as CHW.  Without TensorBoard and
        wandb nothing is written."""
        if self.tb is None and self.wandb is None:
            return
        if hasattr(image, "detach"):
            image = image.detach().cpu().numpy()
        img = np.clip(np.asarray(image), 0, 1)
        if self.tb is not None:
            self.tb.add_image(f"{split}/{name}", img.transpose(2, 0, 1), step)
        if self.wandb is not None:
            self.wandb.log({f"{split}.{name}": self.wandb.Image(img)},
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


@contextlib.contextmanager
def profile_trace(out_dir: str):
    """Profile the block with torch.profiler (the CPU, and CUDA when a card
    is present) and write its Chrome trace to
    ``<out_dir>/torch_trace/trace.json`` at the end (the JAX package's
    profile_trace writes an XProf trace under jax_trace).  Yields the
    trace's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(out_dir, "torch_trace", "trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
