"""L2G-BAT trainer: BAT's schedule with the local-to-global step
(counterpart of joint_tensorf_tpu/train/l2g_trainer.py).

Everything but the state and the step is the BAT Trainer's: phases,
blurs, schedules, budgets.  The differences:

* the state is an L2GState (train/l2g.py) around the initial field: the
  warp embedding and MLP in place of the pose table;
* datasets other than the Blender and procedural scenes start from
  identity base poses;
* the in-bbox budget is probed from the registered poses (the table of
  optimised poses), once the L2G state exists;
* a shape transition rebuilds the field's Adam moments and keeps the pose
  optimiser and its accumulator (step.rebuild_opt_state does exactly that
  on this state too);
* the training poses are the registered ones;
* on the Blender and procedural scenes the depth range is rescaled every
  step by the diameter of the registered cameras, read on the host.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import Options
from ..data.base import SceneData
from .l2g import L2GConfig, init_l2g_state, l2g_depth_range, l2g_train_step
from .trainer import Trainer

_OWN_POSES = ("blender", "synthetic")


def build_l2g_config(opt: Options) -> L2GConfig:
    arch = opt.arch
    return L2GConfig(
        embedding_dim=int(arch.get("embedding_dim", 32)),
        layers_warp=tuple(int(x) for x in
                          arch.get("layers_warp", [64, 64, 6])),
        skip_warp=tuple(int(x) for x in arch.get("skip_warp", [])),
        error_map_size=int(opt.get("error_map_size", 0) or 0),
        global_alignment_weight=float(
            opt.loss_weight.get("global_alignment", 1.0) or 0.0))


class L2GTrainer(Trainer):
    def __init__(self, opt: Options, train_data: SceneData,
                 val_data: Optional[SceneData] = None, device=None):
        self.l2g_cfg = build_l2g_config(opt)
        super().__init__(opt, train_data, val_data, device=device)

    def _init_state(self, field):
        if self.opt.data.dataset not in _OWN_POSES:
            self.pose_base = torch.eye(
                3, 4, device=self.device).expand(self.n_views, 3, 4).clone()
        return init_l2g_state(field, self.l2g_cfg, self.n_views,
                              self.pose_base, generator=self.generator,
                              device=self.device)

    def _step(self, cfg, view_sel, ray_idx, scalars, **kw):
        return l2g_train_step(self.state, cfg, self.l2g_cfg, self.vm_cfg,
                              self.pose_base, self.intr, self.intr_inv,
                              self.current_images, self.current_edges,
                              view_sel, ray_idx, scalars, **kw)

    def get_all_training_poses(self):
        """(the registered poses [V,3,4], GT poses)."""
        return self.state.optimised_poses, self.gt_poses

    def _near_far(self):
        if self.opt.data.dataset in _OWN_POSES:
            return list(l2g_depth_range(self.state.optimised_poses,
                                        self.near_far))
        return super()._near_far()
