"""BAT's training step as one CUDA graph (Trainer._step on a card).

On a CUDA device, without a mesh, without the factor blur, on a
step.TrainState of float32 leaves, the Trainer runs each step shape's step
(step.unsharded_step: the poses and rays, render_rays with its K1, K2, K6
and K7 launches, the loss, torch.autograd.grad, the field's and the pose
table's Adam) as one ``torch.cuda.CUDAGraph`` and replays it.  The graph
holds the kernels of the eager step and computes what train_step computes,
with the same bits; what moves from step to step reaches it through
static buffers, filled before each replay:

* the rays' views and pixels, copied on the device from the trainer's
  upload (pinned, not blocking);
* the stratified jitter and the background coin, drawn by step.predraw
  from the trainer's generator, as the eager renderer draws them and in
  its order, so the random stream is the eager step's;
* one float32 vector (VALUES) with every per-iteration value that moves
  within a step shape: the learning rates, the loss weights and edge
  factors, the near and far planes, the pose cadence, and both Adams' bias
  corrections (optim.adam_scales, on the host in float32), sent by one
  non-blocking copy.  A float32 product with a 0-d tensor gives the bits
  of one with the host float it holds.

The graph's key is what its kernels bake in: the StepConfig, the rays'
shape, the terms and leaves a zero leaves out (the TV weights that are 0,
the learning rates that float32 rounds to 0), the heads' encoding
progress (host arithmetic there), and the address, shape, strides and
dtype of every tensor the step reads or writes (the field's parameters
and box, both Adams' moments, the pose table and its accumulator, the base
poses, the intrinsics, the current images and edge masks, the alpha
mask).  An upsample, a shrink, a mask update or a new 2D-blur cache
therefore captures anew; the old graph is dropped first, which frees its
memory pool, and the graph holds the tensors of its key, so no address
it reads can be freed and handed to another tensor while it lives.

The first step of a key runs the captured function eagerly on the static
buffers, on the capture's side stream: a real training step that warms
the allocator, cuBLAS and the kernels' modules.  The next step of the key
is captured and replayed, and every later one replayed; no extra step
is run.  Where a key changes before it was captured (a phase whose key
moves every step, such as one whose 2D-blur scale is drawn from a pool
each step), the steps run as train_step until a key holds for two steps
in a row; that key's second step is its first on the static buffers.
The Adams' counts advance on the host, one a step (the pose's with its
cadence).  Each step returns clones of the graph's outputs (loss,
mse, psnr and the render fractions, computed in every step and returned
with ``stats``), so no two steps' metrics share a buffer.  A capture adds
nothing to ``cuda_build.LAUNCHES`` (nothing runs); each replay adds the
launches its capture recorded.  ``counts`` (the Trainer's graph_counts):
steps run eagerly, graphs captured, replays.  The span ``jt.step.graph``
is around each replay.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import cuda_build
from ..utils import tracing
from .optim import adam_scales, frozen
from .step import (StepConfig, StepScalars, TrainState, advance_counts,
                   float32_leaves, predraw, unsharded_step)

# the per-iteration values a replay reads, one float32 each, in this order
VALUES = ("lr_index", "lr_basis", "lr_pose", "near", "far", "l1_weight",
          "use_edge", "edge_factor", "non_edge_factor", "tv_depth_weight",
          "tv_density_weight", "tv_color_weight", "pose_do_step",
          "scene_scale1", "scene_scale2", "pose_scale1", "pose_scale2")


def engages(trainer, cfg: StepConfig) -> bool:
    """Whether the trainer's step runs as a CUDA graph: on a card, without
    a mesh and without the factor blur (its matrices are rebuilt from
    each step's c2f sigma), on a step.TrainState (not L2G's, whose step
    syncs on its SVD) of float32 leaves (optim.adam_update_'s)."""
    state = trainer.state
    return (trainer.device.type == "cuda" and trainer.mesh is None
            and cfg.blur is None and isinstance(state, TrainState)
            and float32_leaves(state.field))


def _read(trainer, alpha_mask) -> list:
    """Every tensor the step reads or writes but the static buffers."""
    st = trainer.state
    out = list(st.field.state_dict(keep_vars=True).values())
    out.append(st.field.resolution_tensor())
    for opt in (st.scene_opt, st.pose_opt):
        out += list(opt.mu.values()) + list(opt.nu.values())
    out += [st.se3_refine, st.pose_grad_accum, trainer.pose_base,
            trainer.intr, trainer.intr_inv, trainer.current_images,
            trainer.current_edges]
    if alpha_mask is not None:
        out += [alpha_mask.grid, alpha_mask.aabb]
    return out


def _flags(s: StepScalars) -> tuple:
    """The host choices a step's values make: the TV terms that are on and
    the learning rates that freeze their leaves."""
    return (bool(s.tv_density_weight), bool(s.tv_color_weight),
            frozen(s.lr_index), frozen(s.lr_basis), frozen(s.lr_pose))


def host_values(state: TrainState, cfg: StepConfig, s: StepScalars,
                device) -> np.ndarray:
    """The step's VALUES in float32, both Adams' bias corrections for
    their next counts among them (optim.adam_scales on ``device``)."""
    vals = dict(
        lr_index=s.lr_index, lr_basis=s.lr_basis, lr_pose=s.lr_pose,
        near=s.near_far[0], far=s.near_far[1], l1_weight=s.l1_weight,
        use_edge=s.use_edge, edge_factor=s.edge_factor,
        non_edge_factor=s.non_edge_factor, tv_depth_weight=s.tv_depth_weight,
        tv_density_weight=s.tv_density_weight,
        tv_color_weight=s.tv_color_weight, pose_do_step=s.pose_do_step)
    for name, opt, b2 in (("scene", state.scene_opt, cfg.scene_b2),
                          ("pose", state.pose_opt, cfg.pose_b2)):
        (vals[name + "_scale1"], vals[name + "_scale2"]) = adam_scales(
            opt.count + 1, 0.9, b2, device)
    return np.array([vals[k] for k in VALUES], dtype=np.float32)


def device_scalars(values: torch.Tensor, s: StepScalars) -> tuple:
    """(StepScalars, scales) for step.unsharded_step whose moving values
    are the entries of ``values`` (a float32 vector laid out as VALUES)
    and whose host choices are ``s``'s (_flags; the heads' encoding
    progress): a TV weight of 0 and a frozen rate as the host 0.0."""
    v = dict(zip(VALUES, values.unbind()))
    tv_density, tv_color, f_index, f_basis, f_pose = _flags(s)
    scalars = StepScalars(
        lr_index=0.0 if f_index else v["lr_index"],
        lr_basis=0.0 if f_basis else v["lr_basis"],
        lr_pose=0.0 if f_pose else v["lr_pose"],
        near_far=(v["near"], v["far"]), l1_weight=v["l1_weight"],
        use_edge=v["use_edge"], edge_factor=v["edge_factor"],
        non_edge_factor=v["non_edge_factor"],
        view_pe_progress=float(s.view_pe_progress),
        fea_pe_progress=float(s.fea_pe_progress),
        pose_do_step=v["pose_do_step"],
        tv_depth_weight=v["tv_depth_weight"],
        tv_density_weight=v["tv_density_weight"] if tv_density else 0.0,
        tv_color_weight=v["tv_color_weight"] if tv_color else 0.0)
    scales = {"scene": (v["scene_scale1"], v["scene_scale2"]),
              "pose": (v["pose_scale1"], v["pose_scale2"])}
    return scalars, scales


@dataclasses.dataclass
class StepGraph:
    """One key's static inputs, the tensors it reads, and once captured its
    graph, its outputs and the launches a replay makes."""
    key: tuple
    tensors: list            # held, so no address the graph reads is freed
    view_sel: torch.Tensor
    ray_idx: torch.Tensor
    jitter: Optional[torch.Tensor]
    bg_coin: Optional[torch.Tensor]
    values: torch.Tensor
    scalars: StepScalars     # VALUES' entries as views of ``values``
    scales: dict             # {"scene": pair, "pose": pair}, views too
    warm: bool = False       # the key's first step has run
    graph: Optional[torch.cuda.CUDAGraph] = None
    out: Optional[dict] = None
    launches: Optional[dict] = None


class StepGraphs:
    """The trainer's captured step: one graph at a time, by key."""

    def __init__(self, counts: dict):
        self.counts = counts
        self.current: Optional[StepGraph] = None
        self._unsettled = None      # the key of a step run as train_step
        self._stream = None

    def drop(self):
        """Forget the captured step (its pool and the tensors it holds)."""
        self.current = None

    def step(self, trainer, cfg: StepConfig, view_sel, ray_idx,
             s: StepScalars, generator=None, jitter=None, bg_coin=None,
             alpha_mask=None, stats: bool = False,
             mesh=None) -> Optional[dict]:
        """Trainer._step's step where engages() holds: -> its metrics as
        fresh 0-d tensors (train_step's, with ``stats`` its render
        fractions and blur flag), or None where the step is to run as
        train_step (a key that follows one changed before its capture)."""
        dev = trainer.device
        tensors = _read(trainer, alpha_mask)
        key = (cfg, tuple(view_sel.shape), tuple(ray_idx.shape),
               alpha_mask is None, _flags(s),
               float(s.view_pe_progress), float(s.fea_pe_progress),
               tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                     for t in tensors))
        g = self.current
        if g is None or g.key != key:
            unsettled = (g is not None and g.graph is None) or (
                self._unsettled not in (None, key))
            self.current = g = None
            self._unsettled = key if unsettled else None
            if unsettled:
                return None
        with tracing.span("step"):
            jitter, bg_coin = predraw(
                cfg, view_sel.shape[0] * ray_idx.shape[0], generator, dev,
                jitter, bg_coin)
            if g is None:
                g = self.current = self._new(key, tensors, view_sel,
                                             ray_idx, jitter, bg_coin, s, dev)
            out = self._run(trainer, cfg, g, view_sel, ray_idx, s, jitter,
                            bg_coin, alpha_mask)
        keep = out if stats else {k: out[k] for k in ("loss", "mse", "psnr")}
        metrics = {k: v.clone() for k, v in keep.items()}
        if stats:
            metrics["blur"] = 0.0
        return metrics

    def _run(self, trainer, cfg: StepConfig, g: StepGraph, view_sel,
             ray_idx, s: StepScalars, jitter, bg_coin, alpha_mask) -> dict:
        """Fill ``g``'s static buffers and run its step: eagerly on the
        key's first step, else (captured at the second) replayed; the
        Adams' counts advance.  -> the step's outputs (the graph's)."""
        st = trainer.state
        g.view_sel.copy_(view_sel)
        g.ray_idx.copy_(ray_idx)
        if jitter is not None:
            g.jitter.copy_(jitter)
        if bg_coin is not None:
            g.bg_coin.copy_(bg_coin)
        g.values.copy_(torch.from_numpy(host_values(
            st, cfg, s, trainer.device)).pin_memory(), non_blocking=True)
        run = dict(trainer=trainer, cfg=cfg, g=g, alpha_mask=alpha_mask)
        if not g.warm:
            out = self._eager(**run)
            self.counts["eager"] += 1
        else:
            if g.graph is None:
                self._capture(**run)
                self.counts["captures"] += 1
            with tracing.span("step.graph"):
                g.graph.replay()
            for k, n in g.launches.items():
                cuda_build.LAUNCHES[k] += n
            out = g.out
            self.counts["replays"] += 1
        advance_counts(st, cfg, s)
        return out

    def _new(self, key, tensors, view_sel, ray_idx, jitter, bg_coin,
             s: StepScalars, dev) -> StepGraph:
        values = torch.zeros(len(VALUES), dtype=torch.float32, device=dev)
        scalars, scales = device_scalars(values, s)
        return StepGraph(
            key=key, tensors=tensors, view_sel=torch.empty_like(view_sel),
            ray_idx=torch.empty_like(ray_idx),
            jitter=None if jitter is None else torch.empty_like(jitter),
            bg_coin=None if bg_coin is None else torch.empty_like(bg_coin),
            values=values, scalars=scalars, scales=scales)

    def _call(self, trainer, cfg: StepConfig, g: StepGraph, alpha_mask):
        return unsharded_step(
            trainer.state, cfg, trainer.vm_cfg, trainer.pose_base,
            trainer.intr_inv, trainer.current_images, trainer.current_edges,
            g.view_sel, g.ray_idx, g.scalars, g.scales, jitter=g.jitter,
            alpha_mask=alpha_mask, intr=trainer.intr, bg_coin=g.bg_coin)[0]

    def _side(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def _eager(self, **run) -> dict:
        """The key's first step: the captured function run eagerly on the
        side stream the capture will use."""
        run["g"].warm = True
        side, main = self._side(), torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._call(**run)
        main.wait_stream(side)
        return out

    def _capture(self, **run):
        """Capture the key's step; nothing runs, so the launches counted
        at the capture are taken back and kept for each replay."""
        g = run["g"]
        before = dict(cuda_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._side()):
            out = self._call(**run)
        g.launches = {k: n - before[k]
                      for k, n in cuda_build.LAUNCHES.items()
                      if n != before[k]}
        cuda_build.LAUNCHES.update(before)
        g.graph, g.out = graph, out
