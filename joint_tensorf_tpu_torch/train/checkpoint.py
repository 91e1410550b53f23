"""Checkpoint save / restore in the JAX package's .npz layout
(counterpart of joint_tensorf_tpu/train/checkpoint.py:77-108, :159-215).

One .npz holds:

* ``state/<path>``: every array of the train state under the JAX pytree's
  path strings (``state/.params/.field/.density_planes/[0]``,
  ``state/.scene_opt/.mu/.shading/['layers']/[1]/['w']``, or
  ``.../.shading/['layer2']/['w']`` for the three-layer heads,
  ``.../.shading/['fea_gauss']/['w']`` for GaRF, no shading leaf for SH
  and RGB; a CP field has no ``.density_planes`` / ``.app_planes``); the
  field's Adam moments carry an ``.aabb`` entry, zeros, as JAX's do.
  L2G-BAT's state holds ``.params/.warp_embedding``,
  ``.params/.warp_mlp/[i]/[j]`` (j = 0 the weight, 1 the bias), the pose
  optimiser's moments and the accumulator over ``[0]`` (the embedding)
  and ``[1]/[i]/[j]`` (the MLP), ``.optimised_poses`` and ``.error_map``
  in place of the pose table;
* ``pose_noise``: the SE(3) noise matrices [V, 3, 4] that pose_base is
  composed from, when the config adds noise;
* ``alpha_mask/packed|shape|aabb``: the mask's bits (np.packbits), its
  grid shape and its box;
* ``meta_json``: the schedule (it, the voxel counts, resolutions, lrs,
  the TV weights, n_samples), whether a mask exists and the numpy
  generator's state;
* ``key``: the uint32 pair of JAX's PRNGKey(seed), which JAX's restore
  reads; the port ignores it on restore;
* ``torch_generator_state``: the port's torch.Generator state (its device
  type in meta_json), which JAX's restore ignores.

The trainers without phases (BARF / MLP-NeRF, and the planar images)
use the simple checkpoint (checkpoint.py:111-157 of the JAX package):
``state/<path>`` of the tree {"params", "opt_state"} under JAX's path
strings (``state/['params']/.mlp/['feat']/[0]/['w']``,
``state/['params']/.se3_refine``, ``state/['opt_state']/.mu/.mlp/...``,
``state/['opt_state']/.count``; ``.mlp_fine/...`` with fine sampling; the
planar params are a dict, ``state/['params']/['image']/['rank1']``), the
``key``, BARF's ``pose_noise``, ``meta_json`` (it, the numpy generator's
state, the torch generator's device) and ``torch_generator_state``.

Under a mesh (parallel/) rank 0 writes and, for a synchronous write,
every rank waits for the file; every rank restores the same file, then
the replicas are checked bit for bit (checksum all-reduces) and the
budgets broadcast from rank 0.  The layout is the same with or without a
mesh: under the comp layout every rank gathers the factor blocks (and
their moments) before rank 0 writes the unsharded arrays, and a restore
keeps each rank's block.

Each side restores the other's files: restore rebuilds the field at the
stored shapes and box, the Adam moments and counts, the pose table and
pose_base, and the alpha mask, then re-probes compact_k and app_k_dyn from
the restored numpy generator, as JAX does.  The budgets JAX leaves as they
are on restore (compact_k_bbox, the blur mask) stay as they are here too.
Writes are atomic (a temporary file, then a rename, then the snapshot
copy) and not compressed: JAX compresses (np.savez_compressed), which
saves little on float32 factors and moments at many times the write time;
np.load reads either.  Every array of a payload is copied on the calling
thread, device-to-host, or out of a CPU tensor (convert._np: the next
optimiser step changes the parameters in place), together with the comp
layout's gathers; ``async_write=True`` (JAX's checkpoint.py:13-65) then
queues the disk work on one ordered writer thread, so the train loop
does not wait for the disk; under a mesh rank 0 queues it and no rank
waits.  wait_for_pending() drains the queue and re-raises the first
exception a write hit; both restores call it first and, under a mesh,
meet at a barrier after it, so no rank reads a file still being
written.  The train CLI writes its per-iteration snapshots so and
drains the queue before its final synchronous save.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from .. import convert
from ..geometry import poses as pose_ops
from ..models.alpha_mask import AlphaMask
from ..parallel import sharding
from ..utils import tree as tree_lib
from .l2g import L2GState

_GROUPS = ("density_planes", "density_lines", "app_planes", "app_lines")

# the writer thread (started at the first queued write) and the futures
# of the writes not yet drained
_writer: concurrent.futures.ThreadPoolExecutor | None = None
_pending: list = []
_writer_lock = threading.Lock()


def _write_npz(path: str, payload: dict, snapshot_path: str | None):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    if snapshot_path is not None:
        shutil.copyfile(path, snapshot_path)


def _write(path: str, payload: dict, snapshot_path: str | None,
           async_write: bool):
    """Write now, or queue the write (the payload's arrays hold their own
    memory: _payload, convert._np)."""
    if not async_write:
        _write_npz(path, payload, snapshot_path)
        return
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        # drained futures go; a failed one stays until wait_for_pending
        # raises its exception
        _pending[:] = [f for f in _pending
                       if not f.done() or f.exception() is not None]
        _pending.append(_writer.submit(_write_npz, path, payload,
                                       snapshot_path))


def wait_for_pending():
    """Block until every queued write is on disk; re-raise the first
    exception a write hit."""
    with _writer_lock:
        pending = list(_pending)
        _pending.clear()
    errors = [e for e in (f.exception() for f in pending) if e is not None]
    if errors:
        raise errors[0]


def _field_paths(prefix: str, tree: dict, aabb) -> dict:
    """The converter's field-shaped dict -> {JAX leaf path: array}."""
    out = {}
    for g in _GROUPS:
        for i, a in enumerate(tree[g]):
            out[f"{prefix}/.{g}/[{i}]"] = a
    out[f"{prefix}/.basis"] = tree["basis"]
    _simple_paths(tree["shading"], f"{prefix}/.shading", False, out)
    out[f"{prefix}/.aabb"] = aabb
    return out


def _field_tree(prefix: str, arrays: dict) -> dict:
    """The inverse of _field_paths (the .aabb leaf stays in ``arrays``)."""
    tree = {g: [] for g in _GROUPS}
    for g in _GROUPS:
        while f"{prefix}/.{g}/[{len(tree[g])}]" in arrays:
            tree[g].append(arrays[f"{prefix}/.{g}/[{len(tree[g])}]"])
    tree["basis"] = arrays[f"{prefix}/.basis"]
    head = f"{prefix}/.shading/"
    tree["shading"] = _simple_tree({k[len(head):]: a
                                    for k, a in arrays.items()
                                    if k.startswith(head)}) or {}
    return tree


def _pose_paths(prefix: str, tree: dict) -> dict:
    """L2G's (embedding, MLP) pair -> {JAX leaf path: array}."""
    out = {f"{prefix}/[0]": tree["warp_embedding"]}
    for i, wb in enumerate(tree["warp_mlp"]):
        for j, a in enumerate(wb):
            out[f"{prefix}/[1]/[{i}]/[{j}]"] = a
    return out


def _pose_pair(prefix: str, arrays: dict, emb: str = "[0]",
               mlp: str = "[1]") -> dict:
    """The inverse of _pose_paths (also for the params' own names)."""
    layers = []
    while f"{prefix}/{mlp}/[{len(layers)}]/[0]" in arrays:
        i = len(layers)
        layers.append([arrays[f"{prefix}/{mlp}/[{i}]/[0]"],
                       arrays[f"{prefix}/{mlp}/[{i}]/[1]"]])
    return {"warp_embedding": arrays[f"{prefix}/{emb}"], "warp_mlp": layers}


def _state_arrays(trainer) -> dict:
    """{JAX leaf path: numpy array} of the trainer's state."""
    l2g = isinstance(trainer.state, L2GState)
    d = (convert.l2g_to_numpy(trainer.state) if l2g
         else convert.to_numpy(trainer.state))
    zeros = np.zeros_like(d["aabb"])
    out = _field_paths(".params/.field", d, d["aabb"])
    for m in ("mu", "nu"):
        out.update(_field_paths(f".scene_opt/.{m}", d["scene_opt"][m], zeros))
    out[".scene_opt/.count"] = np.int32(d["scene_opt"]["count"])
    out[".pose_opt/.count"] = np.int32(d["pose_opt"]["count"])
    if l2g:
        out[".params/.warp_embedding"] = d["warp_embedding"]
        for i, wb in enumerate(d["warp_mlp"]):
            for j, a in enumerate(wb):
                out[f".params/.warp_mlp/[{i}]/[{j}]"] = a
        for m in ("mu", "nu"):
            out.update(_pose_paths(f".pose_opt/.{m}", d["pose_opt"][m]))
        out.update(_pose_paths(".pose_grad_accum", d["pose_grad_accum"]))
        out[".optimised_poses"] = d["optimised_poses"]
        out[".error_map"] = d["error_map"]
        return out
    out[".params/.se3_refine"] = d["se3_refine"]
    for m in ("mu", "nu"):
        out[f".pose_opt/.{m}"] = d["pose_opt"][m]
    out[".pose_grad_accum"] = d["pose_grad_accum"]
    return out


def _state_dict(arrays: dict, l2g: bool) -> dict:
    """{JAX leaf path: array} -> the converter's dict (L2G-BAT's with
    ``l2g``)."""
    need = [".params/.field/.aabb", ".scene_opt/.count", ".pose_opt/.count"]
    need += ([".params/.warp_embedding", ".optimised_poses", ".error_map",
              ".pose_grad_accum/[0]"] if l2g
             else [".params/.se3_refine", ".pose_grad_accum"])
    missing = [k for k in need if k not in arrays]
    if missing:
        raise KeyError(f"checkpoint missing leaves {missing}")
    d = _field_tree(".params/.field", arrays)
    d["aabb"] = arrays[".params/.field/.aabb"]
    d["scene_opt"] = {m: _field_tree(f".scene_opt/.{m}", arrays)
                      for m in ("mu", "nu")}
    d["scene_opt"]["count"] = int(arrays[".scene_opt/.count"])
    if l2g:
        d.update(_pose_pair(".params", arrays, ".warp_embedding",
                            ".warp_mlp"))
        d["pose_opt"] = {m: _pose_pair(f".pose_opt/.{m}", arrays)
                         for m in ("mu", "nu")}
        d["pose_grad_accum"] = _pose_pair(".pose_grad_accum", arrays)
        d["optimised_poses"] = arrays[".optimised_poses"]
        d["error_map"] = arrays[".error_map"]
    else:
        d["se3_refine"] = arrays[".params/.se3_refine"]
        d["pose_opt"] = {m: arrays[f".pose_opt/.{m}"] for m in ("mu", "nu")}
        d["pose_grad_accum"] = arrays[".pose_grad_accum"]
    d["pose_opt"]["count"] = int(arrays[".pose_opt/.count"])
    return d


def save_checkpoint(path: str, trainer, async_write: bool = False,
                    snapshot_path: str | None = None):
    """Write the trainer's checkpoint to ``path`` (and a copy to
    ``snapshot_path`` when given), now or queued (``async_write``); under
    a mesh every rank gathers the state (the comp layout's blocks), rank 0
    writes, and after a synchronous write every rank returns once the file
    is there."""
    arrays = _state_arrays(trainer)
    mesh = trainer.mesh
    if mesh is None or mesh.is_main:
        _write(path, _payload(trainer, arrays), snapshot_path, async_write)
    if mesh is not None and not async_write:
        sharding.barrier(mesh)


def _payload(trainer, arrays: dict) -> dict:
    """The file's arrays, each of its own memory (none shares a live
    tensor's, so a queued write sees the state of the save)."""
    meta = {
        "it": trainer.it,
        "n_voxel_list": [int(n) for n in trainer.n_voxel_list],
        "n_voxels": int(trainer.n_voxels),
        "resolution": [int(r) for r in trainer.resolution],
        "alphamask_resolution": [int(r)
                                 for r in trainer.alphamask_resolution],
        "lr_index": trainer.lr_index,
        "lr_basis": trainer.lr_basis,
        "tv_density_weight": trainer.tv_density_weight,
        "tv_color_weight": trainer.tv_color_weight,
        "n_samples": int(trainer.n_samples),
        "has_alpha_mask": trainer.alpha_mask is not None,
        "rng_state": trainer.rng_np.bit_generator.state,
        "torch_generator_device": trainer.generator.device.type,
    }
    payload = {f"state/{k}": v for k, v in arrays.items()}
    seed = int(trainer.opt.get("seed", 0))
    payload["key"] = np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    payload["torch_generator_state"] = trainer.generator.get_state().numpy()
    if trainer.pose_noise is not None:
        payload["pose_noise"] = trainer.pose_noise.cpu().numpy().copy()
    if trainer.alpha_mask is not None:
        grid = trainer.alpha_mask.grid.cpu().numpy() > 0.5
        payload["alpha_mask/packed"] = np.packbits(grid.reshape(-1))
        payload["alpha_mask/shape"] = np.asarray(grid.shape)
        payload["alpha_mask/aabb"] = \
            trainer.alpha_mask.aabb.cpu().numpy().copy()
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)
    return payload


def _restore_generator(data, meta: dict, generator: torch.Generator):
    """The port's torch generator state, when the file holds one for this
    device type (JAX's files hold none)."""
    if "torch_generator_state" not in data.files:
        return
    if meta.get("torch_generator_device") == generator.device.type:
        generator.set_state(torch.as_tensor(data["torch_generator_state"]))
    else:
        # another device's generator: its draws differ whatever its
        # state, so the seeded one stays
        print(f"[ckpt] torch generator state is for "
              f"{meta.get('torch_generator_device')}, not "
              f"{generator.device.type}: left as seeded", flush=True)


def restore_checkpoint(path: str, trainer) -> None:
    """Restore ``trainer`` in place from a checkpoint of either package
    (after the queued writes)."""
    wait_for_pending()
    if trainer.mesh is not None:
        sharding.barrier(trainer.mesh)
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta_json"]).decode())
    dev = trainer.device
    arrays = {k[len("state/"):]: data[k] for k in data.files
              if k.startswith("state/")}
    if isinstance(trainer.state, L2GState):
        trainer.state = convert.l2g_state_from_numpy(
            _state_dict(arrays, True), trainer.vm_cfg, trainer.l2g_cfg,
            device=dev, comp=trainer.comp)
    else:
        trainer.state, _ = convert.train_state_from_numpy(
            _state_dict(arrays, False), trainer.vm_cfg, device=dev,
            comp=trainer.comp)

    trainer.it = int(meta["it"])
    trainer.n_voxel_list = list(meta["n_voxel_list"])
    trainer.n_voxels = int(meta["n_voxels"])
    trainer.resolution = list(meta["resolution"])
    trainer.alphamask_resolution = list(meta["alphamask_resolution"])
    trainer.lr_index = float(meta["lr_index"])
    trainer.lr_basis = float(meta["lr_basis"])
    trainer.tv_density_weight = float(meta["tv_density_weight"])
    trainer.tv_color_weight = float(meta["tv_color_weight"])
    trainer.n_samples = int(meta["n_samples"])
    trainer.rng_np.bit_generator.state = meta["rng_state"]
    _restore_generator(data, meta, trainer.generator)
    if "pose_noise" in data.files:
        trainer.pose_noise = torch.as_tensor(data["pose_noise"], device=dev)
        trainer.pose_base = pose_ops.compose(
            [trainer.pose_noise, trainer.gt_poses])
    if meta["has_alpha_mask"]:
        shape = tuple(int(s) for s in data["alpha_mask/shape"])
        n = int(np.prod(shape))
        grid = np.unpackbits(data["alpha_mask/packed"])[:n].reshape(shape)
        trainer.alpha_mask = AlphaMask(
            grid=torch.as_tensor(grid, dtype=torch.float32, device=dev),
            aabb=torch.as_tensor(data["alpha_mask/aabb"], device=dev))
        trainer.compact_k = trainer._probe_compact_k()
        trainer.app_k_dyn = trainer._probe_app_k()
    trainer.last_step_config = None
    trainer._sync_budgets()
    trainer._verify_replicas(f"restoring {path}")


# ------------------------------------------- BARF / planar (no phases)
_PATH_PART = re.compile(r"\['(\w+)'\]|\.(\w+)|\[(\d+)\]")


def _simple_paths(node, path: str, attrs: bool, out: dict) -> dict:
    """Nested numpy state -> {JAX path string: array}: the keys of a
    dataclass level (``attrs``, BarfParams and AdamState) as ``.name``,
    of a dict as ``['name']``, list items as ``[i]``."""
    if isinstance(node, dict):
        for k, v in node.items():
            if v is not None:
                _simple_paths(v, f"{path}/.{k}" if attrs else
                              f"{path}/['{k}']", False, out)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _simple_paths(v, f"{path}/[{i}]", False, out)
    else:
        out[path] = node
    return out


def _simple_tree(arrays: dict) -> dict:
    """{JAX path string: array} -> the nested state (lists where JAX has
    sequences)."""
    return tree_lib.unflatten({
        ".".join(next(g for g in m.groups() if g is not None)
                 for m in _PATH_PART.finditer(key)): a
        for key, a in arrays.items()})


def save_simple_checkpoint(path: str, trainer, async_write: bool = False,
                           snapshot_path: str | None = None):
    """Write a BarfTrainer's or PlanarTrainer's checkpoint to ``path``
    (and a copy to ``snapshot_path`` when given), now or queued
    (``async_write``)."""
    d = convert.simple_to_numpy(trainer.params, trainer.opt_state)
    attrs = trainer.jax_params_dataclass
    arrays = _simple_paths(d["params"], "['params']", attrs, {})
    for m in ("mu", "nu"):
        _simple_paths(d["opt_state"][m], f"['opt_state']/.{m}", attrs,
                      arrays)
    arrays["['opt_state']/.count"] = np.int32(d["opt_state"]["count"])
    payload = {f"state/{k}": v for k, v in arrays.items()}
    seed = int(trainer.opt.get("seed", 0))
    payload["key"] = np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    payload["torch_generator_state"] = trainer.generator.get_state().numpy()
    if getattr(trainer, "pose_noise", None) is not None:
        payload["pose_noise"] = trainer.pose_noise.cpu().numpy().copy()
    meta = {"it": trainer.it, "rng_state": trainer.rng_np.bit_generator.state,
            "torch_generator_device": trainer.generator.device.type}
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)
    _write(path, payload, snapshot_path, async_write)


def restore_simple_checkpoint(path: str, trainer) -> None:
    """Restore a BarfTrainer or PlanarTrainer in place from a simple
    checkpoint of either package (after the queued writes)."""
    wait_for_pending()
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta_json"]).decode())
    st = _simple_tree({k[len("state/"):]: data[k] for k in data.files
                       if k.startswith("state/")})
    want = set(trainer.params)
    params, opt_state = convert.simple_state_from_numpy(
        {"params": st["params"], "opt_state": st["opt_state"]},
        device=trainer.device)
    if set(params) != want:
        raise KeyError(f"checkpoint leaves {sorted(set(params) ^ want)} do "
                       f"not match the trainer's")
    trainer.params, trainer.opt_state = params, opt_state
    trainer.it = int(meta["it"])
    trainer.rng_np.bit_generator.state = meta["rng_state"]
    _restore_generator(data, meta, trainer.generator)
    if "pose_noise" in data.files:
        trainer.pose_noise = torch.as_tensor(data["pose_noise"],
                                             device=trainer.device)
        trainer.pose_base = pose_ops.compose(
            [trainer.pose_noise, trainer.gt_poses])
