"""Entry points of the port: the BAT-VM forward render on one device,
and a dry run on several ranks (counterpart of the repository's root
__graft_entry__.py).

    python -m joint_tensorf_tpu_torch.graft_entry [--device=cpu]
    python -m joint_tensorf_tpu_torch.graft_entry multichip [N] [--device=cpu]

* ``entry(device=None)`` -> ``(fn, example_args)``: the forward render of
  BAT's VM field (render_rays, train mode, the component-wise factor blur
  at its coarse-to-fine width 0.15) on tiny shapes: ranks 4/4/4 and
  8/8/8, app_dim 27, MLP_Fea with 32 hidden, a 32^3 grid, 48 samples, 256
  rays.  The state is init_vm's on a torch.Generator seeded 0 and the
  stratified offsets are drawn on the host from one seeded 1, so the same
  call on the card and on the CPU renders the same inputs.
  ``fn(*example_args)`` -> (rgb [256, 3], depth [256], opacity [256]);
  on the card the compositor is kernel K1.
* ``dryrun_multichip(n, device=None, backend="gloo")``: JAX's four
  sections on ``n`` ranks started by parallel/launch.spawn, each with
  JAX's assertions: (1) one train step over a [rays, comp] mesh
  ([n/2, 2], or [n, 1] for odd n) with the blur, the dense-grid density
  and the two-stage appearance (a finite loss, the pose table moved,
  each rank holding 1/C of every factor's components); (2) a Trainer on a
  rays mesh [n] across an upsample and the alpha-mask build (finite
  losses, one gradient all-reduce a step, the mask built) and a
  render_views chunk; (3) that trainer's checkpoint saved, restored into
  a fresh trainer on the mesh (iteration, resolution, mask and the
  factors equal, the replicas bit-identical) and resumed for 4 steps;
  (4) two L2G-BAT steps at [n/comp, comp].  It prints one line per
  section.  On the card every rank is a gloo rank on ``cuda:0`` (the
  device when None), as several ranks share one card.

Both run on the card unless the caller passes ``device="cpu"``; without a
card they raise (parallel/mesh.resolve_device).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

from .parallel.mesh import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]


def _vm_config():
    from .models.vm import VMConfig

    return VMConfig(density_n_comp=(4, 4, 4), app_n_comp=(8, 8, 8),
                    app_dim=27, shading_mode="MLP_Fea", hidden=32)


def _field(vm_cfg, res, device, comp=None):
    """init_vm's field drawn on the host from a generator seeded 0 (under
    ``comp`` this rank's component blocks), moved to ``device``."""
    from .models.vm import init_vm

    return init_vm(vm_cfg, res, AABB, torch.Generator().manual_seed(0),
                   comp=comp).to(device)


def _tiny_setup(n_views: int = 4, res=(32, 32, 32), n_samples: int = 48,
                device=None, comp=None):
    """(vm_cfg, head, state, cfg): the tiny BAT-VM field's config, its
    shading head, a fresh TrainState and the StepConfig of a 32x32 scene
    of ``n_views`` views, 64 rays a view, pose optimisation on."""
    from .train.step import StepConfig, init_train_state

    vm_cfg = _vm_config()
    state = init_train_state(
        _field(vm_cfg, res, resolve_device(device), comp), n_views)
    cfg = StepConfig(H=32, W=32, n_views=n_views, rays_per_view=64,
                     n_samples=n_samples, pose_opt=True)
    return vm_cfg, state.field.shading, state, cfg


def entry(device=None):
    """(fn, example_args): the forward render of the BAT-VM field (blurred
    factor grids, rays from a pose) on ``device`` (the card when None);
    see the module docstring."""
    from .render.renderer import BlurSpec, RenderConfig, render_rays

    dev = resolve_device(device)
    vm_cfg = _vm_config()
    field = _field(vm_cfg, (32, 32, 32), dev)
    rcfg = RenderConfig(n_samples=48, is_train=True)
    blur = BlurSpec(mode="uniform-gaussian", kernel_size=16)

    def fn(field, centers, dirs, jitter, near_far, c2f):
        return render_rays(field, vm_cfg, rcfg, centers, dirs, near_far,
                           blur=blur, c2f_density=c2f, c2f_color=c2f,
                           ray_jitter=jitter)

    n = 256
    rng = np.random.default_rng(0)
    centers = np.repeat([[0.0, 0.0, -4.0]], n, 0).astype(np.float32)
    d = rng.normal(size=(n, 3)) * np.array([0.2, 0.2, 0.05]) + [0, 0, 1]
    jitter = torch.rand((n, 1), generator=torch.Generator().manual_seed(1))
    example_args = (field, torch.as_tensor(centers, device=dev),
                    torch.as_tensor(d, dtype=torch.float32, device=dev),
                    jitter.to(dev), (2.0, 6.0), 0.15)
    return fn, example_args


# ------------------------------------------------------------ dry run
def _step_section(n: int, device) -> dict:
    """(1) one train step over [rays, comp] with the blur, the dense grid
    and app_k."""
    from .data.synthetic import sphere_poses
    from .parallel.mesh import make_mesh
    from .render.renderer import BlurSpec
    from .train.step import StepScalars, train_step

    shape = (n // 2, 2) if n % 2 == 0 else (n, 1)
    mesh = make_mesh(shape, ("rays", "comp"), device=device)
    dev = mesh.device
    vm_cfg, _, state, cfg = _tiny_setup(
        device=dev, comp=mesh if mesh.comp > 1 else None)
    cfg = dataclasses.replace(
        cfg, blur=BlurSpec(mode="uniform-gaussian", kernel_size=16),
        densify_density=True, app_k=16)
    for group, n_comp in (("density_planes", vm_cfg.density_n_comp),
                          ("app_lines", vm_cfg.app_n_comp)):
        held = [t.shape[-1] for t in getattr(state.field, group)]
        assert held == [c // mesh.comp for c in n_comp], (
            f"{group}: this rank holds {held} components of {n_comp}")
    n_views, H, W = cfg.n_views, cfg.H, cfg.W
    rng = np.random.default_rng(0)
    pose_base = torch.as_tensor(sphere_poses(n_views), dtype=torch.float32,
                                device=dev)
    focal = 1.2 * W
    intr = torch.as_tensor(np.broadcast_to(
        np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 dtype=np.float32), (n_views, 3, 3)).copy(), device=dev)
    images = torch.as_tensor(rng.random((n_views, H * W, 3)),
                             dtype=torch.float32, device=dev)
    edges = torch.zeros((n_views, H * W), device=dev)
    view_sel = torch.arange(n_views, device=dev)
    ray_idx = torch.as_tensor(rng.permutation(H * W)[:128], device=dev)
    s = StepScalars(
        lr_index=1e-2, lr_basis=5e-4, lr_pose=1e-3, c2f_density=0.15,
        c2f_color=0.15, near_far=(2.0, 6.0), l1_weight=8e-5,
        tv_density_weight=0.0, tv_color_weight=0.0, use_edge=1.0,
        edge_factor=1.5, non_edge_factor=0.5, view_pe_progress=1.0,
        fea_pe_progress=1.0, pose_do_step=1.0, tv_depth_weight=0.0)
    se3 = state.se3_refine.detach().clone()
    metrics, _ = train_step(state, cfg, vm_cfg, pose_base,
                            torch.linalg.inv(intr), images, edges, view_sel,
                            ray_idx, s, intr=intr, mesh=mesh,
                            generator=torch.Generator(dev).manual_seed(0))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    # the pose table must have moved (the joint gradient reached se3)
    delta = float((state.se3_refine.detach() - se3).abs().max())
    assert delta > 0, "pose parameters did not update"
    return {"loss": loss, "pose_delta": delta,
            "mesh": dict(zip(mesh.axes, mesh.shape))}


def _trainer_sections(n: int, device, tmp: str) -> tuple:
    """(2) a Trainer on a rays mesh across an upsample and the mask build,
    and a render_views chunk; (3) its checkpoint saved, restored into a
    fresh trainer on the mesh and resumed."""
    from .config import set_options
    from .data import load_dataset
    from .train import checkpoint as ckpt_lib
    from .train.trainer import Trainer

    opt = set_options(
        os.path.join(_REPO, "configs", "bat_synthetic_small.yaml"), [
            "--max_iter=16", "--data.image_size=[32,32]", "--data.n_views=4",
            "--train_schedule.n_voxel_init=4096",
            "--train_schedule.n_voxel_final=32768",
            "--train_schedule.upsample_iters=[5]",
            "--train_schedule.update_alphamask_iters=[10]",
            "--nerf.sample_intvs=48",
            f"--nerf.n_rays={32 * n}",
            f"--train_schedule.n_rays_init={32 * n}",
            f"--train_schedule.n_rays_rest={32 * n}",
            "--c2f_kernel_size=8", "--blur_2d_c2f_kernel_size=15",
            f"--tpu.mesh_shape=[{n}]", "--tpu.mesh_axes=[rays]"])
    scene = load_dataset(opt, "train", device=device)
    tr = Trainer(opt, scene, device=device)
    assert tr.mesh is not None and tr.mesh.rays == n
    grads = tr.mesh.counts.get("grads", 0)
    hist = tr.run(max_iter=12, log_every=4)
    assert all(np.isfinite(h["loss"]) for h in hist)
    # the data-parallel step: one gradient all-reduce an iteration
    assert tr.mesh.counts.get("grads", 0) - grads == tr.it, tr.mesh.counts
    assert tr.alpha_mask is not None, "alphamask phase not crossed"
    rgb, _, _ = tr.render_views(tr.pose_base[:1], tr.intr[:1],
                                tr.intr_inv[:1], chunk=256)
    assert torch.isfinite(rgb).all()
    trained = {"final_loss": hist[-1]["loss"], "res": list(tr.resolution)}

    ck = os.path.join(tmp, "model.ckpt.npz")
    ckpt_lib.save_checkpoint(ck, tr)
    tr2 = Trainer(opt, scene, device=device)
    assert tr2.mesh is not None
    ckpt_lib.restore_checkpoint(ck, tr2)
    assert tr2.it == tr.it and list(tr2.resolution) == list(tr.resolution)
    assert tr2.alpha_mask is not None, "alpha mask lost in restore"
    # JAX checks that the restored leaves are sharded over the mesh; here
    # each rank holds the whole replicated state (1/C = all of the
    # components on a rays mesh), equal on every rank
    leaf = tr2.state.field.density_planes[0]
    assert leaf.shape[-1] == tr2.vm_cfg.density_n_comp[0] // tr2.mesh.comp
    tr2._verify_replicas("the restored checkpoint")
    assert torch.equal(leaf, tr.state.field.density_planes[0])
    resumed_at = tr.it
    hist3 = tr2.run(max_iter=min(tr.it + 4, int(opt.max_iter)),
                    log_every=2)
    assert hist3 and all(np.isfinite(h["loss"]) for h in hist3)
    return trained, {"resumed_it": resumed_at, "steps": tr2.it - resumed_at}


def _l2g_section(n: int, device) -> dict:
    """(4) two L2G-BAT steps over [n/comp, comp]."""
    from .config import set_options
    from .data import load_dataset
    from .train.l2g_trainer import L2GTrainer

    comp = 2 if n % 2 == 0 else 1
    nr = 32 * (n // comp)
    opt = set_options(
        os.path.join(_REPO, "configs", "l2g_bat_blender_VM.yaml"), [
            "--data.dataset=synthetic", "--data.image_size=[32,32]",
            "--data.n_views=4", "--max_iter=4",
            "--train_schedule.n_voxel_init=4096",
            "--train_schedule.n_voxel_final=8192",
            "--train_schedule.upsample_iters=[]",
            "--train_schedule.update_alphamask_iters=[]",
            f"--train_schedule.n_rays_init={nr}",
            f"--train_schedule.n_rays_rest={nr}",
            "--nerf.sample_intvs=48",
            "--c2f_kernel_size=8", "--blur_2d_c2f_kernel_size=15",
            "--error_map_size=8",
            "--+data.scene_bbox=[-1.5,-1.5,-1.5,1.5,1.5,1.5]",
            f"--tpu.mesh_shape=[{n // comp},{comp}]",
            "--tpu.mesh_axes=[rays,comp]"])
    scene = load_dataset(opt, "train", device=device)
    tr = L2GTrainer(opt, scene, device=device)
    hist = tr.run(max_iter=2, log_every=1)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    return {"loss": hist[-1]["loss"],
            "mesh": dict(zip(tr.mesh.axes, tr.mesh.shape))}


def _dryrun_rank(payload, device) -> dict:
    """One rank of dryrun_multichip: the four sections in JAX's order."""
    n, tmp = payload["n"], payload["tmp"]
    step = _step_section(n, device)
    trained, resumed = _trainer_sections(n, device, tmp)
    return {"step": step, "trainer": trained, "resume": resumed,
            "l2g": _l2g_section(n, device)}


def dryrun_multichip(n_devices: int, device=None, backend: str = "gloo",
                     timeout_s: float = 900.0) -> list:
    """Run the dry run's four sections on ``n_devices`` ranks (module
    docstring); returns every rank's results, rank 0's printed as one line
    a section."""
    from .parallel import launch

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and backend == "gloo":
        dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="jtf_dryrun_") as tmp:
        out = launch.spawn(_dryrun_rank, n_devices,
                           {"n": n_devices, "tmp": tmp}, backend=backend,
                           device=dev, timeout_s=timeout_s)
    r = out[0]
    tag = f"dryrun_multichip({n_devices})"
    print(f"{tag}: OK  loss={r['step']['loss']:.5f} "
          f"pose_delta={r['step']['pose_delta']:.2e} "
          f"mesh={r['step']['mesh']}")
    print(f"{tag}: trainer OK  phases crossed (upsample@5, alphamask@10) "
          f"final_loss={r['trainer']['final_loss']:.5f} "
          f"res={r['trainer']['res']}")
    print(f"{tag}: sharded ckpt save->restore->resume OK (resumed "
          f"it={r['resume']['resumed_it']}, +{r['resume']['steps']} steps)")
    print(f"{tag}: L2G sharded step OK  loss={r['l2g']['loss']:.5f} "
          f"mesh={r['l2g']['mesh']}")
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    for a in list(argv):
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            argv.remove(a)
    if argv and argv[0] == "multichip":
        dryrun_multichip(int(argv[1]) if len(argv) > 1 else 8, device=device)
    else:
        fn, args = entry(device)
        with torch.no_grad():
            out = fn(*args)
        print("entry(): OK", [tuple(o.shape) for o in out])


if __name__ == "__main__":
    main()
