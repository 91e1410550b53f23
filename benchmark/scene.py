"""The procedural scenes the cells train on, made by the benchmark.

A frozen copy of the scene part of joint_tensorf_tpu_torch/data/synthetic.py
at commit cccd099 (BlobField, SolidField, the sphere and forward-facing
camera rigs and the exact-quadrature render), so that the images both the
program and the reference read are the benchmark's inputs and do not move
when the program's data module changes.  The rays of the render are the
pinhole rays of geometry/rays.py at the same commit (pixel centres at
+0.5, directions = [x, y, 1] K^-1 R, centres = -t^T R).
"""
from __future__ import annotations

import numpy as np
import torch


def look_at_pose(cam_pos, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """world->cam [3,4] with the camera looking along its +z axis."""
    p = np.asarray(cam_pos, dtype=np.float32)
    z = np.asarray(target, dtype=np.float32) - p
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, dtype=np.float32), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    t = -R @ p
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def sphere_poses(n: int, radius: float = 4.0, elevation: float = 0.35,
                 seed: int = 0):
    """n poses around the origin with per-view elevation variation."""
    rng = np.random.default_rng(seed)
    thetas = np.linspace(0, 2 * np.pi, n, endpoint=False)
    thetas = thetas + rng.uniform(0, 2 * np.pi / n)
    elevs = elevation + rng.uniform(-0.25, 0.45, n)
    return np.stack([look_at_pose(radius * np.array(
        [np.cos(th) * np.cos(el), np.sin(el), np.sin(th) * np.cos(el)]))
        for th, el in zip(thetas, elevs)])


def facing_poses(n: int, radius: float = 4.0, spread: float = 0.45,
                 seed: int = 0):
    """Forward-facing capture: centres on a small disc in front of the
    scene, each looking at a jittered point near the origin."""
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        dx, dy = rng.uniform(-spread, spread, 2)
        dz = rng.uniform(-0.25, 0.25)
        p = np.array([dx, dy, -(radius + dz)], dtype=np.float32)
        target = rng.uniform(-0.15, 0.15, 3).astype(np.float32)
        poses.append(look_at_pose(p, target=target))
    return np.stack(poses)


def _f32(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _texture(rgb, pts, freqs, phase, amp: float):
    arg = torch.einsum("...d,cod->...co", pts, _f32(freqs, pts.device))
    tex = torch.mean(torch.sin(arg + _f32(phase, pts.device)), dim=-1)
    return torch.clamp(rgb * (1.0 + amp * tex), 0.0, 1.0)


class BlobField:
    """Coloured Gaussian blobs with a 3D colour texture."""

    def __init__(self, n_blobs: int = 5, seed: int = 0,
                 density_scale: float = 40.0):
        rng = np.random.default_rng(seed)
        self.centers = rng.uniform(-0.6, 0.6, (n_blobs, 3))
        self.radii = rng.uniform(0.15, 0.35, n_blobs)
        self.colors = rng.uniform(0.2, 1.0, (n_blobs, 3))
        self.density_scale = density_scale
        self.tex_freqs = rng.uniform(3.0, 9.0, (3, 4, 3))
        self.tex_phase = rng.uniform(0, 2 * np.pi, (3, 4))

    def sigma_rgb(self, pts):
        dev = pts.device
        d2 = torch.sum((pts[..., None, :] - _f32(self.centers, dev)) ** 2,
                       dim=-1)
        g = torch.exp(-0.5 * d2 / _f32(self.radii ** 2, dev))
        sigma = self.density_scale * torch.sum(g, dim=-1)
        w = g / (torch.sum(g, dim=-1, keepdim=True) + 1e-8)
        rgb = _texture(w @ _f32(self.colors, dev), pts, self.tex_freqs,
                       self.tex_phase, 0.45)
        return sigma, rgb


class SolidField:
    """Opaque textured spheres and boxes with sigmoid shells."""

    def __init__(self, n_shapes: int = 9, seed: int = 0,
                 density_scale: float = 500.0, shell: float = 0.02):
        rng = np.random.default_rng(seed)
        self.centers = rng.uniform(-0.65, 0.65, (n_shapes, 3))
        self.sizes = rng.uniform(0.12, 0.30, n_shapes)
        self.is_box = (np.arange(n_shapes) % 2 == 0).astype(np.float32)
        self.colors = rng.uniform(0.15, 1.0, (n_shapes, 3))
        self.density_scale = density_scale
        self.shell = shell
        self.tex_freqs = rng.uniform(4.0, 14.0, (3, 5, 3))
        self.tex_phase = rng.uniform(0, 2 * np.pi, (3, 5))

    def sigma_rgb(self, pts):
        dev = pts.device
        delta = pts[..., None, :] - _f32(self.centers, dev)
        d_sphere = torch.sqrt(torch.sum(delta * delta, dim=-1)) - _f32(
            self.sizes, dev)
        d_box = torch.amax(torch.abs(delta), dim=-1) - _f32(self.sizes, dev)
        box = _f32(self.is_box, dev)
        d = box * d_box + (1 - box) * d_sphere
        sigma = self.density_scale * torch.sum(
            torch.sigmoid(-d / self.shell), dim=-1)
        w = torch.softmax(-d / 0.08, dim=-1)
        rgb = _texture(w @ _f32(self.colors, dev), pts, self.tex_freqs,
                       self.tex_phase, 0.5)
        return sigma, rgb


def pinhole_rays(H: int, W: int, pose, intr_inv):
    """pose [3, 4] world->cam, intr_inv [3, 3] -> (centres, dirs) [H*W, 3]."""
    dev = pose.device
    y = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    x = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    Y, X = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([X.reshape(-1), Y.reshape(-1),
                        torch.ones(H * W, device=dev)], dim=-1)
    R, t = pose[:, :3], pose[:, 3:]
    dirs = (grid @ intr_inv.T) @ R
    centers = (-(t.T @ R)).expand(dirs.shape)
    return centers, dirs


@torch.no_grad()
def render_view(field, pose, intr_inv, H: int, W: int, near: float,
                far: float, n_samples: int, device):
    """Exact-quadrature render of the analytic field from one pose ->
    [3, H, W] on the device, white background."""
    chunk = max(1, 2 ** 22 // n_samples)
    centers, dirs = pinhole_rays(H, W, _f32(pose, device),
                                 _f32(intr_inv, device))
    z = torch.linspace(near, far, n_samples, device=device)
    dist = (far - near) / n_samples
    outs = []
    for s in range(0, centers.shape[0], chunk):
        c, d = centers[s:s + chunk], dirs[s:s + chunk]
        sigma, rgb = field.sigma_rgb(c[:, None, :] + d[:, None, :]
                                     * z[None, :, None])
        alpha = 1 - torch.exp(-sigma * dist)
        T = torch.cumprod(1 - alpha + 1e-10, dim=-1)
        T = torch.cat([torch.ones_like(T[:, :1]), T[:, :-1]], -1)
        wgt = alpha * T
        out = (wgt[..., None] * rgb).sum(-2) + (1 - wgt.sum(-1)[..., None])
        outs.append(torch.clamp(out, 0, 1))
    return torch.cat(outs).reshape(H, W, 3).permute(2, 0, 1)


def scene_field(kind: str, seed: int):
    """The analytic field of ``kind`` ("blobs", "solids", "facing")."""
    if kind in ("solids", "facing"):
        return SolidField(seed=seed)
    if kind == "blobs":
        return BlobField(seed=seed)
    raise ValueError(f"no procedural scene {kind!r} in the benchmark")


def make_scene(kind: str, n_views: int, H: int, W: int, seed: int,
               device) -> dict:
    """The training split of a scene: images [V, 3, H, W] float32 (on the
    device), GT poses [V, 3, 4], intrinsics [V, 3, 3] and their inverses
    (numpy).  The field comes from ``seed``, the cameras from ``seed``
    too (the program's loader takes the same seed for both)."""
    field = scene_field(kind, seed)
    if kind == "facing":
        poses = facing_poses(n_views, seed=seed)
        gt_near, gt_far, n_samples = 2.0, 6.2, 512
    else:
        poses = sphere_poses(n_views, seed=seed)
        gt_near, gt_far = 2.0, 6.0
        n_samples = 512 if kind == "solids" else 256
    focal = 1.1 * W
    intr = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                    dtype=np.float32)
    intr = np.broadcast_to(intr, (n_views, 3, 3)).copy()
    intr_inv = np.linalg.inv(intr).astype(np.float32)
    images = torch.stack([
        render_view(field, poses[i], intr_inv[i], H, W, gt_near, gt_far,
                    n_samples, device) for i in range(n_views)])
    return {"images": images, "poses": poses, "intr": intr,
            "intr_inv": intr_inv, "H": H, "W": W}
