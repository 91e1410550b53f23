"""Procedural synthetic scenes rendered analytically
(counterpart of joint_tensorf_tpu/data/synthetic.py, every scene kind).

``blobs``: colored Gaussian blobs; ``solids``: opaque textured spheres and
boxes (the convergence configs' scene); ``facing``: the solids seen from a
forward-facing camera disc; ``parallax``: solids spread over depth with a
floor and a backdrop wall, seen from that disc.  The fields' parameters
and the cameras come from the same numpy generators as in the JAX package,
so the scene is the reference's scene; the exact-quadrature render runs in
PyTorch on the chosen device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.rays import get_center_and_ray
from ..utils.torch_setup import resolve_device
from .base import SceneData


def look_at_pose(cam_pos, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """world->cam [3,4] with the camera looking along its +z axis."""
    p = np.asarray(cam_pos, dtype=np.float32)
    z = np.asarray(target, dtype=np.float32) - p
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, dtype=np.float32), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])          # rows: camera axes in world coords
    t = -R @ p
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def sphere_poses(n: int, radius: float = 4.0, elevation: float = 0.35,
                 seed: int = 0):
    """n poses around the origin with per-view elevation variation (camera
    centers off one plane, so sim(3) alignment stays well-posed)."""
    rng = np.random.default_rng(seed)
    thetas = np.linspace(0, 2 * np.pi, n, endpoint=False)
    thetas = thetas + rng.uniform(0, 2 * np.pi / n)
    elevs = elevation + rng.uniform(-0.25, 0.45, n)
    poses = []
    for th, el in zip(thetas, elevs):
        p = radius * np.array([np.cos(th) * np.cos(el),
                               np.sin(el),
                               np.sin(th) * np.cos(el)])
        poses.append(look_at_pose(p))
    return np.stack(poses)


def facing_poses(n: int, radius: float = 4.0, spread: float = 0.45,
                 seed: int = 0):
    """Forward-facing capture: camera centers on a small disc at distance
    ``radius`` in front of the scene, each looking at a jittered point near
    the origin."""
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
    """rgb * (1 + amp * mean_octaves sin(pts . freq + phase)), clipped to
    [0, 1]: the multiplicative high-frequency color texture."""
    arg = torch.einsum("...d,cod->...co", pts, _f32(freqs, pts.device))
    tex = torch.mean(torch.sin(arg + _f32(phase, pts.device)), dim=-1)
    return torch.clamp(rgb * (1.0 + amp * tex), 0.0, 1.0)


def _solid_sdf(pts, centers, sizes, is_box):
    """Signed distance [..., K] to each sphere or box (the box's as
    max |delta| - size, not a smooth max)."""
    delta = pts[..., None, :] - _f32(centers, pts.device)   # [..., K, 3]
    d_sphere = torch.sqrt(torch.sum(delta * delta, dim=-1)) - _f32(
        sizes, pts.device)
    d_box = torch.amax(torch.abs(delta), dim=-1) - _f32(sizes, pts.device)
    box = _f32(is_box, pts.device)
    return box * d_box + (1 - box) * d_sphere


class BlobField:
    """Analytic GT field: colored Gaussian blobs with a 3D color texture."""

    def __init__(self, n_blobs: int = 5, seed: int = 0, extent: float = 1.0,
                 density_scale: float = 40.0, texture: bool = True):
        rng = np.random.default_rng(seed)
        self.centers = rng.uniform(-extent * 0.6, extent * 0.6, (n_blobs, 3))
        self.radii = rng.uniform(0.15, 0.35, n_blobs) * extent
        self.colors = rng.uniform(0.2, 1.0, (n_blobs, 3))
        self.density_scale = density_scale
        self.texture = texture
        self.tex_freqs = rng.uniform(3.0, 9.0, (3, 4, 3))   # [rgb, octave, xyz]
        self.tex_phase = rng.uniform(0, 2 * np.pi, (3, 4))

    def sigma_rgb(self, pts):
        """pts: [..., 3] tensor -> (sigma [...], rgb [..., 3])."""
        dev = pts.device
        d2 = torch.sum((pts[..., None, :] - _f32(self.centers, dev)) ** 2,
                       dim=-1)
        g = torch.exp(-0.5 * d2 / _f32(self.radii**2, dev))
        sigma = self.density_scale * torch.sum(g, dim=-1)
        w = g / (torch.sum(g, dim=-1, keepdim=True) + 1e-8)
        rgb = w @ _f32(self.colors, dev)
        if self.texture:
            rgb = _texture(rgb, pts, self.tex_freqs, self.tex_phase, 0.45)
        return sigma, rgb


class SolidField:
    """Analytic GT field: opaque textured solids (spheres and boxes), with
    sigmoid shells over their signed distances and the color of the
    nearest shape (a softmax over -distance)."""

    def __init__(self, n_shapes: int = 9, seed: int = 0, extent: float = 1.0,
                 density_scale: float = 500.0, shell: float = 0.02,
                 texture: bool = True):
        rng = np.random.default_rng(seed)
        self.centers = rng.uniform(-extent * 0.65, extent * 0.65,
                                   (n_shapes, 3))
        self.sizes = rng.uniform(0.12, 0.30, n_shapes) * extent
        self.is_box = (np.arange(n_shapes) % 2 == 0).astype(np.float32)
        self.colors = rng.uniform(0.15, 1.0, (n_shapes, 3))
        self.density_scale = density_scale
        self.shell = shell
        self.texture = texture
        self.tex_freqs = rng.uniform(4.0, 14.0, (3, 5, 3))
        self.tex_phase = rng.uniform(0, 2 * np.pi, (3, 5))

    def sigma_rgb(self, pts):
        """pts: [..., 3] tensor -> (sigma [...], rgb [..., 3])."""
        d = _solid_sdf(pts, self.centers, self.sizes, self.is_box)
        occ = torch.sigmoid(-d / self.shell)                  # [..., K]
        sigma = self.density_scale * torch.sum(occ, dim=-1)
        w = torch.softmax(-d / 0.08, dim=-1)                  # nearest shape
        rgb = w @ _f32(self.colors, pts.device)
        if self.texture:
            rgb = _texture(rgb, pts, self.tex_freqs, self.tex_phase, 0.5)
        return sigma, rgb


class ParallaxField:
    """Analytic GT for the forward-facing protocol with depth structure:
    solids spread over metric depth ~2.2-12 from the camera disc, a sloped
    textured floor and a backdrop wall at z = 15, so that near and far
    content share every image."""

    def __init__(self, n_shapes: int = 10, seed: int = 0,
                 density_scale: float = 300.0, texture: bool = True):
        rng = np.random.default_rng(seed)
        zs = np.linspace(-1.8, 8.0, n_shapes) + rng.uniform(
            -0.4, 0.4, n_shapes)
        lat = 0.38 * (zs + 4.0)       # lateral spread grows with depth
        self.centers = np.stack([
            rng.uniform(-1, 1, n_shapes) * lat,
            rng.uniform(-0.75, 0.9, n_shapes) * lat * 0.8,
            zs], axis=-1)
        self.sizes = (0.10 + 0.05 * rng.random(n_shapes)) * (zs + 4.0) * 0.55
        self.is_box = (np.arange(n_shapes) % 2 == 0).astype(np.float32)
        self.colors = rng.uniform(0.15, 1.0, (n_shapes, 3))
        self.density_scale = density_scale
        self.texture = texture
        self.tex_freqs = rng.uniform(1.0, 6.0, (3, 5, 3))
        self.tex_phase = rng.uniform(0, 2 * np.pi, (3, 5))
        self.floor_y0 = -1.6
        self.floor_slope = -0.12
        self.wall_z = 15.0

    def sigma_rgb(self, pts):
        """pts: [..., 3] tensor -> (sigma [...], rgb [..., 3])."""
        dev = pts.device
        y, z = pts[..., 1], pts[..., 2]
        d = _solid_sdf(pts, self.centers, self.sizes, self.is_box)
        # shells scale with size so far shapes stay resolvable
        shell = _f32(0.015 * (self.sizes / self.sizes.min()), dev)
        occ = torch.sigmoid(-d / shell)                       # [..., K]
        floor_d = y - (self.floor_y0 + self.floor_slope * (z + 4.0))
        wall_d = self.wall_z - z
        occ_floor = torch.sigmoid(-floor_d / 0.05)
        occ_wall = torch.sigmoid(-wall_d / 0.12)
        sigma = self.density_scale * (
            torch.sum(occ, dim=-1) + occ_floor + occ_wall)
        d_all = torch.cat([d, floor_d[..., None], wall_d[..., None]], dim=-1)
        w = torch.softmax(-d_all / 0.06, dim=-1)
        colors = torch.cat([_f32(self.colors, dev),
                            _f32([[0.55, 0.45, 0.35], [0.45, 0.55, 0.70]],
                                 dev)], dim=0)
        rgb = w @ colors
        if self.texture:
            # texture frequency roughly uniform in image space over depth
            depth = torch.clamp(z + 4.0, min=0.5)[..., None]
            rgb = _texture(rgb, pts / depth * 4.0, self.tex_freqs,
                           self.tex_phase, 0.5)
        return sigma, rgb


@torch.no_grad()
def render_analytic(field, pose, intr_inv, H: int, W: int,
                    near: float, far: float, n_samples: int = 256,
                    white_bg: bool = True, device=None):
    """Exact-quadrature render of the analytic field from one pose ->
    [H, W, 3] numpy, in chunks of 2^22 samples."""
    dev = resolve_device(device)
    chunk = max(1, 2 ** 22 // n_samples)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)[None]
    intr_inv = torch.as_tensor(intr_inv, dtype=torch.float32, device=dev)[None]
    centers, dirs = get_center_and_ray(H, W, pose, intr_inv)
    centers, dirs = centers[0], dirs[0]
    z = torch.linspace(near, far, n_samples, device=dev)
    dist = (far - near) / n_samples
    outs = []
    for s in range(0, centers.shape[0], chunk):
        c, d = centers[s:s + chunk], dirs[s:s + chunk]
        pts = c[:, None, :] + d[:, None, :] * z[None, :, None]
        sigma, rgb = field.sigma_rgb(pts)
        alpha = 1 - torch.exp(-sigma * dist)
        T = torch.cumprod(1 - alpha + 1e-10, dim=-1)
        T = torch.cat([torch.ones_like(T[:, :1]), T[:, :-1]], -1)
        wgt = alpha * T
        acc = wgt.sum(-1)
        out = (wgt[..., None] * rgb).sum(-2)
        if white_bg:
            out = out + (1 - acc[..., None])
        outs.append(torch.clamp(out, 0, 1))
    return torch.cat(outs).reshape(H, W, 3).cpu().numpy()


def make_scene(n_views: int = 12, H: int = 64, W: int = 64,
               near: float = 2.0, far: float = 6.0, seed: int = 0,
               n_blobs: int = 5, n_samples: int = 256,
               pose_seed: int | None = None, kind: str = "blobs",
               device=None) -> SceneData:
    """The reference's make_scene / _make_scene_impl: the field from
    ``seed`` alone (train and val splits share it), the cameras from
    ``pose_seed``.  Rendered anew on the device at each call: the JAX
    package caches scenes on disk because its render took minutes on the
    accelerator, while the card renders the convergence configs' 100 views
    at 128^2 in seconds (chip_smoke.py's solids phase prints the time)."""
    gt_near, gt_far = near, far
    if kind == "parallax":
        field = ParallaxField(seed=seed)
        # the depth range spans the backdrop wall; keep the quadrature
        # below the smallest shell over the 20-unit range
        n_samples = max(n_samples, 1280)
    elif kind in ("solids", "facing"):
        field = SolidField(seed=seed)
        # the 0.02-unit sigmoid shells need a GT sample spacing below them
        n_samples = max(n_samples, 512)
    else:
        field = BlobField(n_blobs=n_blobs, seed=seed)
    pose_seed = seed if pose_seed is None else pose_seed
    if kind in ("facing", "parallax"):
        # the returned near_far stays the caller's (NDC) range; the GT is
        # rendered in metric space around the camera disc
        poses = facing_poses(n_views, seed=pose_seed)
        gt_near, gt_far = (2.0, 6.2) if kind == "facing" else (1.9, 20.5)
    else:
        poses = sphere_poses(n_views, seed=pose_seed)
    focal = 1.1 * W
    intr = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                    dtype=np.float32)
    intr = np.broadcast_to(intr, (n_views, 3, 3)).copy()
    intr_inv = np.linalg.inv(intr).astype(np.float32)
    images = np.stack([
        render_analytic(field, poses[i], intr_inv[i], H, W, gt_near, gt_far,
                        n_samples=n_samples, device=device).transpose(2, 0, 1)
        for i in range(n_views)
    ])
    return SceneData(images=images.astype(np.float32), poses=poses,
                     intr=intr, intr_inv=intr_inv, near_far=(near, far),
                     H=H, W=W)


def load(opt, split: str = "train", subset: int | None = None,
         device=None) -> SceneData:
    n = opt.data.get("n_views", 12)
    if split != "train":
        n = opt.data.get("val_sub") or max(2, n // 4)
    H, W = opt.data.image_size
    near, far = opt.nerf.depth.range
    seed = opt.data.get("seed", 0)
    pose_seed = seed + (0 if split == "train" else 1000)
    # data.scene picks the field; a Blender scene name inherited from a
    # parent config (e.g. "lego") means the blobs
    kind = str(opt.data.get("scene", "blobs"))
    if kind not in ("blobs", "solids", "facing", "parallax"):
        kind = "blobs"
    scene = make_scene(n_views=n, H=H, W=W, near=float(near), far=float(far),
                       seed=seed, pose_seed=pose_seed, kind=kind,
                       device=device)
    if subset:
        scene.images = scene.images[:subset]
        scene.poses = scene.poses[:subset]
        scene.intr = scene.intr[:subset]
        scene.intr_inv = scene.intr_inv[:subset]
    return scene
