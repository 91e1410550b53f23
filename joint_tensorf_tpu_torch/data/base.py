"""Dataset container and loading dispatch
(counterpart of joint_tensorf_tpu/data/base.py).

Loaders produce a SceneData of host (numpy) arrays; the trainer uploads it
once to its device.  The colour augmentation (generate_augmentation,
apply_color_jitter) is numpy on the host, drawn from the caller's
generator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SceneData:
    """One split of a scene, fully materialized.

    images: [B, 3, H, W] float32 in [0,1]
    poses:  [B, 3, 4] world->cam GT poses
    intr:   [B, 3, 3]; intr_inv: [B, 3, 3]
    """
    images: np.ndarray
    poses: np.ndarray
    intr: np.ndarray
    intr_inv: np.ndarray
    near_far: tuple[float, float]
    H: int
    W: int

    @property
    def n_views(self) -> int:
        return self.images.shape[0]


def scale_intrinsics(intr: np.ndarray, raw_hw, target_hw,
                     center_crop: float | None = None) -> np.ndarray:
    """Intrinsics after a center crop (a fraction of the raw size), then a
    resize to ``target_hw``."""
    intr = intr.copy().astype(np.float32)
    raw_h, raw_w = raw_hw
    if center_crop is not None:
        crop_h, crop_w = int(raw_h * center_crop), int(raw_w * center_crop)
        intr[..., 0, 2] -= (raw_w - crop_w) / 2
        intr[..., 1, 2] -= (raw_h - crop_h) / 2
        raw_h, raw_w = crop_h, crop_w
    h, w = target_hw
    intr[..., 0, :] *= w / raw_w
    intr[..., 1, :] *= h / raw_h
    return intr


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] weights of jax.image.resize(method="bilinear") along
    one axis, computed as JAX computes them, in float32: a triangle kernel
    at half-pixel centers, widened by the scale when it downsamples (its
    antialiasing), each column normalised to sum 1."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale
                - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        n_in, dtype=torch.float32)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_images(images: np.ndarray, target_hw) -> np.ndarray:
    """[B, C, H, W] -> [B, C, h, w], jax.image.resize's "bilinear" (which
    antialiases when it downsamples): its separable weights as two
    matrices, applied with matmuls in float32.  An axis whose size is kept
    is left as it is."""
    h, w = target_hw
    H, W = images.shape[-2:]
    if (H, W) == (h, w):
        return images
    out = torch.as_tensor(np.asarray(images, dtype=np.float32))
    if H != h:
        out = torch.einsum("bchw,hy->bcyw", out, _resize_weights(H, h))
    if W != w:
        out = torch.einsum("bchw,wx->bchx", out, _resize_weights(W, w))
    return out.numpy()


def generate_augmentation(opt, rng: np.random.Generator) -> dict:
    """One augmentation drawn from ``rng`` as the reference draws it
    (data/base.py:74-90): brightness, contrast, saturation factors uniform
    in 1 +- data.augment's value, hue uniform in +-hue, a horizontal flip
    (with augment.hflip) and a rotation angle (with augment.rotate).  No
    trainer calls it, in either package."""
    aug_cfg = opt.data.get("augment") or {}

    def _rng(lo, hi):
        return float(rng.uniform(lo, hi))
    b = float(aug_cfg.get("brightness") or 0.0)
    c = float(aug_cfg.get("contrast") or 0.0)
    s = float(aug_cfg.get("saturation") or 0.0)
    h = float(aug_cfg.get("hue") or 0.0)
    return {
        "brightness": _rng(1 - b, 1 + b),
        "contrast": _rng(1 - c, 1 + c),
        "saturation": _rng(1 - s, 1 + s),
        "hue": _rng(-h, h),
        "flip": bool(rng.standard_normal() > 0) if aug_cfg.get("hflip")
                else False,
        "rot_angle": ((rng.random() * 2 - 1) * float(aug_cfg["rotate"])
                      if aug_cfg.get("rotate") else 0.0),
    }


def apply_color_jitter(images: np.ndarray, aug: dict) -> np.ndarray:
    """Brightness, contrast, saturation and hue of ``aug`` on [..., 3, H, W]
    float images in [0, 1], then the flip: each step clipped to [0, 1],
    the hue as a rotation in YIQ space (JAX's approximation of
    torchvision's HSV shift)."""
    img = images.astype(np.float32)
    img = np.clip(img * aug["brightness"], 0, 1)
    gray = (0.299 * img[..., 0, :, :] + 0.587 * img[..., 1, :, :]
            + 0.114 * img[..., 2, :, :])
    img = np.clip(aug["contrast"] * img
                  + (1 - aug["contrast"]) * gray.mean(
                      axis=(-2, -1), keepdims=True)[..., None, :, :], 0, 1)
    img = np.clip(aug["saturation"] * img
                  + (1 - aug["saturation"]) * gray[..., None, :, :], 0, 1)
    if aug["hue"]:
        theta = 2 * np.pi * aug["hue"]
        u, w = np.cos(theta), np.sin(theta)
        t = np.array([
            [0.299 + 0.701 * u + 0.168 * w,
             0.587 - 0.587 * u + 0.330 * w,
             0.114 - 0.114 * u - 0.497 * w],
            [0.299 - 0.299 * u - 0.328 * w,
             0.587 + 0.413 * u + 0.035 * w,
             0.114 - 0.114 * u + 0.292 * w],
            [0.299 - 0.300 * u + 1.250 * w,
             0.587 - 0.588 * u - 1.050 * w,
             0.114 + 0.886 * u - 0.203 * w]], np.float32)
        img = np.clip(np.einsum("ij,...jhw->...ihw", t, img), 0, 1)
    if aug.get("flip"):
        img = img[..., ::-1]
    return np.ascontiguousarray(img)


def load_dataset(opt, split: str = "train", subset: int | None = None,
                 device=None) -> SceneData:
    """Dispatch by opt.data.dataset: the procedural scene (rendered on
    ``device``), or a Blender, LLFF, Tanks & Temples (t2) or iPhone scene
    from disk."""
    name = opt.data.dataset
    if name == "synthetic":
        from . import synthetic
        return synthetic.load(opt, split, subset, device=device)
    if name == "blender":
        from . import blender as loader
    elif name == "llff":
        from . import llff as loader
    elif name == "t2":
        from . import t2 as loader
    elif name == "iphone":
        from . import iphone as loader
    else:
        raise ValueError(f"unknown dataset {name!r}")
    return loader.load(opt, split, subset)
