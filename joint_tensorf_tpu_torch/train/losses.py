"""Training losses: photometric MSE with edge-guided masking, depth TV
(counterpart of joint_tensorf_tpu/train/losses.py).

MSE is the nanmean over all elements; the edge-guided variant reweights
edge vs non-edge pixels with hard masks on alternating iterations.

Under a mesh each rank holds a block of the rays, and each nanmean becomes
the global nansum over the global non-NaN count: the ``*_sum_count``
forms give a rank's sums and counts, the counts are reduced over the ranks
(parallel/sharding.reduce_counts), and each rank's share of the loss is
its sums over the global counts, so that the shares sum to the unsharded
nanmean.  A mean of per-rank nanmeans (JAX's pmean) differs from it
wherever the ranks hold different numbers of NaNs.
"""
from __future__ import annotations

import torch


def mse(pred, target):
    return torch.nanmean((pred - target) ** 2)


def mse_sum_count(pred, target):
    """(nansum, non-NaN count) of the squared error: mse is their ratio."""
    sq = (pred - target) ** 2
    return torch.nansum(sq), (~torch.isnan(sq)).sum()


def psnr_from_mse(m):
    return -10.0 * torch.log10(m)


def edge_weighted_render_loss(rgb, target, edge_mask, edge_factor,
                              non_edge_factor, use_edge):
    """rgb/target: [B,R,3]; edge_mask: [B,R] (0/1); use_edge: 0/1.

    use_edge=1 -> f_e*MSE(rgb*m, t*m) + f_ne*MSE(rgb*(1-m), t*(1-m))
    use_edge=0 -> plain MSE.
    """
    m = edge_mask[..., None].to(rgb.dtype)
    edge_part = mse(rgb * m, target * m)
    non_edge_part = mse(rgb * (1 - m), target * (1 - m))
    edge_loss = edge_factor * edge_part + non_edge_factor * non_edge_part
    plain = mse(rgb, target)
    return use_edge * edge_loss + (1.0 - use_edge) * plain


def edge_weighted_sum_count(rgb, target, edge_mask):
    """The three nanmeans of edge_weighted_render_loss as sums [3] and
    non-NaN counts [3]: (edge part, non-edge part, plain)."""
    m = edge_mask[..., None].to(rgb.dtype)
    parts = (mse_sum_count(rgb * m, target * m),
             mse_sum_count(rgb * (1 - m), target * (1 - m)),
             mse_sum_count(rgb, target))
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]))


def edge_weighted_from_sums(sums, counts, edge_factor, non_edge_factor,
                            use_edge):
    """edge_weighted_render_loss from sums and (global) counts."""
    edge_part, non_edge_part, plain = (sums / counts).unbind()
    edge_loss = edge_factor * edge_part + non_edge_factor * non_edge_part
    return use_edge * edge_loss + (1.0 - use_edge) * plain


def depth_tv_loss(depth, grid_h: int, grid_w: int):
    """TV over the sampled ray grid."""
    d = depth.reshape(-1, grid_h, grid_w)
    h_tv = torch.sum((d[:, 1:, :] - d[:, :-1, :]) ** 2) / grid_h
    w_tv = torch.sum((d[:, :, 1:] - d[:, :, :-1]) ** 2) / grid_w
    return h_tv + w_tv
