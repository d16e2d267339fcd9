"""Small distribution / indexing / loss utilities.

Port of counterfactualworldmodels_tpu/ops/misc.py: spatial moments, soft
indexing, channel errors, masked losses, local neighbourhoods and
boundaries, as plain tensor functions on the tensors' device. The JAX
package's ``stop_gradient`` on masks is ``detach`` here.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .coords import coordinate_ims
from .sampling import index_into_images


# ---------------------------------------------------------------------------
# spatial distributions
# ---------------------------------------------------------------------------
def spatial_moments_from_local_dist(local_dist, eps=1e-3, squeeze=True):
    """First spatial moment of a local k*k distribution at every pixel.

    local_dist: [B,K,H,W] or [B,C,K,H,W] with K = k*k. Returns [B,2,H,W]
    (or [B,C,2,H,W]): the normalized-grid centroid of each local patch
    distribution.
    """
    if local_dist.dim() == 4:
        local_dist = local_dist[:, None]
    b, c, kk, h, w = local_dist.shape
    k = int(np.sqrt(kk))
    norm = torch.clamp(local_dist.sum(-3, keepdim=True), min=eps)
    grid = coordinate_ims(1, 1, (k, k), normalize=True,
                          dtype=local_dist.dtype,
                          device=local_dist.device)[0, 0]      # [k,k,2]
    grid = grid.reshape(kk, 2)
    moments = torch.einsum('bckhw,kd->bcdhw', local_dist, grid) / norm
    if c == 1 and squeeze:
        return moments[:, 0]
    return moments


def get_distribution_centroid(dist, eps=1e-9, normalize=False):
    """Centroid of a [B,T,1,H,W] spatial distribution -> [B,T,2]."""
    b, t, c, h, w = dist.shape
    if c != 1:
        raise ValueError(f'expected one channel: {tuple(dist.shape)}')
    dist = dist / torch.clamp(dist.sum((-2, -1), keepdim=True), min=eps)
    grid = coordinate_ims(b, t, (h, w), normalize=normalize,
                          dtype=dist.dtype, device=dist.device)
    grid = grid.movedim(-1, 2)                                # [B,T,2,H,W]
    return (grid * dist).sum((-2, -1))


def soft_index(images, indices, scale_by_imsize=True):
    """Bilinear read of [B,C,H,W] images at [B,P,2] float (h, w) points.
    ``scale_by_imsize`` maps [-1, 1] coords to pixels. Returns [B,P,C]."""
    if indices.shape[-1] != 2:
        raise ValueError(f'indices must end in (h, w): '
                         f'{tuple(indices.shape)}')
    b, c, h, w = images.shape
    h_inds, w_inds = indices[..., 0], indices[..., 1]
    if scale_by_imsize:
        h_inds = (h_inds + 1.0) * h * 0.5
        w_inds = (w_inds + 1.0) * w * 0.5
    h_inds = torch.clamp(h_inds, 0.0, h - 1)
    w_inds = torch.clamp(w_inds, 0.0, w - 1)

    h0, w0 = torch.floor(h_inds), torch.floor(w_inds)
    h1, w1 = torch.ceil(h_inds), torch.ceil(w_inds)
    tl = (h1 - h_inds) * (w1 - w_inds)
    tr = (h1 - h_inds) * (w_inds - w0)
    bl = (h_inds - h0) * (w1 - w_inds)
    br = (h_inds - h0) * (w_inds - w0)

    def read(hi, wi):
        return index_into_images(images, torch.stack([hi, wi], -1).long())

    return (read(h0, w0) * tl[..., None] + read(h0, w1) * tr[..., None] +
            read(h1, w0) * bl[..., None] + read(h1, w1) * br[..., None])


# ---------------------------------------------------------------------------
# channel-reduced errors
# ---------------------------------------------------------------------------
def channel_mse(x, y, dim=-3):
    """RMS error over the channel dim, kept (despite the name a
    root-mean-square, as in the reference)."""
    return torch.sqrt(((x - y) ** 2).mean(dim, keepdim=True))


def channel_l1error(x, y, dim=-3):
    return torch.abs(x - y).mean(dim, keepdim=True)


def channel_l2error(x, y, dim=-3):
    return ((x - y) ** 2).mean(dim, keepdim=True)


def max_delta_error(x, y, dim=-3, backward=False):
    sign = -1.0 if backward else 1.0
    return torch.relu(sign * (x - y)).amax(dim=dim, keepdim=True)


# ---------------------------------------------------------------------------
# masked losses
# ---------------------------------------------------------------------------
def l2_loss(x, y):
    return (x - y) ** 2


def l1_loss(x, y):
    return torch.abs(x - y)


def charbonnier_loss(x, y, eps=1e-3, alpha=0.5):
    """Sums over the channel dim."""
    return (((x - y) ** 2 + eps ** 2) ** alpha).sum(-3, keepdim=True)


def masked_per_pixel_loss(logits, labels, mask, loss_fn=l2_loss):
    """Mean per-pixel loss over a [.., 1, H, W] validity mask."""
    if mask is None:
        mask = torch.ones_like(labels[..., 0:1, :, :])
    mask = mask.detach()
    num_px = torch.clamp(mask.sum((-2, -1)), min=1)
    loss = (loss_fn(logits, labels) * mask).sum((-2, -1)) / num_px
    return loss.mean()


def masked_bce_loss(logits, labels, mask, with_logits=False, eps=1e-7):
    """A per-batch-element loss."""
    if with_logits:
        per_px = (torch.relu(logits) - logits * labels +
                  torch.log1p(torch.exp(-torch.abs(logits))))
    else:
        p = torch.clamp(logits, eps, 1.0 - eps)
        per_px = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    mask = mask.detach()
    num_valid = torch.clamp(mask.sum((-3, -2, -1)), min=1)
    return (per_px * mask).sum((-3, -2, -1)) / num_valid


def weighted_softmax(x, mask, dim=-1, eps=1e-12):
    """Softmax normalized over masked-in entries only."""
    maxes = x.amax(dim=dim, keepdim=True)
    x_exp = torch.exp(x - maxes)
    x_exp_sum = (x_exp * mask).sum(dim, keepdim=True) + eps
    return (x_exp / x_exp_sum) * mask


def masked_kl_div_loss(logits, labels, mask, dim=-1, eps=1e-9):
    """KL(labels || softmax(logits)) over K at each pixel, masked.
    logits/labels/mask: [B,K,H,W]. Returns [B]."""
    b, k, h, w = logits.shape
    n = h * w
    logits = logits.reshape(b, k, n).transpose(1, 2)          # [B,N,K]
    labels = labels.reshape(b, k, n).transpose(1, 2)
    mask = mask.reshape(b, k, n).transpose(1, 2)

    probs = weighted_softmax(logits, mask, dim=dim, eps=eps)
    log_probs = torch.log(torch.clamp(probs, min=eps))
    labels = (labels * mask) / torch.clamp(
        (labels * mask).sum(dim, keepdim=True), min=eps)

    # F.kl_div(log_q, p) = p * (log p - log_q), with 0 log 0 = 0
    kl = torch.where(labels > 0,
                     labels * (torch.log(torch.clamp(labels, min=eps))
                               - log_probs),
                     torch.zeros_like(labels))
    loss = (kl * mask).sum(-1)                                 # [B,N]
    num_valid = torch.clamp((mask.sum(-1) > 0).to(loss.dtype).sum(1), min=1)
    return loss.sum(1) / num_valid


def masked_sequence_loss(logits_seq, labels, mask, gamma=0.8,
                         loss_func=functools.partial(masked_per_pixel_loss,
                                                     loss_fn=l1_loss)):
    """Exponentially weighted loss over an iteration sequence (RAFT-style);
    the L1 per-pixel loss by default."""
    if not isinstance(logits_seq, (list, tuple)):
        logits_seq = [logits_seq]
    n = len(logits_seq)
    loss = 0.0
    for it in range(n):
        loss = loss + loss_func(logits_seq[it], labels, mask) * \
            (gamma ** (n - it - 1))
    return loss


def confidence_thresh_samples(x, value_thresh=0.0, confidence_thresh=0.5,
                              dim=-1):
    """Boolean consensus over a sample axis."""
    if isinstance(x, (list, tuple)):
        x = torch.stack(list(x), dim=dim)
    if value_thresh is not None:
        x = (x > value_thresh).float()
    else:
        x = x.float()
    return x.mean(dim=dim) >= confidence_thresh


# ---------------------------------------------------------------------------
# local neighborhoods / boundaries
# ---------------------------------------------------------------------------
def _unfold(padded, k):
    """[B,C,H+k-1,W+k-1] -> [B,C*k*k,H,W]: every k x k window, channel-major
    then row-major within the window (conv_general_dilated_patches' order)."""
    b, c, hp, wp = padded.shape
    h, w = hp - k + 1, wp - k + 1
    return F.unfold(padded, k).reshape(b, c * k * k, h, w)


def get_local_neighbors(im, size=None, radius=3, invalid=-1.0,
                        to_image=False):
    """All (2r+1)^2 local values at every pixel, ``invalid`` beyond the
    image. im: [B,N] / [B,C,N] (with ``size``=(H,W)) or [B,C,H,W].
    Returns [B,C,K,H,W] if ``to_image`` else [B,C,K,H*W], K=(2r+1)^2."""
    if im.dim() == 2:
        h, w = size
        im = im.reshape(im.shape[0], 1, h, w)
    elif im.dim() == 3:
        h, w = size
        im = im.reshape(im.shape[0], im.shape[1], h, w)
    b, c, h, w = im.shape
    k = 2 * radius + 1
    padded = F.pad(im.float(), (radius, radius, radius, radius),
                   value=float(invalid))
    patches = _unfold(padded, k).reshape(b, c, k * k, h, w).to(im.dtype)
    return patches if to_image else patches.reshape(b, c, k * k, h * w)


def get_patches(x, radius=1):
    """Zero-padded local patches as channels.

    x: [B,C,H,W] (or [B,T,C,H,W]) -> [B, C*(2r+1)^2, H, W]."""
    if radius == 0:
        return x
    shape = x.shape
    if x.dim() == 5:
        x = x.reshape(shape[0] * shape[1], *shape[2:])
    k = 2 * radius + 1
    out = _unfold(F.pad(x, (radius, radius, radius, radius)), k)
    if len(shape) == 5:
        out = out.reshape(shape[0], shape[1], *out.shape[1:])
    return out


def _unit(x, dim=1, eps=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)


def _to_circular(vecs, beta):
    """Project [B,2,H,W] orientation vectors onto the 9 grid directions."""
    circle = coordinate_ims(1, 0, (3, 3), normalize=True, dtype=vecs.dtype,
                            device=vecs.device)               # [1,3,3,2]
    circle = circle.movedim(-1, 1).reshape(1, 2, 9, 1, 1)
    dots = (_unit(vecs[:, :, None]) * _unit(circle)).sum(1)  # [B,9,H,W]
    if beta is None:
        # argmax takes the first of tied maxima, as jnp.argmax does
        return F.one_hot(dots.argmax(1), 9).movedim(-1, 1).float()
    return torch.softmax(dots * beta, dim=1)


def spatial_moments_to_circular_target(moments, beta=10.0):
    return _to_circular(moments, beta)


def circular_target_to_spatial_moment(target):
    if target.shape[1] != 8:
        raise ValueError(f'expected 8 directions: {tuple(target.shape)}')
    clock = torch.tensor([[-1, -1], [0, -1], [0, 1], [0, -1], [0, 1],
                          [1, -1], [1, 0], [1, 1]], dtype=torch.float32,
                         device=target.device)
    clock = clock.reshape(1, 8, 2, 1, 1)
    return (target[:, :, None] * clock).sum(1)


def estimate_boundary_orientations(boundaries, energy, radius=3,
                                   to_circle=False, beta=10.0, eps=1e-3):
    """Orientation of each boundary pixel from the local energy centroid.
    boundaries/energy: [B,1,H,W]."""
    b, _, h, w = boundaries.shape
    local = get_local_neighbors(energy * (1 - boundaries), size=(h, w),
                                radius=radius, invalid=0.0,
                                to_image=True)[:, 0]          # [B,K,H,W]
    num_px = local.sum(1, keepdim=True)
    k = 2 * radius + 1
    grid = coordinate_ims(1, 0, (k, k), normalize=True, dtype=local.dtype,
                          device=local.device)                # [1,k,k,2]
    grid = grid.movedim(-1, 1).reshape(1, 2, k * k, 1, 1)
    orientations = (local[:, None] * grid).sum(2)             # [B,2,H,W]
    orientations = orientations / torch.clamp(num_px, min=eps)
    if not to_circle:
        return orientations
    return _to_circular(orientations, beta)


def compute_local_effects(source, adj_local):
    """Splat each source pixel into its local window weighted by affinity
    (the inverse 'fold' of get_local_neighbors).

    source: [B,D,H,W]; adj_local: [B,K,H,W] -> [B,D,H,W]."""
    b, d, h, w = source.shape
    kk = adj_local.shape[-3]
    k = int(np.sqrt(kk))
    if k * k != kk:
        raise ValueError(f'{kk} neighbours is not a square window')
    r = (k - 1) // 2
    eff = source[:, :, None] * adj_local[:, None]            # [B,D,K,H,W]
    out = torch.zeros((b, d, h + 2 * r, w + 2 * r), dtype=source.dtype,
                      device=source.device)
    for i in range(k):
        for j in range(k):
            out[:, :, i:i + h, j:j + w] += eff[:, :, i * k + j]
    return out[:, :, r:r + h, r:r + w]


def local_average(values, excluded, radius=1):
    """Mean over non-excluded local neighbors."""
    neighbors = get_local_neighbors(values * (1 - excluded), radius=radius,
                                    invalid=0.0, to_image=True)
    norm = get_local_neighbors(1 - excluded, radius=radius, invalid=0.0,
                               to_image=True).sum(-3)
    return neighbors.sum(-3) / torch.clamp(norm, min=1)


def get_mask_boundaries(masks):
    """Pixels of a mask whose 3x3 neighborhood leaves the mask.
    masks: [B,K,H,W] -> boundaries [B,K,H,W] float."""
    m = (masks > 0.5).float()
    neigh = get_local_neighbors(m, radius=1, invalid=0.0,
                                to_image=True)               # [B,K,9,H,W]
    center = neigh[:, :, 4:5]
    boundaries = (neigh != center).any(2).float()
    return boundaries * m
