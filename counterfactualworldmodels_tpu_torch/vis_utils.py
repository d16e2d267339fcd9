"""Tensor visualization helpers.

Port of counterfactualworldmodels_tpu/vis_utils.py. matplotlib is imported
only inside ``imshow``, and only when it has no axes to draw on.
"""
from __future__ import annotations

import numpy as np
import torch


def _numpy(img) -> np.ndarray:
    """An array or tensor (on any device) as a float32 numpy array."""
    if isinstance(img, torch.Tensor):
        img = img.detach().float().cpu().numpy()
    return np.asarray(img, dtype=np.float32)


def to_numpy_image(img, channels_first=True):
    """[C,H,W] / [B,C,H,W] / [B,T,C,H,W] array or tensor -> [H,W,C] float
    numpy ([H,W] for one channel)."""
    img = _numpy(img)
    while img.ndim > 3:
        img = img[0]
    if channels_first and img.ndim == 3 and img.shape[0] in (1, 2, 3):
        img = img.transpose(1, 2, 0)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    return img


def imshow(ims, ax=None, ex=0, t=0, vmin=None, vmax=None, cmap=None,
           title=None, fontsize=12, **kwargs):
    """Show a [B,C,H,W] or [B,T,C,H,W] array or tensor on ``ax`` (a new
    matplotlib figure's axes when None: only then is matplotlib imported,
    so any object with matplotlib's Axes methods can stand in for it)."""
    ims = _numpy(ims)
    if ims.ndim == 5:
        ims = ims[:, t]
    if ims.ndim == 4:
        ims = ims[ex]
    img = to_numpy_image(ims)
    if ax is None:
        import matplotlib.pyplot as plt
        _, ax = plt.subplots(1, 1)
    ax.imshow(np.clip(img, vmin if vmin is not None else img.min(),
                      vmax if vmax is not None else img.max()),
              vmin=vmin, vmax=vmax, cmap=cmap, **kwargs)
    if title is not None:
        ax.set_title(title, fontsize=fontsize)
    return ax
