"""The pixel-pair flow correlation with its rows split over ranks.

Port of counterfactualworldmodels_tpu/parallel/covariance.py. The flow
correlation map (pipelines/segmentation.compute_flow_corrs) is an [n, n]
pixel-pair matrix, n = (H/ds)*(W/ds): at 224 px and ds = 1 that is 6.3 GB
per batch row in f32. Every rank z-scores the small [n, S] magnitude matrix
itself and computes only its block of rows of the product; an all_gather
in rank order assembles the matrix on every rank.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from .mesh import BatchSharding


def sharded_flow_corrs(mesh: DeviceMesh, flow_samples: torch.Tensor,
                       downsample: int = 1, use_covariance: bool = False,
                       eps: float = 1e-12, axis: str = 'rows'
                       ) -> torch.Tensor:
    """compute_flow_corrs' plain correlation (or covariance) path with the
    rows split over mesh axis ``axis``. flow_samples [B, C, H, W, S],
    replicated. Returns the full [B, 1, h, w, h, w] on every rank; the mesh
    axis must divide h*w (ValueError otherwise)."""
    b, c, h, w, s = flow_samples.shape
    ds = downsample
    hd, wd = h // ds, w // ds
    n = hd * wd
    sh = BatchSharding(mesh, axis)
    if n % sh.size:
        raise ValueError(f'{n} rows do not split over the {sh.size} ranks '
                         f'of mesh axis {axis!r}')
    fs = flow_samples.reshape(b, c, hd, ds, wd, ds, s).mean((3, 5))
    mags = torch.sqrt((fs ** 2).mean(1)).reshape(b, n, s)  # RMS over channels
    centered = mags - mags.mean(-1, keepdim=True)
    if use_covariance:
        z = centered / torch.sqrt(torch.tensor(float(max(s - 1, 1))))
    else:
        norm = torch.clamp(torch.sqrt((centered ** 2).sum(-1, keepdim=True)),
                           min=eps)
        z = centered / norm
    rows = torch.einsum('bis,bjs->bij', sh.local(z, 1), z)
    corr = torch.nan_to_num(sh.gather(rows, 1), nan=0.0)
    return corr.reshape(b, 1, hd, wd, hd, wd)
