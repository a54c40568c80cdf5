"""Frustum culling — kernel K1 and its plain version (counterpart of
``lumixengine_tpu/ops/culling.py``).

K1 replaces ``lumixengine_tpu/ops/culling.py::frustum_cull_pallas``: the
world-batched sphere test ``min over planes 0..5 of
((x·px + y·py) + z·pz) + pd >= -r``. The CUDA source is ``csrc/cull.cu``,
which notes what bounds it on the H100 (device memory: 16 bytes in and 1
out per sphere) and why its products and sums are rounded one by one.

``frustum_cull`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; there is no fallback between the two.
"""
from __future__ import annotations

import torch

from lumixengine_tpu_torch.ops import native


def frustum_cull_plain(centers: torch.Tensor, radii: torch.Tensor,
                       planes: torch.Tensor) -> torch.Tensor:
    """centers [W,3,K], radii [W,K], planes [W,8,4] → visible bool [W,K]."""
    p = planes[:, :6, :, None]                        # [W,6,4,1]
    x, y, z = centers[:, 0, None], centers[:, 1, None], centers[:, 2, None]
    dist = ((x * p[:, :, 0] + y * p[:, :, 1]) + z * p[:, :, 2]) + p[:, :, 3]
    return torch.amin(dist, dim=1) >= -radii


def frustum_cull_cuda(centers: torch.Tensor, radii: torch.Tensor,
                      planes: torch.Tensor) -> torch.Tensor:
    """Launch K1 on the current stream. Same contract as the plain version."""
    dev = centers.device
    w, three, k = centers.shape
    if three != 3 or radii.shape != (w, k) or planes.shape != (w, 8, 4):
        raise ValueError(f"bad shapes {tuple(centers.shape)} {tuple(radii.shape)} "
                         f"{tuple(planes.shape)}")
    if w > 65535:
        raise ValueError("K1 takes at most 65535 worlds per launch")
    for name, t in (("centers", centers), ("radii", radii), ("planes", planes)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32")
    native.check_operands(dev, centers=centers, radii=radii, planes=planes)
    out = torch.empty((w, k), dtype=torch.uint8, device=dev)
    lib = native.library()
    rc = lib.lumix_frustum_cull(centers.data_ptr(), radii.data_ptr(), planes.data_ptr(),
                                out.data_ptr(), w, k, native.stream_handle(dev))
    native.check(rc, "lumix_frustum_cull")
    frustum_cull_cuda.launches += 1
    return out.view(torch.bool)


def frustum_cull(centers: torch.Tensor, radii: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Sphere-vs-frustum visibility. centers [..., 3, K], radii [..., K],
    planes [..., 8, 4] → bool [..., K]. CPU tensors take the plain version;
    CUDA tensors launch K1."""
    batch = radii.shape[:-1]
    k = radii.shape[-1]
    c = centers.reshape(-1, 3, k).contiguous()
    r = radii.reshape(-1, k).contiguous()
    p = planes.reshape(-1, 8, 4).to(torch.float32).contiguous()
    if c.device.type == "cpu":
        out = frustum_cull_plain(c, r, p)
    elif c.device.type == "cuda":
        out = frustum_cull_cuda(c, r, p)
    else:
        raise ValueError(f"frustum_cull: unsupported device {c.device}")
    return out.reshape(batch + (k,))


frustum_cull_cuda.launches = 0  # kernel launches, counted where K1 is launched
