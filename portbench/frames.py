"""The rig and the pool of frames a cell serves, made on the device.

The rig: ``views`` cameras on a horizontal line, ``baseline`` apart, each
looking at (0, 0, target_z) through a flat refractive port ``port_dist``
along its optical axis (index ``refr_index``), with K for a full-size image
of full_width x full_height and focal ``focal``.

A frame: every view of a textured plane, rendered through the ports at the
scaled size.  The plane passes through (0, 0, z) with its normal tilted by
two angles; its texture is a sum of sinusoids per colour channel over the
plane's own coordinates.  Each frame draws its z, tilts, frequencies, phases
and amplitudes from one ``torch.Generator`` seeded with the run's seed, so
the same seed gives the same pool.  Masks are all true.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def converging_rig(r: dict):
    """The cameras as float64 numpy dicts (K, R, t, normal, plane_dist,
    refr_index)."""
    n, h, w = r["views"], r["full_height"], r["full_width"]
    K = np.array([[r["focal"], 0.0, w / 2.0], [0.0, r["focal"], h / 2.0],
                  [0.0, 0.0, 1.0]])
    cams = []
    for i in range(n):
        center = np.array([(i - (n - 1) / 2.0) * r["baseline"], 0.0, 0.0])
        z = np.array([0.0, 0.0, r["target_z"]]) - center
        z /= np.linalg.norm(z)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        cams.append(dict(K=K, R=R, t=-R @ center,
                         normal=np.array([0.0, 0.0, 1.0]),
                         plane_dist=r["port_dist"],
                         refr_index=r["refr_index"]))
    return cams


def pixel_rays(cam: dict, h: int, w: int, scale: float, device):
    """float64 world rays (origins, directions) [h, w, 3] through the scaled
    pixel centres, refracted at the port."""
    f64 = dict(dtype=torch.float64, device=device)
    ys = (torch.arange(h, **f64) + 0.5) / scale
    xs = (torch.arange(w, **f64) + 0.5) / scale
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    kinv = torch.as_tensor(np.linalg.inv(cam["K"]), **f64)
    d = torch.stack([xg, yg, torch.ones_like(xg)], -1) @ kinv.T
    d = d / d.norm(dim=-1, keepdim=True)
    nrm = torch.as_tensor(cam["normal"], **f64)
    n = cam["refr_index"]
    nd = d @ nrm
    o = (cam["plane_dist"] / nd)[..., None] * d
    cos_i = -nd
    cos_t2 = 1.0 - (1.0 - cos_i ** 2) / n ** 2
    sign = torch.where(cos_i > 0, -1.0, 1.0)
    d = d + (cos_i + n * sign * torch.sqrt(cos_t2.clamp(min=0.0)))[..., None] \
        * nrm
    d = d / d.norm(dim=-1, keepdim=True)
    R = torch.as_tensor(cam["R"], **f64)
    t = torch.as_tensor(cam["t"], **f64)
    return (o - t) @ R, d @ R


@dataclass
class Pool:
    rgbs: torch.Tensor     # [F, V, h, w, 3] float32, 0..255
    masks: torch.Tensor    # [V, h, w] bool
    planes: torch.Tensor   # [F, 3] float64: z, tilt about x, about y (rad)


def _params(gen, n_frames, n_waves, device):
    """Uniform draws in [0, 1) for every frame, in one call."""
    per_frame = 3 + 3 * n_waves * 4
    return torch.rand((n_frames, per_frame), generator=gen, device=device,
                      dtype=torch.float64)


def make_pool(rig, views, h, w, scale, scene: dict, n_frames: int, seed: int,
              device) -> Pool:
    """``n_frames`` frames of the cameras ``views`` of ``rig``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    nw = scene["texture_waves"]
    u = _params(gen, n_frames, nw, device)
    z_lo, z_hi = scene["plane_z"]
    tilt = math.radians(scene["tilt_deg"])
    z = z_lo + (z_hi - z_lo) * u[:, 0]
    ax = tilt * (2.0 * u[:, 1] - 1.0)
    ay = tilt * (2.0 * u[:, 2] - 1.0)
    waves = u[:, 3:].reshape(n_frames, 3, nw, 4)
    f_lo, f_hi = scene["frequency"]
    freqs = f_lo + (f_hi - f_lo) * waves[..., :2]             # [F, 3, nw, 2]
    phases = 2.0 * math.pi * waves[..., 2]                    # [F, 3, nw]
    amps = 0.3 + 0.7 * waves[..., 3]
    amps = amps / amps.sum(-1, keepdim=True)
    normal = torch.stack([torch.sin(ay) * torch.cos(ax), torch.sin(ax),
                          torch.cos(ay) * torch.cos(ax)], -1)  # [F, 3]
    e1 = torch.stack([torch.cos(ay), torch.zeros_like(ay), -torch.sin(ay)],
                     -1)
    e2 = torch.linalg.cross(normal, e1)
    p0 = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], -1)
    rgbs = torch.empty((n_frames, len(views), h, w, 3), dtype=torch.float32,
                       device=device)
    for k, v in enumerate(views):
        o, d = pixel_rays(rig[v], h, w, scale, device)
        for f in range(n_frames):
            t = ((p0[f] - o) @ normal[f]) / (d @ normal[f])
            rel = o + t[..., None] * d - p0[f]
            uv = torch.stack([rel @ e1[f], rel @ e2[f]], -1) \
                * scene["texture_scale"]                       # [h, w, 2]
            arg = torch.einsum("hwk,cnk->chwn", uv, freqs[f]) \
                + phases[f][:, None, None]                     # [3, h, w, nw]
            val = (amps[f][:, None, None] * torch.sin(arg)).sum(-1)
            peak = amps[f].abs().amax(-1)[:, None, None]
            rgb = 127.5 + scene["amplitude"] * val / peak * 0.5
            rgbs[f, k] = rgb.clamp(0.0, 255.0).permute(1, 2, 0).to(
                torch.float32)
    masks = torch.ones((len(views), h, w), dtype=torch.bool, device=device)
    planes = torch.stack([z, ax, ay], -1)
    return Pool(rgbs=rgbs, masks=masks, planes=planes)


def true_depths(rig, views, h, w, scale, plane, device):
    """Each view's depth of a frame's plane along its principal ray
    [V, h, w] (float64): the tests hold the mixes' scenes inside the
    configurations' labels with it."""
    z, ax, ay = (float(x) for x in plane)
    normal = torch.tensor([math.sin(ay) * math.cos(ax), math.sin(ax),
                           math.cos(ay) * math.cos(ax)], dtype=torch.float64,
                          device=device)
    p0 = torch.tensor([0.0, 0.0, z], dtype=torch.float64, device=device)
    out = []
    for v in views:
        cam = rig[v]
        o, d = pixel_rays(cam, h, w, scale, device)
        t = ((p0 - o) @ normal) / (d @ normal)
        pts = o + t[..., None] * d
        K, R = cam["K"], cam["R"]
        pr = R.T @ (np.linalg.inv(K) @ (K[:, 2] / K[2, 2]))
        pr = torch.as_tensor(pr / np.linalg.norm(pr), dtype=torch.float64,
                             device=device)
        c = torch.as_tensor(-R.T @ cam["t"], dtype=torch.float64,
                            device=device)
        out.append((pts - c) @ pr)
    return torch.stack(out)
