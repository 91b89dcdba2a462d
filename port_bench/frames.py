"""Camera frames made from the seed on the device: a textured blob field
seen along a trajectory through a configuration's intrinsics.

A frozen PyTorch copy of the port's ``utils/synthetic.py``
(``textured_blob_field``, ``render_blob_image``) and of the trajectories of
``benchmarks/slam_bench.py`` (``render_zigzag_sequence``, the dolly of
``render_sequence``). The host renderer draws one blob at a time; here a
frame is one matrix product: a blob is an isotropic Gaussian cut to a
rectangle, so it is the outer product of a row profile and a column
profile, and a frame is ``background + Gyᵀ · diag(a) · Gx`` in float64,
whose products are deterministic on the card. The scene's random numbers
come from a ``torch.Generator`` seeded with the traffic's scene seed, the
sensor noise's from one seeded with the run's seed, each in a fixed
order, so one seed gives the same frames bit for bit. The frames are quantised to 8-bit levels and returned as
float32 in [0, 1], as the host renderer's ``round(img·255)/255``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SEED_MODULUS = 2**63  # torch.Generator takes a seed below 2**64; keep it positive


def rodrigues(w) -> np.ndarray:
    """Rotation matrix (float64) of the axis-angle ``w``."""
    w = np.asarray(w, dtype=np.float64)
    theta = float(np.linalg.norm(w))
    k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + k
    k = k / theta
    return np.eye(3) + math.sin(theta) * k + (1.0 - math.cos(theta)) * (k @ k)


def zigzag_pose(f: int):
    """``render_zigzag_sequence``: forward advance with lateral sweeps and a
    yaw wiggle (hand-held)."""
    r = rodrigues([0.0, 0.015 * np.sin(0.4 * f), 0.0])
    center = np.array([0.1 * f, 0.35 * np.sin(0.75 * f), 0.25 * np.sin(0.35 * f)])
    return r, center


def dolly_pose(f: int):
    """``render_sequence``: a slow translation with a slow rotation."""
    r = rodrigues([0.004 * f, -0.01 * f, 0.002 * f])
    center = np.array([0.14 * f, 0.01 * f, 0.0])
    return r, center


# name: (pose of frame f, advance along x a frame: the field's length)
TRAJECTORIES = {"zigzag": (zigzag_pose, 0.1), "dolly": (dolly_pose, 0.14)}


def poses(trajectory: str, num_frames: int, clip: int | None = None):
    """``(R, t)`` world→camera of every frame, ``(F, 3, 3)`` and ``(F, 3)``.
    With ``clip`` the path restarts every ``clip`` frames, each clip where
    the last one ended along the field: the dolly's rotation grows with the
    frame number and would turn the camera from the field on a long ring."""
    pose, advance = TRAJECTORIES[trajectory]
    clip = clip or num_frames
    rots, ts = [], []
    for f in range(num_frames):
        k, j = divmod(f, clip)
        r, center = pose(j)
        center = center + np.array([advance * clip * k, 0.0, 0.0])
        rots.append(r)
        ts.append(-r @ center)
    return np.stack(rots), np.stack(ts)


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float64, device=device)


def blob_field(g, trajectory: str, num_frames: int, landmarks_per_unit: float,
               satellites: int, spread: float, device):
    """``(points (N, 3), amplitudes (N,), sigma_scales (N,))``: landmarks at
    ``landmarks_per_unit`` a unit of path over the stretch the trajectory
    sweeps, each expanded into a parent blob, one dominant satellite of the
    opposite sign and ``satellites - 1`` small ones
    (``textured_blob_field``)."""
    x_hi = 3.5 + TRAJECTORIES[trajectory][1] * num_frames
    n = int(landmarks_per_unit * (x_hi + 3.5))
    lo = torch.tensor([-3.5, -1.8, 4.0], dtype=torch.float64, device=device)
    hi = torch.tensor([x_hi, 1.8, 9.0], dtype=torch.float64, device=device)
    pts = _uniform(g, (n, 3), lo, hi, device)
    sign = torch.where(torch.arange(n, device=device) % 2 == 0, 1.0, -1.0).to(torch.float64)
    parent_amp = 0.5 * sign
    parts, amps, scales = [pts], [parent_amp], [torch.ones(n, dtype=torch.float64, device=device)]
    ang = _uniform(g, (n,), 0.0, 2 * math.pi, device)
    dz = _uniform(g, (n,), -0.08, 0.08, device)
    dom = 0.6 * spread * torch.stack([torch.cos(ang), torch.sin(ang), dz], dim=-1)
    parts.append(pts + dom)
    amps.append(-0.9 * parent_amp)
    scales.append(torch.full((n,), 0.6, dtype=torch.float64, device=device))
    for _ in range(max(0, satellites - 1)):
        offs = _uniform(g, (n, 3), -spread, spread, device)
        offs[:, 2] *= 0.1
        parts.append(pts + offs)
        mag = _uniform(g, (n,), 0.15, 0.3, device)
        sgn = torch.where(torch.rand(n, generator=g, device=device) < 0.5, -1.0, 1.0)
        amps.append(mag * sgn.to(torch.float64))
        scales.append(_uniform(g, (n,), 0.35, 0.55, device))
    return torch.cat(parts), torch.cat(amps), torch.cat(scales)


def _profiles(center, sigma, r, extent, keep, n_pixels):
    """``(F, N, n_pixels)`` row or column profiles ``exp(-(p-c)²/2σ²)`` on
    ``[max(0, trunc(c)-r), min(extent, trunc(c)+r+1))``, zero elsewhere and
    for blobs not kept."""
    c0 = torch.trunc(center)
    lo = torch.clamp(c0 - r, min=0.0)
    hi = torch.clamp(c0 + r + 1, max=float(extent))
    p = torch.arange(n_pixels, dtype=torch.float64, device=center.device)
    d = p - center[..., None]
    inside = (p >= lo[..., None]) & (p < hi[..., None]) & keep[..., None]
    prof = torch.exp(-(d * d) / (2.0 * sigma * sigma)[..., None])
    return torch.where(inside, prof, 0.0), lo < hi


def render(g, points, amplitudes, sigma_scales, rots, ts, intrinsics, size,
           blob_sigma: float = 12.0, background: float = 0.35, noise: float = 0.01,
           chunk: int = 4) -> torch.Tensor:
    """``(F, H, W)`` float32 frames of the blob field from poses ``rots``,
    ``ts`` (``render_blob_image``: a blob's sigma is ``scale·blob_sigma/z``
    pixels, cut at ``int(3σ)+1``; blobs behind ``z = 0.2``, beyond 20 px of
    the frame or under 0.8 px are left out; Gaussian noise, clip,
    quantisation to 8-bit levels)."""
    w, h = size
    fx, fy, cx, cy = intrinsics
    device = points.device
    rots = torch.as_tensor(rots, dtype=torch.float64, device=device)
    ts = torch.as_tensor(ts, dtype=torch.float64, device=device)
    frames = []
    for start in range(0, len(rots), chunk):
        r, t = rots[start:start + chunk], ts[start:start + chunk]
        xc = torch.einsum("nk,fjk->fnj", points, r) + t[:, None, :]
        z = xc[..., 2]
        safe = torch.where(z != 0, z, 1.0)
        u = torch.where(z != 0, xc[..., 0] / safe, 0.0) * fx + cx
        v = torch.where(z != 0, xc[..., 1] / safe, 0.0) * fy + cy
        sigma = sigma_scales * blob_sigma / safe
        keep = (z > 0.2) & (u >= -20) & (u <= w + 20) & (v >= -20) & (v <= h + 20) & (sigma >= 0.8)
        # Only the blobs that some frame of the chunk draws, in their order.
        seen = torch.nonzero(keep.any(dim=0)).squeeze(1)
        u, v, sigma, keep = u[:, seen], v[:, seen], sigma[:, seen], keep[:, seen]
        radius = torch.floor(3.0 * torch.where(keep, sigma, 0.0)) + 1.0
        gx, ok_x = _profiles(u, sigma, radius, w, keep, w)
        gy, ok_y = _profiles(v, sigma, radius, h, keep, h)
        a = torch.where(keep & ok_x & ok_y, amplitudes[seen], 0.0)
        img = background + torch.bmm((gy * a[..., None]).transpose(1, 2), gx)
        img = img + noise * torch.randn(img.shape, generator=g, dtype=torch.float64, device=device)
        img = torch.round(img.clamp(0.0, 1.0) * 255.0) / 255.0
        frames.append(img.to(torch.float32))
    return torch.cat(frames)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MODULUS)
    return g


def make_frames(seed: int, config: dict, traffic: dict, num_frames: int, device) -> torch.Tensor:
    """The cell's ring of ``num_frames`` consecutive frames ``(F, H, W)``
    float32 on ``device``: the traffic's scene, made from its own
    ``scene["seed"]`` as a recorded sequence is one scene, seen along its
    trajectory through the configuration's intrinsics, with the sensor
    noise drawn from the run's ``seed``. Every seed so gets the same
    blobs, and the same work to within what the noise moves."""
    scene = traffic["scene"]
    points, amps, scales = blob_field(
        _generator(scene["seed"], device), traffic["trajectory"], num_frames,
        scene["landmarks_per_unit"], scene["satellites"], scene["satellite_spread"], device,
    )
    rots, ts = poses(traffic["trajectory"], num_frames, traffic.get("clip_frames"))
    k = config["intrinsics"]
    return render(
        _generator(seed, device), points, amps, scales, rots, ts,
        (k["fx"], k["fy"], k["cx"], k["cy"]), (config["width"], config["height"]),
        scene["blob_sigma"], scene["background"], scene["noise"],
    )
