"""The one traffic generator: a traffic mix's parameters (traffic/<mix>.json)
and `--seed` in, the scene and every frame of the run out.

From the seed it draws the marker ids (among the ids that no misread bit
turns into another), the wall's texture (on the device, two calls of one
torch.Generator) and a smooth shake of the camera. Every other quantity
comes from the mix's file:

  scene       markers on a grid (cols, rows, spacing_m, origin [x, y]), the
              texture's bounds [x_min, y_min, x_max, y_max], px_per_m and
              texture_noise
  sequences   named camera paths, each a list of segments:
                line   frames, from [x, y], to [x, y], yaw [a0, a1], pitch
                orbit  frames (one period), center [x, y], radius_m,
                       max_yaw (x = cx + r cos a, y = cy + r/2 sin a,
                       yaw = max_yaw sin a, pitch = max_yaw/2 cos a)
              at distance_m from the wall, with the sequence's optional
              shake {deg, m} (a sum of three sinusoids per axis with seeded
              phases, over the sequence's length)

A sequence's frames are rendered by the frozen renderer and handed to the
program as uint8 host arrays, as a camera driver hands them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from reference import scene as scn


@dataclasses.dataclass
class Sequence:
    poses: List[Tuple[np.ndarray, np.ndarray]]     # true (Rcw, tcw), float64
    frames: List[np.ndarray]                       # [H, W] uint8
    distance: float                                # to the wall, metres


@dataclasses.dataclass
class Traffic:
    world: scn.World
    cam: dict
    sequences: Dict[str, Sequence]


def camera_of(config: dict) -> dict:
    """The camera of a configuration file as the renderer takes it."""
    c = config["slam"]["camera"]
    return dict(fx=float(c["fx"]), fy=float(c["fy"]), cx=float(c["cx"]),
                cy=float(c["cy"]), dist=[float(v) for v in c["dist"]],
                width=int(c["width"]), height=int(c["height"]),
                fps=float(c["fps"]))


def seed64(seed: int) -> int:
    """The seed as torch.Generator takes it (any whole number)."""
    return int(seed) % (2 ** 63)


def make_world(spec: dict, marker_size: float, seed: int, device) -> scn.World:
    rng = np.random.default_rng(seed64(seed))
    cols, rows = int(spec["cols"]), int(spec["rows"])
    n = cols * rows
    ids = rng.choice(scn.distinct_ids(), size=n, replace=False)
    ox, oy = spec.get("origin", [0.0, 0.0])
    s = float(spec["spacing_m"])
    centers = np.asarray([[ox + (i % cols) * s, oy + (i // cols) * s]
                          for i in range(n)])
    bounds = [float(v) for v in spec["bounds"]]
    ppm = float(spec["px_per_m"])
    (ht, wt), (hb, wb) = scn.texture_shape(*bounds, ppm)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    blocks = 90.0 + 80.0 * torch.rand(hb, wb, generator=gen, device=device)
    noise = float(spec["texture_noise"]) * torch.randn(
        ht, wt, generator=gen, device=device)
    return scn.build_world(ids, centers, marker_size, bounds, ppm, blocks,
                           noise)


def _shake(rng, n: int, deg: float, m: float) -> np.ndarray:
    """[n, 6] smooth offsets (three angles in radians, three in metres):
    per axis, three sinusoids of 1, 2 and 3 cycles over the sequence with
    seeded phases, scaled so the axis stays within its amplitude."""
    t = np.arange(n) / max(n, 1)
    phases = rng.uniform(0, 2 * np.pi, size=(6, 3))
    waves = np.stack([sum(np.sin(2 * np.pi * (k + 1) * t + phases[a, k])
                          for k in range(3)) / 3.0 for a in range(6)], -1)
    amp = np.asarray([np.radians(deg)] * 3 + [m] * 3)
    return waves * amp


def _segment_poses(seg: dict):
    n = int(seg["frames"])
    out = []
    if seg["kind"] == "line":
        x0, y0 = seg["from"]
        x1, y1 = seg["to"]
        a0, a1 = seg.get("yaw", [0.0, 0.0])
        for i in range(n):
            f = i / max(n - 1, 1)
            out.append(((x0 + f * (x1 - x0), y0 + f * (y1 - y0)),
                        a0 + f * (a1 - a0), float(seg.get("pitch", 0.0))))
    elif seg["kind"] == "orbit":
        cx, cy = seg["center"]
        r, my = float(seg["radius_m"]), float(seg["max_yaw"])
        for i in range(n):
            a = 2 * np.pi * i / n
            out.append(((cx + r * np.cos(a), cy + 0.5 * r * np.sin(a)),
                        my * np.sin(a), 0.5 * my * np.cos(a)))
    else:
        raise ValueError(f"unknown segment kind {seg['kind']!r}")
    return out


def sequence_poses(spec: dict, rng) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The true (Rcw, tcw) of every frame of a sequence."""
    d = float(spec["distance_m"])
    steps = [p for seg in spec["segments"] for p in _segment_poses(seg)]
    sh = spec.get("shake")
    off = (_shake(rng, len(steps), float(sh["deg"]), float(sh["m"]))
           if sh else np.zeros((len(steps), 6)))
    poses = []
    for ((x, y), yaw, pitch), o in zip(steps, off):
        poses.append(scn.look_at_plane_pose(
            (x + o[3], y + o[4]), d + o[5], yaw=yaw + o[0],
            pitch=pitch + o[1], roll=o[2]))
    return poses


def make_traffic(traffic: dict, config: dict, seed: int, device) -> Traffic:
    """The scene and every sequence's frames for one run."""
    cam = camera_of(config)
    marker_size = float(config["slam"]["aruco"]["marker_size"])
    world = make_world(traffic["scene"], marker_size, seed, device)
    renderer = scn.Renderer(world, cam)
    rng = np.random.default_rng([seed64(seed), 1])
    seqs = {}
    for name, spec in traffic["sequences"].items():
        poses = sequence_poses(spec, rng)
        frames = torch.stack([renderer.render_u8(R, t) for R, t in poses])
        seqs[name] = Sequence(poses, list(frames.cpu().numpy()),
                              float(spec["distance_m"]))
    return Traffic(world, cam, seqs)
