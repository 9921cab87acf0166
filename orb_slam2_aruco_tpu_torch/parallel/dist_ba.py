"""Distributed bundle adjustment over a list of devices.

Port of orb_slam2_aruco_tpu/parallel/dist_ba.py. JAX shards the BA edge
lists (observations) over a mesh axis with `shard_map`, replicates the
small state (poses, points, markers) and sums the per-shard normal
equation contributions with `psum`. Here one controller does the same over
a "mesh" that is a list of torch devices (repeats allowed: `["cpu"] * 8`
is the JAX tests' 8 virtual CPU devices, `[cuda:0] * n` runs the sharded
code on one card): each shard's edge-level terms are computed on its
device, the partial sums are added on the lead device in shard order
(optim.ba.ba_solve's mesh argument), and one copy of the state is kept and
copied to the other devices once per LM iteration. One process, one map:
no replicas that could drift apart.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch import require_device
from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.optim import ba


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> list:
    """The devices to shard over: `devices` as given (repeats allowed),
    else every CUDA device; the first `n_devices` of them. Raises when it
    names CUDA and there is no GPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        d = require_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    return mesh[:n_devices] if n_devices is not None else mesh


def partition_edges_by_point(prob: ba.BAProblem, n_shards: int):
    """Permute + pad the point-edge lists so that every point's edges land
    on one shard and the shards' loads are balanced (greedy longest-
    processing-time assignment of the per-point edge groups); masked and
    padding edges fill each shard's remainder. Returns (permuted problem,
    scatter [n_shards * cap] int64 numpy: each permuted edge's original
    index, -1 for padding). The assignment is computed on the host from one
    read of e_pt and e_mask, as in JAX."""
    e_pt = prob.e_pt.cpu().numpy()
    e_mask = prob.e_mask.cpu().numpy()
    E = e_pt.shape[0]
    valid = e_mask > 0
    vidx = np.flatnonzero(valid)
    midx = np.flatnonzero(~valid)
    order = vidx[np.argsort(e_pt[vidx], kind="stable")]
    pts, starts, counts = np.unique(
        e_pt[order], return_index=True, return_counts=True)
    # LPT: biggest groups first onto the lightest shard
    shard_of = np.zeros(len(pts), np.int32)
    load = np.zeros(n_shards, np.int64)
    for g in np.argsort(-counts, kind="stable"):
        s = int(np.argmin(load))
        shard_of[g] = s
        load[s] += counts[g]
    # spread the masked edges to even the loads before the cap
    spare = np.zeros(n_shards, np.int64)
    for _ in range(len(midx)):
        spare[int(np.argmin(load + spare))] += 1
    cap = int(np.max(load + spare)) if E else 0
    scatter = np.full(n_shards * cap, -1, np.int64)
    fill = np.zeros(n_shards, np.int64)
    for g in np.argsort(-counts, kind="stable"):
        s = shard_of[g]
        n = counts[g]
        o = s * cap + fill[s]
        scatter[o:o + n] = order[starts[g]:starts[g] + n]
        fill[s] += n
    mi = 0
    for s in range(n_shards):
        take = min(len(midx) - mi, cap - int(fill[s]))
        if take > 0:
            o = s * cap + int(fill[s])
            scatter[o:o + take] = midx[mi:mi + take]
            mi += take
            fill[s] += take

    dev = prob.e_pt.device
    idx = torch.as_tensor(np.maximum(scatter, 0), device=dev)
    ok = torch.as_tensor(scatter >= 0, device=dev)

    def permute1(x):
        out = x.index_select(0, idx)
        keep = ok.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(keep, out, torch.zeros_like(out))

    prob2 = prob._replace(
        e_kf=permute1(prob.e_kf), e_pt=permute1(prob.e_pt),
        e_uv=permute1(prob.e_uv), e_info=permute1(prob.e_info),
        e_mask=permute1(prob.e_mask))
    return prob2, scatter


def pad_edges_to(prob: ba.BAProblem, multiple: int) -> ba.BAProblem:
    """Pad the edge lists so their lengths divide by the mesh size (padded
    edges are masked out)."""

    def pad1(x, n_to):
        pad = n_to - x.shape[0]
        if pad == 0:
            return x
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

    E2 = -(-prob.e_kf.shape[0] // multiple) * multiple
    F2 = -(-prob.m_kf.shape[0] // multiple) * multiple
    return prob._replace(
        **{k: pad1(getattr(prob, k), E2) for k in ba.POINT_EDGES},
        **{k: pad1(getattr(prob, k), F2) for k in ba.MARKER_EDGES})


def distributed_ba_solve(prob: ba.BAProblem, cam: Camera, mesh,
                         iters: int = 10, huber_delta: float = 2.4477,
                         lam0: float = 1e-4) -> ba.BAResult:
    """ba_solve with the observations sharded over `mesh` (a list of
    devices, make_mesh; the result lies on mesh[0]). Point edges are
    partitioned by landmark (partition_edges_by_point) as in JAX; the
    returned edge_chi2 is scattered back to the caller's edge order. On a
    one-entry mesh the problem goes to ba_solve as it is, so the result is
    the single-device solve's, bit for bit."""
    mesh = list(mesh)
    lead = mesh[0]
    prob, cam = ba.to_device(prob, lead), ba.to_device(cam, lead)
    if len(mesh) == 1:
        return ba.ba_solve(prob, cam, iters=iters, huber_delta=huber_delta,
                           lam0=lam0)
    E_orig = int(prob.e_kf.shape[0])
    prob, scatter = partition_edges_by_point(prob, len(mesh))
    prob = pad_edges_to(prob, len(mesh))
    out = ba.ba_solve(prob, cam, iters=iters, huber_delta=huber_delta,
                      lam0=lam0, mesh=mesh)
    # un-permute the per-edge chi2 back to the caller's edge order
    keep = torch.as_tensor(scatter >= 0, device=lead)
    src = torch.as_tensor(scatter, device=lead)[keep]
    chi = torch.zeros(E_orig, dtype=out.edge_chi2.dtype, device=lead)
    chi[src] = out.edge_chi2[:len(scatter)][keep]
    return out._replace(edge_chi2=chi)
