"""Distributed execution: data-parallel extraction, sharded BA.

shard_map-based SPMD wrappers (XLA inserts the collectives; across GPUs of
one host they ride NVLink). The reference has no counterpart (SURVEY.md
section 2); layout follows the north star: frames data-parallel, map blocks
model-parallel, Schur reductions as psums.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..backend import ba
from ..config import PislamConfig
from ..frontend import _extract_impl
from ..ops import nms


def make_batch_extract(cfg: PislamConfig, mesh: Mesh):
    """Batched data-parallel extraction: frames (B, H, W) sharded on "data".

    B must be a multiple of the data-axis size. Returns a jitted function
    frames -> Features with leading batch dim, sharded the same way.
    """
    pc = cfg.pyramid
    mask = jnp.asarray(nms.make_level_mask(
        pc.level_sizes, pc.level_rows, pc.padded_height, pc.stride,
        cfg.frontend.border))

    def one(frame):
        return _extract_impl(frame, mask, cfg)

    spec = P("data", None, None)
    out_spec = P("data")

    @jax.jit
    def run(frames):
        f = shard_map(
            jax.vmap(one), mesh=mesh,
            in_specs=(spec,), out_specs=out_spec, check_vma=False)
        return f(frames)

    return run


def make_streaming_pipeline(cfg: PislamConfig, mesh: Mesh):
    """Data-parallel streaming: per-device camera streams, zero host trips.

    frames (B, T, H, W) uint8 with B sharded on "data" (one or more full
    sequences per device, e.g. a multi-camera rig or sharded dataset
    ingest). Each device runs its streams as a jax.lax.scan of the full
    production per-frame path -- 8-level pyramid build + ORB extraction +
    Hamming matching against the previous frame (the single-chip streaming
    benchmark, tools/bench_streaming.py, widened over the mesh). No
    collectives cross streams, so scaling is embarrassingly parallel and
    efficiency measures pure SPMD overhead. Returns a jitted
    frames -> (num_feats (B, T-1), num_matches (B, T-1)).
    """
    from .. import matching as m
    from ..ops import pyramid as pyr_ops

    pc = cfg.pyramid
    mc = cfg.matcher
    mask = jnp.asarray(nms.make_level_mask(
        pc.level_sizes, pc.level_rows, pc.padded_height, pc.stride,
        cfg.frontend.border))

    def frontend(frame):
        stack = pyr_ops.build_pyramid(frame, pc)
        return _extract_impl(stack, mask, cfg)

    def step(prev, frame):
        feats = frontend(frame)
        idx2, _ = m.match(
            prev.descriptors, feats.descriptors, prev.valid, feats.valid,
            max_distance=mc.max_distance, ratio=mc.ratio,
            cross_check=mc.cross_check)
        return feats, (feats.num_valid, jnp.sum(idx2 >= 0))

    def seq(frames):
        f0 = frontend(frames[0])
        _, out = jax.lax.scan(step, f0, frames[1:])
        return out

    @jax.jit
    def run(frames):
        f = shard_map(
            jax.vmap(seq), mesh=mesh,
            in_specs=(P("data", None, None, None),),
            out_specs=(P("data"), P("data")), check_vma=False)
        return f(frames)

    return run


def make_vo_streaming(cfg: PislamConfig, fx: float, fy: float,
                      cx: float, cy: float, mesh: Mesh, dist=None):
    """Data-parallel device-resident VO: one full trajectory per stream.

    frames (B, T, H, W) uint8 with B sharded on "data" (a multi-camera rig
    or a sharded dataset sweep), keys (B, 2) uint32 PRNG keys. Each device
    runs models.visual_odometry.make_vo_scan over its streams -- the whole
    VO pipeline (pyramid, extraction, matching, RANSAC, pose chaining)
    inside one lax.scan, no host round-trips. No collectives cross streams;
    scaling is embarrassingly parallel. Returns a jitted
    (frames, keys) -> dict of stacked trajectories (R (B, T, 3, 3),
    t (B, T, 3), num_inliers/accepted (B, T-1)).
    """
    from ..models.visual_odometry import make_vo_scan

    one = make_vo_scan(cfg, fx, fy, cx, cy, dist=dist)

    @jax.jit
    def run(frames, keys):
        f = shard_map(
            jax.vmap(one), mesh=mesh,
            in_specs=(P("data", None, None, None), P("data", None)),
            out_specs=P("data"), check_vma=False)
        return f(frames, keys)

    return run


def make_slam_streaming(cfg: PislamConfig, fx: float, fy: float,
                        cx: float, cy: float, mesh: Mesh,
                        keyframe_min_inliers: int = 60,
                        keyframe_max_gap: int = 10, dist=None):
    """Data-parallel multi-session SLAM: one independent map per stream.

    frames (B, T, H, W) uint8 with B sharded on "data"; states a SlamState
    batch (leading axis B, see ``batch_slam_states``). Each device runs the
    device-resident tracking scan (models/slam_scan.py) over its streams --
    B independent SLAM sessions (separate keyframe rings / landmark maps)
    advance T frames in ONE dispatch. This is the dataset-sweep / fleet
    shape: map a directory of sequences over the devices, collect
    trajectories and final map states (checkpointable per stream). Returns
    a jitted (states, frames) -> (states, outs) with outs stacked (B, T, ...).
    """
    from ..models.slam_scan import make_slam_track_scan

    one = make_slam_track_scan(
        cfg, fx, fy, cx, cy, keyframe_min_inliers=keyframe_min_inliers,
        keyframe_max_gap=keyframe_max_gap, dist=dist)

    @jax.jit
    def run(states, frames):
        f = shard_map(
            jax.vmap(one), mesh=mesh,
            in_specs=(P("data"), P("data", None, None, None)),
            out_specs=P("data"), check_vma=False)
        return f(states, frames)

    return run


def batch_slam_states(cfg: PislamConfig, n: int, seed: int = 7):
    """Stack n fresh SlamStates (distinct PRNG keys) along a leading axis."""
    from ..models.slam import init_state

    states = [init_state(cfg, seed=seed + i) for i in range(n)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _sharded_match_local(axis: str, n: int, descA, descB_s, validA, validB_s,
                         max_distance: int, ratio: float, cross_check: bool,
                         gate=None):
    """Per-device body of cross-shard matching (inside shard_map).

    Query (descA) replicated, database (descB_s) row-sharded on `axis`.
    Each device matmuls its shard, then per-row (best, second, index)
    candidates merge with one all_gather -- bit-identical to single-device
    matching.match (global first-occurrence argmin: ties resolve to the
    lowest shard, then the lowest local index). Returns (idx_g, best_g)
    with idx_g = -1 for unmatched, best_g the raw best distance.
    """
    from .. import matching as m

    k1 = descA.shape[0]
    k2s = descB_s.shape[0]
    dist = m.hamming_matrix(descA, descB_s, validA, validB_s)
    if gate is not None:  # (uvA (K1,2), uvB_s (K2s,2), radius)
        dist = m.gate(dist, *gate)
    bidx, best, second = m._best_two(dist)
    rbest = jnp.argmin(dist, axis=0)
    shard = jax.lax.axis_index(axis)
    gidx = bidx + shard * k2s

    all_best = jax.lax.all_gather(best, axis)      # (n, K1)
    all_second = jax.lax.all_gather(second, axis)  # (n, K1)
    all_idx = jax.lax.all_gather(gidx, axis)       # (n, K1)

    w = jnp.argmin(all_best, axis=0)               # winning shard per row
    rows = jnp.arange(k1)
    best_g = all_best[w, rows]
    idx_g = all_idx[w, rows]
    # second best of the union = min over (all seconds, losing bests)
    masked = all_best.at[w, rows].set(m.MAX_DIST)
    second_g = jnp.minimum(jnp.min(all_second, axis=0),
                           jnp.min(masked, axis=0))

    ok = best_g <= max_distance
    ok &= best_g.astype(jnp.float32) < ratio * second_g.astype(jnp.float32)
    if cross_check:
        # rbest: per local column first-argmin
        all_rbest = jax.lax.all_gather(rbest, axis).reshape(n * k2s)
        ok &= all_rbest[idx_g] == rows
    ok &= validA
    return jnp.where(ok, idx_g, -1), best_g


def make_sharded_map_tracker(cfg: PislamConfig, mesh: Mesh,
                             axis: str = "model"):
    """Local-map tracking with the LANDMARK MAP sharded across `axis`.

    The north-star map-scaling primitive (SURVEY.md section 5 "map/keyframe
    sharding across hosts"): landmark descriptors/positions live row-sharded
    over the mesh axis, each device matmuls the replicated query features
    against its shard, candidates merge with one all_gather, matched
    landmark positions are fetched shard-locally and combined with one
    psum, and the small motion-only BA replicates. Call-compatible with the
    single-device ``track_map_state`` partial application
    (lmap, feats, pts, R0, t0) and produces the same (R, t, num_inliers,
    assoc) -- the match is bit-identical, the pose to float tolerance.

    cfg.map.max_landmarks must divide by the axis size.
    """
    from ..backend import pnp

    mc = cfg.map
    n = mesh.shape[axis]
    assert mc.max_landmarks % n == 0, (mc.max_landmarks, n)

    def local(desc_s, valid_s, xyz_s, fdesc, fvalid, pts, R0, t0):
        ls = desc_s.shape[0]
        gate = None
        if mc.gate_radius > 0:  # shard-local landmark projection gate
            xc = xyz_s @ R0.T + t0
            z = xc[:, 2]
            uvl = xc[:, :2] / jnp.maximum(z, 1e-6)[:, None]
            uvl = jnp.where((z > 1e-6)[:, None], uvl, jnp.float32(1e6))
            gate = (pts, uvl, mc.gate_radius)
        idx, _ = _sharded_match_local(
            axis, n, fdesc, desc_s, fvalid, valid_s,
            mc.map_match_max_distance, cfg.matcher.ratio, True, gate=gate)
        ok = idx >= 0
        # shard-local landmark-position fetch, merged with one psum
        shard = jax.lax.axis_index(axis)
        li = idx - shard * ls
        own = ok & (li >= 0) & (li < ls)
        xyz_part = jnp.where(own[:, None],
                             xyz_s[jnp.clip(li, 0, ls - 1)], 0.0)
        xyz = jax.lax.psum(xyz_part, axis)
        out = pnp.motion_only_ba(
            R0, t0, xyz, pts, ok, iters=mc.pnp_iters,
            inlier_threshold=mc.pnp_inlier_threshold)
        assoc = jnp.where(out["inliers"], idx, -1)
        return out["R"], out["t"], out["num_inliers"], assoc

    rep = P()
    sh = P(axis)

    @jax.jit
    def run(lmap, feats, pts, R0, t0):
        f = shard_map(
            local, mesh=mesh,
            in_specs=(P(axis, None), sh, P(axis, None),
                      rep, rep, rep, rep, rep),
            out_specs=(rep, rep, rep, rep), check_vma=False)
        return f(lmap.descriptors, lmap.valid, lmap.xyz,
                 feats.descriptors, feats.valid, pts, R0, t0)

    return run


def make_sharded_store_counts(cfg: PislamConfig, mesh: Mesh,
                              axis: str = "model"):
    """Loop-detection counts with the KEYFRAME STORE sharded across `axis`.

    matching.match_many's (F*K1, K2) matmul splits over the mesh axis by
    keyframe rows; the per-keyframe candidate counts merge with one
    all_gather. Call-compatible with the single-device
    ``_store_counts`` (store, feats) -> (F,) counts, identical values.

    cfg.map.keyframe_capacity must divide by the axis size.
    """
    from .. import matching as m

    n = mesh.shape[axis]
    assert cfg.map.keyframe_capacity % n == 0, \
        (cfg.map.keyframe_capacity, n)

    def local(descs_s, valids_s, desc2, valid2):
        _idx, counts = m.match_many(
            descs_s, valids_s, desc2, valid2,
            max_distance=cfg.matcher.max_distance,
            ratio=cfg.matcher.ratio,
            cross_check=cfg.matcher.cross_check)
        return jax.lax.all_gather(counts, axis).reshape(-1)

    rep = P()

    @jax.jit
    def run(store, feats):
        f = shard_map(
            local, mesh=mesh,
            in_specs=(P(axis, None, None), P(axis, None), rep, rep),
            out_specs=rep, check_vma=False)
        return f(store.descriptors, store.kp_valid,
                 feats.descriptors, feats.valid)

    return run


def make_sharded_match(mesh: Mesh, axis: str = "model",
                       max_distance: int = 64, ratio: float = 0.8,
                       cross_check: bool = True):
    """Cross-shard Hamming matching: query descriptors replicated, database
    descriptors sharded on `axis` (e.g. a landmark map split across chips,
    SURVEY.md section 5 "collectives for Hamming-matching shards").

    Each device matmuls its database shard (matching.hamming_matrix), then
    the per-row (best, second, index) candidates are merged with one
    all_gather over the axis -- identical results to single-device
    matching.match, bit for bit.

    Returns run(descA, descB_sharded, validA, validB_sharded) -> (idx, dist)
    (matching.match argument order) with global database indices in shard
    order.
    """
    def local(descA, descB_s, validA, validB_s):
        from .. import matching as m
        idx_g, best_g = _sharded_match_local(
            axis, mesh.shape[axis], descA, descB_s, validA, validB_s,
            max_distance, ratio, cross_check)
        return idx_g, jnp.where(idx_g >= 0, best_g, m.MAX_DIST)

    rep, sh = P(), P(axis)

    @jax.jit
    def run(descA, descB, validA, validB):
        f = shard_map(local, mesh=mesh,
                      in_specs=(rep, P(axis, None), rep, sh),
                      out_specs=(rep, rep), check_vma=False)
        return f(descA, descB, validA, validB)

    return run


def shard_ba_problem(p: ba.BAProblem, n_shards: int) -> ba.BAProblem:
    """Re-layout a BA problem for model-parallel solving.

    Landmarks and observations are split into `n_shards` equal slabs with
    observations co-located with their landmark (obs_pt becomes shard-local).
    Host-side preprocessing (numpy-friendly, runs once per window).
    """
    import numpy as np

    P_ = int(p.points.shape[0])
    O = int(p.obs_cam.shape[0])
    assert P_ % n_shards == 0, "pad points to a multiple of the model axis"
    pp = P_ // n_shards

    obs_pt = np.asarray(p.obs_pt)
    obs_shard = obs_pt // pp
    order = np.argsort(obs_shard, kind="stable")
    counts = np.bincount(obs_shard, minlength=n_shards)
    per = int(np.max(counts)) if O else 1
    per = -(-per // 8) * 8  # pad shard obs count to a multiple of 8

    def scatter(a, fill=0):
        a = np.asarray(a)
        out = np.full((n_shards, per) + a.shape[1:], fill, a.dtype)
        pos = 0
        for s in range(n_shards):
            c = counts[s]
            out[s, :c] = a[order[pos:pos + c]]
            pos += c
        return out.reshape((n_shards * per,) + a.shape[1:])

    new = ba.BAProblem(
        R=p.R, t=p.t,
        points=p.points,
        obs_cam=jnp.asarray(scatter(p.obs_cam)),
        obs_pt=jnp.asarray(scatter(obs_pt) % pp),  # shard-local landmark index
        obs_uv=jnp.asarray(scatter(p.obs_uv)),
        obs_valid=jnp.asarray(scatter(np.asarray(p.obs_valid), fill=False)),
        cam_valid=p.cam_valid,
        pt_valid=p.pt_valid,
    )
    return new


def make_distributed_ba(mesh: Mesh, iters: int = 8, damping: float = 1e-4,
                        axis: str = "model", solver: str = "dense",
                        cg_iters: int = 64, huber: float = 0.0):
    """Jitted model-parallel bundle adjustment over `mesh`.

    Expects a problem laid out by shard_ba_problem(n_shards=mesh axis size):
    points/observations sharded on their leading dim, poses replicated.
    The Schur reduction runs as psums over the axis (backend/ba.py).

    solver="dense" factorises the replicated (6C, 6C) reduced camera matrix
    after one psum per LM iteration; "cg" never materialises W or S --
    reduced_system_cg applies S x from shard-local per-observation terms
    and psums only the (C, 6) camera-sized vectors per CG iteration, the
    global-BA path at large keyframe capacity (the dense path's
    (P, C*6, 3) W tensor and O((6C)^3) factorisation stop scaling there).
    """
    shard = P(axis)
    shard2 = P(axis, None)
    rep = P()
    in_specs = ba.BAProblem(
        R=rep, t=rep, points=shard2,
        obs_cam=shard, obs_pt=shard, obs_uv=shard2, obs_valid=shard,
        cam_valid=rep, pt_valid=shard,
    )
    out_specs = (in_specs, {"costs": rep, "final_damping": rep})

    def local(prob):
        return ba.ba_iterations(prob, iters, damping, axis_name=axis,
                                solver=solver, cg_iters=cg_iters,
                                huber=huber)

    @jax.jit
    def run(prob: ba.BAProblem):
        f = shard_map(local, mesh=mesh, in_specs=(in_specs,),
                      out_specs=out_specs, check_vma=False)
        return f(prob)

    return run
