"""Device-resident SLAM tracking scan: chunks of frames in one dispatch.

The host-driven KeyframeSLAM.process loop dispatches several jitted calls
plus small host readbacks per frame; each dispatch and sync costs host time
that the device spends idle. This module folds the ENTIRE per-frame tracking
path into one ``lax.scan`` step over SlamState:

    extract -> match vs last keyframe -> RANSAC essential -> local-map PnP
    -> keyframe decision -> conditional keyframe insert + triangulation

Every per-frame decision the Python loop makes on the host (bootstrap,
map-tracking acceptance, keyframe promotion) becomes ``lax.cond`` /
``jnp.where`` on device scalars; the full map state (keyframe ring,
landmark map, observation table, counters, PRNG key) threads through the
scan as the fixed-shape SlamState pytree. A chunk of T frames is therefore
ONE dispatch and ONE sync.

Windowed bundle adjustment is NOT inside the scan: it runs per keyframe
(not per frame), and real SLAM systems run it asynchronously to tracking
(the local-mapping thread in ORB-SLAM). KeyframeSLAM.process_chunk runs
this scan, then BA once if the chunk inserted keyframes. With chunk size 1
the behaviour is identical to the per-frame loop (pinned by
tests/test_slam_scan.py); larger chunks defer BA to chunk boundaries -- the
measured accuracy cost on the committed sequence is small (same test).

The reference has no comparable layer at all (frontend only, README.md:22);
this is the accelerator-resident answer to its per-frame C++ driver loop.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import matching
from ..config import PislamConfig
from ..frontend import _extract_impl
from ..geometry import homography, ransac
from ..ops import nms, pyramid as pyr_ops
from .slam import (SlamState, insert_keyframe_state, keyframe_step_prior,
                   rescale_step_to_prior, track_map_state)
from .visual_odometry import normalise_points


def make_slam_track_scan(cfg: PislamConfig, fx: float, fy: float,
                         cx: float, cy: float,
                         keyframe_min_inliers: int = 60,
                         keyframe_max_gap: int = 10, dist=None):
    """Build the jitted ``(SlamState, frames (T, H, W) u8) -> (SlamState,
    outs)`` tracking scan. ``outs`` holds per-frame pose_R/pose_t/keyframe/
    num_inliers/map_inliers (same fields KeyframeSLAM.process returns)."""
    pc = cfg.pyramid
    mc = cfg.matcher
    vc = cfg.vo
    cap = cfg.map.keyframe_capacity
    K = cfg.frontend.max_keypoints
    mask = np.asarray(nms.make_level_mask(
        pc.level_sizes, pc.level_rows, pc.padded_height, pc.stride,
        cfg.frontend.border))
    level_rows = pc.level_rows
    level_scales = tuple(pc.base_width / w for (w, _h) in pc.level_sizes)

    def frontend(frame):
        stack = pyr_ops.build_pyramid(frame, pc)
        feats = _extract_impl(stack, mask, cfg)
        pts = normalise_points(feats, fx, fy, cx, cy,
                               level_rows, level_scales, dist=dist)
        return feats, pts

    def step(carry, frame):
        st, prev_R, prev_t = carry
        feats, pts = frontend(frame)

        def bootstrap(op):
            st, _pR, _pt = op
            R0 = jnp.eye(3, dtype=jnp.float32)
            t0 = jnp.zeros(3, jnp.float32)
            stn = insert_keyframe_state(
                cap, st, feats, pts, R0, t0,
                jnp.full(K, -1, jnp.int32), jnp.zeros(K, bool),
                jnp.int32(0), jnp.full(K, -1, jnp.int32),
                refresh_desc=cfg.map.refresh_descriptors)
            return stn, (R0, t0, jnp.bool_(True), jnp.int32(0), jnp.int32(0))

        def track(op):
            st, prev_R, prev_t = op
            slot = jnp.mod(st.counters[0] - 1, cap)
            store = st.store
            idx2, _ = matching.match(
                store.descriptors[slot], feats.descriptors,
                store.kp_valid[slot], feats.valid,
                max_distance=mc.max_distance, ratio=mc.ratio,
                cross_check=mc.cross_check)
            ok = idx2 >= 0
            p2 = pts[jnp.clip(idx2, 0)]
            key, sub = jax.random.split(st.key)
            st = st._replace(key=key)
            if vc.bootstrap_model_select:
                # E/H model selection while only the bootstrap keyframe
                # exists (mirrors KeyframeSLAM.process -- see
                # VOConfig.bootstrap_model_select); lax.cond keeps the
                # homography RANSAC off the steady-state path
                def _bootstrap_pose(op):
                    sub, p1, p2, ok = op
                    o = homography.select_model(
                        sub, p1, p2, ok, iters=vc.ransac_iters,
                        e_threshold=vc.inlier_threshold,
                        h_threshold=vc.inlier_threshold)
                    return o["R"], o["t"], o["inliers"], o["num_inliers"]

                def _essential_pose(op):
                    sub, p1, p2, ok = op
                    o = ransac.ransac_essential(
                        sub, p1, p2, ok, iters=vc.ransac_iters,
                        inlier_threshold=vc.inlier_threshold)
                    return o["R"], o["t"], o["inliers"], o["num_inliers"]

                R_, t_, inl_, ninl_ = jax.lax.cond(
                    st.counters[0] == 1, _bootstrap_pose, _essential_pose,
                    (sub, store.pts[slot], p2, ok))
                out = {"R": R_, "t": t_, "inliers": inl_,
                       "num_inliers": ninl_}
            else:
                out = ransac.ransac_essential(
                    sub, store.pts[slot], p2, ok, iters=vc.ransac_iters,
                    inlier_threshold=vc.inlier_threshold)
            n_inl = out["num_inliers"].astype(jnp.int32)
            # LOST when tracking collapses: hold the previous accepted pose
            # instead of chaining the degenerate RANSAC pose (matches
            # KeyframeSLAM.process; relocalisation is host orchestration,
            # handled at chunk boundaries by process_chunk)
            lost = n_inl < vc.min_inliers
            # failure detection (matches the host loop): a degenerate
            # solve emitting a non-finite pose is LOST, not trajectory
            lost |= ~(jnp.all(jnp.isfinite(out["R"]))
                      & jnp.all(jnp.isfinite(out["t"])))
            if vc.max_rel_rotation_deg > 0:
                # motion-continuity guard (matches the host loop): reject
                # mirror/flipped RANSAC solutions as LOST
                cosang = (jnp.trace(out["R"]) - 1.0) / 2.0
                ang = jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0)))
                lost |= ang > vc.max_rel_rotation_deg
            trel = out["t"] / jnp.maximum(jnp.linalg.norm(out["t"]), 1e-9)
            t_kf = (out["R"] @ store.t[slot][:, None])[:, 0]
            R = out["R"] @ store.R[slot]
            t = t_kf + trel
            if vc.step_magnitude_prior:
                # map-PnP dropout fallback (matches KeyframeSLAM.process):
                # candidate keyframe displacement rescaled to the recent
                # keyframe-interval speed x frames elapsed; applied below
                # only when the map pose is rejected
                s_prior = keyframe_step_prior(store, st.counters[0], cap)
                c_kf = -(store.R[slot].T @ store.t[slot][:, None])[:, 0]
                d = s_prior * (st.counters[4] + 1).astype(jnp.float32)
                t_fb = rescale_step_to_prior(R, t, c_kf, d)
                fb_ok = ((s_prior > 0)
                         & (st.counters[0] >= vc.step_prior_min_kf)
                         & jnp.all(jnp.isfinite(t_fb)))
            R = jnp.where(lost, prev_R, R)
            t = jnp.where(lost, prev_t, t)

            if cfg.map.track_map:
                def with_map(_):
                    Rm, tm, nm, assoc = track_map_state(
                        cfg, st.lmap, feats, pts, R, t)
                    return Rm, tm, nm.astype(jnp.int32), assoc

                def without_map(_):
                    return (R, t, jnp.int32(0), jnp.full(K, -1, jnp.int32))

                Rm, tm, n_map, assoc = jax.lax.cond(
                    (st.counters[1] > 0) & ~lost, with_map, without_map,
                    None)
                use = ((n_map >= cfg.map.min_map_inliers) & ~lost
                       & jnp.all(jnp.isfinite(Rm))
                       & jnp.all(jnp.isfinite(tm)))
                R = jnp.where(use, Rm, R)
                t = jnp.where(use, tm, t)
                map_idx = jnp.where(use, assoc, -1)
            else:
                use = jnp.bool_(False)
                n_map = jnp.int32(0)
                map_idx = jnp.full(K, -1, jnp.int32)
            if vc.step_magnitude_prior:
                t = jnp.where(~lost & ~use & fb_ok, t_fb, t)

            since = st.counters[4] + 1
            st = st._replace(counters=st.counters.at[4].set(since))
            make_kf = (~lost & ((n_inl < keyframe_min_inliers)
                                | (since >= keyframe_max_gap)))
            if cfg.map.keyframe_on_map_dropout and cfg.map.track_map:
                # ORB-SLAM "tracking weak -> insert" (matches the host
                # loop): map coverage collapsed but tracking holds, and
                # the landmark table can still grow (saturated-table
                # inserts just churn keyframes -- see the host loop)
                make_kf |= (~lost & (st.counters[1] > 0)
                            & (n_map < cfg.map.min_map_inliers)
                            & (st.counters[1] < cfg.map.max_landmarks))

            def insert(st):
                stn = insert_keyframe_state(
                    cap, st, feats, pts, R, t, idx2, out["inliers"],
                    slot, map_idx,
                    refresh_desc=cfg.map.refresh_descriptors)
                return stn._replace(counters=stn.counters.at[4].set(0))

            st = jax.lax.cond(make_kf, insert, lambda s: s, st)
            return st, (R, t, make_kf, n_inl, n_map)

        st, outs = jax.lax.cond(st.counters[0] == 0, bootstrap, track,
                                (st, prev_R, prev_t))
        # AFTER insert: counters[3] is the frame id (matches the loop)
        st = st._replace(counters=st.counters.at[3].add(1))
        return (st, outs[0], outs[1]), outs

    @jax.jit
    def run(st: SlamState, frames):
        # previous accepted pose seeds from the last keyframe (the same
        # initialisation KeyframeSLAM.set_state uses for _prev_pose)
        slot = jnp.mod(st.counters[0] - 1, cap)
        has_kf = st.counters[0] > 0
        prev_R = jnp.where(has_kf, st.store.R[slot],
                           jnp.eye(3, dtype=jnp.float32))
        prev_t = jnp.where(has_kf, st.store.t[slot], jnp.zeros(3))
        (st, _pR, _pt), (Rs, ts, kf, ninl, nmap) = jax.lax.scan(
            step, (st, prev_R, prev_t.astype(jnp.float32)), frames)
        return st, {"pose_R": Rs, "pose_t": ts, "keyframe": kf,
                    "num_inliers": ninl, "map_inliers": nmap}

    return run
