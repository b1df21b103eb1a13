"""Frame-to-frame visual odometry (BASELINE.json configs[2]).

Pipeline per frame (all device-side, one jitted step):

    pyramid <- build_pyramid(frame)               ops/pyramid.py
    feats   <- extract(pyramid)                   frontend.py
    matches <- hamming match vs previous frame    matching.py
    (R, t)  <- RANSAC essential + cheirality      geometry/ransac.py
    pose    <- pose o (R, t)^-1                   (camera trajectory)

The estimated translation is up to scale per pair (monocular); the driver
chains unit-scale steps (standard monocular VO convention -- scale is
resolved downstream by the SLAM backend / ground-truth alignment in eval).

The frontend stage can be swapped out (``features_fn``) -- tests inject a
synthetic projector to exercise the full matching+RANSAC+chaining path with
known ground truth.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import matching
from ..config import PislamConfig
from ..frontend import Features, make_extract_fn
from ..geometry import ransac
from ..ops import pyramid as pyr_ops


class VOState(NamedTuple):
    R: jax.Array  # (3, 3) world->cam of current frame
    t: jax.Array  # (3,)
    prev: Features
    prev_pts: jax.Array  # (K, 2) normalised coords of prev features
    key: jax.Array
    # scale propagation (vo.scale_propagation): per-feature depths of the
    # previous frame's keypoints in ITS camera (map units, 0 = unknown)
    # and the last accepted step scale. None when the feature is off.
    prev_depths: jax.Array = None
    step_scale: jax.Array = None


def _depths_along_ray1(R, t, p1, p2):
    """Depth (z in camera 1) of each correspondence for relative pose
    x_c2 = R x_c1 + t -- the closed-form midpoint solve of
    backend/triangulate.py specialised to the relative frame."""
    d1 = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], -1)
    d2 = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], -1)
    rd1 = d1 @ R.T
    c_rd1 = jnp.cross(d2, rd1)
    c_t = jnp.cross(d2, jnp.broadcast_to(t, d2.shape))
    return -jnp.sum(c_rd1 * c_t, -1) / jnp.maximum(
        jnp.sum(c_rd1 * c_rd1, -1), 1e-12)


def normalise_points(feats: Features, fx, fy, cx, cy, level_rows,
                     level_scales, dist=None):
    """Pixel keypoints (stacked-pyramid coords) -> normalised level-0 coords.

    Keypoint y is a global pyramid row; subtract its level origin and scale
    coords back to level 0 by the level's downscale factor before applying
    the inverse intrinsics. ``dist`` is an optional (k1, k2, p1, p2) lens
    distortion to undo (geometry/camera.py) -- real cameras are not ideal
    pinholes and the epipolar geometry downstream assumes ideal coords.
    """
    ys = feats.ys
    xs = feats.xs
    rows = jnp.asarray(level_rows)
    lvl = jnp.sum(ys[:, None] >= rows[None, :], axis=1) - 1
    y_local = ys - rows[lvl]
    scale = jnp.asarray(level_scales, jnp.float32)[lvl]
    u = xs.astype(jnp.float32) * scale
    v = y_local.astype(jnp.float32) * scale
    pts = jnp.stack([(u - cx) / fx, (v - cy) / fy], axis=1)
    if dist is not None:
        from ..geometry import camera
        pts = camera.undistort_normalised(pts, *dist)
    return pts


def vo_step(mc, vc, state: VOState, feats: Features, pts):
    """One pure VO step: match vs previous frame, RANSAC essential, chain.

    Shared by the Python-driven ``VisualOdometry.process`` loop and the
    device-resident ``make_vo_scan`` sequence scan, so the two are the same
    program per frame.
    """
    if vc.guided_radius > 0:
        # guided matching: the previous frame's own position is each
        # feature's motion prediction at tracking frame rates -- the gate
        # cuts the search space AND fixes the ratio-test statistics on
        # repetitive texture (VOConfig.guided_radius)
        idx2, dist = matching.match_gated(
            state.prev.descriptors, feats.descriptors,
            state.prev.valid, feats.valid,
            state.prev_pts, pts, vc.guided_radius,
            max_distance=mc.max_distance, ratio=mc.ratio,
            cross_check=mc.cross_check)
    else:
        idx2, dist = matching.match(
            state.prev.descriptors, feats.descriptors,
            state.prev.valid, feats.valid,
            max_distance=mc.max_distance, ratio=mc.ratio,
            cross_check=mc.cross_check)
    ok = idx2 >= 0
    p1 = state.prev_pts
    p2 = pts[jnp.clip(idx2, 0)]
    key, sub = jax.random.split(state.key)
    out = ransac.ransac_essential(
        sub, p1, p2, ok, iters=vc.ransac_iters,
        inlier_threshold=vc.inlier_threshold)
    if vc.refine_two_view:
        # two-view refinement: triangulate the RANSAC inliers at the
        # unit-baseline relative pose and polish the relative pose by
        # motion-only BA against them (VOConfig.refine_two_view). The
        # refined translation is re-normalised below, so the |t|=1 scale
        # convention is untouched.
        from ..backend import pnp

        t_u = out["t"] / jnp.maximum(jnp.linalg.norm(out["t"]), 1e-9)
        z1 = _depths_along_ray1(out["R"], t_u, p1, p2)
        x_c1 = z1[:, None] * jnp.concatenate(
            [p1, jnp.ones_like(p1[..., :1])], -1)
        tri_ok = out["inliers"] & ok & (z1 > 1e-4) & jnp.isfinite(z1)
        ref = pnp.motion_only_ba(
            out["R"], t_u, x_c1, p2, tri_ok, iters=6,
            inlier_threshold=vc.inlier_threshold)
        accept = (ref["num_inliers"] >= out["num_inliers"]) \
            & jnp.all(jnp.isfinite(ref["R"])) \
            & jnp.all(jnp.isfinite(ref["t"]))
        out = {"R": jnp.where(accept, ref["R"], out["R"]),
               "t": jnp.where(accept, ref["t"], out["t"]),
               "inliers": jnp.where(accept, ref["inliers"],
                                    out["inliers"]),
               "num_inliers": jnp.where(accept, ref["num_inliers"],
                                        out["num_inliers"])}
    good = out["num_inliers"] >= vc.min_inliers
    if vc.max_rel_rotation_deg > 0:
        # motion-continuity guard (matches models/slam.py): a huge
        # frame-to-frame rotation is a mirror/flipped RANSAC solution on
        # self-similar texture, not motion -- hold the pose instead
        cosang = (jnp.trace(out["R"]) - 1.0) / 2.0
        ang = jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0)))
        good &= ang <= vc.max_rel_rotation_deg
    # relative pose cam1->cam2 (unit translation); world->cam chains:
    # T_w2 = T_12 o T_w1
    tnorm = out["t"] / jnp.maximum(
        jnp.linalg.norm(out["t"]), 1e-9)

    if vc.scale_propagation:
        # triangulated-depth scale propagation: the unit-norm convention
        # gives every transition |t| = 1 regardless of true step length,
        # distorting the trajectory SHAPE wherever speed varies (a global
        # Umeyama scale cannot fix per-step variation). Features seen in
        # three consecutive frames tie the scales together: their depth in
        # frame i from the (i-1, i) pair (map units) over their depth from
        # the (i, i+1) pair (unit-baseline units) estimates the new step's
        # scale; the masked MEDIAN over inliers is robust to mismatches
        # (the monocular scale chain every real VO uses, vs. the
        # constant-velocity propagation that measurably regressed --
        # models/slam.py:423).
        K = pts.shape[0]
        d1 = _depths_along_ray1(out["R"], tnorm, p1, p2)  # (K,) unit-base
        pair_ok = out["inliers"] & ok & (d1 > 1e-6)
        have_prev = pair_ok & (state.prev_depths > 0)
        ratio = state.prev_depths / jnp.maximum(d1, 1e-9)
        ratio = jnp.where(have_prev & jnp.isfinite(ratio), ratio, jnp.inf)
        n_r = jnp.sum(ratio < jnp.inf)
        r_sorted = jnp.sort(ratio)
        s_med = r_sorted[jnp.maximum(n_r - 1, 0) // 2]  # lower median
        s = jnp.where(n_r >= vc.min_scale_matches, s_med, state.step_scale)
        s = jnp.where(good & jnp.isfinite(s) & (s > 1e-9), s,
                      state.step_scale)
        # depths of the CURRENT frame's features in its camera, map units
        z2 = ((d1 * (p1 @ out["R"][2, :2] + out["R"][2, 2])) + tnorm[2]) * s
        dst = jnp.where(pair_ok & (z2 > 0), jnp.clip(idx2, 0), K)
        # min-scatter: two previous features matching the same current
        # feature (possible with cross_check off) would make .set a
        # nondeterministic last-writer; taking the nearer depth is a
        # deterministic tie rule
        depths_new = jnp.full(K + 1, jnp.inf).at[dst].min(z2)[:K]
        depths_new = jnp.where(jnp.isfinite(depths_new), depths_new, 0.0)
        depths_new = jnp.where(good, depths_new, jnp.zeros(K))
        tstep = s * tnorm
        step_scale_new = jnp.where(good, s, state.step_scale)
    else:
        depths_new = state.prev_depths
        step_scale_new = state.step_scale
        tstep = tnorm

    Rn = jnp.where(good, out["R"] @ state.R, state.R)
    tn = jnp.where(good, (out["R"] @ state.t[:, None])[:, 0] + tstep,
                   state.t)
    new_state = VOState(R=Rn, t=tn, prev=feats, prev_pts=pts, key=key,
                        prev_depths=depths_new, step_scale=step_scale_new)
    info = {"num_matches": jnp.sum(ok),
            "num_inliers": out["num_inliers"],
            "accepted": good}
    return new_state, info


def make_vo_scan(cfg: PislamConfig, fx: float, fy: float,
                 cx: float, cy: float, dist=None):
    """Device-resident VO over a whole sequence: one ``lax.scan``.

    The Python-driven loop dispatches ~3 jitted calls plus host readbacks
    per frame, each with its own dispatch and sync. This folds the FULL
    per-frame path (pyramid build -> ORB extraction -> Hamming match ->
    vmapped RANSAC essential -> pose chaining) into one compiled scan: zero
    host round-trips per frame, one sync per sequence. The reference never
    had a sequence driver at all (its demo is single-frame, demo.cpp:51-115);
    this is the shape a batch deployment wants -- trajectory in,
    trajectory out.

    Returns a jitted ``(frames (T, H, W) u8, key) -> dict`` with the
    world->cam trajectory ``R (T, 3, 3)``, ``t (T, 3)`` (frame 0 = identity)
    and per-transition ``num_inliers``/``accepted`` ((T-1,)). Bit-parity
    with the ``VisualOdometry`` loop is pinned by tests/test_vo_scan.py.
    """
    from ..frontend import _extract_impl
    from ..ops import nms

    pc = cfg.pyramid
    mc = cfg.matcher
    vc = cfg.vo
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

    def step(state, frame):
        feats, pts = frontend(frame)
        new_state, info = vo_step(mc, vc, state, feats, pts)
        return new_state, (new_state.R, new_state.t,
                           info["num_inliers"], info["accepted"])

    @jax.jit
    def run(frames, key):
        f0, p0 = frontend(frames[0])
        st = VOState(R=jnp.eye(3), t=jnp.zeros(3), prev=f0, prev_pts=p0,
                     key=key, prev_depths=jnp.zeros(p0.shape[0]),
                     step_scale=jnp.float32(1.0))
        _, (Rs, ts, ninl, acc) = jax.lax.scan(step, st, frames[1:])
        return {
            "R": jnp.concatenate([jnp.eye(3)[None], Rs]),
            "t": jnp.concatenate([jnp.zeros((1, 3)), ts]),
            "num_inliers": ninl,
            "accepted": acc,
        }

    return run


class VisualOdometry:
    """Monocular VO driver. Intrinsics in pixels at pyramid level 0."""

    def __init__(self, cfg: PislamConfig, fx: float, fy: float,
                 cx: float, cy: float, features_fn=None, dist=None):
        self.cfg = cfg
        pc = cfg.pyramid
        self.extract = features_fn or self._make_image_frontend()
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.dist = tuple(dist) if dist is not None else None
        self.level_rows = pc.level_rows
        # per-level scale back to level 0 = base_width / level_width
        self.level_scales = tuple(
            pc.base_width / w for (w, _h) in pc.level_sizes)
        self._step = self._build_step()

    def _make_image_frontend(self):
        cfg = self.cfg
        extract = make_extract_fn(cfg)
        build = jax.jit(lambda f: pyr_ops.build_pyramid(f, cfg.pyramid))

        def run(frame):
            return extract(build(frame))

        return run

    def _build_step(self):
        mc = self.cfg.matcher
        vc = self.cfg.vo
        return jax.jit(lambda state, feats, pts: vo_step(
            mc, vc, state, feats, pts))

    def init(self, frame, seed: int = 0) -> VOState:
        feats = self.extract(frame)
        pts = normalise_points(feats, self.fx, self.fy, self.cx, self.cy,
                               self.level_rows, self.level_scales,
                               dist=self.dist)
        return VOState(R=jnp.eye(3), t=jnp.zeros(3), prev=feats,
                       prev_pts=pts, key=jax.random.PRNGKey(seed),
                       prev_depths=jnp.zeros(pts.shape[0]),
                       step_scale=jnp.float32(1.0))

    def process(self, state: VOState, frame):
        feats = self.extract(frame)
        pts = normalise_points(feats, self.fx, self.fy, self.cx, self.cy,
                               self.level_rows, self.level_scales,
                               dist=self.dist)
        return self._step(state, feats, pts)

    def camera_position(self, state: VOState) -> np.ndarray:
        """World position of the camera: -R^T t."""
        R = np.asarray(state.R)
        t = np.asarray(state.t)
        return -R.T @ t
