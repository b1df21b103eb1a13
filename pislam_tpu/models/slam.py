"""Keyframe SLAM: map tracking + windowed BA over a checkpointable pytree map.

Architecture (grown from the reference's frontend-only scope, README.md:22,
per the north star):

* state: the ENTIRE map lives in fixed-shape device arrays
  (backend/keyframes.py: KeyframeStore + LandmarkMap + ObservationTable
  packaged as SlamState). One `utils.checkpoint.save` away from resumable;
  a fresh KeyframeSLAM restores it and continues/relocalises.
* tracking: every frame is matched (Hamming, int8 matmul) against the last
  keyframe and localised with RANSAC essential + cheirality (geometry/);
  when the map has landmarks the pose is then refined by motion-only BA
  against matched map points (backend/pnp.py) -- ORB-SLAM-style local-map
  tracking, which also pins the monocular scale to the map.
* mapping: when tracking weakens or the keyframe gap is reached, the frame
  is promoted to a keyframe: one jitted insert step writes the keyframe
  slot, triangulates inlier matches (backend/triangulate.py) and appends
  landmarks + observation rows functionally.
* local BA: the sliding window of the last `window` keyframes with their
  observation rows is refined with Schur-complement bundle adjustment
  (backend/ba.py).
* loop closure: the WHOLE keyframe store is matched against the query in a
  single dispatch (matching.match_many: one (F*K, K2) i8 matmul + one
  (F,) count readback -- the round-1 version cost one dispatch + ~30 ms
  readback per stored keyframe). try_close_loop() conjugates the RANSAC
  relative pose into the pose-graph edge frame and runs pose-graph GN
  (backend/pose_graph.py); relocalise() recovers a kidnapped frame.
* lost-tracking recovery: when frame-to-keyframe tracking collapses below
  `vo.min_inliers` the tracker enters a LOST state instead of trusting the
  degenerate RANSAC pose: it relocalises against the whole keyframe store
  (one dispatch), and on success promotes the frame to a recovery
  keyframe so tracking resumes against it; until recovery the last good
  pose is held. The device-resident chunk scan holds the pose on-device
  and recovers at chunk boundaries via the same host path (chunk=1
  reproduces the loop's decisions exactly).

Host-side Python only orchestrates keyframe decisions (small scalar reads);
all heavy stages are jitted device programs. The image frontend is swappable
(`features_fn`) so tests can drive the full stack from a synthetic projector
with known ground truth.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .. import matching
from ..backend import ba, keyframes as kfs, pnp, pose_graph, triangulate
from ..config import PislamConfig
from ..frontend import Features
from ..geometry import ransac, se3
from ..utils import checkpoint as ckpt
from .visual_odometry import VisualOdometry, normalise_points


class SlamState(NamedTuple):
    """The full SLAM session state: a pytree of fixed-shape arrays."""
    store: kfs.KeyframeStore
    lmap: kfs.LandmarkMap
    obs: kfs.ObservationTable
    # [num_keyframes, lm_cursor, obs_cursor, frame_idx, since_kf]
    counters: jax.Array  # (5,) int32
    key: jax.Array       # PRNG key for RANSAC


@dataclasses.dataclass
class KeyframeView:
    """Lightweight host view of one stored keyframe (compat/introspection)."""
    index: int       # insertion ordinal
    frame: int       # source frame number
    slot: int        # store slot
    R: np.ndarray
    t: np.ndarray


def init_state(cfg: PislamConfig, seed: int = 7) -> SlamState:
    mc, fc = cfg.map, cfg.frontend
    return SlamState(
        store=kfs.empty_store(mc.keyframe_capacity, fc.max_keypoints,
                              fc.words),
        lmap=kfs.empty_map(mc.max_landmarks, fc.words),
        obs=kfs.empty_obs(mc.max_obs),
        counters=jnp.zeros(5, jnp.int32),
        key=jax.random.PRNGKey(seed),
    )


def insert_keyframe_state(cap: int, st: SlamState, feats: Features, pts,
                          R, t, idx2, inliers, prev_slot, map_idx,
                          refresh_desc: bool = False):
    """Pure keyframe insertion: SlamState -> SlamState (jit/scan-safe).

    Writes the keyframe ring slot, triangulates inlier matches against the
    previous keyframe into new landmarks, and appends observation rows --
    all functional updates on the fixed-shape state. Shared by the
    host-driven KeyframeSLAM loop and the device-resident tracking scan
    (slam_scan.py), so both insert identically.
    """
    num_kf = st.counters[0]
    frame_id = st.counters[3]
    slot = jnp.mod(num_kf, cap)
    # ring eviction: observation rows of the overwritten keyframe
    # would otherwise feed BA with a stale pose
    evict = num_kf >= cap
    obs = st.obs._replace(
        valid=st.obs.valid & ~(evict & (st.obs.kf == slot)))
    prev_R, prev_t = st.store.R[prev_slot], st.store.t[prev_slot]
    p1 = st.store.pts[prev_slot]
    prev_kp_valid = st.store.kp_valid[prev_slot]
    store = kfs.insert_keyframe(st.store, slot, R, t, feats, frame_id,
                                pts=pts, ordinal=num_kf)
    # triangulate inlier matches prev_kf -> new_kf into landmarks
    idx2c = jnp.clip(idx2, 0)
    p2 = pts[idx2c]
    X = triangulate.triangulate_two_view(prev_R, prev_t, R, t, p1, p2)
    z1 = (X @ prev_R.T + prev_t)[:, 2]
    z2 = (X @ R.T + t)[:, 2]
    mask = (inliers & (idx2 >= 0) & prev_kp_valid
            & feats.valid[idx2c] & (z1 > 1e-4) & (z2 > 1e-4)
            & jnp.all(jnp.isfinite(X), axis=1))
    # data association: current features already matched to a map
    # landmark (map_idx from this frame's map tracking) must NOT be
    # re-triangulated -- a duplicate landmark with an identical
    # descriptor would make the Lowe ratio test kill every future
    # map match of that point. They get an observation row instead.
    matched_lm = map_idx[idx2c]           # (K,) lm slot or -1
    exist = mask & (matched_lm >= 0)
    new = mask & (matched_lm < 0)
    desc_anchor = feats.descriptors[idx2c]
    lmap, obs, lm_cur, obs_cur = kfs.add_landmarks(
        st.lmap, obs, st.counters[1], st.counters[2],
        X, desc_anchor, new, prev_slot, slot, p1, p2)
    lmap, obs, obs_cur = kfs.add_observations(
        lmap, obs, obs_cur, slot, jnp.clip(matched_lm, 0), p2, exist)
    if refresh_desc:
        # refresh re-observed landmarks' anchor descriptors to the newest
        # view (map.refresh_descriptors); out-of-range rows are dropped
        rows = jnp.where(exist, matched_lm, lmap.descriptors.shape[0])
        lmap = lmap._replace(descriptors=lmap.descriptors.at[rows].set(
            desc_anchor, mode="drop"))
    counters = jnp.stack([
        num_kf + 1, lm_cur, obs_cur, st.counters[3], st.counters[4],
    ]).astype(jnp.int32)
    return SlamState(store, lmap, obs, counters, st.key)


def project_landmarks(lmap: kfs.LandmarkMap, R0, t0):
    """Landmark positions -> normalised-plane coords under a pose prior.

    Behind-camera landmarks project to a far-away sentinel so a projection
    gate can never select them."""
    xc = lmap.xyz @ R0.T + t0
    z = xc[:, 2]
    uv = xc[:, :2] / jnp.maximum(z, 1e-6)[:, None]
    return jnp.where((z > 1e-6)[:, None], uv, jnp.float32(1e6))


def track_map_state(cfg: PislamConfig, lmap: kfs.LandmarkMap, feats: Features,
                    pts, R0, t0):
    """Pure local-map tracking: match features to landmark descriptors and
    refine the pose with motion-only BA. Shared by the host loop and the
    tracking scan. Returns (R, t, num_inliers, assoc).

    With cfg.map.gate_radius > 0 the match is projection-gated: landmarks
    are projected with the (R0, t0) prior and each feature only matches
    within the gate (matching.match_gated, the ORB-SLAM local-map idiom)."""
    mc = cfg.map
    if mc.gate_radius > 0:
        idx, _ = matching.match_gated(
            feats.descriptors, lmap.descriptors, feats.valid, lmap.valid,
            pts, project_landmarks(lmap, R0, t0), mc.gate_radius,
            max_distance=mc.map_match_max_distance,
            ratio=cfg.matcher.ratio, cross_check=True)
    else:
        idx, _ = matching.match(
            feats.descriptors, lmap.descriptors, feats.valid, lmap.valid,
            max_distance=mc.map_match_max_distance,
            ratio=cfg.matcher.ratio, cross_check=True)
    ok = idx >= 0
    xyz = lmap.xyz[jnp.clip(idx, 0)]
    out = pnp.motion_only_ba(
        R0, t0, xyz, pts, ok, iters=mc.pnp_iters,
        inlier_threshold=mc.pnp_inlier_threshold)
    # only reprojection-inlier associations feed data association
    assoc = jnp.where(out["inliers"], idx, -1)
    return out["R"], out["t"], out["num_inliers"], assoc


def keyframe_step_prior(store, num_kf, cap):
    """Per-frame camera speed over the last keyframe interval (map units).

    |c_kf[-1] - c_kf[-2]| / (frame gap) from the keyframe store alone, so
    the host loop and the device scan compute the identical prior with no
    extra carried state. 0 when fewer than two (valid) keyframes, which
    disables the step-magnitude fallback (vo.step_magnitude_prior).
    Keyframe poses are map-PnP-refined and windowed-BA'd, so this is the
    most trustworthy speed estimate available at tracking time."""
    sA = jnp.mod(num_kf - 1, cap)
    sB = jnp.mod(num_kf - 2, cap)
    cA = -(jnp.swapaxes(store.R[sA], -1, -2) @ store.t[sA][..., None])[..., 0]
    cB = -(jnp.swapaxes(store.R[sB], -1, -2) @ store.t[sB][..., None])[..., 0]
    gap = (store.frame_id[sA] - store.frame_id[sB]).astype(jnp.float32)
    ok = (num_kf >= 2) & store.valid[sA] & store.valid[sB] & (gap > 0)
    s = jnp.linalg.norm(cA - cB) / jnp.maximum(gap, 1.0)
    return jnp.where(ok & jnp.isfinite(s), s, 0.0)


def rescale_step_to_prior(R, t_cand, c_kf, d_target):
    """Rescale the candidate pose's camera-centre displacement FROM THE
    LAST KEYFRAME to ``d_target``, keeping RANSAC's measured direction:
    c_new = c_kf + d * (c_cand - c_kf)/|c_cand - c_kf| (for the unit-norm
    candidate the direction is exactly -R^T t_rel), returned as the new
    translation -R @ c_new. Anchoring at the keyframe (not the previous
    frame) keeps the host loop and the device scan decision-identical:
    the scan's carried previous pose resets to the last keyframe at every
    chunk boundary, so a prev-frame-relative form diverges at chunk
    size 1 (measured: 0.67 map units at the first fallback frame)."""
    c_cand = -(jnp.swapaxes(R, -1, -2) @ t_cand[..., None])[..., 0]
    step = c_cand - c_kf
    n = jnp.linalg.norm(step)
    c_new = c_kf + step * (d_target / jnp.maximum(n, 1e-9))
    return -(R @ c_new[..., None])[..., 0]


class KeyframeSLAM:
    def __init__(self, cfg: PislamConfig, fx, fy, cx, cy, features_fn=None,
                 keyframe_min_inliers: int = 60, keyframe_max_gap: int = 10,
                 seed: int = 7, metrics=None, reloc_min_matches: int = 30,
                 mesh=None, dist=None, mapping: bool = True):
        from ..utils.metrics import NullMetrics

        self.cfg = cfg
        # structured observability (utils/metrics.py): stage timers +
        # counters/gauges updated every frame, emitted by the driver as JSON
        # lines (the reference's whole story was one cout, demo.cpp:113-114)
        self.metrics = metrics if metrics is not None else NullMetrics()
        self.vo = VisualOdometry(cfg, fx, fy, cx, cy,
                                 features_fn=features_fn, dist=dist)
        self.keyframe_min_inliers = keyframe_min_inliers
        self.keyframe_max_gap = keyframe_max_gap
        self.reloc_min_matches = reloc_min_matches
        # localization-only mode (ORB-SLAM's "localization mode"): track
        # and relocalise against a FROZEN map -- no keyframe insertion, no
        # triangulation, no BA. Restore a checkpointed map first; the
        # bootstrap insert is still allowed if the map is empty.
        self.mapping = mapping
        self.capacity = cfg.map.keyframe_capacity
        assert self.capacity >= cfg.ba.window, \
            "keyframe ring must hold at least one BA window"

        self._st = init_state(cfg, seed)
        # host mirrors of the counters (authoritative during a run; synced
        # from the device state by set_state / restore)
        self._num_kf = 0
        self._num_lm = 0
        self._num_obs = 0
        self._frame_idx = 0
        self._since_kf = 0
        self.trajectory = []  # camera positions per processed frame (host)
        # cached device rows of the last keyframe (tracking reference)
        self._last: Optional[dict] = None
        # last accepted pose (held while tracking is lost)
        self._prev_pose = (np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))
        # cumulative session counters (metrics counters reset on emit)
        self.frames_lost = 0
        self.relocalisations = 0

        self._match = jax.jit(lambda d1, d2, v1, v2: matching.match(
            d1, d2, v1, v2, max_distance=cfg.matcher.max_distance,
            ratio=cfg.matcher.ratio, cross_check=cfg.matcher.cross_check))
        self._store_counts = jax.jit(
            lambda store, feats: matching.match_many(
                store.descriptors, store.kp_valid,
                feats.descriptors, feats.valid,
                max_distance=cfg.matcher.max_distance,
                ratio=cfg.matcher.ratio,
                cross_check=cfg.matcher.cross_check)[1])
        self._insert = self._build_insert()
        self._track_map = self._build_track_map()
        self._covis = jax.jit(kfs.covisibility)
        self._cull_kf = jax.jit(kfs.cull_one_keyframe,
                                static_argnums=(4, 5))
        self._compact = jax.jit(kfs.compact_map)
        # slots invalidated by keyframe culling (host mirror; an insert
        # that reuses the slot removes it again)
        self._culled_slots: set = set()
        if mesh is not None:
            # map scaling across chips: the big matmuls -- map tracking
            # against the landmark map and store-wide loop detection --
            # run sharded over the mesh's model axis (bit-identical match
            # semantics, parallel/dist.py). State arrays reshard at the
            # jit boundary; the small pose solves replicate.
            from ..parallel import dist
            self._track_map = dist.make_sharded_map_tracker(cfg, mesh)
            self._store_counts = dist.make_sharded_store_counts(cfg, mesh)
        self._has_image_frontend = features_fn is None
        self._chunk_scan = None  # built lazily by process_chunk

    # -- state / checkpointing ----------------------------------------------

    @property
    def state(self) -> SlamState:
        c = np.int32([self._num_kf, self._num_lm, self._num_obs,
                      self._frame_idx, self._since_kf])
        return self._st._replace(counters=jnp.asarray(c))

    def set_state(self, state: SlamState):
        """Adopt a SlamState (e.g. restored from a checkpoint)."""
        self._st = state
        # one batched host sync for counters + slot bookkeeping
        c, valid, ordinal = jax.device_get(
            (state.counters, state.store.valid, state.store.ordinal))
        self._num_kf, self._num_lm, self._num_obs = int(c[0]), int(c[1]), \
            int(c[2])
        self._frame_idx, self._since_kf = int(c[3]), int(c[4])
        # culled slots keep their ordinal but turn invalid
        self._culled_slots = {
            int(s) for s in np.nonzero(~valid & (ordinal >= 0))[0]}
        if self._num_kf > 0:
            slot = (self._num_kf - 1) % self.capacity
            self._cache_last(slot)
            self._prev_pose = (np.asarray(state.store.R[slot]),
                               np.asarray(state.store.t[slot]))
        else:
            self._last = None
            self._prev_pose = (np.eye(3, dtype=np.float32),
                               np.zeros(3, np.float32))

    def save_checkpoint(self, path: str):
        ckpt.save(path, self.state)

    def restore_checkpoint(self, path: str):
        like = init_state(self.cfg)
        self.set_state(ckpt.restore(path, like=like))

    def _cache_last(self, slot: int):
        st = self._st.store
        self._last = {
            "slot": slot,
            "desc": st.descriptors[slot], "valid": st.kp_valid[slot],
            "pts": st.pts[slot],
            "R": np.asarray(st.R[slot]), "t": np.asarray(st.t[slot]),
        }

    # -- jitted pieces ------------------------------------------------------

    def _build_insert(self):
        return jax.jit(partial(insert_keyframe_state, self.capacity,
                               refresh_desc=self.cfg.map.refresh_descriptors))

    def _build_track_map(self):
        cfg = self.cfg
        return jax.jit(lambda lmap, feats, pts, R0, t0: track_map_state(
            cfg, lmap, feats, pts, R0, t0))

    # -- internal -----------------------------------------------------------

    def _features(self, frame):
        feats = self.vo.extract(frame)
        pts = normalise_points(
            feats, self.vo.fx, self.vo.fy, self.vo.cx, self.vo.cy,
            self.vo.level_rows, self.vo.level_scales, dist=self.vo.dist)
        return feats, pts

    def _localise_against(self, desc, valid, ref_pts, feats, pts,
                          model_select: bool = False):
        """RANSAC essential pose of `feats` vs a reference feature block.

        ``model_select`` runs the E/H two-model bootstrap initialiser
        instead (geometry/homography.select_model -- the ORB-SLAM rule;
        see VOConfig.bootstrap_model_select)."""
        idx2, _ = self._match(desc, feats.descriptors, valid, feats.valid)
        ok = idx2 >= 0
        p2 = pts[jnp.clip(idx2, 0)]
        key, sub = jax.random.split(self._st.key)
        self._st = self._st._replace(key=key)
        if model_select:
            from ..geometry import homography
            out = homography.select_model(
                sub, ref_pts, p2, ok,
                iters=self.cfg.vo.ransac_iters,
                e_threshold=self.cfg.vo.inlier_threshold,
                h_threshold=self.cfg.vo.inlier_threshold)
        else:
            out = ransac.ransac_essential(
                sub, ref_pts, p2, ok,
                iters=self.cfg.vo.ransac_iters,
                inlier_threshold=self.cfg.vo.inlier_threshold)
        return out, idx2

    def _slot_rows(self, slot: int):
        st = self._st.store
        return (st.descriptors[slot], st.kp_valid[slot], st.pts[slot],
                np.asarray(st.R[slot]), np.asarray(st.t[slot]))

    # -- public -------------------------------------------------------------

    def process(self, frame):
        """Track one frame; returns dict with pose + bookkeeping."""
        m = self.metrics
        m.count("frames")
        with m.timer("extract"):
            feats, pts = self._features(frame)

        if self._num_kf == 0:
            R = np.eye(3, dtype=np.float32)
            t = np.zeros(3, np.float32)
            self._insert_keyframe(feats, pts, R, t,
                                  jnp.zeros(pts.shape[0], jnp.int32) - 1,
                                  jnp.zeros(pts.shape[0], bool), 0)
            m.count("keyframes_inserted")
            m.gauge("num_keyframes", self.num_keyframes)
            self._frame_idx += 1  # AFTER insert: counters[3] is the frame id
            self.trajectory.append(np.zeros(3))
            self._prev_pose = (R, t)
            return {"pose_R": R, "pose_t": t, "keyframe": True,
                    "num_inliers": 0, "map_inliers": 0,
                    "lost": False, "relocalised": False}

        last = self._last
        with m.timer("track"):
            out, idx2 = self._localise_against(
                last["desc"], last["valid"], last["pts"], feats, pts,
                model_select=(self.cfg.vo.bootstrap_model_select
                              and self._num_kf == 1))
            n_inl = int(out["num_inliers"])
        lost = n_inl < self.cfg.vo.min_inliers
        if not lost:
            # failure detection: a numerically degenerate solve (colinear
            # correspondences, zero-parallax SVD breakdown) can emit a
            # non-finite pose with high "inlier" counts -- treat it as
            # lost rather than corrupting the trajectory/map with NaNs
            if not (np.isfinite(np.asarray(out["R"])).all()
                    and np.isfinite(np.asarray(out["t"])).all()):
                m.count("nonfinite_poses")
                lost = True
        max_rot = self.cfg.vo.max_rel_rotation_deg
        if not lost and max_rot > 0:
            # motion-continuity guard: the keyframe is at most a few frames
            # old, so a large relative rotation is a mirror/flipped RANSAC
            # solution (measured: a ~175 deg flip with 122 "inliers" on
            # self-similar texture), not motion. Mark it LOST; the
            # relocaliser recovers the pose if the scene really cut.
            cosang = (np.trace(np.asarray(out["R"])) - 1.0) / 2.0
            ang = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
            if ang > max_rot:
                m.count("rotation_jumps_rejected")
                lost = True
        relocalised = False
        n_map = 0
        map_idx = jnp.full(pts.shape[0], -1, jnp.int32)
        if lost:
            # tracking collapsed: the RANSAC pose is degenerate garbage.
            # Relocalise against the WHOLE keyframe store (one dispatch);
            # on success the frame becomes a recovery keyframe (below) so
            # tracking resumes against it, else the last accepted pose is
            # held until some later frame relocalises.
            m.count("frames_lost")
            self.frames_lost += 1
            with m.timer("relocalise"):
                rec = self._relocalise_feats(
                    feats, pts, min_matches=self.reloc_min_matches)
            if rec is not None:
                R, t, kf_ord = rec
                relocalised = True
                m.count("relocalisations")
                self.relocalisations += 1
            else:
                R, t = self._prev_pose
        else:
            Rrel = np.asarray(out["R"])
            trel = np.asarray(out["t"])
            trel = trel / max(np.linalg.norm(trel), 1e-9)

            # NOTE on monocular scale: the essential-matrix translation is
            # kept unit-norm; map PnP (below) supplies metric scale whenever
            # enough landmarks are in view. Constant-velocity scale
            # propagation (|c_prev - c_kf| + previous step length) was tried
            # and REGRESSED the committed loop sequence 2x (ATE 0.21 ->
            # 0.41): prediction errors compound through the propagated
            # scale, while the unit-norm convention bounds them per
            # keyframe interval.
            R = Rrel @ last["R"]
            t = Rrel @ last["t"] + trel

            used_pnp = False
            if self.cfg.map.track_map and self._num_lm > 0:
                with m.timer("map_track"):
                    Rm, tm, n_map_d, assoc = self._track_map(
                        self._st.lmap, feats, pts,
                        jnp.asarray(R), jnp.asarray(t))
                    n_map = int(n_map_d)
                Rm, tm = np.asarray(Rm), np.asarray(tm)
                if (n_map >= self.cfg.map.min_map_inliers
                        and np.isfinite(Rm).all()
                        and np.isfinite(tm).all()):
                    R, t = Rm, tm
                    map_idx = assoc
                    used_pnp = True
            if (self.cfg.vo.step_magnitude_prior and not used_pnp
                    and self._num_kf >= self.cfg.vo.step_prior_min_kf):
                # map-PnP dropout: replace the phantom |t_rel| = 1
                # keyframe displacement with the recent keyframe-interval
                # speed x frames elapsed (see VOConfig docs)
                s_prior = float(keyframe_step_prior(
                    self._st.store, self._num_kf, self.capacity))
                if s_prior > 0:
                    d = s_prior * (self._since_kf + 1)
                    t_new = np.asarray(rescale_step_to_prior(
                        jnp.asarray(R), jnp.asarray(t),
                        jnp.asarray(-last["R"].T @ last["t"]),
                        jnp.float32(d)))
                    if np.isfinite(t_new).all():
                        t = t_new
                        m.count("step_prior_fallbacks")

        self._since_kf += 1
        self.trajectory.append(-R.T @ t)

        map_dropout = (self.cfg.map.keyframe_on_map_dropout
                       and self.cfg.map.track_map and self._num_lm > 0
                       and not lost
                       and n_map < self.cfg.map.min_map_inliers
                       # inserting only helps if coverage can actually
                       # grow: with the landmark table saturated the rule
                       # just churns keyframes (measured: chunked service
                       # on the 224-frame sequence inserted ~175 keyframes
                       # and regressed ATE once landmarks hit capacity)
                       and self._num_lm < self.cfg.map.max_landmarks)
        make_kf = (self.mapping and not lost
                   and (n_inl < self.keyframe_min_inliers
                        or self._since_kf >= self.keyframe_max_gap
                        or map_dropout))
        if make_kf:
            with m.timer("insert_ba"):
                self._insert_keyframe(feats, pts, R.astype(np.float32),
                                      t.astype(np.float32), idx2,
                                      out["inliers"], last["slot"], map_idx)
            m.count("keyframes_inserted")
            self._since_kf = 0
        elif relocalised:
            if self.mapping:
                # promote the relocalised view to a recovery keyframe: both
                # the host loop and the device scan then resume tracking
                # against it (no triangulation -- there are no inlier
                # matches to the previous keyframe after a kidnap)
                K = pts.shape[0]
                with m.timer("insert_ba"):
                    self._insert_keyframe(
                        feats, pts, np.asarray(R, np.float32),
                        np.asarray(t, np.float32),
                        jnp.full(K, -1, jnp.int32), jnp.zeros(K, bool),
                        rec[2] % self.capacity)
                m.count("keyframes_inserted")
                self._since_kf = 0
                make_kf = True
            else:
                # localization-only: the map is frozen -- re-target
                # tracking at the matched stored keyframe instead
                self._cache_last(rec[2] % self.capacity)
        self._frame_idx += 1  # AFTER insert: counters[3] is the frame id
        self._prev_pose = (np.asarray(R, np.float32),
                           np.asarray(t, np.float32))

        m.count("track_inliers", n_inl)
        m.count("map_inliers", n_map)
        m.gauge("num_keyframes", self.num_keyframes)
        m.gauge("num_landmarks", self._num_lm)
        m.gauge("num_observations", self._num_obs)
        return {"pose_R": R, "pose_t": t, "keyframe": make_kf,
                "num_inliers": n_inl, "map_inliers": n_map,
                "lost": lost, "relocalised": relocalised}

    def process_chunk(self, frames):
        """Track a chunk of frames in ONE device dispatch (slam_scan.py).

        The whole per-frame tracking path -- extraction, matching, RANSAC,
        map PnP, keyframe decision and insertion -- runs inside a lax.scan
        over the SlamState pytree; windowed BA then runs once on the host
        if the chunk inserted keyframes (the local-mapping-thread pattern).
        chunk size 1 reproduces process() decision-identically, positions
        to float tolerance (tests/test_slam_scan.py -- one fused program
        vs several jit boundaries is not bitwise);
        larger chunks amortise the per-dispatch/sync cost over T
        frames at a small measured accuracy cost (eval_seq4, 224 frames,
        chunk 8 vs the per-frame loop: online ATE 0.398 vs 0.358, ~11% --
        round 4 measured 0.78 vs 0.44 before the Huber windowed BA; the
        full table and the re-triangulation negative are in
        tools/ab_chunk_accuracy.py). Only available with the
        real image frontend (an injected features_fn is host code and
        cannot be traced into the scan). Returns the per-frame outputs dict.
        """
        if not self._has_image_frontend:
            raise ValueError("process_chunk requires the image frontend "
                             "(features_fn is host code)")
        if not self.mapping:
            raise ValueError(
                "localization-only mode runs the per-frame loop: the scan "
                "tracks against the NEWEST stored keyframe and cannot "
                "re-target after relocalisation without inserting")
        if self._chunk_scan is None:
            from .slam_scan import make_slam_track_scan
            self._chunk_scan = make_slam_track_scan(
                self.cfg, self.vo.fx, self.vo.fy, self.vo.cx, self.vo.cy,
                keyframe_min_inliers=self.keyframe_min_inliers,
                keyframe_max_gap=self.keyframe_max_gap, dist=self.vo.dist)
        frames = jnp.asarray(frames)
        m = self.metrics
        n_kf_before = self._num_kf
        n_lm_before = self._num_lm
        with m.timer("scan_chunk"):
            st, outs = self._chunk_scan(self.state, frames)
            self.set_state(st)  # one counters readback per chunk
        m.count("frames", frames.shape[0])
        m.count("keyframes_inserted", self._num_kf - n_kf_before)
        for R, t in zip(np.asarray(outs["pose_R"]),
                        np.asarray(outs["pose_t"])):
            self.trajectory.append(-R.T @ t)
        if self._num_kf > n_kf_before and self._num_kf >= 2:
            with m.timer("insert_ba"):
                self._local_ba()
            if (self.cfg.map.chunk_retriangulate and frames.shape[0] > 1
                    and self._num_lm > n_lm_before):
                # in-chunk landmarks were triangulated against poses BA
                # had not refined; reset their linearisation point from
                # the refined poses and converge once more (see
                # retriangulate_landmarks -- chunk 1 inserts like the
                # per-frame loop and skips this)
                with m.timer("insert_ba"):
                    if self.retriangulate_landmarks(n_lm_before,
                                                    self._num_lm):
                        self._local_ba()
        # chunk-boundary lost-tracking recovery: the scan cannot relocalise
        # on-device (the store-wide match is host orchestration), so when
        # the chunk ENDS lost, relocalise the last frame against the whole
        # keyframe store and promote it to a recovery keyframe -- the next
        # chunk then tracks against it. chunk=1 reproduces process()'s
        # in-loop recovery decision-for-decision.
        outs = {k: np.array(v) for k, v in outs.items()}  # writable copies
        ninl = outs["num_inliers"]
        # a bootstrap frame reports 0 inliers but is a keyframe, not lost
        if (ninl.shape[0] > 0 and int(ninl[-1]) < self.cfg.vo.min_inliers
                and not bool(outs["keyframe"][-1]) and self._num_kf > 0):
            m.count("frames_lost")
            self.frames_lost += 1
            with m.timer("relocalise"):
                feats, pts = self._features(frames[-1])
                rec = self._relocalise_feats(
                    feats, pts, min_matches=self.reloc_min_matches)
            if rec is not None:
                R, t, kf_ord = rec
                K = pts.shape[0]
                self._frame_idx -= 1  # the frame id is the LAST chunk frame
                self._insert_keyframe(
                    feats, pts, np.asarray(R, np.float32),
                    np.asarray(t, np.float32),
                    jnp.full(K, -1, jnp.int32), jnp.zeros(K, bool),
                    kf_ord % self.capacity)
                self._frame_idx += 1
                self._since_kf = 0
                outs["pose_R"][-1] = np.asarray(R, np.float32)
                outs["pose_t"][-1] = np.asarray(t, np.float32)
                outs["keyframe"][-1] = True
                self.trajectory[-1] = -np.asarray(R).T @ np.asarray(t)
                m.count("relocalisations")
                self.relocalisations += 1
                m.count("keyframes_inserted")
        m.gauge("num_keyframes", self.num_keyframes)
        m.gauge("num_landmarks", self._num_lm)
        m.gauge("num_observations", self._num_obs)
        return outs

    def _insert_keyframe(self, feats, pts, R, t, idx2, inliers, prev_slot,
                         map_idx=None):
        st = self.state  # sync counters into the device state
        if map_idx is None:
            map_idx = jnp.full(pts.shape[0], -1, jnp.int32)
        self._st = self._insert(st, feats, pts, jnp.asarray(R),
                                jnp.asarray(t), idx2, inliers,
                                prev_slot, map_idx)
        c = np.asarray(self._st.counters)
        self._num_kf, self._num_lm, self._num_obs = int(c[0]), int(c[1]), \
            int(c[2])
        self._culled_slots.discard((self._num_kf - 1) % self.capacity)
        self._cache_last((self._num_kf - 1) % self.capacity)
        if self._num_kf >= 2:
            self._local_ba()

    # -- bundle adjustment --------------------------------------------------

    def _window(self, size: Optional[int] = None):
        """(ordinals, slots) of the newest `size` keyframes, oldest first.
        Culled slots are skipped (their observation rows are gone)."""
        w = min(size or self.cfg.ba.window, self._num_kf)
        base = self._num_kf - w
        pairs = [(o, o % self.capacity) for o in range(base, self._num_kf)
                 if (o % self.capacity) not in self._culled_slots]
        return [o for o, _ in pairs], [s for _, s in pairs]

    def _window_covis(self):
        """(ordinals, slots) of the newest keyframe plus its most covisible
        keyframes (shared-landmark weights, backend/keyframes.covisibility)
        -- ORB-SLAM's local-BA neighbourhood instead of the temporal window.
        Falls back to the temporal window when the newest keyframe has no
        covisible partners yet (bootstrap)."""
        w = self.cfg.ba.window
        st = self._st
        weights, valid, ordinal = jax.device_get(
            (self._covis(st.store, st.lmap, st.obs),
             st.store.valid, st.store.ordinal))
        cur = (self._num_kf - 1) % self.capacity
        wrow = np.where(valid, weights[cur], -1)
        wrow[cur] = -1
        order = np.argsort(-wrow, kind="stable")
        picked = [cur] + [int(s) for s in order if wrow[s] > 0][: w - 1]
        if len(picked) < 2:
            return self._window()
        picked.sort(key=lambda s: int(ordinal[s]))
        return [int(ordinal[s]) for s in picked], picked

    def _local_ba(self):
        bc = self.cfg.ba
        if bc.covisibility_window and self._num_kf > bc.window:
            ordinals, slots = self._window_covis()
        else:
            ordinals, slots = self._window()
        self._run_ba(ordinals, slots, C=bc.window, max_points=bc.max_points,
                     max_obs=bc.max_obs, iters=bc.gn_iters,
                     fixed_observers=bc.fixed_observers)

    def global_ba(self, iters: Optional[int] = None):
        """Full-map bundle adjustment: ALL stored keyframes + landmarks.

        The offline/loop-closure refinement pass: after the pose graph has
        moved keyframe poses, landmarks still sit where the pre-closure
        poses triangulated them -- one global BA re-converges the whole map
        (gauge: the oldest stored keyframe is held fixed and the next one at
        its distance from it, ba.ba_iterations' scale_anchor). Pinning the
        second keyframe whole instead held its tracked error in place: under
        summation-order noise the closure then regressed eval_seq's keyframe
        ATE by up to 0.006, with the minimal gauge by at most 0.0014. Same
        fixed-shape Schur machinery as the windowed pass, sized to the
        store capacity instead of the sliding window.
        """
        mc, bc = self.cfg.map, self.cfg.ba
        ordinals, slots = self._window(size=self.capacity)
        with self.metrics.timer("global_ba"):
            self._run_ba(ordinals, slots, C=self.capacity,
                         max_points=mc.max_landmarks, max_obs=mc.max_obs,
                         iters=iters or bc.global_iters,
                         fixed_observers=0, scale_anchor=True)

    def _run_ba(self, ordinals, slots, C: int, max_points: int,
                max_obs: int, iters: int,
                fixed_observers: Optional[int] = None,
                scale_anchor: bool = False):
        bc = self.cfg.ba
        if len(ordinals) < 2 or self._num_obs == 0:
            return
        st = self._st
        # one host readback of the observation tables (per keyframe, not
        # per frame)
        obs_kf = np.asarray(st.obs.kf)
        obs_lm = np.asarray(st.obs.lm)
        obs_uv = np.asarray(st.obs.uv)
        obs_valid = np.asarray(st.obs.valid)
        kf_ordinal = np.asarray(st.store.ordinal)

        # rows whose keyframe ordinal is IN the window (set membership, not
        # a contiguous range: the covisibility window picks non-adjacent
        # keyframes); `ordinals` is sorted ascending
        ords = np.asarray(ordinals)
        ords_of_obs = kf_ordinal[obs_kf]
        pos_in = np.searchsorted(ords, ords_of_obs)
        member = (pos_in < len(ords)) & \
            (ords[np.minimum(pos_in, len(ords) - 1)] == ords_of_obs)
        sel = obs_valid & member
        sel_idx = np.where(sel)[0]
        if len(sel_idx) == 0:
            return
        lm_slots = np.unique(obs_lm[sel_idx])[:max_points]
        # local point index of each selected row (sorted-unique -> searchsorted)
        pos = np.searchsorted(lm_slots, obs_lm[sel_idx])
        in_window = (pos < len(lm_slots)) & \
            (lm_slots[np.minimum(pos, len(lm_slots) - 1)] == obs_lm[sel_idx])
        rows = sel_idx[in_window][:max_obs]
        if len(rows) == 0:
            return

        # out-of-window FIXED observers (ORB-SLAM local-BA "fixed
        # keyframes"; see BAConfig.fixed_observers): keyframes outside the
        # window observing window landmarks join the problem with frozen
        # poses, anchoring the window's scale and orientation to the
        # older map. Ordered FIRST so ba's n_fixed prefix pins them.
        fixed_cap = 0 if fixed_observers is None else fixed_observers
        fixed_slots = []
        fx_rows = np.empty(0, np.int64)
        if fixed_cap > 0:
            pos_all = np.searchsorted(lm_slots, obs_lm)
            lm_member = (pos_all < len(lm_slots)) & \
                (lm_slots[np.minimum(pos_all, len(lm_slots) - 1)] == obs_lm)
            kf_valid = np.asarray(st.store.valid)
            out_sel = obs_valid & lm_member & ~member & kf_valid[obs_kf]
            counts = np.bincount(obs_kf[out_sel], minlength=self.capacity)
            order = np.argsort(-counts, kind="stable")
            fixed_slots = [int(s) for s in order if counts[s] > 0][:fixed_cap]
            if fixed_slots:
                in_fixed = np.zeros(self.capacity, bool)
                in_fixed[fixed_slots] = True
                fx_rows = np.where(out_sel & in_fixed[obs_kf])[0]
                fx_rows = fx_rows[: max_obs - len(rows)]
        n_fx = len(fixed_slots)
        # >= 2 pinned cameras (gauge + monocular scale anchor): short
        # observer lists are topped up with the oldest window cams. With
        # scale_anchor and no fixed observers the gauge is the minimal one
        # of ba.ba_iterations instead: the oldest camera pinned, the next
        # one held at its distance from it
        scale_anchor = scale_anchor and n_fx == 0
        n_fixed = 1 if scale_anchor else max(2, n_fx)

        cam_slots = list(fixed_slots) + list(slots)
        cam_of_slot = np.full(self.capacity, -1, np.int64)
        cam_of_slot[np.asarray(cam_slots, np.int64)] = np.arange(
            len(cam_slots))

        C_total = C + fixed_cap
        O, P_ = max_obs, max_points
        obs_cam = np.zeros(O, np.int32)
        obs_pt = np.zeros(O, np.int32)
        uv = np.zeros((O, 2), np.float32)
        ov = np.zeros(O, bool)
        allrows = np.concatenate([rows, fx_rows]) if len(fx_rows) else rows
        nr = len(allrows)
        obs_cam[:nr] = cam_of_slot[obs_kf[allrows]]
        obs_pt[:nr] = np.searchsorted(lm_slots, obs_lm[allrows])
        uv[:nr] = obs_uv[allrows]
        ov[:nr] = True

        Rw = np.asarray(st.store.R[np.asarray(cam_slots)])
        tw = np.asarray(st.store.t[np.asarray(cam_slots)])
        Rs = np.broadcast_to(np.eye(3, dtype=np.float32),
                             (C_total, 3, 3)).copy()
        ts = np.zeros((C_total, 3), np.float32)
        cam_valid = np.zeros(C_total, bool)
        Rs[:len(cam_slots)], ts[:len(cam_slots)] = Rw, tw
        cam_valid[:len(cam_slots)] = True

        Xw = np.asarray(st.lmap.xyz[jnp.asarray(lm_slots)])
        points = np.zeros((P_, 3), np.float32)
        points[:len(lm_slots)] = Xw
        pt_valid = np.zeros(P_, bool)
        pt_valid[:len(lm_slots)] = True

        prob = ba.BAProblem(
            R=jnp.asarray(Rs), t=jnp.asarray(ts), points=jnp.asarray(points),
            obs_cam=jnp.asarray(obs_cam), obs_pt=jnp.asarray(obs_pt),
            obs_uv=jnp.asarray(uv), obs_valid=jnp.asarray(ov),
            cam_valid=jnp.asarray(cam_valid), pt_valid=jnp.asarray(pt_valid))
        out, _ = ba.bundle_adjust(prob, iters=iters, damping=bc.damping,
                                  huber=bc.huber, n_fixed=n_fixed,
                                  scale_anchor=scale_anchor)

        # failure detection (same philosophy as tracking): a degenerate
        # Schur solve (rank-deficient after heavy culling/eviction, or
        # low-precision matmul conditioning) must not poison the map --
        # reject the whole update rather than commit NaNs (observed once:
        # chunked long-session service on the chip went NaN through an
        # unguarded refinement and crashed the final eval)
        lo, hi = n_fx, n_fx + len(slots)   # free (window) camera block
        outR = np.asarray(out.R[lo:hi])
        outt = np.asarray(out.t[lo:hi])
        outX = np.asarray(out.points[:len(lm_slots)])
        if not (np.isfinite(outR).all() and np.isfinite(outt).all()
                and np.isfinite(outX).all()):
            self.metrics.count("ba_nonfinite_rejected")
            return

        sl = jnp.asarray(np.int32(slots))
        store = st.store._replace(
            R=st.store.R.at[sl].set(out.R[lo:hi]),
            t=st.store.t.at[sl].set(out.t[lo:hi]))
        lmap = st.lmap._replace(
            xyz=st.lmap.xyz.at[jnp.asarray(lm_slots)].set(
                out.points[:len(lm_slots)]))
        self._st = st._replace(store=store, lmap=lmap)
        self._cache_last((self._num_kf - 1) % self.capacity)

    def retriangulate_landmarks(self, lm_lo: int, lm_hi: int) -> int:
        """Re-triangulate landmarks in slot range [lm_lo, lm_hi) from
        their first two observations using the CURRENT keyframe poses.

        The fix for the chunked scan's accuracy gap: landmarks inserted
        inside a device-resident chunk are triangulated against poses
        windowed BA has not yet refined, and BA afterwards converges to a
        nearby bad local minimum instead of undoing the bad linearisation
        point (measured on eval_seq4 chunk 8: online ATE 0.78 vs the
        per-frame loop's 0.44; repeating boundary BA 3x only reached
        0.75). Re-triangulating from the refined poses resets the
        geometry exactly where it was created stale; process_chunk runs
        this between its two boundary-BA passes. Degenerate
        re-triangulations (behind-camera or non-finite) keep their old
        position. Returns the number of landmarks moved.
        """
        if lm_hi <= lm_lo:
            return 0
        st = self._st
        okf, olm, ouv, ovalid = jax.device_get(
            (st.obs.kf, st.obs.lm, st.obs.uv, st.obs.valid))
        kf_valid = np.asarray(st.store.valid)
        lmv = np.asarray(st.lmap.valid)
        sel = (ovalid & (olm >= lm_lo) & (olm < lm_hi)
               & kf_valid[okf] & lmv[olm])
        rows = np.nonzero(sel)[0]
        if rows.size == 0:
            return 0
        # first two observation rows per landmark (append order = insertion
        # order, so these are the two views it was triangulated from)
        order = rows[np.argsort(olm[rows], kind="stable")]
        lms = olm[order]
        uniq, first, counts = np.unique(lms, return_index=True,
                                        return_counts=True)
        has2 = counts >= 2
        if not has2.any():
            return 0
        l = uniq[has2]
        r1 = order[first[has2]]
        r2 = order[first[has2] + 1]
        R = np.asarray(st.store.R)
        t = np.asarray(st.store.t)
        R1, t1, R2, t2 = R[okf[r1]], t[okf[r1]], R[okf[r2]], t[okf[r2]]
        tri = jax.vmap(lambda Ra, ta, Rb, tb, pa, pb:
                       triangulate.triangulate_two_view(
                           Ra, ta, Rb, tb, pa[None], pb[None])[0])
        X = np.asarray(tri(jnp.asarray(R1), jnp.asarray(t1),
                           jnp.asarray(R2), jnp.asarray(t2),
                           jnp.asarray(ouv[r1]), jnp.asarray(ouv[r2])))
        z1 = np.einsum("nij,nj->ni", R1, X)[:, 2] + t1[:, 2]
        z2 = np.einsum("nij,nj->ni", R2, X)[:, 2] + t2[:, 2]
        ok = np.isfinite(X).all(1) & (z1 > 1e-4) & (z2 > 1e-4)
        l, X = l[ok], X[ok]
        if l.size == 0:
            return 0
        lmap = st.lmap._replace(xyz=st.lmap.xyz.at[jnp.asarray(l)].set(
            jnp.asarray(X, jnp.float32)))
        self._st = st._replace(lmap=lmap)
        self.metrics.count("landmarks_retriangulated", int(l.size))
        return int(l.size)

    def cull_landmarks(self, max_residual: Optional[float] = None,
                       min_obs: int = 2):
        """Map maintenance: drop landmarks that reproject badly against the
        current keyframe poses or have too little support (ORB-SLAM-style
        culling; backend/keyframes.py:cull_landmarks). Run after BA / loop
        closure so residuals reflect refined poses. Returns the number of
        landmarks culled. Slots are invalidated, not reclaimed (the
        fixed-capacity map drops newest-first when full)."""
        mc = self.cfg.map
        thr = (max_residual if max_residual is not None
               else 2.0 * mc.pnp_inlier_threshold)
        st = self._st
        with self.metrics.timer("cull"):
            before = int(jnp.sum(st.lmap.valid))
            lmap, obs = jax.jit(kfs.cull_landmarks)(
                st.store, st.lmap, st.obs, thr, min_obs)
            culled = before - int(jnp.sum(lmap.valid))
        self._st = st._replace(lmap=lmap, obs=obs)
        self.metrics.count("landmarks_culled", culled)
        return culled

    def evict_stale_landmarks(self, min_free: int = 0):
        """Long-session map freshness: when fewer than ``min_free``
        landmark slots are free, invalidate the landmarks whose LAST
        observation is oldest until ``min_free`` are free
        (backend/keyframes.evict_stale_landmarks). A saturated landmark
        table silently disables triangulation -- and with it the
        keyframe-on-map-dropout rule -- for the rest of the session
        (measured on the 224-frame sequence: the chunked service pinned
        at 8192/8192 from mid-run). Compacts afterwards, so the freed
        slots are immediately available to the triangulation cursor (a
        bare mask invalidation would leave the cursor saturated until
        some later compact()). Returns the number evicted."""
        st = self._st
        # count from the mask, not _num_lm: culling invalidates rows
        # without moving the cursor until compact() runs
        free = int(st.lmap.capacity) - int(jnp.sum(st.lmap.valid))
        need = min_free - free
        if need <= 0:
            return 0
        with self.metrics.timer("evict_stale"):
            lmap, obs, n = jax.jit(kfs.evict_stale_landmarks)(
                st.store, st.lmap, st.obs, jnp.int32(need))
            n = int(n)
        self._st = st._replace(lmap=lmap, obs=obs)
        self.metrics.count("landmarks_evicted", n)
        if n:
            self.compact()
        return n

    # -- covisibility / keyframe culling / compaction ------------------------

    def covisibility(self) -> np.ndarray:
        """(F, F) shared-landmark counts between keyframe slots (one matmul
        over the observation table; backend/keyframes.covisibility).
        The ORB-SLAM covisibility graph."""
        st = self._st
        return np.asarray(self._covis(st.store, st.lmap, st.obs))

    def cull_keyframes(self, max_cull: int = 1, protect_recent: int = 3,
                       min_other_obs: int = 3,
                       redundant_fraction: float = 0.9):
        """Cull redundant keyframes (ORB-SLAM keyframe culling).

        A keyframe is redundant when >= ``redundant_fraction`` of its
        observed landmarks are seen by >= ``min_other_obs`` other keyframes.
        One keyframe is culled per device dispatch (culling changes the
        survivors' redundancy, so batch culling could strip a region bare);
        up to ``max_cull`` iterations. The newest ``protect_recent``
        keyframes (tracking references) and the oldest (BA/pose-graph gauge
        anchor) are never culled. Returns the culled ordinals, oldest pass
        first. Pair with compact() to reclaim observation capacity.
        """
        protect_recent = max(1, protect_recent)
        culled = []
        m = self.metrics
        for _ in range(max_cull):
            st = self._st
            ordinal = np.asarray(st.store.ordinal)
            valid = np.asarray(st.store.valid)
            if int(valid.sum()) <= protect_recent + 2:
                break
            min_ord = int(ordinal[valid].min())
            eligible = valid & (ordinal > min_ord) \
                & (ordinal < self._num_kf - protect_recent)
            if not eligible.any():
                break
            with m.timer("cull_keyframes"):
                store, lmap, obs, slot = self._cull_kf(
                    st.store, st.lmap, st.obs, jnp.asarray(eligible),
                    min_other_obs, redundant_fraction)
                slot = int(slot)
            if slot < 0:
                break
            self._st = st._replace(store=store, lmap=lmap, obs=obs)
            self._culled_slots.add(slot)
            culled.append(int(ordinal[slot]))
        if culled:
            m.count("keyframes_culled", len(culled))
            m.gauge("num_keyframes", self.num_keyframes)
        return culled

    def compact(self):
        """Re-pack live landmarks/observations to the front of their stores
        and pull the cursors back (backend/keyframes.compact_map) -- culling
        invalidates rows but only compaction reclaims their capacity for a
        long-running session. Returns (num_landmarks, num_observations)."""
        st = self._st
        with self.metrics.timer("compact"):
            lmap, obs, n_lm, n_obs = self._compact(st.lmap, st.obs)
            self._num_lm, self._num_obs = int(n_lm), int(n_obs)
        self._st = st._replace(lmap=lmap, obs=obs)
        self.metrics.gauge("num_landmarks", self._num_lm)
        self.metrics.gauge("num_observations", self._num_obs)
        return self._num_lm, self._num_obs

    # -- loop closure / relocalisation --------------------------------------

    def match_keyframe(self, feats, pts, exclude_recent: int = 0,
                       min_matches: int = 30, exclude_slots=None):
        """Match features against the ENTIRE keyframe store in one dispatch;
        localise against the best-supported keyframe.

        Returns (kf_ordinal, R_rel, t_rel_unit, num_inliers) where the
        relative pose maps the matched keyframe's camera to the query camera
        (translation up to monocular scale), or (-1, None, None, 0) when no
        keyframe reaches `min_matches` filtered correspondences. Keyframes
        with ordinal >= num_keyframes - exclude_recent are skipped (loop
        detection must not fire on the immediate past).
        """
        if self._num_kf - exclude_recent <= 0:
            return -1, None, None, 0
        counts = np.asarray(self._store_counts(self._st.store, feats))
        ordinal = np.asarray(self._st.store.ordinal)
        valid = np.asarray(self._st.store.valid)
        eligible = valid & (ordinal < self._num_kf - exclude_recent)
        if exclude_slots is not None:
            eligible = eligible & ~np.asarray(exclude_slots, bool)
        counts = np.where(eligible, counts, -1)
        best_slot = int(np.argmax(counts))
        if counts[best_slot] < min_matches:
            return -1, None, None, 0
        desc, kvalid, ref_pts, _R, _t = self._slot_rows(best_slot)
        out, _ = self._localise_against(desc, kvalid, ref_pts, feats, pts)
        n_inl = int(out["num_inliers"])
        if n_inl < max(self.cfg.vo.min_inliers, min_matches // 2):
            return -1, None, None, 0
        t = np.asarray(out["t"])
        t = t / max(np.linalg.norm(t), 1e-9)
        return int(ordinal[best_slot]), np.asarray(out["R"]), t, n_inl

    def _loop_neighbourhood_pnp(self, old_slot: int, desc, kvalid, pts,
                                R_init, t_init, min_inliers: int,
                                exclude_recent: int = 0,
                                max_neighbours: Optional[int] = None):
        """Metric re-measurement of the loop pose: PnP of the current
        keyframe's features against the landmark UNION of the matched
        keyframe and its most covisible neighbours.

        The essential-matrix loop measurement is monocular -- its
        translation magnitude must be invented, and taking it from the
        current (drifted) baseline preserves the very drift the closure is
        meant to remove (measured on eval_seq2: 1.41 m estimated terminal
        baseline vs 0.146 m truth, and the pose graph made ATE *worse*,
        0.154 -> 0.196). The old keyframes' landmarks carry the map's
        metric scale from before the drift accumulated, so 2D-3D
        motion-only BA against them (backend/pnp.py) yields a fully metric
        pose -- the monocular analog of ORB-SLAM's SIM(3) loop correction
        with the scale read off the map. Round 4 measured that ONE
        keyframe's landmarks leave the edge's own error (0.24 m on
        eval_seq2) the same order as the drift it corrects; the
        neighbourhood union (more landmarks, wider baseline spread) is
        what buys edge accuracy, and the per-neighbour support counts let
        try_close_loop emit one weighted edge per old keyframe.

        Returns a dict {R, t, num_inliers, slots, supports, lm, idx2,
        inliers, uv} (world->cam pose; ``supports[i]`` = PnP-inlier
        landmarks observed by ``slots[i]``; ``lm``/``idx2``/``inliers``/
        ``uv`` describe the per-landmark associations for loop fusion),
        or None when the neighbourhood has no usable landmarks or total
        PnP support is below ``min_inliers``.
        """
        mc = self.cfg.map
        st = self._st
        # neighbourhood slots: the matched keyframe + most covisible
        # partners, excluding anything temporally recent (those are the
        # query's own neighbourhood, not the loop side)
        slots = [old_slot]
        n_nb = mc.loop_neighbours if max_neighbours is None else \
            max_neighbours
        if n_nb > 0:
            covis = self.covisibility()
            valid = np.asarray(st.store.valid)
            ordinal = np.asarray(st.store.ordinal)
            wrow = np.where(
                valid & (ordinal < self._num_kf - exclude_recent),
                covis[old_slot], -1)
            wrow[old_slot] = -1
            order = np.argsort(-wrow, kind="stable")
            slots += [int(s) for s in order
                      if wrow[s] >= mc.loop_neighbour_min_covis][:n_nb]
        okf, ovalid, olm = np.asarray(st.obs.kf), np.asarray(
            st.obs.valid), np.asarray(st.obs.lm)
        lmv = np.asarray(st.lmap.valid)
        L = lmv.shape[0]
        member = np.zeros((len(slots), L), bool)
        for i, s in enumerate(slots):
            rows = olm[(okf == s) & ovalid]
            member[i, rows[lmv[rows]]] = True
        counts = member.sum(0)
        K = int(desc.shape[0])
        lm_desc_all = np.asarray(st.lmap.descriptors)
        lm_xyz_all = np.asarray(st.lmap.xyz)

        def pad(lm):
            ldesc = np.zeros((K, desc.shape[1]), np.uint32)
            lxyz = np.zeros((K, 3), np.float32)
            ldesc[: lm.size] = lm_desc_all[lm]
            lxyz[: lm.size] = lm_xyz_all[lm]
            lok = np.zeros(K, bool)
            lok[: lm.size] = True
            return ldesc, lxyz, lok

        def solve(lm, idx2, R0, t0, coarse: bool):
            """(pose dict, per-row arrays) fine PnP against `lm` rows."""
            _, lxyz, lok = pad(lm)
            ok = lok & (idx2 >= 0)
            uv = np.asarray(pts)[np.clip(idx2, 0, K - 1)]
            R0 = jnp.asarray(R0, jnp.float32)
            t0 = jnp.asarray(t0, jnp.float32)
            if coarse:
                # the init translation scale is the DRIFTED baseline
                # |c_cur - c_old|, which can sit far outside the fine
                # Huber basin (measured on eval_seq2: scale 5.0 map
                # units, median init residual 0.19 -- fine-only reached
                # 11 inliers where coarse->fine reaches 37): a wide
                # first stage pulls the pose into the basin
                c = pnp.motion_only_ba(R0, t0, jnp.asarray(lxyz),
                                       jnp.asarray(uv, jnp.float32),
                                       jnp.asarray(ok), iters=15,
                                       huber=5e-2)
                R0, t0 = c["R"], c["t"]
            out = pnp.motion_only_ba(R0, t0, jnp.asarray(lxyz),
                                     jnp.asarray(uv, jnp.float32),
                                     jnp.asarray(ok), iters=15)
            return out, uv

        # stage A: the matched keyframe's OWN landmarks, descriptor-only
        # matching -- a small clean set the two-stage PnP converges on
        lm_a = np.nonzero(member[0])[0][:K]
        if lm_a.size < min_inliers:
            return None
        ldesc_a, _, lok_a = pad(lm_a)
        idx2_a, _ = self._match(jnp.asarray(ldesc_a), desc,
                                jnp.asarray(lok_a), kvalid)
        out_a, uv_a = solve(lm_a, np.asarray(idx2_a), R_init, t_init,
                            coarse=True)
        n_a = int(out_a["num_inliers"])
        if n_a < min_inliers:
            return None
        lm, idx2, out, uv = lm_a, np.asarray(idx2_a), out_a, uv_a

        if len(slots) > 1:
            # stage B: re-associate against the neighbourhood UNION with a
            # projection gate at the converged pose, then refine
            # (ORB-SLAM's loop flow: compute the correction from the
            # matched keyframe, then SearchByProjection over its covisible
            # neighbourhood, then optimise again). An UNGATED union match
            # feeds the solver aliased correspondences that outvote the
            # good ones (measured on eval_seq2: 162 raw union matches ->
            # 2 PnP inliers, vs 87 own-landmark matches -> 37).
            lm_u = np.nonzero(counts > 0)[0]
            # capacity-bound: prefer landmarks seen by the most
            # neighbourhood keyframes (best-anchored geometry)
            lm_u = lm_u[np.argsort(-counts[lm_u], kind="stable")][:K]
            ldesc_u, lxyz_u, lok_u = pad(lm_u)
            Rb, tb = np.asarray(out_a["R"]), np.asarray(out_a["t"])
            xc = lxyz_u @ Rb.T + tb
            z = xc[:, 2]
            proj = np.where((z > 1e-6)[:, None],
                            xc[:, :2] / np.maximum(z, 1e-6)[:, None],
                            np.float32(1e6)).astype(np.float32)
            radius = self.cfg.map.gate_radius or \
                4.0 * self.cfg.map.pnp_inlier_threshold
            idx2_u, _ = jax.jit(partial(
                matching.match_gated, radius=float(radius),
                max_distance=self.cfg.map.map_match_max_distance,
                ratio=self.cfg.matcher.ratio, cross_check=True))(
                jnp.asarray(ldesc_u), desc, jnp.asarray(lok_u), kvalid,
                jnp.asarray(proj), pts)
            out_b, uv_b = solve(lm_u, np.asarray(idx2_u), Rb, tb,
                                coarse=False)
            if int(out_b["num_inliers"]) >= n_a:
                lm, idx2, out, uv = lm_u, np.asarray(idx2_u), out_b, uv_b

        n = int(out["num_inliers"])
        inl = np.asarray(out["inliers"])
        inl_of_lm = np.zeros(L, bool)
        inl_of_lm[lm] = inl[: lm.size]
        supports = [int((member[i] & inl_of_lm).sum())
                    for i in range(len(slots))]
        return {"R": np.asarray(out["R"]), "t": np.asarray(out["t"]),
                "num_inliers": n, "slots": slots, "supports": supports,
                "lm": lm, "idx2": idx2, "inliers": inl, "uv": uv}

    def _loop_pnp_pose(self, old_slot: int, desc, kvalid, pts,
                       R_init, t_init, min_inliers: int):
        """Single-keyframe metric loop PnP (round-3 edge construction,
        kept for the A/B record in tools/ab_loop_edge.py): the
        neighbourhood PnP restricted to the matched keyframe's own
        landmarks. Returns (R, t, num_inliers) or None."""
        res = self._loop_neighbourhood_pnp(
            old_slot, desc, kvalid, pts, R_init, t_init, min_inliers,
            max_neighbours=0)
        if res is None:
            return None
        return res["R"], res["t"], res["num_inliers"]

    def _fuse_loop_observations(self, cur_slot: int, res: dict) -> int:
        """Loop fusion: append observation rows linking the current
        keyframe to the PnP-inlier OLD landmarks (ORB-SLAM's loop fusion,
        re-expressed as one batched add_observations append). Global BA
        afterwards then enforces the closure on the map geometry itself --
        the pose-graph edges alone leave the reprojection field encoding
        the pre-closure geometry. Landmarks the current keyframe already
        observes are skipped. Returns the number of rows fused."""
        st = self._st
        okf, ovalid, olm = np.asarray(st.obs.kf), np.asarray(
            st.obs.valid), np.asarray(st.obs.lm)
        existing = np.zeros(st.lmap.capacity, bool)
        existing[olm[(okf == cur_slot) & ovalid]] = True
        lm, idx2, inl, uv = res["lm"], res["idx2"], res["inliers"], res["uv"]
        K = idx2.shape[0]
        lm_slot = np.zeros(K, np.int32)
        mask = np.zeros(K, bool)
        lm_slot[: lm.size] = lm
        mask[: lm.size] = inl[: lm.size] & ~existing[lm]
        n_fuse = int(mask.sum())
        if n_fuse == 0:
            return 0
        lmap, obs, obs_cur = kfs.add_observations(
            st.lmap, st.obs, jnp.int32(self._num_obs), jnp.int32(cur_slot),
            jnp.asarray(lm_slot), jnp.asarray(uv, jnp.float32),
            jnp.asarray(mask))
        self._st = st._replace(lmap=lmap, obs=obs)
        self._num_obs = int(obs_cur)
        self.metrics.count("loop_obs_fused", n_fuse)
        return n_fuse

    def _detect_loop(self, min_matches: int = 40, exclude_recent: int = 3,
                     exclude_covisible_weight: int = 0):
        """Loop detection + metric measurement + fusion (shared by
        try_close_loop and close_loop).

        The loop pose is measured METRICALLY when possible: the current
        keyframe is PnP-localised against the landmark union of the
        matched keyframe and its covisible neighbours
        (`_loop_neighbourhood_pnp`), which carries the map's scale into
        the measurement, and ONE weighted pose-graph edge is emitted per
        old keyframe whose own landmarks supply at least
        cfg.map.loop_edge_min_support PnP inliers (the old keyframes'
        relative poses are BA-refined local geometry, so the multi-edge
        fan constrains the closure far better than a single noisy edge).
        The PnP-inlier associations are also fused into the observation
        table (`_fuse_loop_observations`) so a subsequent global BA
        enforces the closure on the map geometry itself. When the old
        neighbourhood has no usable landmarks the edge falls back to the
        monocular essential-matrix measurement with its translation scale
        set from the current pose estimates (direction/rotation
        correction only).
        With ``exclude_covisible_weight`` > 0, keyframes sharing at least
        that many landmarks with the query are additionally excluded
        (ORB-SLAM's covisibility-consistency rule: a keyframe already
        connected to the query through the map is the local neighbourhood,
        not a loop -- a "closure" against it adds no new constraint).
        Returns (matched ordinal, pose-graph edges), or None.
        """
        if self._num_kf < exclude_recent + 2:
            return None
        m = self.metrics
        cur_slot = (self._num_kf - 1) % self.capacity
        desc, kvalid, pts, R_cur, t_cur = self._slot_rows(cur_slot)
        feats_like = Features(
            codes=self._st.store.codes[cur_slot], valid=kvalid,
            angles=jnp.zeros(kvalid.shape[0], jnp.uint8), descriptors=desc)
        excl = None
        if exclude_covisible_weight > 0:
            excl = self.covisibility()[cur_slot] >= exclude_covisible_weight
        with m.timer("loop_detect"):
            idx, R_rel, t_unit, n_sup = self.match_keyframe(
                feats_like, pts, exclude_recent=exclude_recent,
                min_matches=min_matches, exclude_slots=excl)
        if idx < 0:
            return None
        old_slot = idx % self.capacity
        R_old = np.asarray(self._st.store.R[old_slot])
        t_old = np.asarray(self._st.store.t[old_slot])
        # current-estimate baseline length sets the edge scale
        c_old = -R_old.T @ t_old
        c_cur = -R_cur.T @ t_cur
        scale = float(np.linalg.norm(c_cur - c_old))
        # RANSAC measures T_rel with x_cur = R_rel x_old + t_rel, i.e.
        # T_rel = X_cur X_old^-1 (camera-frame relative). The pose-graph edge
        # convention (edge_residuals / odometry edges) is Z = X_old^-1 X_cur,
        # so conjugate: Z = X_old^-1 (T_rel X_old). Passing T_rel directly
        # would inject error proportional to the keyframes' absolute rotation
        # (verified: perfect measurements left residual ~0.5 for
        # non-commuting rotations).
        t_rel = t_unit * scale
        R_meas = R_rel @ R_old
        t_meas = R_rel @ t_old + t_rel
        res = self._loop_neighbourhood_pnp(
            old_slot, desc, kvalid, pts, R_meas, t_meas,
            min_inliers=max(self.cfg.map.min_map_inliers, min_matches // 2),
            exclude_recent=exclude_recent)
        edges = []
        cur_ord = self._num_kf - 1
        if res is not None:
            R_meas, t_meas, n_sup = res["R"], res["t"], res["num_inliers"]
            m.count("loop_edges_metric")
            ordinal = np.asarray(self._st.store.ordinal)
            store_R = np.asarray(self._st.store.R)
            store_t = np.asarray(self._st.store.t)
            for s, sup in zip(res["slots"], res["supports"]):
                if sup < self.cfg.map.loop_edge_min_support:
                    continue
                edges.append((int(ordinal[s]), cur_ord,
                              store_R[s].T @ R_meas,
                              store_R[s].T @ (t_meas - store_t[s]),
                              float(sup)))
            if self.cfg.map.loop_fuse_observations:
                self._fuse_loop_observations(cur_slot, res)
        if not edges:
            # essential-matrix fallback (or every neighbour below the
            # support floor): the single round-3-style edge to the
            # matched keyframe
            edges = [(idx, cur_ord, R_old.T @ R_meas,
                      R_old.T @ (t_meas - t_old), float(n_sup))]
        return idx, edges

    def try_close_loop(self, min_matches: int = 40, exclude_recent: int = 3,
                       exclude_covisible_weight: int = 0):
        """Detect a loop for the newest keyframe and optimise the pose
        graph (see `_detect_loop` for the measurement). The primitive
        closure; `close_loop` is the production pipeline with the
        measured graph-vs-BA-only selection. Returns the matched keyframe
        ordinal, or -1 if no loop was found."""
        det = self._detect_loop(min_matches, exclude_recent,
                                exclude_covisible_weight)
        if det is None:
            return -1
        idx, edges = det
        with self.metrics.timer("pose_graph"):
            self.optimise_pose_graph(loop_edges=edges)
        self.metrics.count("loops_closed")
        return idx

    def map_consistency(self, obs_ref=None):
        """Mean Huber-robust reprojection cost per valid observation of
        the whole map at the current poses (gt-free), each row capped at
        the cost of a residual of ten Huber scales. The model-selection
        metric for close_loop: a closure path that leaves the map
        internally strained scores high.

        ``obs_ref`` optionally FREEZES the observation set (a host tuple
        (kf, lm, uv, valid) captured earlier): the cost is then evaluated
        over that fixed set regardless of what the branch culled since.
        Without it the metric is Goodhart-able -- a branch can cull its
        worst rows and score well on the survivors (measured on
        eval_seq4: the graph branch culled ~4k rows across three BA/cull
        rounds, undercut the geometry branch's cost and won the
        selection at 0.388-vs-0.339 ATE). Returns (mean_cost, num_obs).
        """
        st = self._st
        if obs_ref is None:
            okf, olm, ouv, ov = jax.device_get(
                (st.obs.kf, st.obs.lm, st.obs.uv, st.obs.valid))
        else:
            okf, olm, ouv, ov = obs_ref
        kv = np.asarray(st.store.valid)
        lv = np.asarray(st.lmap.valid) if obs_ref is None else \
            np.ones(st.lmap.capacity, bool)
        sel = ov & kv[okf] & lv[olm]
        n = int(sel.sum())
        if n == 0:
            return 0.0, 0
        R = np.asarray(st.store.R)[okf[sel]]
        t = np.asarray(st.store.t)[okf[sel]]
        X = np.asarray(st.lmap.xyz)[olm[sel]]
        xc = np.einsum("nij,nj->ni", R, X) + t
        z = np.maximum(xc[:, 2], 1e-6)
        r = xc[:, :2] / z[:, None] - ouv[sel]
        rn = np.linalg.norm(r, axis=1)
        h = self.cfg.ba.huber or 6e-3
        # a row beyond ten Huber scales, or behind its camera, is a gross
        # outlier whatever its size, and costs as one at 10 h. Uncapped, a
        # single frozen row whose culled landmark ended up at a camera's
        # depth plane (|r| ~ 1e6 through the depth clamp) lifted a branch's
        # mean cost from ~8e-6 to 1.7 and handed the selection to the
        # other branch (measured on the H100: eval_seq keyframe ATE 0.13)
        cap = 10 * h
        rn = np.where(xc[:, 2] > 1e-6, np.minimum(rn, cap), cap)
        rho = np.where(rn <= h, rn * rn, h * (2 * rn - h))
        return float(rho.mean()), n

    def close_loop(self, min_matches: int = 40, exclude_recent: int = 3,
                   exclude_covisible_weight: int = 0):
        """Production loop closure: detect + measure + fuse, then pick
        the better of two closure mechanisms BY MEASUREMENT.

        After `_detect_loop` fuses the PnP-inlier associations into the
        observation table, two candidate end states are computed from the
        same snapshot: (A) global BA + cull against the fused
        observations alone, and (B) pose-graph optimisation over the
        weighted loop edges first, then the same BA + cull. The state
        with the lower `map_consistency` cost wins (gt-free model
        selection). Measured rationale (this round, all four committed
        sequences): the graph delivers the large correction when drift
        dominates, but when the anchor segment itself is misplaced
        (eval_seq2's degenerate bootstrap) or drift is at the edge-noise
        floor, it REGRESSES keyframe ATE 0.35->0.50 while branch A holds
        it -- and the consistency costs separate the two cases by 7-150x
        (tools/ab_closure.py). Returns {"loop", "used_graph"}.
        """
        det = self._detect_loop(min_matches, exclude_recent,
                                exclude_covisible_weight)
        if det is None:
            return {"loop": -1, "used_graph": False}
        idx, edges = det
        m = self.metrics
        snap = self.state
        # frozen judgement set: the post-fusion observation table. Both
        # branches are scored against THESE rows whatever they cull, so
        # a branch cannot win by discarding its evidence (see
        # map_consistency's Goodhart note).
        obs_ref = jax.device_get((snap.obs.kf, snap.obs.lm, snap.obs.uv,
                                  snap.obs.valid))

        def refine():
            # three BA/cull rounds: each round converges against the
            # fused constraints, the cull drops the associations that
            # remained gross outliers, and the next round re-converges
            # the cleaned map (measured on eval_seq3 keyframe ATE:
            # one round 0.134, two 0.116, three 0.102)
            for _ in range(3):
                self.global_ba()
                self.cull_landmarks()

        # branch A: geometry-only closure (fused observations -> BA)
        refine()
        cost_ba, _ = self.map_consistency(obs_ref)
        state_ba = self.state
        # branch B: pose graph first, then the identical refinement (NO
        # extra steps -- an asymmetric branch breaks the cost
        # comparability: adding re-triangulation to B lowered its
        # consistency below A's while its ATE was worse, a measured
        # mispick on eval_seq4)
        self.set_state(snap)
        with m.timer("pose_graph"):
            self.optimise_pose_graph(loop_edges=edges)
        refine()
        cost_graph, _ = self.map_consistency(obs_ref)
        # the graph branch must be CLEARLY better to win: when the two
        # costs land within ~10% the comparison is inside its own noise
        # (measured: a 3.1u-vs-3.1u tie on eval_seq3 where the graph
        # branch was 0.146 vs 0.102 ATE), and the geometry-only branch is
        # the conservative default (never regressed a sequence by more
        # than float noise across the committed four)
        used_graph = cost_graph < 0.9 * cost_ba
        if not used_graph:
            self.set_state(state_ba)
        m.count("loops_closed")
        if used_graph:
            m.count("loops_closed_graph")
        return {"loop": idx, "used_graph": used_graph,
                "cost_ba": cost_ba, "cost_graph": cost_graph}

    def _relocalise_feats(self, feats, pts, min_matches: int = 30):
        """Localise extracted features against the keyframe map.

        Returns (R, t, kf_ordinal) or None. Shared by the public
        relocalise() and the in-loop lost-tracking recovery in process().
        """
        idx, R_rel, t_unit, _ = self.match_keyframe(
            feats, pts, min_matches=min_matches)
        if idx < 0:
            return None
        slot = idx % self.capacity
        R_kf = np.asarray(self._st.store.R[slot])
        t_kf = np.asarray(self._st.store.t[slot])
        R = R_rel @ R_kf
        t = R_rel @ t_kf + t_unit
        if self.cfg.map.track_map and self._num_lm > 0:
            Rm, tm, n_map, _ = self._track_map(
                self._st.lmap, feats, pts, jnp.asarray(R), jnp.asarray(t))
            if int(n_map) >= self.cfg.map.min_map_inliers:
                R, t = np.asarray(Rm), np.asarray(tm)
        return R, t, idx

    def relocalise(self, frame, min_matches: int = 30):
        """Localise a frame against the keyframe map (kidnapped-robot case).

        Returns (R, t) world->camera, or None if no keyframe matches. The
        translation inherits the map's scale via the matched keyframe's
        stored pose plus a unit-norm relative offset; when the landmark map
        is populated the pose is additionally refined by motion-only BA
        against it (exact map-scale translation).
        """
        feats, pts = self._features(frame)
        rec = self._relocalise_feats(feats, pts, min_matches=min_matches)
        return None if rec is None else (rec[0], rec[1])

    def merge_map(self, other: SlamState, min_anchors: int = 3,
                  min_matches: int = 30):
        """Fuse another session's map into this one (multi-agent /
        multi-session rendezvous, the ORB-SLAM3 atlas-merge idea).

        Every keyframe of ``other`` is relocalised against THIS map (one
        store-wide match each; map PnP pins metric scale); a SIM(3)
        (Umeyama) between the relocalised camera centres and the other
        session's own centres maps its frame into this one -- monocular
        maps have independent scales, hence SIM(3), not SE(3). The other
        session's keyframes (poses transformed), landmarks (positions
        transformed) and observation rows (slot-remapped) are then
        appended, subject to free capacity (newest first when short).

        Returns the number of keyframes merged, or -1 if fewer than
        ``min_anchors`` of the other session's keyframes relocalise.
        """
        m = self.metrics
        o_store, o_lmap, o_obs = other.store, other.lmap, other.obs
        o_valid = np.asarray(o_store.valid)
        o_ord = np.asarray(o_store.ordinal)
        slots_b = [int(s) for s in np.argsort(o_ord) if o_valid[s]]
        if not slots_b:
            return -1

        # 1. relocalise the other session's keyframes against THIS map
        anchors = []  # (slot_b, R_a, t_a)
        with m.timer("merge_relocalise"):
            for s in slots_b:
                feats_like = Features(
                    codes=o_store.codes[s], valid=o_store.kp_valid[s],
                    angles=jnp.zeros(o_store.codes.shape[1], jnp.uint8),
                    descriptors=o_store.descriptors[s])
                rec = self._relocalise_feats(
                    feats_like, o_store.pts[s], min_matches=min_matches)
                if rec is not None:
                    anchors.append((s, rec[0], rec[1]))
        if len(anchors) < min_anchors:
            return -1

        # 2. SIM(3) from the other session's frame to this one. The
        # rotation comes from the anchor ROTATION pairs (chordal mean of
        # R_a^T R_b), NOT from a centre-cloud Umeyama: camera centres of a
        # straight/planar trajectory are (near-)degenerate and leave the
        # rotation free about the path axis. Scale and translation then
        # come from the centres with the rotation fixed.
        Rb = np.asarray(o_store.R)
        tb = np.asarray(o_store.t)
        cb = np.stack([-Rb[s].T @ tb[s] for s, _R, _t in anchors])
        ca = np.stack([-Ra.T @ ta for _s, Ra, ta in anchors])
        # each anchor gives RU^T ~ R_b^T R_a (R_a = R_b RU^T), so
        # RU = proj_SO3(sum R_a^T R_b)
        M = np.sum([Ra.T @ Rb[s] for s, Ra, _t in anchors], axis=0)
        U, _sv, Vt = np.linalg.svd(M)
        fix = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
        RU = U @ fix @ Vt  # X_a = s RU X_b + p
        e = cb - cb.mean(0)
        g = ca - ca.mean(0)
        denom = float((e * e).sum())
        s_ = (float((g * (e @ RU.T)).sum()) / denom if denom > 1e-12
              else 1.0)
        p = ca.mean(0) - s_ * RU @ cb.mean(0)
        if not (np.isfinite(s_) and s_ > 1e-6 and np.isfinite(RU).all()
                and np.isfinite(p).all()):
            return -1

        # 3. transform ALL of the other session's keyframes + landmarks
        #    x_a = s RU x_b + p; camera axes rotate by RU (scale-free)
        st = self.state
        cap = self.capacity
        n_free = cap - self.num_keyframes
        if n_free <= 0:
            return -1
        keep = slots_b[-n_free:] if len(slots_b) > n_free else slots_b
        Rn = {s: (Rb[s] @ RU.T).astype(np.float32) for s in keep}
        cn = {s: (s_ * (RU @ (-Rb[s].T @ tb[s])) + p) for s in keep}

        store, lmap, obs = st.store, st.lmap, st.obs
        base_ord = self._num_kf
        slot_map = {}
        for i, s in enumerate(keep):
            ns = (base_ord + i) % cap
            slot_map[s] = ns
            tn = (-Rn[s] @ cn[s]).astype(np.float32)
            store = store._replace(
                R=store.R.at[ns].set(jnp.asarray(Rn[s])),
                t=store.t.at[ns].set(jnp.asarray(tn)),
                codes=store.codes.at[ns].set(o_store.codes[s]),
                kp_valid=store.kp_valid.at[ns].set(o_store.kp_valid[s]),
                descriptors=store.descriptors.at[ns].set(
                    o_store.descriptors[s]),
                pts=store.pts.at[ns].set(o_store.pts[s]),
                frame_id=store.frame_id.at[ns].set(o_store.frame_id[s]),
                ordinal=store.ordinal.at[ns].set(base_ord + i),
                valid=store.valid.at[ns].set(True))

        # landmarks: transformed positions, appended to free rows
        o_lm_valid = np.asarray(o_lmap.valid)
        lm_rows = np.nonzero(o_lm_valid)[0]
        lm_free = lmap.capacity - self._num_lm
        lm_rows = lm_rows[:lm_free]
        lm_map = {}
        if len(lm_rows):
            xyz_b = np.asarray(o_lmap.xyz)[lm_rows]
            xyz_a = (s_ * (xyz_b @ RU.T) + p).astype(np.float32)
            dst = np.arange(self._num_lm, self._num_lm + len(lm_rows))
            lm_map = {int(src): int(d) for src, d in zip(lm_rows, dst)}
            lmap = lmap._replace(
                xyz=lmap.xyz.at[jnp.asarray(dst)].set(jnp.asarray(xyz_a)),
                descriptors=lmap.descriptors.at[jnp.asarray(dst)].set(
                    o_lmap.descriptors[jnp.asarray(lm_rows)]),
                obs_count=lmap.obs_count.at[jnp.asarray(dst)].set(
                    o_lmap.obs_count[jnp.asarray(lm_rows)]),
                valid=lmap.valid.at[jnp.asarray(dst)].set(True))

        # observation rows: remap keyframe/landmark slots, append
        o_obs_valid = np.asarray(o_obs.valid)
        o_obs_kf = np.asarray(o_obs.kf)
        o_obs_lm = np.asarray(o_obs.lm)
        rows = [i for i in np.nonzero(o_obs_valid)[0]
                if int(o_obs_kf[i]) in slot_map
                and int(o_obs_lm[i]) in lm_map]
        rows = rows[: obs.capacity - self._num_obs]
        if rows:
            dst = jnp.asarray(np.arange(self._num_obs,
                                        self._num_obs + len(rows)))
            obs = obs._replace(
                kf=obs.kf.at[dst].set(jnp.asarray(
                    [slot_map[int(o_obs_kf[i])] for i in rows], np.int32)),
                lm=obs.lm.at[dst].set(jnp.asarray(
                    [lm_map[int(o_obs_lm[i])] for i in rows], np.int32)),
                uv=obs.uv.at[dst].set(o_obs.uv[jnp.asarray(
                    np.asarray(rows))]),
                valid=obs.valid.at[dst].set(True))

        self._st = st._replace(store=store, lmap=lmap, obs=obs)
        self._num_kf = base_ord + len(keep)
        self._num_lm = self._num_lm + len(lm_rows)
        self._num_obs = self._num_obs + len(rows)
        self._cache_last((self._num_kf - 1) % cap)
        m.count("maps_merged")
        m.gauge("num_keyframes", self.num_keyframes)
        m.gauge("num_landmarks", self._num_lm)
        return len(keep)

    def optimise_pose_graph(self, loop_edges=()):
        """Global pose-graph GN over stored keyframes: sequential odometry
        edges (from current poses) plus `loop_edges` =
        [(ordinal_i, ordinal_j, R_ij, t_ij[, weight]), ...] relative
        constraints.

        Edges carry scalar information weights (the ORB-SLAM essential
        graph weights edges by match support): odometry edges by the
        shared-landmark count of their keyframe pair (covisibility), loop
        edges by their measurement's inlier count. An equal-weight graph
        lets N-1 odometry edges outvote one correct loop edge.

        After the graph moves the keyframes, every landmark is transported
        with its ANCHOR keyframe (its earliest in-graph observer): the
        landmark keeps its camera-frame coordinates through the correction,
            X' = R1^T (R0 X + t0 - t1).
        Without this step the reprojection residuals still encode the
        pre-closure geometry and a subsequent global BA pulls the keyframes
        straight back (measured on eval_seq2: post-BA keyframe ATE was
        bit-identical to pre-closure) -- this is ORB-SLAM's loop-correction
        map-point transport, re-expressed batched.
        """
        views = self.keyframes
        n = len(views)
        if n < 2:
            return
        slots = np.int32([v.slot for v in views])
        node_of_ordinal = {v.index: i for i, v in enumerate(views)}
        R = jnp.asarray(np.stack([v.R for v in views]))
        t = jnp.asarray(np.stack([v.t for v in views]))
        # consecutive odometry edges in one batched call
        Rinv, tinv = se3.inverse(R[:-1], t[:-1])
        Rij, tij = se3.compose(Rinv, tinv, R[1:], t[1:])
        ei = list(range(n - 1))
        ej = list(range(1, n))
        eR = [np.asarray(Rij)]
        et = [np.asarray(tij)]
        # odometry edge weights: shared-landmark counts (covisibility),
        # clamped to >= 1 so a zero-covisibility pair keeps its odometry
        # constraint instead of dropping out of the graph
        covis = self.covisibility()
        ew = [max(1.0, float(covis[slots[k], slots[k + 1]]))
              for k in range(n - 1)]
        extra_R, extra_t = [], []
        for edge in loop_edges:
            i, j, Rl, tl = edge[:4]
            wl = float(edge[4]) if len(edge) > 4 else 1.0
            if i not in node_of_ordinal or j not in node_of_ordinal:
                continue
            ei.append(node_of_ordinal[i]); ej.append(node_of_ordinal[j])
            extra_R.append(np.asarray(Rl, np.float32))
            extra_t.append(np.asarray(tl, np.float32))
            ew.append(max(1.0, wl))
        if extra_R:
            eR.append(np.stack(extra_R)); et.append(np.stack(extra_t))
        g = pose_graph.PoseGraph(
            R=R, t=t,
            edge_i=jnp.asarray(np.int32(ei)), edge_j=jnp.asarray(np.int32(ej)),
            edge_R=jnp.asarray(np.concatenate(eR)),
            edge_t=jnp.asarray(np.concatenate(et)),
            edge_valid=jnp.ones(len(ei), bool),
            node_valid=jnp.ones(n, bool),
            edge_weight=jnp.asarray(np.float32(ew)))
        sim3 = bool(self.cfg.map.pose_graph_sim3)
        g2, _ = pose_graph.optimize(g, iters=8, damping=1e-5, sim3=sim3)
        if not (np.isfinite(np.asarray(g2.R)).all()
                and np.isfinite(np.asarray(g2.t)).all()):
            # degenerate normal equations (see _run_ba's guard): keep the
            # current poses rather than commit a NaN graph
            self.metrics.count("pose_graph_nonfinite_rejected")
            return
        if sim3:
            # recover SE(3) keyframe poses from the Sim(3) solution the
            # ORB-SLAM way: corrected S_iw = (s_i R_i, t_i) gives
            # T_iw = [R_i | t_i / s_i], and each landmark goes through
            # corrected S_wi o old T_iw (scale-consistent transport below).
            s_node = jnp.exp(g2.node_logs)
            t_se3 = g2.t / s_node[:, None]
        else:
            s_node = jnp.ones(n, jnp.float32)
            t_se3 = g2.t
        st = self._st
        sl = jnp.asarray(slots)
        store = st.store._replace(R=st.store.R.at[sl].set(g2.R),
                                  t=st.store.t.at[sl].set(t_se3))

        # transport landmarks with their anchor keyframe's correction
        obs_kf = np.asarray(st.obs.kf)
        obs_lm = np.asarray(st.obs.lm)
        obs_valid = np.asarray(st.obs.valid)
        node_of_slot = np.full(self.capacity, -1, np.int64)
        node_of_slot[slots] = np.arange(n)
        rows = obs_valid & (node_of_slot[obs_kf] >= 0)
        L = int(st.lmap.xyz.shape[0])
        anchor = np.full(L, n, np.int64)  # n = "no in-graph observer"
        np.minimum.at(anchor, obs_lm[rows], node_of_slot[obs_kf[rows]])
        lm_rows = np.where(np.asarray(st.lmap.valid) & (anchor < n))[0]
        lmap = st.lmap
        if lm_rows.size:
            a = anchor[lm_rows]
            R0, t0 = np.asarray(R)[a], np.asarray(t)[a]
            R1, t1 = np.asarray(g2.R)[a], np.asarray(g2.t)[a]
            X = np.asarray(st.lmap.xyz)[lm_rows]
            xc = np.einsum("nij,nj->ni", R0, X) + t0
            # SE(3): X' = R1^T (xc - t1). Sim(3): the corrected inverse is
            # X' = R1^T (xc - t1) / s1 (t1 = RAW optimised translation) --
            # local geometry rescales with its anchor camera.
            Xn = (np.einsum("nji,nj->ni", R1, xc - t1)
                  / np.asarray(s_node)[a, None]).astype(np.float32)
            lmap = st.lmap._replace(
                xyz=st.lmap.xyz.at[jnp.asarray(lm_rows)].set(
                    jnp.asarray(Xn)))

        self._st = st._replace(store=store, lmap=lmap)
        self._cache_last((self._num_kf - 1) % self.capacity)

    # -- introspection ------------------------------------------------------

    @property
    def keyframes(self):
        """Host views of stored keyframes, ordered by insertion ordinal."""
        st = self._st.store
        ordinal = np.asarray(st.ordinal)
        valid = np.asarray(st.valid)
        frame_id = np.asarray(st.frame_id)
        R = np.asarray(st.R)
        t = np.asarray(st.t)
        order = [int(s) for s in np.argsort(ordinal) if valid[s]]
        return [KeyframeView(index=int(ordinal[s]), frame=int(frame_id[s]),
                             slot=s, R=R[s], t=t[s]) for s in order]

    @property
    def num_keyframes(self) -> int:
        return min(self._num_kf, self.capacity) - len(self._culled_slots)

    @property
    def keyframes_inserted(self) -> int:
        """Total keyframes ever inserted (monotonic; unlike num_keyframes
        it keeps growing after the ring fills or culling removes slots --
        the correct clock for periodic maintenance cadences)."""
        return self._num_kf

    @property
    def num_landmarks(self) -> int:
        return self._num_lm

    def landmark_positions(self) -> np.ndarray:
        """(N, 3) world positions of live landmarks."""
        xyz = np.asarray(self._st.lmap.xyz)
        valid = np.asarray(self._st.lmap.valid)
        return xyz[valid]

    def keyframe_positions(self) -> np.ndarray:
        return np.stack([-v.R.T @ v.t for v in self.keyframes])

    @property
    def keyframe_frames(self):
        """Source frame number of each keyframe."""
        return [v.frame for v in self.keyframes]
