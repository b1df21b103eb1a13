"""Fixed-capacity keyframe store + local map as a checkpointable pytree.

The reference's closest analog is the caller-owned append-only keypoint/
descriptor vectors (Fast.h:198, Orb.h:397-398) and a painted PNG as the only
persistence (demo.cpp:111; SURVEY.md section 5 "checkpoint/resume: none").
Here the map is a real pytree of fixed-shape arrays (XLA-friendly,
checkpointable, shardable across devices and hosts):

* keyframes: poses + per-keyframe feature block (codes/pts/desc/valid)
* landmarks: world positions + the descriptor of their anchor observation
* observations: a flat (keyframe slot, landmark slot, uv) table feeding
  windowed bundle adjustment

Insertion/eviction are functional slot updates (donated in the jitted
driver); models/slam.py builds its entire SLAM state out of these, so a
running SLAM session is one `utils.checkpoint.save` away from resumable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class KeyframeStore(NamedTuple):
    R: jax.Array            # (F, 3, 3) world->cam
    t: jax.Array            # (F, 3)
    codes: jax.Array        # (F, K) uint32 packed keypoints
    kp_valid: jax.Array     # (F, K) bool
    descriptors: jax.Array  # (F, K, words) uint32
    pts: jax.Array          # (F, K, 2) float32 normalised keypoint coords
    frame_id: jax.Array     # (F,) int32 source frame index (-1 = empty)
    ordinal: jax.Array      # (F,) int32 insertion ordinal (-1 = empty)
    valid: jax.Array        # (F,) bool

    @property
    def capacity(self):
        return self.R.shape[0]


class LandmarkMap(NamedTuple):
    xyz: jax.Array          # (L, 3) world positions
    descriptors: jax.Array  # (L, words) uint32 anchor descriptors
    obs_count: jax.Array    # (L,) int32
    valid: jax.Array        # (L,) bool

    @property
    def capacity(self):
        return self.xyz.shape[0]


class ObservationTable(NamedTuple):
    """Flat keypoint-observation table: which keyframe saw which landmark
    where (normalised coords). Fixed capacity O with a validity mask; the
    BA window assembly selects rows by keyframe ordinal."""
    kf: jax.Array           # (O,) int32 keyframe SLOT
    lm: jax.Array           # (O,) int32 landmark SLOT
    uv: jax.Array           # (O, 2) float32
    valid: jax.Array        # (O,) bool

    @property
    def capacity(self):
        return self.kf.shape[0]


def empty_store(capacity: int, max_kp: int, words: int = 8) -> KeyframeStore:
    return KeyframeStore(
        R=jnp.broadcast_to(jnp.eye(3), (capacity, 3, 3)).astype(jnp.float32),
        t=jnp.zeros((capacity, 3), jnp.float32),
        codes=jnp.zeros((capacity, max_kp), jnp.uint32),
        kp_valid=jnp.zeros((capacity, max_kp), bool),
        descriptors=jnp.zeros((capacity, max_kp, words), jnp.uint32),
        pts=jnp.zeros((capacity, max_kp, 2), jnp.float32),
        frame_id=jnp.full((capacity,), -1, jnp.int32),
        ordinal=jnp.full((capacity,), -1, jnp.int32),
        valid=jnp.zeros((capacity,), bool),
    )


def empty_map(capacity: int, words: int = 8) -> LandmarkMap:
    return LandmarkMap(
        xyz=jnp.zeros((capacity, 3), jnp.float32),
        descriptors=jnp.zeros((capacity, words), jnp.uint32),
        obs_count=jnp.zeros((capacity,), jnp.int32),
        valid=jnp.zeros((capacity,), bool),
    )


def empty_obs(capacity: int) -> ObservationTable:
    return ObservationTable(
        kf=jnp.zeros((capacity,), jnp.int32),
        lm=jnp.zeros((capacity,), jnp.int32),
        uv=jnp.zeros((capacity, 2), jnp.float32),
        valid=jnp.zeros((capacity,), bool),
    )


def insert_keyframe(store: KeyframeStore, slot, R, t, feats, frame_id,
                    pts=None, ordinal=None):
    """Functional slot write (slot may be traced). feats: frontend.Features.

    `pts` (K, 2) are the normalised keypoint coordinates (zeros if omitted);
    `ordinal` is the insertion ordinal (defaults to frame_id so pure-store
    users keep a valid ordering)."""
    if pts is None:
        pts = jnp.zeros_like(store.pts[0])
    if ordinal is None:
        ordinal = frame_id
    return KeyframeStore(
        R=store.R.at[slot].set(R),
        t=store.t.at[slot].set(t),
        codes=store.codes.at[slot].set(feats.codes),
        kp_valid=store.kp_valid.at[slot].set(feats.valid),
        descriptors=store.descriptors.at[slot].set(feats.descriptors),
        pts=store.pts.at[slot].set(pts),
        frame_id=store.frame_id.at[slot].set(frame_id),
        ordinal=store.ordinal.at[slot].set(ordinal),
        valid=store.valid.at[slot].set(True),
    )


def next_slot(store: KeyframeStore):
    """First free slot, else the oldest frame (ring eviction)."""
    free = jnp.argmin(store.valid)          # first False if any
    any_free = ~jnp.all(store.valid)
    oldest = jnp.argmin(jnp.where(store.valid, store.frame_id, 2**31 - 1))
    return jnp.where(any_free, free, oldest)


def add_landmarks(lmap: LandmarkMap, obs: ObservationTable,
                  lm_cursor, obs_cursor,
                  xyz, desc, mask, slot_a, slot_b, uv_a, uv_b):
    """Append up to K landmarks (two observations each) functionally.

    xyz (K, 3) world points, desc (K, words) anchor descriptors, mask (K,)
    selects real entries; slot_a/slot_b are the two observing keyframe
    slots with normalised coords uv_a/uv_b (K, 2). Entries past capacity
    are DROPPED (scatter mode='drop'); the returned cursors saturate at
    capacity so subsequent inserts keep dropping cleanly. Dropping newest
    (not ring-evicting) keeps every live observation row consistent -- an
    overwritten landmark slot would orphan its BA observations.
    """
    L = lmap.capacity
    O = obs.capacity
    k = xyz.shape[0]
    pos = lm_cursor + jnp.cumsum(mask.astype(jnp.int32)) - 1
    lm_slot = jnp.where(mask & (pos < L), pos, L)  # L = out of range -> drop
    new_map = LandmarkMap(
        xyz=lmap.xyz.at[lm_slot].set(xyz, mode="drop"),
        descriptors=lmap.descriptors.at[lm_slot].set(desc, mode="drop"),
        obs_count=lmap.obs_count.at[lm_slot].set(2, mode="drop"),
        valid=lmap.valid.at[lm_slot].set(True, mode="drop"),
    )
    placed = mask & (pos < L)
    # two observation rows per placed landmark, interleaved [a0, b0, a1, ...]
    opos = obs_cursor + 2 * (pos - lm_cursor)
    oa = jnp.where(placed & (opos < O), opos, O)
    ob = jnp.where(placed & (opos + 1 < O), opos + 1, O)
    slot_a = jnp.broadcast_to(jnp.int32(slot_a), (k,))
    slot_b = jnp.broadcast_to(jnp.int32(slot_b), (k,))
    new_obs = ObservationTable(
        kf=obs.kf.at[oa].set(slot_a, mode="drop").at[ob].set(
            slot_b, mode="drop"),
        lm=obs.lm.at[oa].set(lm_slot, mode="drop").at[ob].set(
            lm_slot, mode="drop"),
        uv=obs.uv.at[oa].set(uv_a, mode="drop").at[ob].set(uv_b, mode="drop"),
        valid=obs.valid.at[oa].set(True, mode="drop").at[ob].set(
            True, mode="drop"),
    )
    n_placed = jnp.sum(placed.astype(jnp.int32))
    new_lm_cursor = jnp.minimum(lm_cursor + n_placed, L)
    new_obs_cursor = jnp.minimum(obs_cursor + 2 * n_placed, O)
    return new_map, new_obs, new_lm_cursor, new_obs_cursor


def cull_landmarks(store: KeyframeStore, lmap: LandmarkMap,
                   obs: ObservationTable, max_residual: float,
                   min_obs: int = 2, bad_fraction: float = 0.5):
    """Invalidate unreliable landmarks + their observation rows (pure).

    Map maintenance in the ORB-SLAM mould: a landmark is culled when the
    majority of its observations reproject badly against the CURRENT
    keyframe poses (outliers from wrong associations or bad triangulation
    poison PnP tracking and BA), or when it is supported by fewer than
    ``min_obs`` observations. Residuals are normalised-coordinate
    distances; behind-camera projections count as bad. All fixed-shape
    segment reductions -- jit/scan safe. Returns (lmap, obs).
    """
    # residual of every observation row under current poses
    Rk = store.R[obs.kf]                       # (O, 3, 3)
    tk = store.t[obs.kf]                       # (O, 3)
    X = lmap.xyz[obs.lm]                       # (O, 3)
    xc = jnp.einsum("oij,oj->oi", Rk, X) + tk
    z = xc[:, 2]
    proj = xc[:, :2] / jnp.where(z == 0, 1.0, z)[:, None]
    err = jnp.linalg.norm(proj - obs.uv, axis=1)
    row_bad = obs.valid & ((err > max_residual) | (z <= 1e-6))

    L = lmap.capacity
    seg = jnp.where(obs.valid, obs.lm, L)      # invalid rows -> dropped
    n_bad = jnp.zeros(L, jnp.int32).at[seg].add(
        row_bad.astype(jnp.int32), mode="drop")
    n_tot = jnp.zeros(L, jnp.int32).at[seg].add(
        obs.valid.astype(jnp.int32), mode="drop")
    cull = lmap.valid & (
        (n_bad.astype(jnp.float32)
         > bad_fraction * n_tot.astype(jnp.float32))
        | (n_tot < min_obs))
    new_map = lmap._replace(valid=lmap.valid & ~cull,
                            obs_count=jnp.where(cull, 0, n_tot))
    new_obs = obs._replace(valid=obs.valid & ~cull[obs.lm])
    return new_map, new_obs


def covisibility(store: KeyframeStore, lmap: LandmarkMap,
                 obs: ObservationTable):
    """(F, F) covisibility weights: shared-landmark counts between keyframes.

    The ORB-SLAM covisibility graph as dense array code: scatter the
    observation table into a dense (F, L) incidence matrix, then one
    matmul gives every pairwise count at once (no per-edge host logic).
    f32 is exact for counts < 2^24. Diagonal is zeroed; rows/columns of
    invalid keyframes are all zero.
    """
    F, L = store.capacity, lmap.capacity
    ok = obs.valid & store.valid[obs.kf] & lmap.valid[obs.lm]
    inc = jnp.zeros((F, L), jnp.float32).at[obs.kf, obs.lm].max(
        ok.astype(jnp.float32))
    w = jnp.round(inc @ inc.T).astype(jnp.int32)
    return w * (1 - jnp.eye(F, dtype=jnp.int32))


def keyframe_redundancy(store: KeyframeStore, lmap: LandmarkMap,
                        obs: ObservationTable, min_other_obs: int = 3):
    """Per-slot redundancy: fraction of a keyframe's observed landmarks that
    are also observed by >= ``min_other_obs`` OTHER keyframes (so total
    observation count >= min_other_obs + 1). Returns (frac (F,), n_seen (F,)).
    All fixed-shape segment sums -- jit-safe."""
    F, L = store.capacity, lmap.capacity
    ok = obs.valid & store.valid[obs.kf] & lmap.valid[obs.lm]
    lmseg = jnp.where(ok, obs.lm, L)
    n_tot = jnp.zeros(L, jnp.int32).at[lmseg].add(1, mode="drop")
    well = ok & (n_tot[jnp.clip(obs.lm, 0, L - 1)] >= min_other_obs + 1)
    kfseg = jnp.where(ok, obs.kf, F)
    n_seen = jnp.zeros(F, jnp.int32).at[kfseg].add(1, mode="drop")
    n_red = jnp.zeros(F, jnp.int32).at[kfseg].add(
        well.astype(jnp.int32), mode="drop")
    frac = n_red.astype(jnp.float32) / jnp.maximum(n_seen, 1)
    return frac, n_seen


def cull_one_keyframe(store: KeyframeStore, lmap: LandmarkMap,
                      obs: ObservationTable, eligible,
                      min_other_obs: int = 3,
                      redundant_fraction: float = 0.9):
    """Cull the single most redundant eligible keyframe (pure, jit-safe).

    ORB-SLAM's keyframe-culling rule: a keyframe whose landmarks are
    almost all (>= ``redundant_fraction``) seen by >= ``min_other_obs``
    other keyframes adds nothing to the map but costs BA/pose-graph work.
    One keyframe per call (culling changes the redundancy counts of the
    survivors, so batch-culling could over-cull); the host loop iterates.

    ``eligible`` (F,) bool masks slots the caller protects (the newest
    tracking references, the gauge-anchor oldest keyframe). The culled
    slot keeps its ordinal but turns invalid; its observation rows are
    invalidated and the landmarks' obs_count decremented. Returns
    (store, lmap, obs, slot) with slot == -1 when nothing was culled.
    """
    frac, n_seen = keyframe_redundancy(store, lmap, obs, min_other_obs)
    cand = store.valid & eligible & (n_seen > 0) & \
        (frac >= redundant_fraction)
    slot = jnp.argmax(jnp.where(cand, frac, -1.0))
    found = jnp.any(cand)
    slot_or = jnp.where(found, slot, store.capacity)  # capacity = no-op
    rows = obs.valid & (obs.kf == slot_or)
    dec = jnp.where(rows, obs.lm, lmap.capacity)
    lmap2 = lmap._replace(
        obs_count=lmap.obs_count.at[dec].add(-1, mode="drop"))
    obs2 = obs._replace(valid=obs.valid & ~rows)
    store2 = store._replace(
        valid=store.valid.at[slot_or].set(False, mode="drop"))
    return store2, lmap2, obs2, jnp.where(found, slot.astype(jnp.int32), -1)


def evict_stale_landmarks(store: KeyframeStore, lmap: LandmarkMap,
                          obs: ObservationTable, need: jax.Array):
    """Invalidate the ``need`` landmarks with the OLDEST last observation
    (pure, fixed-shape). ORB-SLAM keeps its map fresh by culling points
    that stopped being observed; here staleness = the highest insertion
    ordinal among a landmark's observing keyframes (one scatter-max over
    the observation table), so landmarks still seen by recent keyframes
    are naturally protected. Used by long-session maintenance when the
    landmark table saturates: without eviction a full table disables
    triangulation (and the keyframe-on-map-dropout rule) for the rest of
    the session. Returns (lmap, obs, n_dropped).

    need <= 0 is a no-op. The caller should follow with compact_map to
    reclaim the freed rows for the cursors.
    """
    L = lmap.capacity
    rows = obs.valid
    last = jnp.full(L, -1, jnp.int32).at[
        jnp.where(rows, obs.lm, L)].max(
        jnp.where(rows, store.ordinal[obs.kf], -1), mode="drop")
    # oldest-first rank among VALID landmarks (invalid sort last)
    key = jnp.where(lmap.valid, last, jnp.int32(2 ** 31 - 1))
    order = jnp.argsort(key, stable=True)
    rank = jnp.zeros(L, jnp.int32).at[order].set(
        jnp.arange(L, dtype=jnp.int32))
    drop = lmap.valid & (rank < jnp.maximum(need, 0))
    lmap2 = lmap._replace(valid=lmap.valid & ~drop)
    obs2 = obs._replace(valid=obs.valid & ~drop[obs.lm])
    return lmap2, obs2, jnp.sum(drop.astype(jnp.int32))


def compact_map(lmap: LandmarkMap, obs: ObservationTable):
    """Re-pack live landmarks and observation rows to the front (pure).

    The landmark/observation stores drop newest-first when their cursors
    saturate (add_landmarks); culling invalidates rows but cannot move the
    cursor back. Compaction makes long sessions sustainable: a stable
    argsort moves valid rows to the front preserving order, observation
    landmark indices are remapped through the permutation, and the
    returned (n_lm, n_obs) are the new cursors. One fixed-shape gather
    per array -- jit-safe, O(L log L + O log O) on device.
    """
    L, O = lmap.capacity, obs.capacity
    order = jnp.argsort(~lmap.valid, stable=True)
    new_pos = jnp.zeros(L, jnp.int32).at[order].set(
        jnp.arange(L, dtype=jnp.int32))
    lmap2 = LandmarkMap(
        xyz=lmap.xyz[order],
        descriptors=lmap.descriptors[order],
        obs_count=lmap.obs_count[order],
        valid=lmap.valid[order],
    )
    oorder = jnp.argsort(~obs.valid, stable=True)
    obs2 = ObservationTable(
        kf=obs.kf[oorder],
        lm=new_pos[obs.lm][oorder],
        uv=obs.uv[oorder],
        valid=obs.valid[oorder],
    )
    n_lm = jnp.sum(lmap.valid.astype(jnp.int32))
    n_obs = jnp.sum(obs.valid.astype(jnp.int32))
    return lmap2, obs2, n_lm, n_obs


def add_observations(lmap: LandmarkMap, obs: ObservationTable, obs_cursor,
                     kf_slot, lm_slot, uv, mask):
    """Append observation rows of EXISTING landmarks (data association).

    lm_slot (K,) landmark slots, uv (K, 2) normalised coords seen from
    keyframe `kf_slot`, mask (K,) selects real rows. Increments the
    landmarks' obs_count. Rows past capacity are dropped (cursor saturates).
    """
    O = obs.capacity
    k = lm_slot.shape[0]
    pos = obs_cursor + jnp.cumsum(mask.astype(jnp.int32)) - 1
    row = jnp.where(mask & (pos < O), pos, O)
    kf_slot = jnp.broadcast_to(jnp.int32(kf_slot), (k,))
    new_obs = ObservationTable(
        kf=obs.kf.at[row].set(kf_slot, mode="drop"),
        lm=obs.lm.at[row].set(lm_slot, mode="drop"),
        uv=obs.uv.at[row].set(uv, mode="drop"),
        valid=obs.valid.at[row].set(True, mode="drop"),
    )
    placed = mask & (pos < O)
    counted = jnp.where(placed, lm_slot, lmap.capacity)
    new_map = lmap._replace(
        obs_count=lmap.obs_count.at[counted].add(1, mode="drop"))
    n_placed = jnp.sum(placed.astype(jnp.int32))
    return new_map, new_obs, jnp.minimum(obs_cursor + n_placed, O)
