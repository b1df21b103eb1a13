"""Backend: BA convergence on synthetic windows, pose-graph optimisation,
keyframe store semantics, triangulation."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pislam_tpu.backend import ba, keyframes, pose_graph, triangulate
from pislam_tpu.geometry import se3


def synthetic_ba(nc=4, npts=60, nobs_per=None, seed=0, pose_noise=0.05,
                 point_noise=0.1, obs_noise=0.0, pad_obs=64):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (npts, 3)).astype(np.float32)
    Rs, ts = [], []
    for c in range(nc):
        w = rng.normal(0, 0.05, 3).astype(np.float32)
        R = np.asarray(se3.so3_exp(jnp.asarray(w)))
        t = np.float32([0.3 * c, 0.02 * c, 0.0])
        Rs.append(R); ts.append(t)
    Rs, ts = np.stack(Rs), np.stack(ts)

    cams, pts, uvs = [], [], []
    for c in range(nc):
        xc = X @ Rs[c].T + ts[c]
        uv = xc[:, :2] / xc[:, 2:]
        for p in range(npts):
            cams.append(c); pts.append(p)
            uvs.append(uv[p] + rng.normal(0, obs_noise, 2))
    cams = np.int32(cams); pts = np.int32(pts)
    uvs = np.float32(uvs)
    nobs = len(cams)
    total = ((nobs + pad_obs - 1) // pad_obs) * pad_obs
    pad = total - nobs
    obs_valid = np.concatenate([np.ones(nobs, bool), np.zeros(pad, bool)])
    cams = np.concatenate([cams, np.zeros(pad, np.int32)])
    pts = np.concatenate([pts, np.zeros(pad, np.int32)])
    uvs = np.concatenate([uvs, np.zeros((pad, 2), np.float32)])

    # perturb initial estimate (keep cam0 = gauge)
    R0, t0 = Rs.copy(), ts.copy()
    for c in range(1, nc):
        dw = rng.normal(0, pose_noise, 3).astype(np.float32)
        R0[c] = np.asarray(se3.so3_exp(jnp.asarray(dw))) @ Rs[c]
        t0[c] = ts[c] + rng.normal(0, pose_noise, 3)
    X0 = X + rng.normal(0, point_noise, X.shape).astype(np.float32)

    prob = ba.BAProblem(
        R=jnp.asarray(R0), t=jnp.asarray(t0), points=jnp.asarray(X0),
        obs_cam=jnp.asarray(cams), obs_pt=jnp.asarray(pts),
        obs_uv=jnp.asarray(uvs), obs_valid=jnp.asarray(obs_valid),
        cam_valid=jnp.ones(nc, bool), pt_valid=jnp.ones(npts, bool),
    )
    return prob, (Rs, ts, X)


def test_ba_converges_noise_free():
    prob, (Rs, ts, X) = synthetic_ba()
    c0, _ = ba.ba_cost(prob)
    out, info = ba.bundle_adjust(prob, iters=12, damping=1e-3)
    c1, _ = ba.ba_cost(out)
    assert float(c1) < float(c0) * 1e-4, (float(c0), float(c1))
    # camera 0 untouched (gauge)
    np.testing.assert_allclose(np.asarray(out.R[0]), Rs[0], atol=1e-6)


def test_ba_masked_obs_ignored():
    prob, _ = synthetic_ba(seed=1)
    # corrupt the PADDED (invalid) observations wildly: must not change result
    bad_uv = prob.obs_uv.at[~prob.obs_valid].set(1e3)
    prob2 = prob._replace(obs_uv=bad_uv)
    o1, _ = ba.bundle_adjust(prob, iters=4)
    o2, _ = ba.bundle_adjust(prob2, iters=4)
    np.testing.assert_allclose(np.asarray(o1.points), np.asarray(o2.points),
                               atol=1e-6)


def test_pose_graph_closes_loop():
    rng = np.random.default_rng(2)
    n = 8
    # ground truth: poses along a circle
    Rs, ts = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    for i in range(1, n):
        w = np.float32([0, 2 * np.pi / n, 0])
        dR = np.asarray(se3.so3_exp(jnp.asarray(w)))
        Rs.append(dR @ Rs[-1])
        ts.append(ts[-1] + rng.normal(0, 0.0, 3).astype(np.float32)
                  + np.float32([1, 0, 0]))
    Rs, ts = np.stack(Rs), np.stack(ts)

    ei, ej, eR, et = [], [], [], []
    def add_edge(i, j):
        Ri_inv, ti_inv = se3.inverse(jnp.asarray(Rs[i]), jnp.asarray(ts[i]))
        Rij, tij = se3.compose(Ri_inv, ti_inv, jnp.asarray(Rs[j]), jnp.asarray(ts[j]))
        ei.append(i); ej.append(j)
        eR.append(np.asarray(Rij)); et.append(np.asarray(tij))
    for i in range(n - 1):
        add_edge(i, i + 1)
    add_edge(n - 1, 0)  # loop closure

    # noisy initialisation
    R0, t0 = Rs.copy(), ts.copy()
    for i in range(1, n):
        dw = rng.normal(0, 0.08, 3).astype(np.float32)
        R0[i] = np.asarray(se3.so3_exp(jnp.asarray(dw))) @ Rs[i]
        t0[i] = ts[i] + rng.normal(0, 0.2, 3)

    g = pose_graph.PoseGraph(
        R=jnp.asarray(R0), t=jnp.asarray(t0),
        edge_i=jnp.asarray(np.int32(ei)), edge_j=jnp.asarray(np.int32(ej)),
        edge_R=jnp.asarray(np.stack(eR)), edge_t=jnp.asarray(np.stack(et)),
        edge_valid=jnp.ones(len(ei), bool), node_valid=jnp.ones(n, bool),
    )
    c0 = float(jnp.sum(pose_graph.edge_residuals(g) ** 2))
    g2, costs = pose_graph.optimize(g, iters=15, damping=1e-5)
    c1 = float(costs[-1])
    assert c1 < c0 * 1e-3, (c0, c1)
    # recovered trajectory close to ground truth
    np.testing.assert_allclose(np.asarray(g2.t), ts, atol=0.05)


def test_triangulate_two_view_exact():
    rng = np.random.default_rng(3)
    X = rng.uniform([-1, -1, 3], [1, 1, 8], (50, 3)).astype(np.float32)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    w = np.float32([0.02, -0.4, 0.01])
    R2 = np.asarray(se3.so3_exp(jnp.asarray(w)))
    t2 = np.float32([0.5, 0.05, 0.02])
    x1 = X
    x2 = X @ R2.T + t2
    p1 = x1[:, :2] / x1[:, 2:]
    p2 = x2[:, :2] / x2[:, 2:]
    Xr = np.asarray(triangulate.triangulate_two_view(
        jnp.asarray(R1), jnp.asarray(t1), jnp.asarray(R2), jnp.asarray(t2),
        jnp.asarray(p1), jnp.asarray(p2)))
    np.testing.assert_allclose(Xr, X, atol=1e-3)


def test_keyframe_store_ring():
    store = keyframes.empty_store(capacity=3, max_kp=8, words=2)

    class F:  # minimal Features stand-in
        def __init__(self, seed):
            rng = np.random.default_rng(seed)
            self.codes = jnp.asarray(rng.integers(1, 2**31, 8, dtype=np.int64).astype(np.uint32))
            self.valid = jnp.ones(8, bool)
            self.descriptors = jnp.asarray(
                rng.integers(0, 2**31, (8, 2), dtype=np.int64).astype(np.uint32))

    eye = jnp.eye(3); z = jnp.zeros(3)
    for fid in range(5):
        slot = keyframes.next_slot(store)
        store = keyframes.insert_keyframe(store, slot, eye, z, F(fid), fid)
    ids = sorted(np.asarray(store.frame_id).tolist())
    assert ids == [2, 3, 4]  # oldest evicted first
    assert bool(np.asarray(store.valid).all())


def _random_graph(n=6, m_loop=2, seed=7, noise=0.1):
    """Chain + random loop edges with NON-commuting rotations."""
    rng = np.random.default_rng(seed)
    Rs = [np.eye(3, dtype=np.float32)]
    ts = [np.zeros(3, np.float32)]
    for i in range(1, n):
        w = rng.normal(0, 0.5, 3).astype(np.float32)  # arbitrary axes
        dR = np.asarray(se3.so3_exp(jnp.asarray(w)))
        Rs.append((dR @ Rs[-1]).astype(np.float32))
        ts.append((ts[-1] + rng.normal(0, 1.0, 3)).astype(np.float32))
    Rs, ts = np.stack(Rs), np.stack(ts)

    ei, ej, eR, et = [], [], [], []

    def add_edge(i, j):
        Ri_inv, ti_inv = se3.inverse(jnp.asarray(Rs[i]), jnp.asarray(ts[i]))
        Rij, tij = se3.compose(Ri_inv, ti_inv,
                               jnp.asarray(Rs[j]), jnp.asarray(ts[j]))
        ei.append(i); ej.append(j)
        eR.append(np.asarray(Rij)); et.append(np.asarray(tij))

    for i in range(n - 1):
        add_edge(i, i + 1)
    for _ in range(m_loop):
        i, j = sorted(rng.choice(n, 2, replace=False))
        add_edge(int(i), int(j))

    R0, t0 = Rs.copy(), ts.copy()
    for i in range(1, n):
        dw = rng.normal(0, noise, 3).astype(np.float32)
        R0[i] = np.asarray(se3.so3_exp(jnp.asarray(dw))) @ Rs[i]
        t0[i] = ts[i] + rng.normal(0, noise, 3)

    return pose_graph.PoseGraph(
        R=jnp.asarray(R0), t=jnp.asarray(t0),
        edge_i=jnp.asarray(np.int32(ei)), edge_j=jnp.asarray(np.int32(ej)),
        edge_R=jnp.asarray(np.stack(eR)), edge_t=jnp.asarray(np.stack(et)),
        edge_valid=jnp.ones(len(ei), bool), node_valid=jnp.ones(n, bool),
    ), (Rs, ts)


def test_analytic_jacobians_match_numerical():
    g, _ = _random_graph(noise=0.15)
    ja_i, ja_j, ra = pose_graph._analytic_jacobians(g)
    jn_i, jn_j, rn = pose_graph._numerical_jacobians(g)
    np.testing.assert_allclose(np.asarray(ra), np.asarray(rn), atol=1e-5)
    # forward differences carry O(eps) truncation + float32 cancellation:
    # agreement to a few percent absolute is all they can certify
    np.testing.assert_allclose(np.asarray(ja_i), np.asarray(jn_i), atol=5e-2)
    np.testing.assert_allclose(np.asarray(ja_j), np.asarray(jn_j), atol=5e-2)


def test_analytic_jacobians_finite_at_convergence():
    """At a perfectly consistent graph every residual is 0 -- the regime
    where arccos-based log autodiff would produce NaNs."""
    g, _ = _random_graph(noise=0.0)
    ji, jj, r = pose_graph._analytic_jacobians(g)
    assert np.isfinite(np.asarray(ji)).all()
    assert np.isfinite(np.asarray(jj)).all()
    assert float(jnp.sum(r ** 2)) < 1e-8


def test_pose_graph_large_loop_converges_tight():
    """64-node noisy loop with non-commuting rotations: analytic Jacobians
    must drive the cost to float32 floor (the forward-difference version
    plateaus orders of magnitude higher on this size)."""
    g, (Rs, ts) = _random_graph(n=64, m_loop=6, seed=11, noise=0.05)
    c0 = float(jnp.sum(pose_graph.edge_residuals(g) ** 2))
    g2, costs = pose_graph.optimize(g, iters=20, damping=1e-6)
    c1 = float(costs[-1])
    assert c1 < c0 * 1e-8, (c0, c1)
    assert c1 < 1e-6, c1


def test_loop_edge_conjugation_zero_residual():
    """The RANSAC relative pose (T_rel = X_cur X_old^-1, camera frames) must
    enter the pose graph as Z = X_old^-1 T_rel X_old. With rotations about
    DIFFERING axes the unconjugated edge leaves a large residual; the
    conjugated one is ~zero at ground truth (ADVICE round-1, high)."""
    rng = np.random.default_rng(5)
    R_old = np.asarray(se3.so3_exp(jnp.asarray(
        np.float32([0.7, 0.1, -0.3]))), np.float32)
    t_old = np.float32([1.0, -0.5, 2.0])
    R_cur = np.asarray(se3.so3_exp(jnp.asarray(
        np.float32([-0.2, 0.9, 0.4]))), np.float32)
    t_cur = np.float32([0.3, 1.5, -0.7])
    # the measurement RANSAC reports: x_cur = R_rel x_old + t_rel
    R_rel = R_cur @ R_old.T
    t_rel = t_cur - R_rel @ t_old

    def resid(R_edge, t_edge):
        g = pose_graph.PoseGraph(
            R=jnp.asarray(np.stack([R_old, R_cur])),
            t=jnp.asarray(np.stack([t_old, t_cur])),
            edge_i=jnp.asarray(np.int32([0])), edge_j=jnp.asarray(np.int32([1])),
            edge_R=jnp.asarray(R_edge[None]), edge_t=jnp.asarray(t_edge[None]),
            edge_valid=jnp.ones(1, bool), node_valid=jnp.ones(2, bool))
        return float(jnp.linalg.norm(pose_graph.edge_residuals(g)))

    # conjugated (the fix, matching models/slam.py try_close_loop)
    R_edge = R_old.T @ R_rel @ R_old
    t_edge = R_old.T @ (R_rel @ t_old + t_rel - t_old)
    assert resid(R_edge.astype(np.float32),
                 t_edge.astype(np.float32)) < 1e-5
    # unconjugated (the round-1 bug): residual stays O(1)
    assert resid(R_rel.astype(np.float32), t_rel.astype(np.float32)) > 0.3


def test_refresh_descriptors_updates_anchor():
    """map.refresh_descriptors=True: a re-observed landmark's anchor
    descriptor becomes the newest observation's descriptor at keyframe
    insertion (default OFF -- measured worse on the committed sequences,
    see config.py)."""
    import jax.numpy as jnp

    from pislam_tpu.config import PislamConfig, FrontendConfig
    from pislam_tpu.frontend import Features
    from pislam_tpu.models.slam import init_state, insert_keyframe_state

    K = 32
    cfg = PislamConfig(frontend=FrontendConfig(max_keypoints=K))
    rng = np.random.default_rng(3)

    def feats_of(desc):
        codes = ((200 << 24) | (np.arange(K, dtype=np.uint64) + 100 << 12)
                 | 200).astype(np.uint32)
        return Features(codes=jnp.asarray(codes), valid=jnp.ones(K, bool),
                        angles=jnp.zeros(K, jnp.uint8),
                        descriptors=jnp.asarray(desc))

    d0 = rng.integers(0, 2**31, (K, 8), dtype=np.int64).astype(np.uint32)
    d1 = rng.integers(0, 2**31, (K, 8), dtype=np.int64).astype(np.uint32)
    pts = rng.uniform(-0.5, 0.5, (K, 2)).astype(np.float32)
    eye = jnp.eye(3, dtype=jnp.float32)

    for refresh in (False, True):
        st = init_state(cfg)
        # bootstrap keyframe with d0
        st = insert_keyframe_state(
            cfg.map.keyframe_capacity, st, feats_of(d0), jnp.asarray(pts),
            eye, jnp.zeros(3), jnp.full(K, -1, jnp.int32),
            jnp.zeros(K, bool), 0, jnp.full(K, -1, jnp.int32),
            refresh_desc=refresh)
        # second keyframe: every feature matches the previous one 1:1 and
        # triangulates -> landmarks anchored with d1 (new landmarks use the
        # CURRENT frame's descriptors either way)
        t2 = jnp.asarray(np.float32([0.2, 0, 0]))
        st = insert_keyframe_state(
            cfg.map.keyframe_capacity, st, feats_of(d1),
            jnp.asarray(pts + np.float32([0.05, 0])), eye, t2,
            jnp.arange(K, dtype=jnp.int32), jnp.ones(K, bool), 0,
            jnp.full(K, -1, jnp.int32), refresh_desc=refresh)
        n_lm = int(st.counters[1])
        assert n_lm > 0
        # third keyframe: same features ASSOCIATED to those landmarks via
        # map_idx -> with refresh the anchors become d2, without they stay
        d2 = rng.integers(0, 2**31, (K, 8), dtype=np.int64).astype(np.uint32)
        assoc = jnp.arange(K, dtype=jnp.int32)  # feature i -> landmark i
        assoc = jnp.where(jnp.arange(K) < n_lm, assoc, -1)
        st = insert_keyframe_state(
            cfg.map.keyframe_capacity, st, feats_of(d2),
            jnp.asarray(pts + np.float32([0.1, 0])), eye,
            jnp.asarray(np.float32([0.4, 0, 0])),
            jnp.arange(K, dtype=jnp.int32), jnp.ones(K, bool), 1, assoc,
            refresh_desc=refresh)
        got = np.asarray(st.lmap.descriptors[:min(K, n_lm)])
        want = (d2 if refresh else d1)[:min(K, n_lm)]
        assert np.array_equal(got, want), refresh


# -- covisibility / keyframe culling / compaction ----------------------------


def _toy_map():
    """4 keyframes, 4 live landmarks, hand-written observation rows.

    kf0 sees lm{0,1,2}; kf1 sees lm{0,1,2,3}; kf2 sees lm{0,1,2};
    kf3 sees lm{0,1,2,3}.  So lm0-2 have 4 observations each, lm3 has 2.
    """
    store = keyframes.empty_store(capacity=4, max_kp=4, words=2)
    store = store._replace(valid=jnp.ones(4, bool),
                           ordinal=jnp.arange(4, dtype=jnp.int32),
                           frame_id=jnp.arange(4, dtype=jnp.int32))
    lmap = keyframes.empty_map(8, words=2)
    lmap = lmap._replace(
        valid=jnp.arange(8) < 4,
        xyz=jnp.arange(24, dtype=jnp.float32).reshape(8, 3))
    sees = {0: [0, 1, 2], 1: [0, 1, 2, 3], 2: [0, 1, 2], 3: [0, 1, 2, 3]}
    kf, lm = [], []
    for f, ls in sees.items():
        kf += [f] * len(ls)
        lm += ls
    n = len(kf)
    obs = keyframes.empty_obs(16)
    obs = obs._replace(kf=obs.kf.at[:n].set(jnp.int32(kf)),
                       lm=obs.lm.at[:n].set(jnp.int32(lm)),
                       valid=obs.valid.at[:n].set(True))
    lmap = lmap._replace(
        obs_count=jnp.zeros(8, jnp.int32).at[jnp.int32(lm)].add(1))
    return store, lmap, obs


def test_covisibility_counts():
    store, lmap, obs = _toy_map()
    W = np.asarray(keyframes.covisibility(store, lmap, obs))
    assert (W == W.T).all()
    assert (np.diag(W) == 0).all()
    assert W[0, 1] == 3 and W[1, 3] == 4 and W[0, 2] == 3 and W[2, 3] == 3

    # rows of an invalidated keyframe disappear
    store2 = store._replace(valid=store.valid.at[1].set(False))
    W2 = np.asarray(keyframes.covisibility(store2, lmap, obs))
    assert (W2[1] == 0).all() and (W2[:, 1] == 0).all()
    assert W2[0, 3] == 3


def test_keyframe_redundancy_and_cull():
    store, lmap, obs = _toy_map()
    frac, n_seen = keyframes.keyframe_redundancy(store, lmap, obs,
                                                 min_other_obs=3)
    frac = np.asarray(frac)
    # kf0/kf2 see only lm0-2 (4 obs each -> redundant): frac 1.0;
    # kf1/kf3 also see lm3 (2 obs): frac 3/4
    assert np.allclose(frac, [1.0, 0.75, 1.0, 0.75])
    assert np.asarray(n_seen).tolist() == [3, 4, 3, 4]

    eligible = jnp.asarray([False, True, True, False])
    store2, lmap2, obs2, slot = keyframes.cull_one_keyframe(
        store, lmap, obs, eligible, min_other_obs=3, redundant_fraction=0.9)
    assert int(slot) == 2
    assert not bool(store2.valid[2])
    # kf2's rows invalidated, its landmarks' obs_count decremented
    gone = np.asarray(obs.valid & (obs.kf == 2))
    assert (~np.asarray(obs2.valid)[gone]).all()
    assert np.asarray(lmap2.obs_count)[:4].tolist() == [3, 3, 3, 2]

    # a second cull finds nothing: lm0-2 now have only 3 observations,
    # so no remaining keyframe clears the redundancy bar
    _s3, _l3, _o3, slot2 = keyframes.cull_one_keyframe(
        store2, lmap2, obs2, eligible, min_other_obs=3,
        redundant_fraction=0.9)
    assert int(slot2) == -1

    # protected slots are never culled even when redundant
    _s4, _l4, _o4, slot3 = keyframes.cull_one_keyframe(
        store, lmap, obs, jnp.asarray([False, True, False, False]),
        min_other_obs=3, redundant_fraction=0.9)
    assert int(slot3) == -1


def test_evict_stale_landmarks_oldest_first():
    """Staleness eviction drops the landmarks whose LAST observing
    keyframe is oldest, invalidates their observation rows, and leaves
    fresher landmarks alone (long-session map freshness;
    backend/keyframes.evict_stale_landmarks)."""
    store = keyframes.empty_store(capacity=4, max_kp=4, words=2)
    store = store._replace(valid=jnp.ones(4, bool),
                           ordinal=jnp.arange(4, dtype=jnp.int32))
    lmap = keyframes.empty_map(8, words=2)
    lmap = lmap._replace(valid=jnp.arange(8) < 4)
    # last observers: lm0 -> kf0, lm1 -> kf1, lm2 -> kf3, lm3 -> kf3
    kf = [0, 0, 1, 3, 2, 3]
    lm = [0, 1, 1, 2, 3, 3]
    obs = keyframes.empty_obs(16)
    obs = obs._replace(kf=obs.kf.at[:6].set(jnp.int32(kf)),
                       lm=obs.lm.at[:6].set(jnp.int32(lm)),
                       valid=obs.valid.at[:6].set(True))

    lmap2, obs2, n = keyframes.evict_stale_landmarks(
        store, lmap, obs, jnp.int32(2))
    assert int(n) == 2
    v = np.asarray(lmap2.valid)
    assert not v[0] and not v[1]          # oldest last-observation dropped
    assert v[2] and v[3]                  # fresh landmarks survive
    ov = np.asarray(obs2.valid)
    assert not ov[0] and not ov[1] and not ov[2]   # lm0/lm1 rows gone
    assert ov[3] and ov[4] and ov[5]
    # no-op when nothing is needed
    lmap3, obs3, n3 = keyframes.evict_stale_landmarks(
        store, lmap, obs, jnp.int32(0))
    assert int(n3) == 0
    assert np.array_equal(np.asarray(lmap3.valid), np.asarray(lmap.valid))
    # compaction reclaims the slots for the cursor
    lmap4, obs4, n_lm, _n_obs = keyframes.compact_map(lmap2, obs2)
    assert int(n_lm) == 2


def test_compact_map_repacks_and_remaps():
    store, lmap, obs = _toy_map()
    # cull kf2, then additionally kill landmark 1 and its rows
    store, lmap, obs, _ = keyframes.cull_one_keyframe(
        store, lmap, obs, jnp.asarray([False, True, True, False]),
        min_other_obs=3, redundant_fraction=0.9)
    lmap = lmap._replace(valid=lmap.valid.at[1].set(False))
    obs = obs._replace(valid=obs.valid & (obs.lm != 1))

    # record the live (kf, landmark-xyz, uv) association set before
    kfv = np.asarray(obs.kf)[np.asarray(obs.valid)]
    xyzv = np.asarray(lmap.xyz)[np.asarray(obs.lm)[np.asarray(obs.valid)]]
    before = {(int(k), tuple(x)) for k, x in zip(kfv, xyzv)}

    lmap2, obs2, n_lm, n_obs = keyframes.compact_map(lmap, obs)
    n_lm, n_obs = int(n_lm), int(n_obs)
    assert n_lm == 3 and n_obs == len(before)
    v2 = np.asarray(lmap2.valid)
    assert v2[:n_lm].all() and not v2[n_lm:].any()
    ov2 = np.asarray(obs2.valid)
    assert ov2[:n_obs].all() and not ov2[n_obs:].any()
    # every surviving observation still points at the same world point
    kf2 = np.asarray(obs2.kf)[ov2]
    xyz2 = np.asarray(lmap2.xyz)[np.asarray(obs2.lm)[ov2]]
    after = {(int(k), tuple(x)) for k, x in zip(kf2, xyz2)}
    assert after == before
    # compacted indices are in range of the new cursor
    assert (np.asarray(obs2.lm)[ov2] < n_lm).all()


# ---- matrix-free CG solvers (the large-window path) ------------------------


def test_ba_cg_matches_dense():
    """CG-solved LM iterations track the dense Schur path on the same
    problem: both reach the noise-free optimum, and the per-iteration
    camera deltas agree to CG tolerance."""
    prob, (Rs, ts, X) = synthetic_ba(nc=6, npts=80, pose_noise=0.05)
    dense, _ = ba.bundle_adjust(prob, iters=8, solver="dense")
    cg, _ = ba.bundle_adjust(prob, iters=8, solver="cg", cg_iters=64)
    cost_d, _ = ba.ba_cost(dense)
    cost_c, _ = ba.ba_cost(cg)
    assert float(cost_d) < 1e-8
    assert float(cost_c) < 1e-8
    np.testing.assert_allclose(np.asarray(cg.R), np.asarray(dense.R),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(cg.t), np.asarray(dense.t),
                               atol=1e-4)



def test_ba_scale_anchor_step_is_orthogonal():
    """One LM step with scale_anchor: the solved camera update has no
    component along the anchor (camera 1's centre along the baseline from
    camera 0), camera 1 still moves otherwise, and the dense and CG solves
    agree."""
    prob, _ = synthetic_ba(nc=6, npts=80, pose_noise=0.05, seed=4)
    r, jc, jp, _ = ba.residuals_and_jacobians(prob)
    a = ba._scale_anchor(prob, 1)
    c = -np.einsum("cji,cj->ci", np.asarray(prob.R), np.asarray(prob.t))
    u = (c[1] - c[0]) / np.linalg.norm(c[1] - c[0])
    np.testing.assert_allclose(np.asarray(a)[6:9],
                               np.asarray(prob.R[1]) @ u, atol=1e-6)
    assert np.count_nonzero(np.asarray(a)) == 3
    hcc, bc, hpp, bp, w = ba.gn_normal_blocks(prob, r, jc, jp)
    s, b, _, _ = ba.schur_reduce(hcc, bc, hpp, bp, w, 1e-3, prob.cam_valid,
                                 n_fixed=1, anchor=a)
    dense = np.asarray(jnp.linalg.solve(s, b))
    cg = np.asarray(ba.reduced_system_cg(prob, r, jc, jp, 1e-3, 96,
                                         n_fixed=1, anchor=a)[0])
    for dx in (dense, cg):
        assert abs(float(dx @ np.asarray(a))) < 1e-6
        np.testing.assert_array_equal(dx[:6], 0.0)
        assert np.abs(dx[6:12]).max() > 1e-3
    np.testing.assert_allclose(cg, dense, atol=1e-4)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_ba_scale_anchor_converges(solver):
    """The seven-DoF gauge: camera 0 untouched, camera 1 free to rotate
    and to move across the baseline but held at its distance from camera 0
    (to second order in the step), and the noise-free problem still
    converges to zero cost."""
    prob, _ = synthetic_ba(nc=6, npts=80, pose_noise=0.05, seed=4)
    out, _ = ba.bundle_adjust(prob, iters=12, damping=1e-3, solver=solver,
                              cg_iters=64, n_fixed=1, scale_anchor=True)
    cost, nobs = ba.ba_cost(out)
    assert float(cost) / float(nobs) < 1e-8
    np.testing.assert_allclose(np.asarray(out.R[0]), np.asarray(prob.R[0]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.t[0]), np.asarray(prob.t[0]),
                               atol=1e-6)
    c_in = -np.einsum("cji,cj->ci", np.asarray(prob.R), np.asarray(prob.t))
    c_out = -np.einsum("cji,cj->ci", np.asarray(out.R), np.asarray(out.t))
    base_in = np.linalg.norm(c_in[1] - c_in[0])
    base_out = np.linalg.norm(c_out[1] - c_out[0])
    assert abs(base_out - base_in) < 0.02 * base_in, (base_in, base_out)
    assert np.linalg.norm(c_out[1] - c_in[1]) > 1e-3
    assert np.abs(np.asarray(out.R[1]) - np.asarray(prob.R[1])).max() > 1e-3

def test_ba_cg_scales_to_256_cameras():
    """global_ba at keyframe_capacity 256: the dense path would build a
    (P, 1536, 3) W tensor and factorise (1536)^2; the CG path must solve
    it matrix-free and still converge on a noise-free problem."""
    prob, _ = synthetic_ba(nc=256, npts=512, pose_noise=0.02,
                           point_noise=0.05, seed=3)
    out, info = ba.bundle_adjust(prob, iters=6, solver="cg", cg_iters=96)
    cost, nobs = ba.ba_cost(out)
    # mean reprojection residual below 1e-4 (noise-free observations)
    assert float(cost) / float(nobs) < 1e-8


def test_pose_graph_cg_matches_dense():
    g, _ = _random_graph(n=12, m_loop=3, seed=11, noise=0.15)
    gd, costs_d = pose_graph.optimize(g, iters=10, solver="dense")
    gc, costs_c = pose_graph.optimize(g, iters=10, solver="cg", cg_iters=128)
    assert float(costs_d[-1]) < 1e-9
    assert float(costs_c[-1]) < 1e-9
    np.testing.assert_allclose(np.asarray(gc.R), np.asarray(gd.R), atol=1e-4)
    np.testing.assert_allclose(np.asarray(gc.t), np.asarray(gd.t), atol=1e-4)


def test_pose_graph_cg_large_chain():
    """256-node chain + loops converges through the CG path (auto-selected
    above 64 nodes)."""
    g, _ = _random_graph(n=256, m_loop=8, seed=2, noise=0.05)
    g2, costs = pose_graph.optimize(g, iters=12)  # auto -> cg, 256 cg iters
    assert float(costs[-1]) < 1e-4


def _scale_drift_graph(n=16, rate=1.12):
    """Circle trajectory whose odometry steps carry multiplicative scale
    drift (the monocular failure mode), plus one TRUE metric loop edge."""
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    true_t = np.stack([np.cos(angles), np.sin(angles), 0 * angles],
                      1).astype(np.float32) * 3
    drift = rate ** np.arange(n - 1)
    est_t = [true_t[0]]
    for i in range(n - 1):
        est_t.append(est_t[-1] + (true_t[i + 1] - true_t[i]) * drift[i])
    est_t = np.stack(est_t).astype(np.float32)
    ei = np.concatenate([np.arange(n - 1), [n - 1]])
    ej = np.concatenate([np.arange(1, n), [0]])
    et = []
    for a, b in zip(ei, ej):
        src = true_t if (a, b) == (n - 1, 0) else est_t
        et.append(src[b] - src[a])
    g = pose_graph.PoseGraph(
        R=jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))),
        t=jnp.asarray(est_t),
        edge_i=jnp.asarray(np.int32(ei)), edge_j=jnp.asarray(np.int32(ej)),
        edge_R=jnp.asarray(np.tile(np.eye(3, dtype=np.float32),
                                   (len(ei), 1, 1))),
        edge_t=jnp.asarray(np.stack(et).astype(np.float32)),
        edge_valid=jnp.ones(len(ei), bool), node_valid=jnp.ones(n, bool))
    return g, est_t, true_t


def test_pose_graph_sim3_absorbs_scale_drift():
    """Under monocular scale drift + one metric loop edge, the Sim(3)
    graph reaches a lower residual AND a better similarity-aligned
    trajectory than SE(3) -- the extra per-node scale DOF absorbs the
    drift that SE(3) must misattribute to rotations/translations
    (the ORB-SLAM essential-graph rationale)."""
    from pislam_tpu.evaluation import ate_rmse

    g, est_t, true_t = _scale_drift_graph()
    g6, c6 = pose_graph.optimize(g, iters=30, sim3=False)
    g7, c7 = pose_graph.optimize(g, iters=30, sim3=True)
    assert float(c7[-1]) < float(c6[-1]) * 0.75
    # scales activated, gauge node pinned at log-scale 0
    logs = np.asarray(g7.node_logs)
    assert abs(logs[0]) < 1e-6
    assert np.abs(logs).max() > 0.05
    ate_pre = float(ate_rmse(est_t, true_t))
    ate_se3 = float(ate_rmse(np.asarray(g6.t), true_t))
    ate_sim3 = float(ate_rmse(np.asarray(g7.t), true_t))
    assert ate_sim3 < ate_se3 * 0.8, (ate_pre, ate_se3, ate_sim3)


def test_pose_graph_sim3_consistent_is_fixed_point():
    """A graph whose edges exactly match its nodes must not move (and must
    not invent scales) under the Sim(3) optimiser."""
    g, _ = _random_graph(n=10, m_loop=2, seed=5, noise=0.0)
    g2, costs = pose_graph.optimize(g, iters=5, sim3=True)
    assert float(costs[-1]) < 1e-10
    np.testing.assert_allclose(np.asarray(g2.t), np.asarray(g.t), atol=1e-5)
    np.testing.assert_allclose(np.asarray(g2.node_logs), 0.0, atol=1e-5)
