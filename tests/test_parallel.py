"""Multi-device tests on the 8-virtual-CPU mesh (conftest).

Distributed BA must match the single-device result; data-parallel extraction
must match per-frame extraction.
"""

import numpy as np
import jax
import pytest
import jax.numpy as jnp

from pislam_tpu.backend import ba
from pislam_tpu.config import FrontendConfig, MeshConfig, PislamConfig, PyramidConfig
from pislam_tpu.frontend import make_extract_fn
from pislam_tpu.parallel import dist, mesh as meshmod

from test_backend import synthetic_ba
import oracles


def test_mesh_shapes():
    m = meshmod.make_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    assert m.devices.shape == (4, 2)
    m2 = meshmod.make_mesh(MeshConfig(data_parallel=8))
    assert m2.devices.shape == (8, 1)


@pytest.mark.parametrize("dp,mp,n", [(1, 1, 8), (2, 4, 4), (4, 1, 8)])
def test_make_mesh_raises_on_count_mismatch(dp, mp, n):
    """A mesh that does not use exactly the devices given is an error, never
    a silent fallback to an unsharded layout."""
    with pytest.raises(ValueError, match="devices"):
        meshmod.make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp),
                          devices=jax.devices()[:n])


def test_distributed_ba_matches_single():
    prob, _ = synthetic_ba(nc=4, npts=64, seed=5, pad_obs=64)
    single, info_s = ba.bundle_adjust(prob, iters=6, damping=1e-3)

    m = meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    sharded = dist.shard_ba_problem(prob, 4)
    run = dist.make_distributed_ba(m, iters=6, damping=1e-3)
    out, info_d = run(sharded)

    # identical pose trajectories (same math, different reduction order ->
    # tiny float differences)
    np.testing.assert_allclose(np.asarray(out.R), np.asarray(single.R),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.t), np.asarray(single.t),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(info_d["costs"]),
                               np.asarray(info_s["costs"]), rtol=1e-3)


def test_distributed_ba_cg_matches_single():
    """The matrix-free CG solver through the distributed path: psums of
    (C, 6) camera vectors PER CG ITERATION instead of one (6C, 6C) psum +
    dense factorisation. Must match the single-device CG result."""
    prob, _ = synthetic_ba(nc=4, npts=64, seed=5, pad_obs=64)
    single, info_s = ba.bundle_adjust(prob, iters=6, damping=1e-3,
                                      solver="cg", cg_iters=64)

    m = meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    sharded = dist.shard_ba_problem(prob, 4)
    run = dist.make_distributed_ba(m, iters=6, damping=1e-3,
                                   solver="cg", cg_iters=64)
    out, info_d = run(sharded)

    np.testing.assert_allclose(np.asarray(out.R), np.asarray(single.R),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.t), np.asarray(single.t),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(info_d["costs"]),
                               np.asarray(info_s["costs"]), rtol=1e-3)


def test_distributed_ba_cg_256_cameras():
    """Pod-scale global BA: 256 cameras, landmarks/observations sharded
    over an 8-way model axis, solved matrix-free (the dense path would
    materialise the (P, 1536, 3) W tensor per shard and factorise
    (1536)^2 -- the exact ceiling the CG path lifts). Noise-free problem
    must converge through the per-CG-iteration psum reduction."""
    prob, _ = synthetic_ba(nc=256, npts=256, pose_noise=0.02,
                           point_noise=0.05, seed=3)
    m = meshmod.make_mesh(MeshConfig(data_parallel=1, model_parallel=8))
    sharded = dist.shard_ba_problem(prob, 8)
    run = dist.make_distributed_ba(m, iters=6, damping=1e-4,
                                   solver="cg", cg_iters=96)
    out, info = run(sharded)
    cost, nobs = ba.ba_cost(prob)   # pre-optimisation cost for contrast
    cost1, _ = ba.ba_cost(out._replace(
        obs_valid=prob.obs_valid, obs_cam=prob.obs_cam,
        obs_pt=prob.obs_pt, obs_uv=prob.obs_uv))
    assert float(cost1) / float(nobs) < 1e-8, (float(cost), float(cost1))


def test_data_parallel_extraction_matches_single():
    pyr = PyramidConfig(base_width=96, base_height=80, num_levels=2)
    fe = FrontendConfig(fast_threshold=20, harris_threshold=1 << 10,
                        border=16, max_keypoints=128)
    cfg = PislamConfig(pyramid=pyr, frontend=fe)

    frames = np.stack([
        np.zeros((pyr.padded_height, pyr.stride), np.uint8) for _ in range(8)
    ])
    for b in range(8):
        for (w, h), r in zip(pyr.level_sizes, pyr.level_rows):
            frames[b, r:r + h, :w] = oracles.make_test_image(h, w, seed=100 + b)

    m = meshmod.make_mesh(MeshConfig(data_parallel=8, model_parallel=1))
    batch_extract = dist.make_batch_extract(cfg, m)
    out = batch_extract(jnp.asarray(frames))

    single = make_extract_fn(cfg)
    for b in range(8):
        ref = single(frames[b])
        np.testing.assert_array_equal(np.asarray(out.codes[b]),
                                      np.asarray(ref.codes))
        np.testing.assert_array_equal(np.asarray(out.descriptors[b]),
                                      np.asarray(ref.descriptors))


def test_streaming_pipeline_matches_single():
    """The data-parallel streaming scan (per-device camera streams) must
    report the same per-frame feature/match counts as the single-device
    streaming path for each stream."""
    from pislam_tpu import matching
    from pislam_tpu.frontend import _extract_impl
    from pislam_tpu.ops import nms, pyramid as pyr_ops

    pyr = PyramidConfig(base_width=96, base_height=80, num_levels=2)
    fe = FrontendConfig(fast_threshold=20, harris_threshold=1 << 10,
                        border=16, max_keypoints=128)
    cfg = PislamConfig(pyramid=pyr, frontend=fe)
    mc = cfg.matcher

    nb, t = 4, 4
    frames = np.stack([
        np.stack([oracles.make_test_image(pyr.base_height, pyr.base_width,
                                          seed=10 * b + i)
                  for i in range(t)])
        for b in range(nb)
    ])

    m = meshmod.make_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    run = dist.make_streaming_pipeline(cfg, m)
    nfeat, nmatch = run(jnp.asarray(frames))
    assert nfeat.shape == (nb, t - 1)

    mask = np.asarray(nms.make_level_mask(
        pyr.level_sizes, pyr.level_rows, pyr.padded_height, pyr.stride,
        fe.border))

    def single(frame):
        return _extract_impl(pyr_ops.build_pyramid(frame, pyr), mask, cfg)

    for b in range(nb):
        prev = single(jnp.asarray(frames[b, 0]))
        for i in range(1, t):
            cur = single(jnp.asarray(frames[b, i]))
            idx2, _ = matching.match(
                prev.descriptors, cur.descriptors, prev.valid, cur.valid,
                max_distance=mc.max_distance, ratio=mc.ratio,
                cross_check=mc.cross_check)
            assert int(nfeat[b, i - 1]) == int(cur.num_valid)
            assert int(nmatch[b, i - 1]) == int(jnp.sum(idx2 >= 0))
            prev = cur


def test_vo_streaming_matches_single_scan():
    """Data-parallel VO trajectories == per-stream single-device scans."""
    from pislam_tpu.models.visual_odometry import make_vo_scan

    pyr = PyramidConfig(base_width=96, base_height=80, num_levels=2)
    fe = FrontendConfig(fast_threshold=20, harris_threshold=1 << 10,
                        border=16, max_keypoints=128)
    cfg = PislamConfig(pyramid=pyr, frontend=fe)
    fx = fy = 80.0
    cx, cy = 48.0, 40.0

    nb, t = 4, 3
    frames = np.stack([
        np.stack([oracles.make_test_image(pyr.base_height, pyr.base_width,
                                          seed=100 * b + i)
                  for i in range(t)])
        for b in range(nb)
    ])
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(nb, dtype=jnp.uint32))

    m = meshmod.make_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    run = dist.make_vo_streaming(cfg, fx, fy, cx, cy, m)
    out = run(jnp.asarray(frames), keys)
    assert out["R"].shape == (nb, t, 3, 3)
    assert out["t"].shape == (nb, t, 3)

    one = make_vo_scan(cfg, fx, fy, cx, cy)
    for b in range(nb):
        ref = one(jnp.asarray(frames[b]), keys[b])
        np.testing.assert_allclose(np.asarray(out["R"][b]),
                                   np.asarray(ref["R"]), atol=1e-5)
        np.testing.assert_allclose(np.asarray(out["t"][b]),
                                   np.asarray(ref["t"]), atol=1e-5)
        assert np.array_equal(np.asarray(out["accepted"][b]),
                              np.asarray(ref["accepted"]))


def test_slam_streaming_matches_single_scan():
    """Data-parallel multi-session SLAM == per-stream single-device scans."""
    from pislam_tpu.models.slam import init_state
    from pislam_tpu.models.slam_scan import make_slam_track_scan

    pyr = PyramidConfig(base_width=96, base_height=80, num_levels=2)
    fe = FrontendConfig(fast_threshold=20, harris_threshold=1 << 10,
                        border=16, max_keypoints=128)
    cfg = PislamConfig(pyramid=pyr, frontend=fe)
    fx = fy = 80.0
    cx, cy = 48.0, 40.0

    nb, t = 4, 3
    frames = np.stack([
        np.stack([oracles.make_test_image(pyr.base_height, pyr.base_width,
                                          seed=200 * b + i)
                  for i in range(t)])
        for b in range(nb)
    ])

    m = meshmod.make_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    run = dist.make_slam_streaming(cfg, fx, fy, cx, cy, m,
                                   keyframe_min_inliers=40,
                                   keyframe_max_gap=2)
    states = dist.batch_slam_states(cfg, nb)
    states, outs = run(states, jnp.asarray(frames))
    assert outs["pose_R"].shape == (nb, t, 3, 3)
    # every session bootstrapped its own map (frame 0 is a keyframe)
    assert np.asarray(outs["keyframe"])[:, 0].all()
    assert (np.asarray(states.counters)[:, 0] >= 1).all()

    one = make_slam_track_scan(cfg, fx, fy, cx, cy,
                               keyframe_min_inliers=40, keyframe_max_gap=2)
    for b in range(nb):
        st_b, ref = one(init_state(cfg, seed=7 + b), jnp.asarray(frames[b]))
        np.testing.assert_allclose(np.asarray(outs["pose_t"][b]),
                                   np.asarray(ref["pose_t"]), atol=1e-5)
        assert np.array_equal(np.asarray(outs["keyframe"][b]),
                              np.asarray(ref["keyframe"]))
        assert np.array_equal(np.asarray(states.counters[b]),
                              np.asarray(st_b.counters))


def test_sharded_match_matches_single():
    from pislam_tpu import matching

    rng = np.random.default_rng(11)
    k1, k2 = 192, 512  # k2 sharded 4 ways
    base = rng.integers(0, 2**31, (k2, 8), dtype=np.int64).astype(np.uint32)
    # queries: noisy copies of random database rows (realistic near-matches)
    pick = rng.integers(0, k2, k1)
    noise = (rng.random((k1, 8, 32)) < 0.03).astype(np.uint32)
    noise = (noise << np.arange(32, dtype=np.uint32)).sum(-1).astype(np.uint32)
    qa = base[pick] ^ noise
    va = rng.random(k1) < 0.9
    vb = rng.random(k2) < 0.9

    args = (jnp.asarray(qa), jnp.asarray(base),
            jnp.asarray(va), jnp.asarray(vb))
    idx_s, dist_s = matching.match(*args, max_distance=64, ratio=0.8,
                                   cross_check=True)

    m = meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    run = dist.make_sharded_match(m, max_distance=64, ratio=0.8,
                                  cross_check=True)
    idx_d, dist_d = run(*args)

    assert np.array_equal(np.asarray(idx_s), np.asarray(idx_d))
    assert np.array_equal(np.asarray(dist_s), np.asarray(dist_d))


def test_checkpointed_runner_resumes(tmp_path):
    from pislam_tpu.parallel.elastic import CheckpointedRunner, initialize_multihost

    assert initialize_multihost() == 0  # single-process no-op

    calls = []

    def step(state, item):
        calls.append(int(item))
        return {"acc": state["acc"] + jnp.float32(item)}

    d = str(tmp_path / "ck")
    r = CheckpointedRunner(step, d, every=3)
    s = r.resume({"acc": jnp.float32(0)})
    s = r.run(s, range(5))
    assert float(s["acc"]) == 10.0 and calls == [0, 1, 2, 3, 4]

    # a "restarted" worker resumes from the step-3 checkpoint
    calls.clear()
    r2 = CheckpointedRunner(step, d, every=3)
    s2 = r2.resume({"acc": jnp.float32(0)})
    s2 = r2.run(s2, range(5))
    assert float(s2["acc"]) == 10.0
    assert calls == []  # final checkpoint covered all 5 steps


def test_sharded_map_tracker_matches_single():
    """Landmark map sharded 4-ways: tracking == single-device track_map_state
    (bit-identical association, pose to float tolerance)."""
    from pislam_tpu.backend import keyframes as kfs
    from pislam_tpu.frontend import Features
    from pislam_tpu.models.slam import track_map_state

    rng = np.random.default_rng(13)
    cfg = PislamConfig()
    L = cfg.map.max_landmarks          # 8192, divisible by 4
    K = 256
    nlm = 300
    lmap = kfs.empty_map(L, cfg.frontend.words)
    xyz = rng.uniform([-4, -3, 2], [4, 3, 10], (nlm, 3)).astype(np.float32)
    desc = rng.integers(0, 2**31, (nlm, 8), dtype=np.int64).astype(np.uint32)
    lmap = lmap._replace(
        xyz=lmap.xyz.at[:nlm].set(xyz),
        descriptors=lmap.descriptors.at[:nlm].set(desc),
        valid=lmap.valid.at[:nlm].set(True))

    # query features: noisy landmark views projected with a known pose
    R0 = np.eye(3, dtype=np.float32)
    t0 = np.float32([0.05, -0.02, 0.01])
    pick = rng.integers(0, nlm, K)
    xc = xyz[pick] @ R0.T + t0
    pts = (xc[:, :2] / xc[:, 2:]).astype(np.float32)
    pts += rng.normal(0, 1e-3, pts.shape).astype(np.float32)
    feats = Features(
        codes=jnp.zeros(K, jnp.uint32), valid=jnp.ones(K, bool),
        angles=jnp.zeros(K, jnp.uint8),
        descriptors=jnp.asarray(desc[pick]))

    Rs, ts_, ni_s, assoc_s = jax.jit(
        lambda lm, f, p, R, t: track_map_state(cfg, lm, f, p, R, t))(
        lmap, feats, jnp.asarray(pts), jnp.asarray(R0), jnp.asarray(t0))

    m = meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    run = dist.make_sharded_map_tracker(cfg, m)
    Rd, td, ni_d, assoc_d = run(lmap, feats, jnp.asarray(pts),
                                jnp.asarray(R0), jnp.asarray(t0))

    assert int(ni_s) > 50  # the scenario must actually track
    assert int(ni_s) == int(ni_d)
    assert np.array_equal(np.asarray(assoc_s), np.asarray(assoc_d))
    np.testing.assert_allclose(np.asarray(Rd), np.asarray(Rs), atol=1e-5)
    np.testing.assert_allclose(np.asarray(td), np.asarray(ts_), atol=1e-5)


def test_sharded_store_counts_matches_single():
    """Keyframe store sharded 4-ways: loop-detection counts identical."""
    from pislam_tpu import matching
    from pislam_tpu.backend import keyframes as kfs
    from pislam_tpu.frontend import Features

    rng = np.random.default_rng(17)
    cfg = PislamConfig()
    F, K = cfg.map.keyframe_capacity, 128
    store = kfs.empty_store(F, K, cfg.frontend.words)
    desc = rng.integers(0, 2**31, (F, K, 8), dtype=np.int64).astype(np.uint32)
    kv = rng.random((F, K)) < 0.8
    store = store._replace(
        descriptors=jnp.asarray(desc), kp_valid=jnp.asarray(kv),
        valid=jnp.ones(F, bool))
    # query shares many descriptors with keyframe 5
    q = desc[5].copy()
    q[::3] = rng.integers(0, 2**31, (len(q[::3]), 8),
                          dtype=np.int64).astype(np.uint32)
    feats = Features(
        codes=jnp.zeros(K, jnp.uint32), valid=jnp.ones(K, bool),
        angles=jnp.zeros(K, jnp.uint8), descriptors=jnp.asarray(q))

    counts_s = matching.match_many(
        store.descriptors, store.kp_valid, feats.descriptors, feats.valid,
        max_distance=cfg.matcher.max_distance, ratio=cfg.matcher.ratio,
        cross_check=cfg.matcher.cross_check)[1]

    m = meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    run = dist.make_sharded_store_counts(cfg, m)
    counts_d = run(store, feats)

    assert int(np.argmax(np.asarray(counts_s))) == 5
    assert np.array_equal(np.asarray(counts_s), np.asarray(counts_d))


def test_sharded_map_slam_end_to_end():
    """KeyframeSLAM(mesh=...) == KeyframeSLAM() on the synthetic scene:
    same keyframe decisions, same loop detection, trajectories close."""
    from test_models import (make_world, make_trajectory, projector,
                             tiny_cfg, FX, FY, CX, CY)
    from pislam_tpu.models.slam import KeyframeSLAM

    xyz, desc = make_world(seed=21)
    Rs, ts_ = make_trajectory(14)
    cfg = tiny_cfg()
    proj = projector(xyz, desc, Rs, ts_)

    single = KeyframeSLAM(cfg, FX, FY, CX, CY, features_fn=proj,
                          keyframe_min_inliers=220, keyframe_max_gap=4)
    m = meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    sharded = KeyframeSLAM(cfg, FX, FY, CX, CY, features_fn=proj,
                           keyframe_min_inliers=220, keyframe_max_gap=4,
                           mesh=m)
    for i in range(14):
        a = single.process(i)
        b = sharded.process(i)
        assert a["keyframe"] == b["keyframe"], i
        assert a["num_inliers"] == b["num_inliers"], i
        assert abs(a["map_inliers"] - b["map_inliers"]) <= 2, i
    assert sharded.num_keyframes == single.num_keyframes
    assert sharded.keyframe_frames == single.keyframe_frames
    np.testing.assert_allclose(
        np.stack(sharded.trajectory), np.stack(single.trajectory), atol=2e-3)

    # loop detection against the sharded store agrees
    pose = sharded.relocalise(3, min_matches=30)
    assert pose is not None
    assert np.linalg.norm(np.asarray(pose[0]) - Rs[3]) < 0.06


def test_sharded_map_tracker_gated_matches_single():
    """Projection-gated map tracking: sharded == single-device."""
    import dataclasses as dc

    from pislam_tpu.backend import keyframes as kfs
    from pislam_tpu.frontend import Features
    from pislam_tpu.models.slam import track_map_state

    rng = np.random.default_rng(29)
    base = PislamConfig()
    cfg = dc.replace(base, map=dc.replace(base.map, gate_radius=0.06))
    L = cfg.map.max_landmarks
    K, nlm = 192, 240
    xyz = rng.uniform([-4, -3, 2], [4, 3, 10], (nlm, 3)).astype(np.float32)
    # aliased descriptors so the gate MATTERS for the result
    desc = rng.integers(0, 2**31, (nlm // 2, 8),
                        dtype=np.int64).astype(np.uint32)
    desc = np.vstack([desc, desc])
    lmap = kfs.empty_map(L, 8)
    lmap = lmap._replace(
        xyz=lmap.xyz.at[:nlm].set(xyz),
        descriptors=lmap.descriptors.at[:nlm].set(desc),
        valid=lmap.valid.at[:nlm].set(True))

    R0 = np.eye(3, dtype=np.float32)
    t0 = np.float32([0.02, 0.01, -0.01])
    pick = rng.integers(0, nlm, K)
    xc = xyz[pick] @ R0.T + t0
    pts = (xc[:, :2] / xc[:, 2:]).astype(np.float32)
    feats = Features(
        codes=jnp.zeros(K, jnp.uint32), valid=jnp.ones(K, bool),
        angles=jnp.zeros(K, jnp.uint8), descriptors=jnp.asarray(desc[pick]))

    Rs, ts_, ni_s, assoc_s = jax.jit(
        lambda lm, f, p, R, t: track_map_state(cfg, lm, f, p, R, t))(
        lmap, feats, jnp.asarray(pts), jnp.asarray(R0), jnp.asarray(t0))

    m = meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    run = dist.make_sharded_map_tracker(cfg, m)
    Rd, td, ni_d, assoc_d = run(lmap, feats, jnp.asarray(pts),
                                jnp.asarray(R0), jnp.asarray(t0))

    assert int(ni_s) > 100  # the gate resolves the aliased map
    assert int(ni_s) == int(ni_d)
    assert np.array_equal(np.asarray(assoc_s), np.asarray(assoc_d))
    np.testing.assert_allclose(np.asarray(Rd), np.asarray(Rs), atol=1e-5)
    np.testing.assert_allclose(np.asarray(td), np.asarray(ts_), atol=1e-5)


@pytest.mark.parametrize("radius", [0.0, 0.2])
def test_sharded_match_body_matches_single(radius):
    """Cross-shard matching (query replicated, database row-sharded over
    4 devices) == single-device matching.match / match_gated bit for bit,
    including a best-distance tie split across shards (the lowest global
    index must win) and a gate that cuts candidates."""
    from jax.sharding import PartitionSpec as P
    from pislam_tpu import matching

    rng = np.random.default_rng(31)
    k1, k2 = 192, 1024
    d1 = rng.integers(0, 2**32, (k1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (k2, 8), dtype=np.uint32)
    uv1 = rng.uniform(-0.5, 0.5, (k1, 2)).astype(np.float32)
    uv2 = rng.uniform(-0.5, 0.5, (k2, 2)).astype(np.float32)
    for i in range(0, k1, 3):   # near-duplicates, near in the image too
        d2[(i * 5) % k2] = d1[i] ^ np.uint32(rng.integers(0, 2**8))
        uv2[(i * 5) % k2] = uv1[i] + rng.normal(0, 0.05, 2)
    d2[100] = d1[7]
    d2[700] = d1[7]             # exact tie split across shards
    uv2[100] = uv2[700] = uv1[7]
    v1 = rng.random(k1) < 0.9
    v2 = rng.random(k2) < 0.9
    v1[7] = v2[100] = v2[700] = True
    j = lambda a: jnp.asarray(a)

    m = meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=4))

    def body(b_s, v2_s, uv2_s):
        g = (j(uv1), uv2_s, radius) if radius else None
        return dist._sharded_match_local(
            "model", 4, j(d1), b_s, j(v1), v2_s, 64, 0.8, True, gate=g)

    f = jax.jit(jax.shard_map(
        body, mesh=m, in_specs=(P("model"), P("model"), P("model")),
        out_specs=(P(), P()), check_vma=False))
    idx_s, best_s = f(j(d2), j(v2), j(uv2))
    if radius:
        idx, dd = matching.match_gated(j(d1), j(d2), j(v1), j(v2), j(uv1),
                                       j(uv2), radius)
    else:
        idx, dd = matching.match(j(d1), j(d2), j(v1), j(v2))
        run = dist.make_sharded_match(m)
        idx_r, dd_r = run(j(d1), j(d2), j(v1), j(v2))
        assert np.array_equal(np.asarray(idx_r), np.asarray(idx))
        assert np.array_equal(np.asarray(dd_r), np.asarray(dd))
    idx, idx_s = np.asarray(idx), np.asarray(idx_s)
    assert (idx >= 0).sum() > 10
    assert np.array_equal(idx_s, idx)
    ok = idx >= 0
    assert np.array_equal(np.asarray(best_s)[ok], np.asarray(dd)[ok])
