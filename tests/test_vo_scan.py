"""Device-resident VO sequence scan == the Python-driven VO loop.

make_vo_scan folds the full per-frame VO path into one lax.scan (zero host
round-trips per frame -- one dispatch per sequence). Both paths
run vo_step, so per-frame decisions must agree and trajectories must match
to float tolerance (the scan compiles one fused program, so bitwise
equality across jit boundaries is not guaranteed).
"""

import dataclasses
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

from pislam_tpu.models.visual_odometry import VisualOdometry, make_vo_scan

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "eval_seq.npz")


def test_vo_scan_matches_loop():
    from eval_ate import slam_config

    d = np.load(DATA)
    frames = d["frames"][:10]
    fx, fy, cx, cy = (float(d["fx"]), float(d["fy"]),
                      float(d["cx"]), float(d["cy"]))
    cfg = slam_config(384, 256)
    cfg = dataclasses.replace(
        cfg, vo=dataclasses.replace(cfg.vo, ransac_iters=128))

    seed = 3
    run = make_vo_scan(cfg, fx, fy, cx, cy)
    out = run(jnp.asarray(frames), jax.random.PRNGKey(seed))

    vo = VisualOdometry(cfg, fx, fy, cx, cy)
    state = vo.init(jnp.asarray(frames[0]), seed=seed)
    Rs, ts, ninl, acc = [np.eye(3)], [np.zeros(3)], [], []
    for f in frames[1:]:
        state, info = vo.process(state, jnp.asarray(f))
        Rs.append(np.asarray(state.R)); ts.append(np.asarray(state.t))
        ninl.append(int(info["num_inliers"]))
        acc.append(bool(info["accepted"]))

    assert np.array_equal(np.asarray(out["accepted"]), np.asarray(acc))
    assert np.abs(np.asarray(out["num_inliers"]) - np.asarray(ninl)).max() <= 2
    np.testing.assert_allclose(np.asarray(out["R"]), np.stack(Rs), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out["t"]), np.stack(ts), atol=1e-4)
    # the trajectory is non-trivial: every transition accepted, motion real
    assert all(acc)
    assert np.linalg.norm(np.stack(ts)[1:], axis=1).min() > 0.1
