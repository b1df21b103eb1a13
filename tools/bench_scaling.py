"""Multi-device scaling benchmark: BASELINE.json configs[4].

Runs data-parallel batch extraction and model-parallel distributed BA over a
jax.sharding.Mesh and reports weak-scaling efficiency at 1/2/4/8 devices.

By default this runs on N virtual CPU devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8, JAX_PLATFORMS=cpu) --
the sharding layout, collectives and SPMD programs are the ones a multi-GPU
host would execute; the absolute numbers are CPU numbers, not device
timings. Pass --real to run on the default backend's devices instead.
"""

import json
import os
import sys

if "--real" not in sys.argv:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np
import jax

# also force it through jax.config, in case jax was imported earlier
if "--real" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp


def main():
    from pislam_tpu.config import (FrontendConfig, MeshConfig, PislamConfig,
                                   PyramidConfig)
    from pislam_tpu.parallel import dist, mesh as meshmod

    # small per-device workload (CPU virtual devices): 2 VGA-quarter frames
    pyr = PyramidConfig(base_width=256, base_height=192, num_levels=4)
    fe = FrontendConfig(fast_threshold=20, harris_threshold=1 << 12,
                        border=16, max_keypoints=512)
    cfg = PislamConfig(pyramid=pyr, frontend=fe)
    frames_per_device = 2

    rng = np.random.default_rng(0)
    results = {}
    sizes = [n for n in (1, 2, 4, 8) if n <= len(jax.devices())]
    for n in sizes:
        mesh = meshmod.make_mesh(
            MeshConfig(data_parallel=n, model_parallel=1),
            devices=jax.devices()[:n])
        run = dist.make_batch_extract(cfg, mesh)
        frames = rng.integers(
            0, 256, (n * frames_per_device, pyr.padded_height, pyr.stride),
            np.uint8)
        fr = jax.device_put(frames)
        out = run(fr)
        jax.block_until_ready(out)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = run(fr)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        results[n] = (n * frames_per_device) / t

    base = results[sizes[0]]
    report = {
        "metric": "batch_extract_weak_scaling",
        "platform": jax.default_backend(),
        "frames_per_s": {str(n): round(v, 2) for n, v in results.items()},
        "efficiency": {
            str(n): round(results[n] / (base * n), 3) for n in sizes},
    }
    if jax.default_backend() == "cpu":
        # virtual devices share the same physical cores: total throughput
        # staying ~flat as devices scale means the SPMD partitioning adds no
        # overhead (ideal = 1.0 here); per-device efficiency only measures
        # anything on real hardware (run with --real on a slice)
        report["sharding_overhead_vs_1dev"] = {
            str(n): round(base / results[n], 3) for n in sizes}
        report["note"] = ("cpu virtual devices share cores; see "
                          "sharding_overhead_vs_1dev (ideal 1.0), not "
                          "efficiency")
    print(json.dumps(report))

    # ---- streaming pipeline weak scaling: one camera stream per device ----
    t_frames = 16
    st_results = {}
    for n in sizes:
        mesh = meshmod.make_mesh(
            MeshConfig(data_parallel=n, model_parallel=1),
            devices=jax.devices()[:n])
        run = dist.make_streaming_pipeline(cfg, mesh)
        frames = rng.integers(
            0, 256, (n, t_frames, pyr.base_height, pyr.base_width), np.uint8)
        fr = jax.device_put(frames)
        out = run(fr)
        jax.block_until_ready(out)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = run(fr)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        st_results[n] = (n * t_frames) / float(np.median(times))

    st_base = st_results[sizes[0]]
    report = {
        "metric": "streaming_pipeline_weak_scaling",
        "platform": jax.default_backend(),
        "frames_per_stream": t_frames,
        "frames_per_s": {str(n): round(v, 2) for n, v in st_results.items()},
        "efficiency": {
            str(n): round(st_results[n] / (st_base * n), 3) for n in sizes},
    }
    if jax.default_backend() == "cpu":
        report["sharding_overhead_vs_1dev"] = {
            str(n): round(st_base / st_results[n], 3) for n in sizes}
        report["note"] = ("cpu virtual devices share cores; see "
                          "sharding_overhead_vs_1dev (ideal 1.0), not "
                          "efficiency")
    print(json.dumps(report))

    # ---- multi-session SLAM weak scaling: one full map per stream ----
    slam_t = 8
    fx = fy = 0.9 * pyr.base_width
    cx_, cy_ = pyr.base_width / 2.0, pyr.base_height / 2.0
    sl_results = {}
    for n in sizes:
        mesh = meshmod.make_mesh(
            MeshConfig(data_parallel=n, model_parallel=1),
            devices=jax.devices()[:n])
        run = dist.make_slam_streaming(cfg, fx, fy, cx_, cy_, mesh,
                                       keyframe_min_inliers=40,
                                       keyframe_max_gap=4)
        states = dist.batch_slam_states(cfg, n)
        frames = rng.integers(
            0, 256, (n, slam_t, pyr.base_height, pyr.base_width), np.uint8)
        fr = jax.device_put(frames)
        out = run(states, fr)
        jax.block_until_ready(out)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = run(states, fr)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        sl_results[n] = (n * slam_t) / float(np.median(times))

    sl_base = sl_results[sizes[0]]
    report = {
        "metric": "multi_session_slam_weak_scaling",
        "platform": jax.default_backend(),
        "frames_per_stream": slam_t,
        "frames_per_s": {str(n): round(v, 2) for n, v in sl_results.items()},
        "efficiency": {
            str(n): round(sl_results[n] / (sl_base * n), 3) for n in sizes},
    }
    if jax.default_backend() == "cpu":
        report["sharding_overhead_vs_1dev"] = {
            str(n): round(sl_base / sl_results[n], 3) for n in sizes}
        report["note"] = ("cpu virtual devices share cores; see "
                          "sharding_overhead_vs_1dev (ideal 1.0), not "
                          "efficiency")
    print(json.dumps(report))

    # ---- distributed BA weak scaling: GN iterations/s over the mesh ----
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    from test_backend import synthetic_ba

    iters = 6
    pts_per_shard = 128
    ba_results = {}
    for n in sizes:
        prob, _ = synthetic_ba(nc=8, npts=n * pts_per_shard, seed=3,
                               pad_obs=64)
        mesh = meshmod.make_mesh(
            MeshConfig(data_parallel=1, model_parallel=n),
            devices=jax.devices()[:n])
        sharded = dist.shard_ba_problem(prob, n)
        run = dist.make_distributed_ba(mesh, iters=iters, damping=1e-3)
        out = run(sharded)
        jax.block_until_ready(out)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = run(sharded)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        ba_results[n] = iters / float(np.median(times))

    ba_base = ba_results[sizes[0]]
    report = {
        "metric": "distributed_ba_weak_scaling",
        "platform": jax.default_backend(),
        "points_per_shard": pts_per_shard,
        "ba_iters_per_s": {str(n): round(v, 2)
                           for n, v in ba_results.items()},
        "slowdown_vs_1dev": {
            str(n): round(ba_base / ba_results[n], 3) for n in sizes},
    }
    if jax.default_backend() == "cpu":
        report["note"] = (
            "weak scaling (total landmarks grow with devices) on virtual "
            "devices sharing cores: ideal slowdown_vs_1dev = N; values "
            "<= N mean the psum Schur reduction adds no overhead. On real "
            "hardware ideal = 1.0 (run with --real on a slice).")
    print(json.dumps(report))

    # ---- sharded-map matching weak scaling: map grows with devices ----
    # (the KeyframeSLAM(mesh=...) loop-closure/relocalisation matmul:
    # database rows sharded over the model axis, one all_gather merge)
    k1 = 512
    db_per_shard = 4096
    match_results = {}
    for n in sizes:
        mesh = meshmod.make_mesh(
            MeshConfig(data_parallel=1, model_parallel=n),
            devices=jax.devices()[:n])
        run = dist.make_sharded_match(mesh, max_distance=64, ratio=0.8,
                                      cross_check=True)
        qa = rng.integers(0, 2**31, (k1, 8),
                          dtype=np.int64).astype(np.uint32)
        db = rng.integers(0, 2**31, (n * db_per_shard, 8),
                          dtype=np.int64).astype(np.uint32)
        args = (jax.device_put(qa), jax.device_put(db),
                jax.device_put(np.ones(k1, bool)),
                jax.device_put(np.ones(n * db_per_shard, bool)))
        out = run(*args)
        jax.block_until_ready(out)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = run(*args)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        match_results[n] = 1.0 / float(np.median(times))

    mbase = match_results[sizes[0]]
    report = {
        "metric": "sharded_map_match_weak_scaling",
        "platform": jax.default_backend(),
        "queries": k1,
        "db_rows_per_shard": db_per_shard,
        "matches_per_s": {str(n): round(v, 2)
                          for n, v in match_results.items()},
        "slowdown_vs_1dev": {
            str(n): round(mbase / match_results[n], 3) for n in sizes},
    }
    if jax.default_backend() == "cpu":
        report["note"] = (
            "weak scaling (map grows with devices, per-shard work fixed) "
            "on virtual devices sharing cores: ideal slowdown_vs_1dev = 1 "
            "here because per-device FLOPs are constant; values near 1 "
            "mean the all_gather merge adds no overhead.")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
