"""Worker for the two-process multi-host test (tests/test_multiprocess.py).

Run as:  python tests/multiproc_worker.py <port> <process_id> <scratch_dir>

This is the one place where `parallel.elastic.initialize_multihost` (the
actual jax.distributed bootstrap) executes for real: two local processes,
each with 4 virtual CPU devices, join one 8-device JAX runtime over a
localhost coordinator and run

  * data-parallel extraction over a 2x4 ("data" x "model") global mesh,
    checked bit-exact against the same frame extracted process-locally,
  * cross-shard Hamming matching (all_gather over the model axis, now
    crossing the process/DCN boundary), checked against local matching,
  * model-parallel distributed BA (psum Schur reductions across processes),
  * CheckpointedRunner.resume with NON-shared checkpoint dirs: process 0
    restores steps_done=7 from disk, process 1 has nothing, and the
    broadcast (parallel/elastic.py) must land both at 7.

The reference has no multi-process anything (SURVEY.md section 2: no
threads/MPI/NCCL; CMakeLists.txt:18-25); this path is pure north-star
surface (BASELINE.json configs[4]). Prints "MULTIHOST_OK {json}" on success.
"""

import json
import os
import sys

PORT, PID, SCRATCH = sys.argv[1], int(sys.argv[2]), sys.argv[3]

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# CPU cross-process collectives ride gloo (the CPU stand-in for NCCL)
jax.config.update("jax_cpu_collectives_implementation", "gloo")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from pislam_tpu.parallel.elastic import (CheckpointedRunner,  # noqa: E402
                                         initialize_multihost)


def main():
    idx = initialize_multihost(f"localhost:{PORT}", num_processes=2,
                               process_id=PID)
    assert idx == PID, (idx, PID)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, jax.devices()
    assert len(jax.local_devices()) == 4, jax.local_devices()

    from pislam_tpu import matching
    from pislam_tpu.backend import ba
    from pislam_tpu.config import (FrontendConfig, MeshConfig, PislamConfig,
                                   PyramidConfig)
    from pislam_tpu.frontend import make_extract_fn
    from pislam_tpu.parallel import dist, mesh as meshmod

    # data axis (size 2) spans the two processes: devices 0-3 live on
    # process 0, 4-7 on process 1, and make_mesh lays "data" out major
    mesh = meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=4))

    def globalize(x, spec):
        """Every process holds the same full host array; build the global
        sharded jax.Array from its local pieces."""
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, sh, lambda i: x[i])

    pyr = PyramidConfig(base_width=64, base_height=48, num_levels=1)
    fe = FrontendConfig(fast_threshold=10, harris_threshold=1,
                        border=16, max_keypoints=32)
    cfg = PislamConfig(pyramid=pyr, frontend=fe)

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, pyr.padded_height, pyr.stride),
                          dtype=np.uint8)

    # --- data-parallel extraction across the process boundary ------------
    batch_extract = dist.make_batch_extract(cfg, mesh)
    feats = batch_extract(globalize(frames, P("data", None, None)))
    codes = np.asarray(
        jax.experimental.multihost_utils.process_allgather(
            feats.codes, tiled=True)).reshape(2, -1)
    # bit-exact vs the same frames extracted process-locally (no mesh)
    local = make_extract_fn(cfg)
    for b in range(2):
        ref = np.asarray(local(frames[b]).codes)
        assert np.array_equal(codes[b], ref), f"frame {b} diverged"

    # --- cross-shard matching: all_gather crosses the DCN boundary -------
    d0 = rng.integers(0, 2**32, (32, 8), dtype=np.uint32)
    d1 = rng.integers(0, 2**32, (32, 8), dtype=np.uint32)
    v = np.ones(32, bool)
    idx_ref, _ = jax.jit(matching.match)(d0, d1, v, v)
    smatch = dist.make_sharded_match(mesh)
    idx_s, _ = smatch(globalize(d0, P()), globalize(d1, P("model", None)),
                      globalize(v, P()), globalize(v, P("model")))
    idx_s = np.asarray(idx_s.addressable_data(0))  # replicated output
    assert np.array_equal(idx_s, np.asarray(idx_ref)), \
        "sharded matcher diverged across processes"

    # --- model-parallel BA: psum Schur reductions over 2 processes --------
    C, Pn = 3, 32
    X = rng.uniform([-1, -1, 4], [1, 1, 8], (Pn, 3)).astype(np.float32)
    Rs = np.broadcast_to(np.eye(3, dtype=np.float32), (C, 3, 3)).copy()
    ts = np.stack([np.float32([0.2 * c, 0, 0]) for c in range(C)])
    cams, pts, uvs = [], [], []
    for c in range(C):
        xc = X @ Rs[c].T + ts[c]
        uv = xc[:, :2] / xc[:, 2:]
        for p in range(Pn):
            cams.append(c)
            pts.append(p)
            uvs.append(uv[p])
    prob = ba.BAProblem(
        R=jnp.asarray(Rs), t=jnp.asarray(ts + 0.01),
        points=jnp.asarray(X + 0.02),
        obs_cam=jnp.asarray(np.int32(cams)), obs_pt=jnp.asarray(np.int32(pts)),
        obs_uv=jnp.asarray(np.float32(uvs)),
        obs_valid=jnp.ones(C * Pn, bool),
        cam_valid=jnp.ones(C, bool), pt_valid=jnp.ones(Pn, bool))
    sharded = dist.shard_ba_problem(prob, 4)
    spec = ba.BAProblem(
        R=P(), t=P(), points=P("model", None),
        obs_cam=P("model"), obs_pt=P("model"), obs_uv=P("model", None),
        obs_valid=P("model"), cam_valid=P(), pt_valid=P("model"))
    gprob = jax.tree.map(globalize, sharded, spec,
                         is_leaf=lambda x: x is None)
    run_ba = dist.make_distributed_ba(mesh, iters=2, damping=1e-3)
    _out, info = run_ba(gprob)
    costs = np.asarray(info["costs"].addressable_data(0))  # replicated
    c0, c1 = float(costs.reshape(-1)[0]), float(costs.reshape(-1)[-1])
    assert np.isfinite(c1) and c1 < c0, (c0, c1)

    # --- CheckpointedRunner: steps_done broadcast across the boundary ----
    my_dir = os.path.join(SCRATCH, f"proc{PID}")
    state0 = {"x": jnp.arange(4, dtype=jnp.float32)}
    runner = CheckpointedRunner(lambda s, i: s, my_dir, every=100)
    if PID == 0:
        runner.steps_done = 7
        runner._save(state0)  # jnp state: checkpoint.save host-ifies it
    # all processes wait for the file to exist before resuming
    jax.experimental.multihost_utils.sync_global_devices("ckpt written")
    fresh = CheckpointedRunner(lambda s, i: s, my_dir, every=100)
    fresh.resume(state0)
    assert fresh.steps_done == 7, \
        f"proc {PID}: steps_done {fresh.steps_done} != 7 (broadcast failed)"

    print("MULTIHOST_OK", json.dumps({
        "process": PID, "processes": jax.process_count(),
        "devices": len(jax.devices()), "ba_cost": [c0, c1],
        "steps_done": fresh.steps_done}), flush=True)


if __name__ == "__main__":
    main()
