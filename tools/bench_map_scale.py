"""Map-tracking cost vs map size on the GPU.

    python tools/bench_map_scale.py [sizes_csv]

Times ``track_map_state`` -- the production per-frame local-map tracking
stage (projection-gated match against ALL landmark descriptors +
motion-only-BA PnP, models/slam.py:track_map_state) -- at landmark
capacities 16384 / 65536 / 131072 with the K=512 serving frontend config.
Each size: the median of 20 jitted calls ended by block_until_ready.

The map is synthetic (seeded) but exercised honestly: 400 of the 512 query
features are true views (descriptor + sub-gate-radius reprojection) of
randomly chosen landmarks, the rest junk; each size's tracked pose must
recover >= 300 PnP inliers before it is timed, so the timed path is the one
production takes (gate hit, ratio test, motion-only BA convergence), not a
degenerate all-miss short-circuit. Prints the card, then one JSON line.
Fails without a GPU.
"""
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pislam_tpu.backend import keyframes as kfs  # noqa: E402
from pislam_tpu.config import PislamConfig  # noqa: E402
from pislam_tpu.frontend import Features  # noqa: E402
from pislam_tpu.models.slam import track_map_state  # noqa: E402
from pislam_tpu.utils.cache import enable_compile_cache  # noqa: E402
from pislam_tpu.utils.profiling import median_ms, require_gpu  # noqa: E402

K = 512
WORDS = 8
N_TRUE = 400


def make_case(n_lm, seed=0):
    """(lmap, feats, pts, R0, t0) with 400/512 query features being true
    gated views of random landmarks, per the module docstring."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n_lm, 3), np.float32)
    xyz[:, 0] = rng.uniform(-3, 3, n_lm)
    xyz[:, 1] = rng.uniform(-2, 2, n_lm)
    xyz[:, 2] = rng.uniform(4, 8, n_lm)
    desc = rng.integers(0, 2**31, (n_lm, WORDS),
                        dtype=np.int64).astype(np.uint32)
    lmap = kfs.empty_map(n_lm, WORDS)._replace(
        xyz=jnp.asarray(xyz), descriptors=jnp.asarray(desc),
        valid=jnp.ones(n_lm, bool),
        obs_count=jnp.full(n_lm, 8, jnp.int32))
    pick = rng.choice(n_lm, N_TRUE, replace=False)
    uv_true = xyz[pick, :2] / xyz[pick, 2:3]
    fdesc = rng.integers(0, 2**31, (K, WORDS),
                         dtype=np.int64).astype(np.uint32)
    fdesc[:N_TRUE] = desc[pick]
    pts = rng.uniform(-0.4, 0.4, (K, 2)).astype(np.float32)
    pts[:N_TRUE] = uv_true + rng.normal(0, 0.002, (N_TRUE, 2))
    feats = Features(codes=jnp.zeros(K, jnp.uint32),
                     valid=jnp.ones(K, bool),
                     angles=jnp.zeros(K, jnp.uint8),
                     descriptors=jnp.asarray(fdesc))
    return lmap, feats, jnp.asarray(pts), jnp.eye(3), jnp.zeros(3)


def main():
    card = require_gpu()
    enable_compile_cache()
    sizes = [int(s) for s in sys.argv[1].split(",")] if len(sys.argv) > 1 \
        else [16384, 65536, 131072]
    import dataclasses as dc
    cfg = PislamConfig()
    cfg = dc.replace(cfg, map=dc.replace(cfg.map, gate_radius=0.06))
    track = jax.jit(lambda *a: track_map_state(cfg, *a))

    out = {}
    for n_lm in sizes:
        lmap, feats, pts, R0, t0 = make_case(n_lm)
        args = (lmap, feats, pts, jnp.asarray(R0, jnp.float32),
                jnp.asarray(t0, jnp.float32))
        # honesty gate: the timed path must actually track
        n = int(track(*args)[2])
        assert n >= 300, (n_lm, n)
        out[f"{n_lm}lm"] = round(median_ms(track, *args), 4)
        print(f"{n_lm:7d} landmarks: {n} PnP inliers, {out[f'{n_lm}lm']} ms")
    print(card)
    print(json.dumps({
        "metric": "map_tracking_ms_per_frame", "value": out,
        "unit": "ms/frame (gated match + motion-only BA, K1=512)",
        "card": card}))


if __name__ == "__main__":
    main()
