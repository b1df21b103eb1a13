"""VO throughput on the GPU: the device-resident sequence scan (make_vo_scan).

    python tools/bench_vo.py

Times the whole VO pipeline (pyramid + extraction + matching +
256-hypothesis RANSAC + pose chaining) as one lax.scan over the committed
48-frame eval sequence (384x256, 4-level pyramid, tools/eval_ate.
slam_config). One call processes the whole sequence and ends in
block_until_ready; the value is the median of 20 calls after a warm-up,
divided by the frame count. Prints the card, then one JSON line. Fails
without a GPU.
"""
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from pislam_tpu.models.visual_odometry import make_vo_scan  # noqa: E402
from pislam_tpu.utils.profiling import median_ms, require_gpu  # noqa: E402


def main():
    card = require_gpu()
    from eval_ate import slam_config  # enables the compile cache

    d = np.load(os.path.join(REPO, "data", "eval_seq.npz"))
    frames = d["frames"]
    cfg = slam_config(frames.shape[2], frames.shape[1])
    run = make_vo_scan(cfg, float(d["fx"]), float(d["fy"]), float(d["cx"]),
                       float(d["cy"]))
    ms = median_ms(run, jnp.asarray(frames), jax.random.PRNGKey(0)) \
        / frames.shape[0]
    print(card)
    print(json.dumps({"metric": "vo_scan_fps", "value": round(1e3 / ms, 1),
                      "unit": "frames/s", "ms_per_frame": round(ms, 4),
                      "frames": int(frames.shape[0]),
                      "resolution": f"{frames.shape[2]}x{frames.shape[1]}",
                      "card": card}))


if __name__ == "__main__":
    main()
