"""SLAM tracking throughput on the GPU: the device-resident scan.

    python tools/bench_slam.py

Times make_slam_track_scan (full tracking: pyramid + extraction + match vs
last keyframe + RANSAC + map PnP + conditional keyframe insertion) over the
committed 48-frame eval sequence from a fresh state. One call processes the
whole sequence and ends in block_until_ready; the value is the median of
20 calls after a warm-up, divided by the frame count. Window BA runs at
keyframe rate on the host and is excluded -- this is the tracking rate a
serving deployment sees between BA refinements. Prints the card, then one
JSON line. Fails without a GPU.
"""
import json
import os
import sys

import numpy as np
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from pislam_tpu.models.slam import init_state  # noqa: E402
from pislam_tpu.models.slam_scan import make_slam_track_scan  # noqa: E402
from pislam_tpu.utils.profiling import median_ms, require_gpu  # noqa: E402


def main():
    card = require_gpu()
    from eval_ate import slam_config  # enables the compile cache

    d = np.load(os.path.join(REPO, "data", "eval_seq.npz"))
    frames = d["frames"]
    cfg = slam_config(frames.shape[2], frames.shape[1])
    run = make_slam_track_scan(
        cfg, float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
        keyframe_min_inliers=60, keyframe_max_gap=3)
    ms = median_ms(run, init_state(cfg), jnp.asarray(frames)) \
        / frames.shape[0]
    print(card)
    print(json.dumps({"metric": "slam_track_scan_fps",
                      "value": round(1e3 / ms, 1), "unit": "frames/s",
                      "ms_per_frame": round(ms, 4),
                      "frames": int(frames.shape[0]),
                      "resolution": f"{frames.shape[2]}x{frames.shape[1]}",
                      "card": card}))


if __name__ == "__main__":
    main()
