"""Streaming-sequence benchmark on the GPU: BASELINE.json configs[1].

    python tools/bench_streaming.py [--frames DIR] [--n 200]

200-frame VGA sequence -> per frame, ALL on device: 8-level pyramid build
(5x5 binomial blur + exact-ratio bilinear resize) + ORB extraction + Hamming
matching against the previous frame. The whole sequence runs as one
jax.lax.scan, so the number reported is steady-state device throughput with
zero host round-trips -- the production streaming configuration. The value
is the median of 7 whole-sequence calls (each ended by block_until_ready)
divided by the frame count.

Frames: a real image directory if --frames is given (New College style),
otherwise a moving crop (~1 px/frame) of a tiled io.datasets.texture_frame
(committed real texture at VGA). Fails without a GPU.

Reference point: the Pi 3 runs extraction at ~20 ms/frame and external FLANN
matching at <20 ms/frame (README.md:114, :125-128) => ~25 fps for this
pipeline, pyramid build not included (delegated to the Pi GPU).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pislam_tpu.utils.cache import enable_compile_cache  # noqa: E402
from pislam_tpu.utils.profiling import median_ms, require_gpu  # noqa: E402


def synthetic_sequence(n_frames: int, h: int, w: int) -> np.ndarray:
    """Moving crop of a 2x2-tiled texture frame: real texture, ~1 px/frame."""
    from pislam_tpu.io.datasets import texture_frame

    src = texture_frame(w, h)
    big = np.concatenate([np.concatenate([src, src], 1)] * 2, 0)
    frames = np.zeros((n_frames, h, w), np.uint8)
    for i in range(n_frames):
        frames[i] = big[i % h: i % h + h, i % w: i % w + w]
    return frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", default=None,
                    help="image directory (sorted *.png); default synthetic")
    ap.add_argument("--n", type=int, default=200)
    args = ap.parse_args()
    card = require_gpu()
    enable_compile_cache()

    from pislam_tpu.config import PislamConfig
    from pislam_tpu.frontend import _extract_impl
    from pislam_tpu import matching
    from pislam_tpu.ops import nms, pyramid as pyr_ops

    cfg = PislamConfig()
    pc = cfg.pyramid
    mc = cfg.matcher

    if args.frames:
        from pislam_tpu.io.datasets import image_dir
        stream = image_dir(args.frames)
        frames = np.stack([f for _, f in zip(range(args.n), stream)])
    else:
        frames = synthetic_sequence(args.n, pc.base_height, pc.base_width)

    mask = jnp.asarray(nms.make_level_mask(
        pc.level_sizes, pc.level_rows, pc.padded_height, pc.stride,
        cfg.frontend.border))

    def frontend(frame):
        stack = pyr_ops.build_pyramid(frame, pc)
        return _extract_impl(stack, mask, cfg)

    def step(prev, frame):
        feats = _frontend(frame)
        idx2, dist = matching.match(
            prev.descriptors, feats.descriptors, prev.valid, feats.valid,
            max_distance=mc.max_distance, ratio=mc.ratio,
            cross_check=mc.cross_check)
        n = jnp.sum(idx2 >= 0)
        return feats, (feats.num_valid, n)

    _frontend = frontend

    @jax.jit
    def run_sequence(frames):
        f0 = _frontend(frames[0])
        _, (nfeats, nmatches) = jax.lax.scan(step, f0, frames[1:])
        return nfeats, nmatches

    fr = jnp.asarray(frames)
    nf, nm = run_sequence(fr)
    nf_np, nm_np = np.asarray(nf), np.asarray(nm)
    per = median_ms(run_sequence, fr, reps=7) / 1e3 / len(frames)

    print(card)
    print(json.dumps({
        "metric": "streaming_pyramid_extract_match_fps",
        "value": round(1.0 / per, 1),
        "unit": (f"frames/s ({len(frames)} VGA frames, 8-level pyramid build"
                 f" + ORB-256 + Hamming match; avg {nf_np.mean():.0f} feats,"
                 f" {nm_np.mean():.0f} matches/frame)"),
        "vs_baseline": round((1.0 / per) / 25.0, 2),
        "card": card,
    }))


if __name__ == "__main__":
    main()
