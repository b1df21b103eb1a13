"""End-to-end demo driver: the reference demo.cpp equivalent.

Usage:
    python -m pislam_tpu.demo PYRAMID.png [--out out.png]
    python -m pislam_tpu.demo FRAME.png --build-pyramid [--out out.png]

First form consumes a pre-stacked 640x2210 pyramid PNG (the reference's demo
input, demo.cpp:51-68). Second form takes a single 640x480 frame and builds
the 8-level pyramid on-device (the step the reference outsourced to the Pi
GPU, README.md:28-31). Either way: run the jitted ORB frontend, paint crosses
at the keypoints (demo.cpp:119-130 pattern), write the output PNG, and print
extraction time + feature count (demo.cpp:113-114).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def paint_point(img: np.ndarray, x: int, y: int):
    """Cross marker, same strokes as reference paintPoint (demo.cpp:119-130)."""
    h, w = img.shape
    for dy in (-5, -4, 4, 5):
        if 0 <= y + dy < h:
            img[y + dy, x] = 0
    for dx in (-5, -4, 4, 5):
        if 0 <= x + dx < w:
            img[y, x + dx] = 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="stacked pyramid PNG or single frame PNG")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--build-pyramid", action="store_true",
                    help="input is a single frame; build the pyramid on-device")
    ap.add_argument("--threshold", type=int, default=20)
    ap.add_argument("--harris-threshold", type=int, default=1 << 15)
    ap.add_argument("--max-keypoints", type=int, default=2048)
    args = ap.parse_args(argv)

    from .utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    import pislam_tpu
    from pislam_tpu.config import FrontendConfig, PislamConfig, PyramidConfig
    from pislam_tpu.io import read_png, write_png
    from pislam_tpu.ops import pyramid as pyr_ops

    img = read_png(args.input)
    pc = PyramidConfig()
    cfg = PislamConfig(
        pyramid=pc,
        frontend=FrontendConfig(
            fast_threshold=args.threshold,
            harris_threshold=args.harris_threshold,
            max_keypoints=args.max_keypoints,
        ),
    )

    if args.build_pyramid:
        assert img.shape == (pc.base_height, pc.base_width), (
            f"frame must be {pc.base_height}x{pc.base_width}, got {img.shape}")
        build = jax.jit(lambda f: pyr_ops.build_pyramid(f, pc))
        stack = build(jnp.asarray(img))
    else:
        assert img.shape == (pc.total_height, pc.base_width), (
            f"pyramid must be {pc.total_height}x{pc.base_width}, got {img.shape}")
        buf = np.zeros((pc.padded_height, pc.stride), np.uint8)
        buf[: img.shape[0], : img.shape[1]] = img
        stack = jnp.asarray(buf)

    extract = pislam_tpu.make_extract_fn(cfg)
    jax.block_until_ready(extract(stack))  # compile + warm

    t0 = time.perf_counter()
    feats = jax.block_until_ready(extract(stack))
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    valid = np.asarray(feats.valid)

    xs = np.asarray(feats.xs)[valid]
    ys = np.asarray(feats.ys)[valid]

    out = np.asarray(stack)[: pc.total_height, : pc.base_width].copy()
    for x, y in zip(xs.tolist(), ys.tolist()):
        paint_point(out, x, y)
    write_png(args.out, out)

    d = jax.devices()[0]
    print(f"{d.platform} ({d.device_kind}) time: {elapsed_ms:.3f} ms")
    print(f"{int(valid.sum())} features")
    return 0


if __name__ == "__main__":
    sys.exit(main())
