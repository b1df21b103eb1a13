"""Stage profile of the on-device pyramid build on the GPU.

    python tools/profile_pyramid.py

Times the full 8-level VGA build and its parts (5x5 blur, one resize step,
the 7/8 kernel, the level stacking) on io.datasets.texture_frame: each the
median of 50 jitted calls ended by block_until_ready. Prints the card
first; fails without a GPU.
"""
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pislam_tpu.config import PyramidConfig  # noqa: E402
from pislam_tpu.io.datasets import texture_frame  # noqa: E402
from pislam_tpu.ops.bilinear import bilinear7_8, resize_bilinear  # noqa: E402
from pislam_tpu.ops.gaussian import gaussian5x5  # noqa: E402
from pislam_tpu.ops.pyramid import build_pyramid, stack_levels  # noqa: E402
from pislam_tpu.utils.cache import enable_compile_cache  # noqa: E402
from pislam_tpu.utils.profiling import median_ms, require_gpu  # noqa: E402


def main():
    print(require_gpu())
    enable_compile_cache()
    cfg = PyramidConfig()
    frame = jax.device_put(texture_frame(cfg.base_width, cfg.base_height))
    levels = [jnp.zeros((h, w), jnp.uint8) for (w, h) in cfg.level_sizes]
    stages = {
        "build_pyramid (full, 8 levels)": (
            lambda x: build_pyramid(x, cfg), frame),
        "gaussian5x5 VGA": (gaussian5x5, frame),
        "resize VGA->533x400": (lambda x: resize_bilinear(x, 400, 533), frame),
        "bilinear7_8 VGA": (bilinear7_8, frame),
        "stack_levels (pad+concat)": (
            lambda lv: stack_levels(lv, cfg), levels),
    }
    for name, (fn, arg) in stages.items():
        print(f"{name:36s} {median_ms(jax.jit(fn), arg, reps=50):8.4f} ms")


if __name__ == "__main__":
    main()
