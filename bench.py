"""Headline benchmark: VGA ORB extraction frames/s on one GPU.

Prints the card (device kind, nvidia-smi name and power limit), then ONE
JSON line: {"metric", "value", "unit", "vs_baseline", "device", "card"}.

Baseline: the reference extracts ~1000-1900 ORB features from a VGA 8-level
pyramid in ~19.5-24 ms on a Raspberry Pi 3 single core (BASELINE.md,
doc/frame_times.png) ~= 50 fps. vs_baseline = our fps / 50.

Measures the full jitted frontend (FAST + Harris + NMS + top-K + orientation
+ BRIEF-256) at the demo thresholds on an 8-level pyramid built on the card
from io.datasets.texture_frame (real texture from the committed sequences).
Each timed call ends in block_until_ready; the value is the median of 50
calls after a warm-up. Fails when JAX finds no GPU.
"""

import json
import sys

import jax

from pislam_tpu.utils.cache import enable_compile_cache


def main():
    from pislam_tpu.utils.profiling import median_ms, require_gpu

    card = require_gpu()
    enable_compile_cache()
    import pislam_tpu
    from pislam_tpu.io.datasets import texture_frame
    from pislam_tpu.ops import pyramid

    cfg = pislam_tpu.PislamConfig()
    stack = jax.jit(lambda f: pyramid.build_pyramid(f, cfg.pyramid))(
        jax.device_put(texture_frame()))
    extract = pislam_tpu.make_extract_fn(cfg)
    nfeat = int(extract(stack).num_valid)
    ms = median_ms(extract, stack, reps=50)
    fps = 1e3 / ms

    pi3_fps = 50.0  # BASELINE.md: ~20 ms/frame at ~1000-1900 features
    d = jax.devices()[0]
    print(card)
    print(json.dumps({
        "metric": "vga_orb_extract_fps",
        "value": round(fps, 1),
        "unit": f"frames/s (8-level VGA pyramid, {nfeat} feats, 256-bit; "
                f"median of 50, ms/frame {ms:.4f})",
        "vs_baseline": round(fps / pi3_fps, 2),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
