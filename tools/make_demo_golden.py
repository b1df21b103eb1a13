"""Generate the demo-pyramid golden artifact from the literal oracles.

Runs the per-pixel reference-semantics oracle chain (tests/oracles.py:
fast_detect -> fast_score_harris -> fast_extract -> centroid -> atan2_bin ->
brief_describe) ONCE over the real demo pyramid
(/root/reference/demo/input.png, 640x2210, 8 VGA levels stacked), exactly as
the reference demo binary does per level (demo.cpp:78-101: per-level
detect/score/extract with y-offset re-encode, then one whole-pyramid
orbCompute), and writes the keypoints + angle bins + descriptors to
tests/golden/demo_golden.npz.

tests/test_demo_golden.py then asserts the production pipeline
reproduces this byte-for-byte -- the grounded version of the reference's
de-facto integration test (its demo binary's output).

Usage: python tools/make_demo_golden.py
"""

import os
import sys
import time

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import oracles  # noqa: E402
from pislam_tpu.config import PislamConfig  # noqa: E402

DEMO = "/root/reference/demo/input.png"
OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden",
                   "demo_golden.npz")

FAST_THRESHOLD = 20       # demo.cpp:85
HARRIS_THRESHOLD = 1 << 15  # demo.cpp:86
BORDER = 16               # demo.cpp template arg
WORDS = 8                 # demo.cpp:101 orbCompute<640, 8>


def main():
    img = np.asarray(Image.open(DEMO).convert("L"))
    assert img.shape == (2210, 640), img.shape
    cfg = PislamConfig()
    pc = cfg.pyramid

    codes = []
    t0 = time.time()
    for (w, h), row in zip(pc.level_sizes, pc.level_rows):
        lvl = img[row:row + h, :w]
        mask = oracles.fast_detect(lvl, FAST_THRESHOLD, BORDER)
        scored = oracles.fast_score_harris(lvl, mask, HARRIS_THRESHOLD,
                                           BORDER)
        kps = oracles.fast_extract(scored, BORDER)
        # re-encode y += level row, as demo.cpp:92-97
        codes.extend((c & 0xFFFFF000) | ((c & 0xFFF) + row) for c in kps)
        print(f"level {w}x{h} @ row {row}: {len(kps)} keypoints "
              f"({time.time() - t0:.1f}s)", flush=True)

    n = len(codes)
    print(f"total {n} keypoints")
    angles = np.zeros(n, np.uint8)
    descs = np.zeros((n, WORDS), np.uint32)
    for i, c in enumerate(codes):
        x = (c >> 12) & 0xFFF
        y = c & 0xFFF
        m10, m01 = oracles.centroid(img, x, y)
        rot = oracles.atan2_bin(m10, m01)
        angles[i] = rot
        descs[i] = oracles.brief_describe(img, x, y, rot, WORDS)
        if i % 200 == 0:
            print(f"desc {i}/{n} ({time.time() - t0:.1f}s)", flush=True)

    codes = np.asarray(codes, np.uint32)
    order = np.argsort(codes)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT, codes=codes[order], angles=angles[order], descriptors=descs[order],
        fast_threshold=FAST_THRESHOLD, harris_threshold=HARRIS_THRESHOLD,
        border=BORDER, words=WORDS)
    print(f"wrote {OUT}: {n} keypoints in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
