"""On-device image pyramid construction.

The reference treats pyramid building as out-of-scope for the CPU ("The
Raspberry Pi GPU is better suited for this task", README.md:28-31) and ships
only the kernels (gaussian5x5, bilinear7_8/13_16). This build brings the
whole pyramid on-device (SURVEY.md section 1): one jitted function takes a
camera frame and emits the stacked (total_height, stride) uint8 buffer the
frontend consumes, with the demo's exact level table round(base*(5/6)^l)
(demo.cpp:38-47).

Two builders:

* build_pyramid      -- general path: 5x5 blur + exact-ratio bilinear resize
                        per level (resize semantics in ops/bilinear.py).
* build_pyramid_fast -- the reference's own suggested scheme (Bilinear.h:28-31,
                        :153): chain 7/8 and 13/16 reductions, whose byte-exact
                        kernels we have, picking at each level whichever ratio
                        lands closer to the demo level table. Level sizes then
                        deviate slightly from round(w*(5/6)^l); returned
                        geometry reflects the actual sizes.
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp

from ..config import PyramidConfig, round_up
from .bilinear import bilinear7_8, bilinear13_16, resize_bilinear
from .gaussian import gaussian5x5


def build_pyramid(frame, cfg: PyramidConfig):
    """(base_height, base_width) uint8 frame -> stacked pyramid buffer.

    Per level: blur the previous level with the exact 5x5 binomial, then
    bilinear-resize to the level table size. Returns
    (padded_height, stride) uint8.
    """
    assert frame.shape == (cfg.base_height, cfg.base_width), (
        f"expected {(cfg.base_height, cfg.base_width)}, got {frame.shape}"
    )
    sizes = cfg.level_sizes
    levels = [frame]
    for lvl in range(1, cfg.num_levels):
        w, h = sizes[lvl]
        prev = gaussian5x5(levels[-1])
        levels.append(resize_bilinear(prev, h, w))
    return stack_levels(levels, cfg)


def plan_fast_chain(cfg: PyramidConfig) -> List[Tuple[str, Tuple[int, int]]]:
    """Static plan for the 7/8 / 13/16 chain: per level, which kernel and the
    resulting (w, h). Chooses the ratio whose width lands nearer the demo
    table (greedy, like chaining 7/8 and 13/16 to approximate 1.2x steps,
    Bilinear.h:28-31)."""
    plan = [("keep", (cfg.base_width, cfg.base_height))]
    w, h = cfg.base_width, cfg.base_height
    for lvl in range(1, cfg.num_levels):
        tw = cfg.level_sizes[lvl][0]
        w78 = w * 7 // 8
        w1316 = w * 13 // 16
        if abs(w78 - tw) <= abs(w1316 - tw):
            w, h = w * 7 // 8, h * 7 // 8
            plan.append(("7/8", (w, h)))
        else:
            w, h = w * 13 // 16, h * 13 // 16
            plan.append(("13/16", (w, h)))
    return plan


def build_pyramid_fast(frame, cfg: PyramidConfig):
    """Chain the byte-exact 7/8 and 13/16 kernels (after 5x5 blur per level).

    Returns (stacked_buffer, actual_level_sizes). Input dims are padded to
    multiples of 16 internally (kernel contract, Bilinear.h:32, :155).
    """
    plan = plan_fast_chain(cfg)
    levels = [frame]
    w, h = cfg.base_width, cfg.base_height
    cur = frame
    for kind, (nw, nh) in plan[1:]:
        blurred = gaussian5x5(cur)
        ph, pw = round_up(h, 16), round_up(w, 16)
        padded = jnp.pad(blurred, ((0, ph - h), (0, pw - w)), mode="edge")
        out = bilinear7_8(padded) if kind == "7/8" else bilinear13_16(padded)
        cur = out[:nh, :nw]
        w, h = nw, nh
        levels.append(cur)
    sizes = tuple((lv.shape[1], lv.shape[0]) for lv in levels)
    return stack_levels(levels, cfg, sizes), sizes


def stack_levels(levels, cfg: PyramidConfig, sizes=None):
    """Stack per-level images into the (padded_height, stride) buffer."""
    sizes = sizes or cfg.level_sizes
    total = sum(h for _, h in sizes)
    rows = []
    for img, (w, h) in zip(levels, sizes):
        assert img.shape == (h, w), (img.shape, (h, w))
        rows.append(jnp.pad(img, ((0, 0), (0, cfg.stride - w))))
    out = jnp.concatenate(rows, axis=0)
    pad = round_up(total, 8) - total
    if pad:
        out = jnp.pad(out, ((0, pad), (0, 0)))
    return out
