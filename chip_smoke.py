#!/usr/bin/env python3
"""Smoke test of the main paths on the GPU, each checked against the CPU.

    python chip_smoke.py            # phases 0-3 on one GPU
    python chip_smoke.py --multi    # the sharded paths on four GPUs

Phases (one GPU):
  0. device: fail at once unless JAX runs on a GPU; print the card.
  1. VGA extraction with the default PislamConfig (8 levels, 2048
     keypoints) on a 640x480 frame of committed texture
     (io.datasets.texture_frame): the pyramid is
     built on the card, then make_extract_fn runs. Codes, validity, angles
     and descriptors must equal the same jitted functions run on the CPU in
     this process, bit for bit (the frontend is integer throughout).
  2. matching.match and matching.match_gated (radius 0.06) at 2048 x 8192,
     bit for bit against the CPU.
  3. the SLAM service on all 48 frames of data/eval_seq.npz (host loop and
     --chunk 8), then KeyframeSLAM + close_loop, against the accuracy pins
     of tests/test_service.py and tests/test_eval_sequence.py.

--multi (four GPUs): the service with --model-parallel 4 against one card
(10 frames, as tests/test_service.py does),
sharded matching (ungated and gated) against matching.match[_gated] bit for
bit, distributed BA (dense and CG) on 4 cards against 1, and
__graft_entry__.dryrun_multichip(4).

Progress goes to stdout; the last line is one JSON object
{"ok": true, "device": {...}}, printed only when every phase passed. Any
failed phase makes the exit code 1.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEQ = os.path.join(REPO, "data", "eval_seq.npz")

# recorded CPU figures (tests/test_eval_sequence.py,
# test_committed_sequence_slam_with_loop_closure)
CPU_KF_ATE_PRE, CPU_KF_ATE_POST = 0.1015, 0.0986


def log(*a):
    print(*a, flush=True)


def phase0_device():
    import jax

    if jax.default_backend() != "gpu":
        sys.stderr.write(f"chip_smoke: no GPU (JAX backend "
                         f"{jax.default_backend()!r}); nothing was run\n")
        sys.exit(2)
    from pislam_tpu.utils.profiling import gpu_name_and_power

    d = jax.devices()[0]
    card = gpu_name_and_power()
    log(f"[0] device: {d.platform} {d.device_kind} x{len(jax.devices())}")
    return card


def _on_cpu(fn, *args):
    """Run a jitted function on the CPU device (inputs committed there)."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.device_get(fn(*jax.device_put(args, cpu)))


def check(ok, what):
    """An assert that `python -O` cannot strip."""
    if not ok:
        raise AssertionError(what)


def _same(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    check(a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape))
    bad = int(np.sum(a != b))
    check(bad == 0, f"{name}: {bad} of {a.size} entries differ GPU vs CPU")


def phase1_extraction(ctx):
    import jax
    import pislam_tpu
    from pislam_tpu.io.datasets import texture_frame
    from pislam_tpu.ops import pyramid
    from pislam_tpu.utils.profiling import median_ms

    cfg = pislam_tpu.PislamConfig()
    pc = cfg.pyramid
    check((pc.num_levels, cfg.frontend.max_keypoints) == (8, 2048),
          "the default config is 8 levels, 2048 keypoints")
    frame = texture_frame(pc.base_width, pc.base_height)
    build = jax.jit(lambda f: pyramid.build_pyramid(f, pc))
    extract = pislam_tpu.make_extract_fn(cfg)

    stack = build(jax.device_put(frame))
    feats = jax.device_get(extract(stack))
    stack_cpu = _on_cpu(build, frame)
    feats_cpu = _on_cpu(extract, stack_cpu)
    _same("pyramid", stack, stack_cpu)
    for f in ("codes", "valid", "angles", "descriptors"):
        _same(f, getattr(feats, f), getattr(feats_cpu, f))
    n = int(np.sum(feats.valid))
    check(n > 300, f"only {n} features on a textured VGA frame")
    ms_x = median_ms(extract, stack)
    ms_px = median_ms(lambda f: extract(build(f)), jax.device_put(frame))
    log(f"[1] extraction VGA 8 levels K=2048: {n} features, bit-exact vs "
        f"CPU (pyramid, codes, valid, angles, descriptors); median of 20: "
        f"extract {ms_x:.3f} ms/frame, pyramid+extract {ms_px:.3f} ms/frame")
    ctx["feats"] = feats


def make_match_case(feats, k2=8192, seed=0):
    """Query = the VGA frame's descriptors; database = four seeded
    perturbed copies of them (0.5-30 % of bits flipped) with nearby
    image coordinates, some invalid and some behind the camera."""
    rng = np.random.default_rng(seed)
    d1 = np.asarray(feats.descriptors)
    v1 = np.asarray(feats.valid)
    k1 = d1.shape[0]
    copies = k2 // k1
    d2, uv2 = [], []
    uv1 = rng.uniform(-0.6, 0.6, (k1, 2)).astype(np.float32)
    for c, p in enumerate(np.linspace(0.005, 0.3, copies)):
        bits = rng.random((k1, d1.shape[1], 32)) < p
        flip = np.sum(bits.astype(np.uint64) << np.arange(32, dtype=np.uint64),
                      axis=-1).astype(np.uint32)
        d2.append(d1 ^ flip)
        uv2.append(uv1 + rng.normal(0, 0.02 * (c + 1), (k1, 2)))
    d2 = np.concatenate(d2)
    uv2 = np.concatenate(uv2).astype(np.float32)
    v2 = np.tile(v1, copies) & (rng.random(k2) < 0.95)
    uv2[rng.random(k2) < 0.02] = 1e6          # behind-camera sentinel
    uv2[rng.random(k2) < 0.01] = np.inf
    return d1, d2, v1, v2, uv1, uv2


def phase2_matching(ctx):
    import jax
    from pislam_tpu import matching
    from pislam_tpu.utils.profiling import median_ms

    d1, d2, v1, v2, uv1, uv2 = make_match_case(ctx["feats"])
    args = jax.device_put((d1, d2, v1, v2))
    gargs = jax.device_put((d1, d2, v1, v2, uv1, uv2))
    gated = jax.jit(lambda *a: matching.match_gated(*a, radius=0.06))

    out = jax.device_get(matching.match(*args))
    out_cpu = _on_cpu(matching.match, d1, d2, v1, v2)
    gout = jax.device_get(gated(*gargs))
    gout_cpu = _on_cpu(gated, d1, d2, v1, v2, uv1, uv2)
    for name, a, b in (("match idx", out[0], out_cpu[0]),
                       ("match dist", out[1], out_cpu[1]),
                       ("gated idx", gout[0], gout_cpu[0]),
                       ("gated dist", gout[1], gout_cpu[1])):
        _same(name, a, b)
    nm, ng = int(np.sum(out[0] >= 0)), int(np.sum(gout[0] >= 0))
    check(nm > 100 and ng > 100, (nm, ng))
    ms_m = median_ms(matching.match, *args)
    ms_g = median_ms(gated, *gargs)
    log(f"[2] matching 2048 x 8192: {nm} matches ungated, {ng} gated "
        f"(r=0.06), bit-exact vs CPU; median of 20: match {ms_m:.3f} ms, "
        f"match_gated {ms_g:.3f} ms")


def run_service(argv):
    """service.main(argv) -> (its JSON report, wall seconds)."""
    from pislam_tpu import service

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        service.main(argv)
    wall = time.perf_counter() - t0
    return json.loads(buf.getvalue().strip().splitlines()[-1]), wall


def run_keyframe_slam():
    """The pipeline of tests/test_eval_sequence.py on eval_seq: KeyframeSLAM
    then close_loop -> (keyframes, loop ordinal, ATE pre, ATE post,
    median process() ms/frame over the second half)."""
    import jax.numpy as jnp
    from pislam_tpu.evaluation import ate_rmse
    from pislam_tpu.models.slam import KeyframeSLAM

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from eval_ate import slam_config

    d = np.load(SEQ)
    frames, Rs, ts = d["frames"], d["Rs"], d["ts"]
    gt = np.stack([-R.T @ t for R, t in zip(Rs, ts)])
    slam = KeyframeSLAM(slam_config(384, 256), float(d["fx"]),
                        float(d["fy"]), float(d["cx"]), float(d["cy"]),
                        keyframe_min_inliers=60, keyframe_max_gap=3)
    per_frame = []
    for f in frames:
        t0 = time.perf_counter()
        slam.process(jnp.asarray(f))     # returns host values: synced
        per_frame.append(time.perf_counter() - t0)
    n_kf = len(slam.keyframe_frames)
    gtk = gt[np.asarray(slam.keyframe_frames)]
    pre = float(ate_rmse(slam.keyframe_positions(), gtk))
    loop = slam.close_loop(min_matches=40, exclude_recent=3)["loop"]
    post = float(ate_rmse(slam.keyframe_positions(), gtk))
    steady = float(np.median(per_frame[len(per_frame) // 2:])) * 1e3
    return n_kf, loop, pre, post, steady


def phase3_slam(ctx):
    for extra in ([], ["--chunk", "8"]):
        with tempfile.TemporaryDirectory() as tmp:
            rep, wall = run_service(["--seq", SEQ, "--checkpoint-dir",
                                     os.path.join(tmp, "ckpt")] + extra)
        mode = "chunk 8" if extra else "host loop"
        log(f"[3] service ({mode}): frames {rep['frames']}, keyframes "
            f"{rep['keyframes']}, landmarks {rep['landmarks']}, frames_lost "
            f"{rep['frames_lost']}, ate_rmse {rep.get('ate_rmse')}, "
            f"{wall:.1f} s wall incl. compile "
            f"({wall / rep['frames'] * 1e3:.1f} ms/frame)")
        check(rep["frames"] == 48 and rep["frames_lost"] == 0, rep)
        check(rep.get("ate_rmse") is not None and rep["ate_rmse"] < 0.5, rep)

    n_kf, loop, pre, post, steady = run_keyframe_slam()
    log(f"[3] KeyframeSLAM + close_loop: {n_kf} keyframes, loop to ordinal "
        f"{loop}, keyframe ATE pre {pre:.4f} (CPU recorded "
        f"{CPU_KF_ATE_PRE}, diff {pre - CPU_KF_ATE_PRE:+.4f}) post "
        f"{post:.4f} (CPU recorded {CPU_KF_ATE_POST}, diff "
        f"{post - CPU_KF_ATE_POST:+.4f}); process() median over the "
        f"second half {steady:.2f} ms/frame")
    check(n_kf >= 10, n_kf)
    check(0 <= loop <= 2, loop)
    check(post < 0.12 and post < pre + 0.005, (pre, post))


# --------------------------------------------------------------- 4 GPUs

def multi_service(ctx):
    # the setting of tests/test_service.py::test_service_sharded_map_mode:
    # over longer runs the Huber LM turns float noise (run to run on the
    # GPU, and between reduction orders) into different accepted maps
    argv = ["--seq", SEQ, "--max-frames", "10", "--no-loop-close"]
    one, _ = run_service(argv)
    four, wall = run_service(argv + ["--model-parallel", "4"])
    log(f"[m] service 10 frames: 1 card kf {one['keyframes']} lm "
        f"{one['landmarks']} ate {one['ate_rmse']} | --model-parallel 4 kf "
        f"{four['keyframes']} lm {four['landmarks']} ate {four['ate_rmse']} "
        f"({wall:.1f} s wall)")
    check(four["keyframes"] == one["keyframes"], (one, four))
    check(four["landmarks"] == one["landmarks"], (one, four))
    check(abs(four["ate_rmse"] - one["ate_rmse"]) < 2e-3, (one, four))


def multi_match(ctx):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import pislam_tpu
    from pislam_tpu import matching
    from pislam_tpu.config import MeshConfig
    from pislam_tpu.io.datasets import texture_frame
    from pislam_tpu.ops import pyramid
    from pislam_tpu.parallel import dist, mesh as meshmod

    cfg = pislam_tpu.PislamConfig()
    frame = texture_frame(640, 480)
    feats = jax.device_get(pislam_tpu.make_extract_fn(cfg)(
        pyramid.build_pyramid(jnp.asarray(frame), cfg.pyramid)))
    d1, d2, v1, v2, uv1, uv2 = make_match_case(feats)
    mesh = meshmod.make_mesh(MeshConfig(model_parallel=4))
    want = jax.device_get(matching.match(d1, d2, v1, v2))
    got = jax.device_get(dist.make_sharded_match(mesh)(d1, d2, v1, v2))
    _same("sharded idx", got[0], want[0])
    _same("sharded dist", got[1], want[1])

    def body(b_s, v2_s, uv2_s):
        return dist._sharded_match_local(
            "model", 4, jnp.asarray(d1), b_s, jnp.asarray(v1), v2_s,
            64, 0.8, True, gate=(jnp.asarray(uv1), uv2_s, 0.06))

    gated = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("model"), P("model"), P("model")),
        out_specs=(P(), P()), check_vma=False))
    gidx, gbest = jax.device_get(gated(d2, v2, uv2))
    gwant = jax.device_get(matching.match_gated(d1, d2, v1, v2, uv1, uv2,
                                                radius=0.06))
    _same("sharded gated idx", gidx, gwant[0])
    ok = gwant[0] >= 0
    _same("sharded gated dist", gbest[ok], gwant[1][ok])
    log(f"[m] sharded matching 2048 x 8192 over 4 cards: "
        f"{int(np.sum(want[0] >= 0))} ungated, {int(ok.sum())} gated, "
        f"bit-exact vs one card")


def multi_ba(ctx):
    import jax
    import jax.numpy as jnp
    from pislam_tpu.backend import ba
    from pislam_tpu.config import MeshConfig
    from pislam_tpu.geometry import se3
    from pislam_tpu.parallel import dist, mesh as meshmod

    rng = np.random.default_rng(5)
    nc, npts = 8, 1024
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (npts, 3)).astype(np.float32)
    Rs = np.stack([np.asarray(se3.so3_exp(jnp.asarray(
        rng.normal(0, 0.05, 3).astype(np.float32)))) for _ in range(nc)])
    ts = np.stack([np.float32([0.3 * c, 0.02 * c, 0.0]) for c in range(nc)])
    xc = np.einsum("cij,pj->cpi", Rs, X) + ts[:, None]
    uv = (xc[..., :2] / xc[..., 2:]).reshape(-1, 2)
    uv += rng.normal(0, 1e-4, uv.shape)
    cams = np.repeat(np.arange(nc, dtype=np.int32), npts)
    pts = np.tile(np.arange(npts, dtype=np.int32), nc)
    R0, t0 = Rs.copy(), ts.copy()
    for c in range(1, nc):
        R0[c] = np.asarray(se3.so3_exp(jnp.asarray(
            rng.normal(0, 0.05, 3).astype(np.float32)))) @ Rs[c]
        t0[c] = ts[c] + rng.normal(0, 0.05, 3)
    prob = ba.BAProblem(
        R=jnp.asarray(R0), t=jnp.asarray(t0),
        points=jnp.asarray(X + rng.normal(0, 0.1, X.shape).astype(
            np.float32)),
        obs_cam=jnp.asarray(cams), obs_pt=jnp.asarray(pts),
        obs_uv=jnp.asarray(uv.astype(np.float32)),
        obs_valid=jnp.ones(nc * npts, bool), cam_valid=jnp.ones(nc, bool),
        pt_valid=jnp.ones(npts, bool))
    mesh = meshmod.make_mesh(MeshConfig(model_parallel=4))
    sharded = dist.shard_ba_problem(prob, 4)
    for solver in ("dense", "cg"):
        single, info_s = ba.bundle_adjust(prob, iters=6, damping=1e-3,
                                          solver=solver, cg_iters=64)
        out, info_d = dist.make_distributed_ba(
            mesh, iters=6, damping=1e-3, solver=solver, cg_iters=64)(sharded)
        c_s = np.asarray(info_s["costs"])
        c_d = np.asarray(info_d["costs"])
        np.testing.assert_allclose(np.asarray(out.R), np.asarray(single.R),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(out.t), np.asarray(single.t),
                                   atol=1e-4)
        np.testing.assert_allclose(c_d, c_s, rtol=1e-3)
        check(c_s[-1] < 0.1 * c_s[0], c_s)
        log(f"[m] distributed BA ({solver}, {nc} cams, {npts} points) on 4 "
            f"cards == 1 card: cost {c_s[0]:.4e} -> {c_s[-1]:.4e} "
            f"(4 cards {c_d[-1]:.4e})")


def multi_dryrun(ctx):
    sys.path.insert(0, REPO)
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
    log("[m] __graft_entry__.dryrun_multichip(4) ok")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU checks")
    args = ap.parse_args(argv)

    card = phase0_device()
    import jax

    from pislam_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    if args.multi:
        if len(jax.devices()) != 4:
            sys.stderr.write(f"--multi needs 4 GPUs, found "
                             f"{len(jax.devices())}\n")
            return 2
        phases = [multi_service, multi_match, multi_ba, multi_dryrun]
    else:
        phases = [phase1_extraction, phase2_matching, phase3_slam]

    ctx, failed = {}, []
    t_start = time.perf_counter()
    for ph in phases:
        t0 = time.perf_counter()
        try:
            ph(ctx)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            failed.append(ph.__name__)
            log(f"FAILED {ph.__name__}")
        log(f"    ({ph.__name__}: {time.perf_counter() - t0:.1f} s)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    if failed:
        log(f"chip_smoke: {len(failed)} phase(s) failed: {', '.join(failed)}")
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
