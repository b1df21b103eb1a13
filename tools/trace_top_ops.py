"""Profile VGA extraction and 2048 x 8192 matching on the GPU; print the top
device operations of each trace and the route XLA chose for the int8
products.

    python tools/trace_top_ops.py [--out DIR] [--calls N]

Two traces, each of N calls after a warm-up: extraction with the default
PislamConfig (8-level VGA pyramid, 2048 keypoints) on io.datasets.
texture_frame, and matching.match at K1=2048 against K2=8192 (chip_smoke's
match case). For each, the top operations by summed device time
(utils/profiling.top_device_ops) are printed as ms per call, with the HLO
shape and source op each came from, and the device time per call against
the median wall time of one synchronous call. Then the
optimized HLO of both programs is searched for the int8 products: a
custom call to cuBLAS(Lt) means the library GEMM; a fusion or a plain
dot means XLA's own emitter. Fails without a GPU.
"""

import argparse
import os
import re
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402


def _hlo_int8_routes(compiled_text: str):
    """Lines of optimized HLO that compute a product (library GEMM calls,
    Triton GEMM fusions or plain dots), with their operand types."""
    out = []
    for line in compiled_text.splitlines():
        if re.search(r"__cublas|__triton_gemm|kind=kCustom|\bdot\(", line):
            out.append(line.strip()[:400])
    return out[:30]


def _hlo_index(compiled_text: str):
    """HLO instruction name -> (result shape, op_name metadata): says which
    source op a kernel named in the trace came from."""
    out = {}
    for line in compiled_text.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.-]+) = (\S+) ", line)
        if m:
            op = re.search(r'op_name="([^"]+)"', line)
            out[m.group(1)] = (m.group(2), op.group(1) if op else "")
    return out


def _print_layout(logdir):
    """Planes and their lines in the trace: where the device events are."""
    import glob

    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        lines = [f"{ln.name}({sum(1 for _ in ln.events)})"
                 for ln in plane.lines]
        print(f"  plane {plane.name}: {', '.join(lines)[:400]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="trace directory (default: a new temp directory)")
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    out = args.out or tempfile.mkdtemp(prefix="pislam_trace_")

    from pislam_tpu.utils.profiling import (median_ms, require_gpu,
                                            top_device_ops, xla_trace)
    card = require_gpu()
    from pislam_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    import pislam_tpu
    from pislam_tpu import matching
    from pislam_tpu.io.datasets import texture_frame
    from pislam_tpu.ops import pyramid
    from chip_smoke import make_match_case

    cfg = pislam_tpu.PislamConfig()
    stack = jax.jit(lambda f: pyramid.build_pyramid(f, cfg.pyramid))(
        jax.device_put(texture_frame()))
    extract = pislam_tpu.make_extract_fn(cfg)
    feats = jax.device_get(extract(stack))
    margs = jax.device_put(make_match_case(feats)[:4])
    jax.block_until_ready(matching.match(*margs))

    for name, fn, fargs in (("extract", extract, (stack,)),
                            ("match", matching.match, margs)):
        logdir = os.path.join(out, name)
        with xla_trace(logdir):
            for _ in range(args.calls):
                jax.block_until_ready(fn(*fargs))
        if name == "extract":
            _print_layout(logdir)
        print(f"== {name}: top device ops, ms per call over {args.calls} "
              f"calls ({card})")
        text = fn.lower(*fargs).compile().as_text()
        index = _hlo_index(text)
        ops = top_device_ops(logdir)
        for op, ms, n in ops[:15]:
            shape, src = index.get(op, ("", ""))
            print(f"  {ms / args.calls:9.4f} ms  x{n // args.calls:<3d} "
                  f"{op[:90]}  {shape} {src}")
        busy = sum(ms for _, ms, _ in ops) / args.calls
        wall = median_ms(fn, *fargs)
        print(f"  device time {busy:.4f} ms per call in {len(ops)} ops; "
              f"median wall of a synchronous call {wall:.4f} ms "
              f"(device busy {busy / wall:.0%})")
        print(f"== {name}: products in the optimized HLO")
        for line in _hlo_int8_routes(text):
            print("  " + line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
