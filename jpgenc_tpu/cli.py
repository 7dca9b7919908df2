"""Command-line interface (SURVEY.md layer F): encode / decode / bench.

Usage:
  python -m jpgenc_tpu encode IN.{png,ppm,jpg,...} OUT.jpg [--quality Q]
      [--subsampling 444|422|420] [--restart N] [--optimize] [--stripes N]
  python -m jpgenc_tpu decode IN.jpg OUT.png
  python -m jpgenc_tpu bench [--size HxW] [--quality Q] [--frames N]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    if img.mode not in ("L", "RGB"):
        img = img.convert("RGB")
    return np.asarray(img)


def _save_image(path: str, arr: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(arr).save(path)


def cmd_encode(args: argparse.Namespace) -> int:
    from jpgenc_tpu.api import encode
    img = _load_image(args.input)
    t0 = time.perf_counter()
    if args.stripes > 1:
        from jpgenc_tpu.parallel.mesh import encode_striped
        data = encode_striped(img, n_stripes=args.stripes,
                              quality=args.quality,
                              subsampling=args.subsampling,
                              restart_interval=args.restart,
                              optimize=args.optimize)
    else:
        data = encode(img, quality=args.quality, subsampling=args.subsampling,
                      restart_interval=args.restart, optimize=args.optimize,
                      dct_method=args.dct_method)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    px = img.shape[0] * img.shape[1]
    print(f"{args.output}: {len(data)} bytes, {8 * len(data) / px:.3f} bpp, "
          f"{px / dt / 1e6:.1f} MPix/s", file=sys.stderr)
    return 0


def cmd_batch(args: argparse.Namespace) -> int:
    """Checkpointed batch encode of a directory (or glob) of image files."""
    import os

    from jpgenc_tpu import io
    from jpgenc_tpu.batch import run_batch

    paths = io.find_images(args.input, args.glob)
    if not paths:
        print(f"no images match {args.input!r}", file=sys.stderr)
        return 1
    os.makedirs(args.output, exist_ok=True)
    outs = [os.path.join(args.output,
                         os.path.splitext(os.path.basename(p))[0] + ".jpg")
            for p in paths]
    manifest = args.manifest or os.path.join(args.output, "manifest.jsonl")
    res = run_batch(paths, outs, manifest, quality=args.quality,
                    subsampling=args.subsampling,
                    restart_interval=args.restart, optimize=args.optimize,
                    chunk_size=args.chunk, dct_method=args.dct_method)
    print(json.dumps({"images": len(paths), "done": res.done,
                      "skipped": res.skipped,
                      "mpix_per_s": round(res.mpix_per_s, 2)}))
    return 0


def cmd_decode(args: argparse.Namespace) -> int:
    from jpgenc_tpu.api import decode
    with open(args.input, "rb") as f:
        data = f.read()
    arr = decode(data)
    _save_image(args.output, arr)
    print(f"{args.output}: {arr.shape}", file=sys.stderr)
    return 0


def _bench_image(h: int, w: int) -> np.ndarray:
    from jpgenc_tpu.utils.fixtures import synth_frame
    return synth_frame(h, w)


def cmd_bench(args: argparse.Namespace) -> int:
    from jpgenc_tpu.api import encode
    h, w = (int(x) for x in args.size.split("x"))
    img = _bench_image(h, w)
    if args.profile:
        from jpgenc_tpu.utils.profiling import trace
        encode(img, quality=args.quality)             # compile outside trace
        with trace(args.profile):
            encode(img, quality=args.quality)
        print(f"trace written to {args.profile}", file=sys.stderr)
    data = encode(img, quality=args.quality)          # warm/compile
    t0 = time.perf_counter()
    for _ in range(args.frames):
        data = encode(img, quality=args.quality)
    dt = (time.perf_counter() - t0) / args.frames
    print(json.dumps({
        "size": args.size, "quality": args.quality,
        "mpix_per_s": round(h * w / dt / 1e6, 2),
        "bpp": round(8 * len(data) / (h * w), 3),
    }))
    return 0


def cmd_rd_curve(args: argparse.Namespace) -> int:
    """Rate-distortion sweep: one JSON row per quality (PSNR-vs-bpp curve)."""
    import io

    from PIL import Image

    from jpgenc_tpu.api import encode
    from jpgenc_tpu.utils.metrics import psnr
    img = (_load_image(args.input) if args.input
           else _bench_image(*[int(x) for x in args.size.split("x")]))
    px = img.shape[0] * img.shape[1]
    for q in [int(x) for x in args.qualities.split(",")]:
        data = encode(img, quality=q, subsampling=args.subsampling)
        dec = np.asarray(Image.open(io.BytesIO(data)).convert(
            "RGB" if img.ndim == 3 else "L"))
        print(json.dumps({"quality": q,
                          "bpp": round(8 * len(data) / px, 4),
                          "psnr_db": round(float(psnr(dec, img)), 3)}))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="jpgenc_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode", help="encode an image to baseline JFIF")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--quality", type=int, default=75)
    e.add_argument("--subsampling", choices=["444", "422", "420"],
                   default="420")
    e.add_argument("--restart", type=int, default=0,
                   help="restart interval in MCUs (0 = off)")
    e.add_argument("--optimize", action="store_true",
                   help="two-pass optimized Huffman tables")
    e.add_argument("--dct-method", choices=["float", "islow"],
                   default="float", dest="dct_method",
                   help="islow = libjpeg-exact integer pipeline "
                        "(byte-identical files to libjpeg-turbo)")
    e.add_argument("--stripes", type=int, default=1,
                   help="shard MCU-row stripes over the device mesh")
    e.set_defaults(fn=cmd_encode)

    bt = sub.add_parser("batch",
                        help="checkpointed batch encode of a directory")
    bt.add_argument("input", help="directory or glob of image files")
    bt.add_argument("output", help="output directory for .jpg files")
    bt.add_argument("--glob", default="*", help="filename pattern inside dir")
    bt.add_argument("--quality", type=int, default=75)
    bt.add_argument("--subsampling", choices=["444", "422", "420"],
                    default="420")
    bt.add_argument("--restart", type=int, default=0)
    bt.add_argument("--optimize", action="store_true")
    bt.add_argument("--dct-method", choices=["float", "islow"],
                    default="float", dest="dct_method")
    bt.add_argument("--chunk", type=int, default=16,
                    help="images per sharded encode chunk")
    bt.add_argument("--manifest", default="",
                    help="resume manifest path (default OUTPUT/manifest.jsonl)")
    bt.set_defaults(fn=cmd_batch)

    d = sub.add_parser("decode", help="decode a baseline JFIF file")
    d.add_argument("input")
    d.add_argument("output")
    d.set_defaults(fn=cmd_decode)

    b = sub.add_parser("bench", help="quick throughput check")
    b.add_argument("--size", default="1080x1920")
    b.add_argument("--quality", type=int, default=75)
    b.add_argument("--frames", type=int, default=10)
    b.add_argument("--profile", default="",
                   help="write a jax.profiler trace to this directory")
    b.set_defaults(fn=cmd_bench)

    r = sub.add_parser("rd-curve", help="PSNR-vs-bpp sweep as JSON rows")
    r.add_argument("--input", default="",
                   help="image file (default: synthetic)")
    r.add_argument("--size", default="512x512")
    r.add_argument("--qualities", default="10,25,50,75,90,95")
    r.add_argument("--subsampling", choices=["444", "422", "420"],
                   default="420")
    r.set_defaults(fn=cmd_rd_curve)

    args = p.parse_args(argv)
    return args.fn(args)


def run() -> int:
    """Program entry (python -m jpgenc_tpu): persistent compile cache on,
    then the command."""
    from jpgenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    return main()


if __name__ == "__main__":
    raise SystemExit(run())
