#!/usr/bin/env python
"""Randomized differential audit across the whole config space (r5).

The test suite pins known-tricky geometries; this audit samples the space
randomly — size (tiny/odd included), mode, quality, restart interval,
optimize, dct_method, content class — and checks every emitted file
against independent oracles:

  - Pillow and OpenCV must decode it without error at the right shape;
  - our decoder's pixels must track the exact-arithmetic reference
    reconstruction (jpgenc_tpu.ref.decoder) TIGHTLY, and Pillow's decode
    of the same file loosely — libjpeg's integer islow IDCT legitimately
    deviates from exact arithmetic by up to ~20/255 on coefficients
    outside its IEEE-1180 accuracy domain (noise content), and Pillow ==
    OpenCV == TF exactly there because they share the code;
  - islow trials must be BYTE-IDENTICAL to Pillow/libjpeg-turbo's file;
  - decode_batch must agree with single decode (knife-edge parity).

Run on CPU (every random geometry compiles fresh executables, which the
CPU backend does in seconds):

    JAX_PLATFORMS=cpu python scripts/audit_fuzz.py [--trials 60] [--seed 7]

Prints one JSON summary; exits nonzero on any failure.
"""
from __future__ import annotations

import argparse
import io as _io
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _content(rng, h, w, ch, kind):
    if kind == "noise":
        return rng.integers(0, 256, (h, w, ch) if ch else (h, w), np.uint8)
    if kind == "flat":
        return np.full((h, w, ch) if ch else (h, w),
                       int(rng.integers(0, 256)), np.uint8)
    if kind == "edges":
        img = np.zeros((h, w, ch) if ch else (h, w), np.uint8)
        img[::2] = 255
        img[:, :: max(1, w // 7)] = 128
        return img
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127 + 90 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
    if ch:
        base = np.stack([base + 20 * c for c in range(ch)], axis=-1)
    return np.clip(base, 0, 255).astype(np.uint8)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=60)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    from jpgenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import cv2
    from PIL import Image

    from jpgenc_tpu.api import decode, decode_batch, encode
    from jpgenc_tpu.ref.decoder import exact_decode
    from jpgenc_tpu.utils.metrics import psnr

    rng = np.random.default_rng(args.seed)
    fails = []
    counts = {"islow_byte_identical": 0}
    for t in range(args.trials):
        h = int(rng.integers(1, 260))
        w = int(rng.integers(1, 260))
        mode = rng.choice(["gray", "420", "422", "444"])
        q = int(rng.integers(10, 99))
        dri = int(rng.choice([0, 0, 1, 3, 8, 32]))
        opt = bool(rng.integers(0, 2))
        islow = bool(rng.integers(0, 3) == 0)
        kind = rng.choice(["noise", "grad", "flat", "edges"])
        ch = 0 if mode == "gray" else 3
        img = _content(rng, h, w, ch, kind)
        desc = f"t{t} {h}x{w} {mode} Q{q} dri={dri} opt={opt} " \
               f"islow={islow} {kind}"
        try:
            kw = dict(quality=q, restart_interval=dri, optimize=opt,
                      dct_method="islow" if islow else "float")
            if ch:
                kw["subsampling"] = mode
            data = encode(img, **kw)
            # oracle decodes
            pil = np.asarray(Image.open(_io.BytesIO(data)).convert(
                "RGB" if ch else "L"))
            assert pil.shape == img.shape, f"PIL shape {pil.shape}"
            cvf = cv2.IMREAD_COLOR if ch else cv2.IMREAD_GRAYSCALE
            cv = cv2.imdecode(np.frombuffer(data, np.uint8), cvf)
            assert cv is not None and cv.shape[:2] == (h, w), "cv2 decode"
            # our decode vs the exact-arithmetic reference: tight
            own = decode(data)
            assert own.shape == img.shape
            ref = exact_decode(data)
            dr = np.abs(own.astype(np.int64) - ref.astype(np.int64))
            # magnitude-only bound: one f32-vs-f64 tie-broken SAMPLE (.5
            # boundary) shifts RGB by up to ceil(1.772)+1 after color
            # amplification; synthetic gradients/flats produce whole
            # blocks of exact-.5 samples, so the AFFECTED FRACTION is
            # content-dependent and meaningless as a bound
            assert dr.max() <= 3, f"own-vs-exact maxdiff {dr.max()}"
            # vs PIL: loose (libjpeg integer-IDCT deviation on extreme
            # coefficients; see module docstring)
            d = np.abs(own.astype(np.int64) - pil.astype(np.int64))
            # corruption detector, not an accuracy bound: libjpeg's
            # integer-IDCT tail error on adversarial noise is open-ended
            # (observed 50+ at single pixels with healthy PSNR), so gate
            # on PSNR + the spread, never on a single pixel
            # relative control: our decode must sit no farther from
            # PIL than EXACT ARITHMETIC does (libjpeg's integer-IDCT
            # deviation on adversarial noise is open-ended, so absolute
            # bounds are unprincipled; own ~ ref is asserted above, and a
            # bug shared with the reference would still break the islow
            # byte-parity and structural checks)
            dref = np.abs(ref.astype(np.int64) - pil.astype(np.int64))
            slack = max(1e-3, 16.0 / d.size)
            assert float(psnr(own, pil)) > 34 \
                and (d > 4).mean() <= (dref > 4).mean() + slack \
                and (d > 16).mean() <= (dref > 16).mean() + slack, \
                f"own-vs-pil psnr {psnr(own, pil):.1f} frac>4 " \
                f"{(d > 4).mean():.3f} (ref {(dref > 4).mean():.3f})"
            # batch vs single (knife-edge parity)
            for g in decode_batch([data] * 2, chunk=1):
                d2 = np.abs(g.astype(np.int64) - own.astype(np.int64))
                assert d2.max() <= 1, f"batch-vs-single {d2.max()}"
            # islow byte parity vs Pillow (no-DRI trials: Pillow's restart
            # knob is row-granular; the islow suite covers DRI mapping)
            if islow and dri == 0:
                buf = _io.BytesIO()
                pkw = {"quality": q, "optimize": opt}
                if ch:
                    pkw["subsampling"] = {"444": 0, "422": 1, "420": 2}[mode]
                Image.fromarray(img).save(buf, "JPEG", **pkw)
                assert data == buf.getvalue(), "islow byte parity"
                counts["islow_byte_identical"] += 1
            print(f"ok {desc}", file=sys.stderr, flush=True)
        except Exception as e:  # noqa: BLE001 — collect, report, fail at end
            fails.append({"trial": desc, "error": f"{type(e).__name__}: {e}"})
            print(f"FAIL {desc}: {e}", file=sys.stderr, flush=True)
    print(json.dumps({"trials": args.trials, "failures": fails, **counts}))
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
