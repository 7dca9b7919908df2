#!/usr/bin/env python
"""GPU smoke run of the encode/decode main path, checked against the repo's
NumPy references.

    python chip_smoke.py              # the one-card phases at full size
    python chip_smoke.py --cards 4    # only the sharded paths, on 4 cards

The one-card run drives `jpgenc_tpu.api` and `jpgenc_tpu.parallel.mesh` on
seeded synthetic frames (`utils.fixtures.synth_batch`):

1. flagship encode: 64 x 1080p RGB 4:2:0 Q75 through `encode_batch`;
2. quality/restart tiers: Q95 with DRI 120, and Q90;
3. islow (libjpeg-exact integer DCT) in all four layouts;
4. two-pass optimize: 4K through `api.encode`, and a batched 1080p run;
5. decode of the flagship files into device memory (`decode_batch`,
   `decode`).

Every phase compares with the references in `jpgenc_tpu.ref`: float
coefficients |d| <= 1 on at most 1e-4 of them, islow coefficients exact,
entropy bytes exact, histograms exact, decoded coefficients exact, pixels
|d| <= 1 on at most 1e-3 of them. Any mismatch raises. Only a GPU is
accepted: on any other platform the script exits non-zero and prints no
result. The last line of stdout is one JSON object naming the device.

Each phase is a function of its sizes, so tests/test_chip_smoke.py runs
every phase at a tiny size on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = (1080, 1920)
UHD = (2160, 3840)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

def check_close(got, ref, frac: float, what: str) -> dict:
    """|got - ref| <= 1 everywhere and nonzero on at most `frac` of the
    elements (frac 0 demands equality)."""
    got = np.asarray(got).astype(np.int64)
    ref = np.asarray(ref).astype(np.int64)
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {ref.shape}")
    d = np.abs(got - ref)
    n_bad = int((d > 0).sum())
    maxd = int(d.max()) if d.size else 0
    if maxd > (1 if frac else 0) or n_bad > frac * d.size:
        raise AssertionError(f"{what}: {n_bad} of {d.size} differ "
                             f"(max |d| {maxd}, allowed fraction {frac})")
    return {"n_diff": n_bad, "max_diff": maxd}


def check_equal(got, ref, what: str) -> None:
    if got != ref:
        raise AssertionError(f"{what}: outputs differ")


def _scan_to_raster(zz_scan, layout) -> np.ndarray:
    """Scan-ordered [s_pad, 64] blocks -> raster-per-component blocks."""
    zz = np.asarray(zz_scan)
    out = np.zeros((sum(c.n_blocks for c in layout.comps), 64), np.int32)
    out[np.asarray(layout.scan_flat)] = zz[:layout.n_scan]
    return out


def _raster_to_scan(blocks, layout) -> np.ndarray:
    s_pad = layout.n_segments * layout.blocks_per_segment
    out = np.zeros((s_pad, 64), np.int32)
    out[:layout.n_scan] = np.asarray(blocks)[np.asarray(layout.scan_flat)]
    return out


def _entropy_bytes(plan, zz_scan, luts, quality: int) -> bytes:
    """Device entropy stage over the capacity ladder (api.encode's)."""
    import jax.numpy as jnp

    from jpgenc_tpu.engine import scan_caps
    from jpgenc_tpu.ops.pack import w_blk_for_quality
    w_q = w_blk_for_quality(quality)
    for tier, w_blk in (("tight", w_q), ("safe", max(w_q, 24)),
                        ("worst", 56)):
        cap_u = scan_caps(plan.layout, quality, tier)[0]
        scan, ok = plan.entropy_scan_bytes_zz(jnp.asarray(zz_scan), luts,
                                              cap_u, w_blk)
        if ok:
            return scan
    raise AssertionError("worst-tier device entropy stage overflowed")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _encode_twice(fn, name: str) -> list[bytes]:
    """Run an encode twice: first call compiles, second is warm."""
    files, first = _timed(fn)
    again, warm = _timed(fn)
    check_equal(again, files, f"{name}: rerun bytes")
    log(f"{name}: first call {first:.2f} s, warm {warm:.2f} s, "
        f"compile ~{max(first - warm, 0.0):.2f} s")
    return files


def check_batch(frames, files, *, mode: str, quality: int, restart: int,
                mesh, islow: bool = False, name: str = "") -> None:
    """Phase 1-3 checks of one encode_batch result:

    - frame 0's device coefficients vs the reference transform (float:
      |d| <= 1 on <= 1e-4; islow: exact);
    - the device entropy stage fed the reference's integer coefficients
      produces exactly the reference's scan bytes;
    - api.encode of frame 0 reproduces its batch row;
    - every file decodes to the batch's own quantized coefficients.
    """
    import jax.numpy as jnp

    from jpgenc_tpu import api
    from jpgenc_tpu.config import EncodeConfig
    from jpgenc_tpu.decoder import decode_to_coefficients
    from jpgenc_tpu.engine import luts_from_tables, qtables_for_quality
    from jpgenc_tpu.parallel.mesh import _batch_setup, put_batch
    from jpgenc_tpu.ref import encoder as E
    from jpgenc_tpu.ref.islow import image_to_zigzag_islow

    sub = "420" if mode == "gray" else mode
    cfg = EncodeConfig(quality=quality, subsampling=sub,
                       restart_interval=restart,
                       dct_method="islow" if islow else "float")
    imgs, b, _, layout, plan, _, fns = _batch_setup(frames, cfg, mesh)
    qt_host, qt_dev = qtables_for_quality(quality)
    dc_t, ac_t = E.standard_tables()
    img0 = np.asarray(frames[0])

    # coefficients of frame 0 vs the reference transform
    if islow:
        ref = image_to_zigzag_islow(img0, layout, list(qt_host))
        dev = plan.zz_scan_islow(jnp.asarray(img0), qt_dev)
        st = check_close(_scan_to_raster(dev, layout), ref, 0.0,
                         f"{name}: islow coefficients")
    else:
        ref = E.image_to_zigzag(img0, layout, list(qt_host))
        dev = plan.zz_scan(jnp.asarray(img0), qt_dev)
        st = check_close(_scan_to_raster(dev, layout), ref, 1e-4,
                         f"{name}: coefficients")

    # device entropy stage on the reference's integer coefficients
    scan = _entropy_bytes(plan, _raster_to_scan(ref, layout),
                          luts_from_tables(dc_t, ac_t), quality)
    check_equal(scan, E.entropy_scan(layout, ref, dc_t, ac_t),
                f"{name}: entropy bytes")

    # the single-image API agrees with its batch row
    one = api.encode(img0, quality=quality, subsampling=sub,
                     restart_interval=restart,
                     dct_method="islow" if islow else "float")
    check_equal(one, files[0], f"{name}: api.encode vs encode_batch row")

    # every file round-trips the batch's own quantized coefficients
    zz_b = np.asarray(fns["zz_islow" if islow else "zz"](
        put_batch(imgs, fns["sharding_img"]), qt_dev))
    for i, data in enumerate(files):
        _, blocks, _ = decode_to_coefficients(data)
        check_close(blocks, _scan_to_raster(zz_b[i], layout), 0.0,
                    f"{name}: file {i} decoded coefficients")
    log(f"{name}: ok ({b} files, frame-0 coefficient diffs "
        f"{st['n_diff']} of {ref.size}, mean {np.mean([len(f) for f in files]):.0f} B/file)")


# ---------------------------------------------------------------------------
# Phases (each a function of its sizes)
# ---------------------------------------------------------------------------

def phase_flagship(mesh, h: int, w: int, batch: int) -> tuple:
    """64 x 1080p 4:2:0 Q75 through encode_batch. Returns (frames, files)."""
    import jax

    from jpgenc_tpu.config import EncodeConfig
    from jpgenc_tpu.engine import luts_from_tables, qtables_for_quality
    from jpgenc_tpu.parallel.mesh import _batch_setup, encode_batch, put_batch
    from jpgenc_tpu.ref.encoder import standard_tables
    from jpgenc_tpu.utils.fixtures import synth_batch

    frames = synth_batch(h, w, batch)
    # compile the batched encode step ahead of time: its compile seconds and
    # memory analysis come before anything runs
    imgs, _, _, layout, plan, caps, fns = _batch_setup(
        frames, EncodeConfig(quality=75), mesh)
    _, qt_dev = qtables_for_quality(75)
    args = (put_batch(imgs, fns["sharding_img"]), qt_dev, plan.plan,
            plan.scan_flat, luts_from_tables(*standard_tables()))
    compiled, t_c = _timed(lambda: fns["encode_bytes"].lower(*args).compile())
    log(f"flagship: batched encode step compiled in {t_c:.2f} s")
    ma = compiled.memory_analysis()
    if ma is not None:
        log("flagship: memory_analysis " + json.dumps({
            k: int(getattr(ma, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)}))
    jax.block_until_ready(compiled(*args))
    files = _encode_twice(lambda: encode_batch(frames, quality=75,
                                               mesh=mesh), "flagship")
    check_batch(frames, files, mode="420", quality=75, restart=0, mesh=mesh,
                name="flagship")
    return frames, files


def phase_tiers(mesh, h: int, w: int, batch: int) -> None:
    """Q95 + DRI 120 (w16 first tier) and Q90 (w12) through encode_batch."""
    from jpgenc_tpu.parallel.mesh import encode_batch
    from jpgenc_tpu.utils.fixtures import synth_batch

    frames = synth_batch(h, w, batch)
    for q, dri in ((95, 120), (90, 0)):
        name = f"tiers q{q} dri{dri}"
        files = _encode_twice(lambda: encode_batch(
            frames, quality=q, restart_interval=dri, mesh=mesh), name)
        check_batch(frames, files, mode="420", quality=q, restart=dri,
                    mesh=mesh, name=name)


def phase_islow(mesh, h: int, w: int, batch: int) -> None:
    """libjpeg-exact integer pipeline in 4:2:0, 4:2:2, 4:4:4 and gray."""
    from jpgenc_tpu.parallel.mesh import encode_batch
    from jpgenc_tpu.utils.fixtures import synth_batch

    rgb = synth_batch(h, w, batch)
    for mode in ("420", "422", "444", "gray"):
        frames = rgb[..., 0].copy() if mode == "gray" else rgb
        sub = "420" if mode == "gray" else mode
        name = f"islow {mode}"
        files = _encode_twice(lambda: encode_batch(
            frames, quality=75, subsampling=sub, mesh=mesh,
            dct_method="islow"), name)
        check_batch(frames, files, mode=mode, quality=75, restart=0,
                    mesh=mesh, islow=True, name=name)


def _check_optimized(data: bytes, img, layout, plan, name: str) -> None:
    """The device histogram equals the reference's on the device's own
    coefficients, and the file round-trips them."""
    import jax.numpy as jnp

    from jpgenc_tpu.decoder import decode_to_coefficients
    from jpgenc_tpu.engine import qtables_for_quality
    from jpgenc_tpu.ref.encoder import symbol_histogram

    _, qt_dev = qtables_for_quality(75)
    zz, hist = plan.zz_and_histogram(jnp.asarray(img), qt_dev)
    blocks = _scan_to_raster(zz, layout)
    check_close(hist, symbol_histogram(layout, blocks), 0.0,
                f"{name}: histogram")
    _, dec, _ = decode_to_coefficients(data)
    check_close(dec, blocks, 0.0, f"{name}: decoded coefficients")


def phase_optimize(mesh, uhd: tuple, h: int, w: int, batch: int) -> None:
    """Two-pass optimized Huffman: one 4K frame through api.encode, and a
    batched 1080p run through encode_batch."""
    from jpgenc_tpu import api
    from jpgenc_tpu.engine import get_plan
    from jpgenc_tpu.layout import make_layout
    from jpgenc_tpu.parallel.mesh import encode_batch
    from jpgenc_tpu.utils.fixtures import synth_batch, synth_frame

    big = synth_frame(*uhd)
    lay = make_layout(*uhd, "420", 0)
    data = _encode_twice(lambda: [api.encode(big, optimize=True)],
                         "optimize 4k")[0]
    _check_optimized(data, big, lay, get_plan(lay), "optimize 4k")
    log(f"optimize 4k: ok ({len(data)} B)")

    frames = synth_batch(h, w, batch)
    files = _encode_twice(lambda: encode_batch(frames, optimize=True,
                                               mesh=mesh), "optimize batch")
    lay = make_layout(h, w, "420", 0)
    plan = get_plan(lay)
    for i, data in enumerate(files):
        _check_optimized(data, frames[i], lay, plan, f"optimize batch {i}")
    log(f"optimize batch: ok ({len(files)} files)")


def phase_decode(files, chunk: int, pixel_frac: float = 1e-3) -> None:
    """Files -> pixels in device memory (decode_batch, chunked) and single
    decode, vs the float64 reference decoder."""
    import jax

    from jpgenc_tpu import api
    from jpgenc_tpu.ref.decoder import exact_decode

    def run():
        return jax.block_until_ready(api.decode_batch(files, to_device=True,
                                                      chunk=chunk))
    chunks, first = _timed(run)
    _, warm = _timed(run)
    log(f"decode batch: first call {first:.2f} s, warm {warm:.2f} s, "
        f"compile ~{max(first - warm, 0.0):.2f} s")
    pix = [np.asarray(a) for c in chunks for a in np.asarray(c)]
    if len(pix) != len(files):
        raise AssertionError(f"decode batch: {len(pix)} frames for "
                             f"{len(files)} files")
    n_diff = 0
    for i, data in enumerate(files):
        n_diff += check_close(pix[i], exact_decode(data), pixel_frac,
                              f"decode batch: frame {i} pixels")["n_diff"]
    one = np.asarray(api.decode(files[0], to_device=True))
    check_close(one, exact_decode(files[0]), pixel_frac,
                "decode single: pixels")
    log(f"decode: ok ({len(files)} frames, {n_diff} pixels off by 1)")


def phase_cards(devices, hw: tuple, batch: int, uhd: tuple,
                n_stripes: int) -> None:
    """The sharded paths on len(devices) cards, each compared byte for byte
    with the same call on one card in this process: encode_batch over a
    1-D mesh and over a 2 x 2 MeshConfig, encode_striped (optimize + islow)
    and the sharded decode_batch."""
    import jax
    from jax.sharding import Mesh

    from jpgenc_tpu.config import MeshConfig
    from jpgenc_tpu.parallel import mesh as M
    from jpgenc_tpu.utils.fixtures import synth_batch, synth_frame

    n = len(devices)
    one = Mesh(np.array(devices[:1]), ("batch",))
    wide = Mesh(np.array(devices), ("batch",))
    frames = synth_batch(*hw, batch)

    ref = M.encode_batch(frames, quality=75, mesh=one)
    got = _encode_twice(lambda: M.encode_batch(frames, quality=75,
                                               mesh=wide),
                        f"cards: encode_batch 1-D mesh of {n}")
    check_equal(got, ref, "cards: 1-D mesh vs one card")
    log(f"cards: encode_batch 1-D mesh of {n}: identical to one card")

    if n % 2 == 0:
        cfg = MeshConfig(batch=n // 2, stripe=2)
        got = M.encode_batch(frames, quality=75, mesh=cfg)
        check_equal(got, ref, "cards: 2-D mesh vs one card")
        log(f"cards: encode_batch {n // 2}x2 MeshConfig: identical to one "
            "card")

    big = synth_frame(*uhd)
    kw = dict(quality=75, optimize=True, dct_method="islow")
    ref_s = M.encode_striped(big, n_stripes,
                             mesh=Mesh(np.array(devices[:1]), ("stripe",)),
                             **kw)
    got_s = M.encode_striped(big, n_stripes,
                             mesh=Mesh(np.array(devices[:n_stripes]),
                                       ("stripe",)), **kw)
    check_equal(got_s, ref_s, "cards: striped vs one card")
    log(f"cards: encode_striped {n_stripes} stripes optimize+islow: "
        f"identical to one card ({len(got_s)} B)")

    ref_d = np.asarray(M.decode_batch(ref, mesh=one))
    out = jax.block_until_ready(M.decode_batch(ref, mesh=wide))
    used = {d.id for d in out.sharding.device_set}
    if len(used) != n:
        raise AssertionError(f"cards: decoded pixels on {len(used)} of {n} "
                             "devices")
    check_close(np.asarray(out), ref_d, 0.0, "cards: sharded decode pixels")
    log(f"cards: decode_batch over {n} cards: identical to one card")


# ---------------------------------------------------------------------------

def _device_report(devices) -> None:
    for d in devices:
        st = d.memory_stats() or {}
        log(f"device {d.id}: peak_bytes_in_use "
            f"{st.get('peak_bytes_in_use', 'not reported')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4 runs only the sharded paths on four cards")
    args = ap.parse_args(argv)

    from jpgenc_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but {len(devices)} "
              "devices", file=sys.stderr)
        return 2
    devices = devices[:args.cards]
    log(f"jax.devices(): {jax.devices()}")
    log("nvidia-smi: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().replace("\n", " | "))
    log(f"compile cache: {cache}")
    from jpgenc_tpu import native
    log(f"native tier loaded: {native.available()}")
    if not native.available():
        raise RuntimeError("the native C++ tier did not load")

    from jax.sharding import Mesh
    t_all = time.perf_counter()
    if args.cards > 1:
        phase_cards(devices, FLAGSHIP, 64, UHD, n_stripes=4)
    else:
        mesh = Mesh(np.array(devices), ("batch",))
        for name, fn in (
                ("flagship", lambda: phase_flagship(mesh, *FLAGSHIP, 64)),
                ("tiers", lambda: phase_tiers(mesh, *FLAGSHIP, 8)),
                ("islow", lambda: phase_islow(mesh, *FLAGSHIP, 4)),
                ("optimize", lambda: phase_optimize(mesh, UHD, *FLAGSHIP,
                                                    8))):
            out, dt = _timed(fn)
            log(f"phase {name}: {dt:.2f} s")
            if name == "flagship":
                files = out[1]
        _, dt = _timed(lambda: phase_decode(files, chunk=32))
        log(f"phase decode: {dt:.2f} s")
    _device_report(devices)
    log(f"all phases passed in {time.perf_counter() - t_all:.2f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
