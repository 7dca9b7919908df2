#!/usr/bin/env python
"""Benchmark driver (SURVEY.md component #23): one JSON line on stdout.

Headline metric: MPix/s on one device, baseline JPEG encode at Q=75, RGB
1080p 4:2:0, standard Annex K tables — the BASELINE.json:2 north-star. The
`configs` field carries the BASELINE.json:6-11 matrix — one row per config
including the PSNR-vs-bpp quality half of the metric pair (ours vs the
Pillow/libjpeg-turbo anchor at equal quality) and a decode row.

The headline times sustained batched encode with device-resident input;
"e2e+upload" includes the host->device pixel upload. The JSON also carries
a transfer probe (`link_probe`), `device_only_mpix_per_s` per encode config
and for decode (payloads left in device memory), and `d2h_bytes` per encode
row. The full detail goes to stderr (the `DETAIL` line).
"""
from __future__ import annotations

import io as _io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

H, W = 1080, 1920
B = int(os.environ.get("BENCH_BATCH", "64"))
# distinct frames uploaded: the bench uploads 16 distinct 1080p frames
# (~100 MB) and device-tiles them to the B-frame compute batch
B_UP = min(B, int(os.environ.get("BENCH_BATCH_UPLOAD", "16")))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _pipeline_fns(layout, quality, batch, mesh, tier="tight"):
    """Batched device-pipeline callables for one (layout, quality, tier)."""
    import jax

    from jpgenc_tpu.engine import (get_plan, luts_from_tables,
                                   qtables_for_quality, scan_caps)
    from jpgenc_tpu.ops.pack import w_blk_for_quality
    from jpgenc_tpu.parallel.mesh import _batched_fns
    from jpgenc_tpu.ref.encoder import standard_tables

    plan = get_plan(layout)
    caps = (scan_caps(layout, quality, tier)[0], w_blk_for_quality(quality))
    fns = _batched_fns(plan, batch, mesh, caps)
    qt_host, qt_dev = qtables_for_quality(quality)
    dc_t, ac_t = standard_tables()
    luts = luts_from_tables(dc_t, ac_t)
    return plan, fns, qt_host, qt_dev, (dc_t, ac_t), luts


def _launch_collect(layout, plan, fns, qt_dev, luts, frames_dev, hdr, batch):
    """(launch, collect) closures for the pipelined encode loop.
    collect(pending) -> (files, d2h_bytes_this_batch)."""
    from jpgenc_tpu.engine import (combined_fetch, fetch_prefix,
                                   finalize_host_w, split_fetch)
    from jpgenc_tpu.ops.pack import seg_nwords_aligned, walign_for

    n_rst = layout.n_segments - 1
    n_seg = layout.n_segments
    wal = walign_for(layout.blocks_per_segment)

    cap_w = fns["caps"][0] // 4
    guess = [1024]   # adaptive prefix-length guess (u32 words), per stream

    def launch():
        # enqueue the combined (prefix + metadata) fetch buffer IMMEDIATELY
        # behind its own encode: if it were enqueued at collect time it
        # would sit in the device queue behind the NEXT batch's encode,
        # serializing the pipeline. ONE array -> collect pays one sync.
        u, nbits, ovf = fns["encode_bytes"](
            frames_dev, qt_dev, plan.plan, plan.scan_flat, luts)
        handle, k = combined_fetch(u, nbits, ovf, guess[0])
        return handle, k, u

    def collect(pend):
        handle, k, u = pend
        arr = np.asarray(handle)
        d2h = arr.nbytes
        up, nb, ov = split_fetch(arr, k, n_seg)
        total_w = int(seg_nwords_aligned(nb, wal).sum(axis=1).max())
        assert not ov.any() and total_w <= cap_w, \
            "capacity tier overflow — bench config needs a bigger tier"
        if total_w > up.shape[-1]:
            up = fetch_prefix(u, total_w)
            d2h += up.nbytes
        guess[0] = max(total_w, 1024)
        return [hdr + finalize_host_w(up[i], nb[i], 0, n_rst, wal)
                + b"\xff\xd9" for i in range(batch)], d2h

    return launch, collect


def _device_only(plan, fns, qt_dev, luts, frames_dev, batch, npix,
                 n_iter=6) -> float:
    """Device-only encode rate: time n_iter dispatches with the packed-word
    payloads left in device memory, ended by block_until_ready on the last
    (the device queue is ordered). Separates the device rate from the D2H
    transfer + host stuffing of the pipelined rows."""
    import jax

    def step():
        return fns["encode_bytes"](
            frames_dev, qt_dev, plan.plan, plan.scan_flat, luts)
    jax.block_until_ready(step())            # warm
    t0 = time.perf_counter()
    last = None
    for _ in range(n_iter):
        last = step()
    jax.block_until_ready(last)
    dt = time.perf_counter() - t0
    return round(n_iter * batch * npix / 1e6 / dt, 2)


def _run_pipeline(layout, plan, fns, qt_dev, luts, frames_dev, hdr, batch,
                  n_iter, npix=None):
    """Timed device-pipeline encode -> (sec/batch, files, extras).
    extras carries d2h_bytes per batch and (when npix is given) the
    device-only MPix/s for the same executable."""
    launch, collect = _launch_collect(layout, plan, fns, qt_dev, luts,
                                      frames_dev, hdr, batch)
    outs, d2h = collect(launch())            # compile + warm
    assert outs[0][:2] == b"\xff\xd8" and outs[0][-2:] == b"\xff\xd9"
    # sustained pipelined loop: batch k+1's device compute is queued before
    # batch k's results are fetched/assembled, so the download + host
    # stuffing overlap the next batch's encode (async dispatch). Each
    # iteration is timed separately and the MEDIAN is reported, so one
    # straggler does not set the row.
    pending = launch()
    iters = []
    for _ in range(n_iter - 1):
        t0 = time.perf_counter()
        nxt = launch()
        outs, d2h = collect(pending)
        iters.append(time.perf_counter() - t0)
        pending = nxt
    t0 = time.perf_counter()
    outs, d2h = collect(pending)
    iters.append(time.perf_counter() - t0)
    iters.sort()
    extras = {"d2h_bytes": d2h}
    if npix is not None:
        extras["device_only_mpix_per_s"] = _device_only(
            plan, fns, qt_dev, luts, frames_dev, batch, npix)
    return iters[len(iters) // 2], outs, extras


def _link_probe():
    """Transfer probe: H2D and D2H MB/s on a fixed 8 MB buffer + the
    tiny-put round-trip latency, measured with NO jitted computation
    anywhere (compile latency must not pollute the probe), so D2H-bound
    rows can be read against it. Returns a spare un-fetched device array so
    the END of the run can re-measure D2H drift without another upload."""
    import jax
    n = 8 << 20
    host = np.arange(n, dtype=np.uint8)      # non-constant data
    t0 = time.perf_counter()
    np.asarray(jax.device_put(np.zeros(4096, np.uint8)))
    first_put_ms = (time.perf_counter() - t0) * 1e3   # absorbs any
    t0 = time.perf_counter()                 # fresh-process transfer stall
    np.asarray(jax.device_put(np.ones(4096, np.uint8)))
    rt_small_ms = (time.perf_counter() - t0) * 1e3
    # H2D: 8 MB put, fenced by a tiny put+get (the DMA queue is ordered;
    # the combined round trip below cross-checks the assumption)
    t0 = time.perf_counter()
    dev_h = jax.device_put(host)
    np.asarray(jax.device_put(np.zeros(4096, np.uint8)))
    # the fence is itself a tiny-put round trip: subtract its measured
    # latency so h2d_mb_s is not systematically understated ~15-20%
    h2d_s = max(time.perf_counter() - t0 - rt_small_ms / 1e3, 1e-6)
    # D2H: first fetch of a device array (jax.Array caches the host copy
    # after one conversion, so each probe array is fetched exactly once)
    t0 = time.perf_counter()
    np.asarray(dev_h)
    d2h_s = time.perf_counter() - t0
    # combined round trip on a fresh buffer as the cross-check
    t0 = time.perf_counter()
    np.asarray(jax.device_put(host[::-1].copy()))
    rt_s = time.perf_counter() - t0
    spare = jax.device_put(host[: n // 2].copy())     # for the end re-probe
    probe = {
        "buffer_mb": n >> 20,
        "first_put_ms": round(first_put_ms, 1),
        "rt_small_ms": round(rt_small_ms, 1),
        "h2d_mb_s": round((n >> 20) / h2d_s, 1),
        "d2h_mb_s": round((n >> 20) / d2h_s, 1),
        "rt_mb_s": round((2 * n >> 20) / rt_s, 1),
    }
    return probe, spare


def _psnr_bpp(data: bytes, img: np.ndarray, quality: int,
              subsampling: str | None = None,
              optimize: bool = False) -> dict:
    """Quality half of the metric pair: ours vs the Pillow anchor (encoded
    with the SAME chroma subsampling AND optimize flag so the bpp
    comparison is apples-to-apples; Pillow's default for color is
    4:2:0)."""
    from PIL import Image

    from jpgenc_tpu.utils.metrics import psnr
    px = img.shape[0] * img.shape[1]
    dec = np.asarray(Image.open(_io.BytesIO(data)).convert(
        "RGB" if img.ndim == 3 else "L"))
    buf = _io.BytesIO()
    kw = {}
    if subsampling is not None and img.ndim == 3:
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[subsampling]
    if optimize:
        kw["optimize"] = True
    Image.fromarray(img).save(buf, "JPEG", quality=quality, **kw)
    anchor = buf.getvalue()
    adec = np.asarray(Image.open(_io.BytesIO(anchor)).convert(
        "RGB" if img.ndim == 3 else "L"))
    return {
        "bpp": round(8 * len(data) / px, 4),
        "psnr_db": round(float(psnr(dec, img)), 2),
        "pillow_bpp": round(8 * len(anchor) / px, 4),
        "pillow_psnr_db": round(float(psnr(adec, img)), 2),
    }


def main() -> None:
    from jpgenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    from jax.sharding import Mesh

    from jpgenc_tpu.container.jfif import build_headers
    from jpgenc_tpu.layout import make_layout
    from jpgenc_tpu.parallel.mesh import encode_batch
    from jpgenc_tpu.utils.fixtures import synth_batch, synth_frame

    mesh = Mesh(np.array(jax.devices()[:1]), ("batch",))
    configs: dict[str, dict] = {}

    # The headline config runs unconditionally; each further matrix config
    # runs only while the time budget holds, so the JSON line always lands.
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "500"))
    bench_t0 = time.perf_counter()

    def budget_left() -> bool:
        return time.perf_counter() - bench_t0 < budget_s

    # ---- transfer probe ---------------------------------------------------
    link, d2h_spare = _link_probe()
    _log(f"link probe: {link}")

    # ---- config :8 — HEADLINE: 1080p RGB 4:2:0 Q75 -----------------------
    from jpgenc_tpu.parallel.mesh import put_batch
    frames = synth_batch(H, W, B_UP)
    layout = make_layout(H, W, "420", 0)
    plan, fns, qt_host, qt_dev, tabs, luts = _pipeline_fns(layout, 75, B, mesh)
    hdr = build_headers(layout, list(qt_host), *tabs)
    reps = -(-B // B_UP)
    tile = jax.jit(lambda x: jax.numpy.concatenate([x] * reps, axis=0)[:B],
                   out_shardings=fns["sharding_img"])
    frames_dev = tile(put_batch(frames, fns["sharding_img"]))
    frames_dev.block_until_ready()
    # 10 iterations + median: the sustained operating point
    sec, outs, ex8 = _run_pipeline(layout, plan, fns, qt_dev, luts,
                                   frames_dev, hdr, B, n_iter=10, npix=H * W)
    mpix = B * H * W / 1e6
    headline = mpix / sec
    q8 = {"mpix_per_s": round(headline, 2), **ex8,
          **_psnr_bpp(outs[0], frames[0], 75)}
    configs["1080p_420_q75"] = q8
    _log(f"c8 1080p 4:2:0 Q75 pipeline: {headline:.2f} MPix/s "
         f"(device-only {ex8['device_only_mpix_per_s']}); "
         f"bpp {q8['bpp']} psnr {q8['psnr_db']} "
         f"(pillow {q8['pillow_bpp']}/{q8['pillow_psnr_db']})")

    def _config(name, fn):
        if not budget_left():
            configs[name] = {"skipped": "bench time budget exhausted"}
            _log(f"{name}: skipped (budget)")
            return
        try:
            configs[name] = fn()
        except Exception as e:  # one config must not kill the JSON line
            configs[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
            _log(f"{name}: ERROR {e}")

    # ---- config :7 — grayscale 512x512 Q75 -------------------------------
    def c7():
        gray = np.stack([synth_frame(512, 512)[:, :, 0] for _ in range(B)])
        glayout = make_layout(512, 512, "gray", 0)
        # the noisy gray fixture lands ~1.2 bpp — above the tight bucket
        gplan, gfns, gqt_host, gqt_dev, gtabs, gluts = _pipeline_fns(
            glayout, 75, B, mesh, tier="safe")
        ghdr = build_headers(glayout, list(gqt_host), *gtabs)
        gdev = put_batch(gray, gfns["sharding_img"])
        gsec, gouts, gex = _run_pipeline(glayout, gplan, gfns, gqt_dev,
                                         gluts, gdev, ghdr, B, n_iter=8,
                                         npix=512 * 512)
        gq = _psnr_bpp(gouts[0], gray[0], 75)
        row = {"mpix_per_s": round(B * 512 * 512 / 1e6 / gsec, 2),
               **gex, **gq}
        _log(f"c7 gray 512: {row['mpix_per_s']} MPix/s "
             f"(device-only {gex['device_only_mpix_per_s']}); "
             f"bpp {gq['bpp']} psnr {gq['psnr_db']}")
        return row


    # ---- config :9 — FULL quality sweep (Q=10..95) + restart intervals ---
    # the PSNR-vs-bpp rate-distortion curve (SURVEY.md 408-410) needs >= 5
    # points; per-quality executables cache, and Q75 reuses the DRI layout's
    # plan, so the marginal cost per point is one entropy-LUT recompile.
    # Build (compile+warm) and timing are SEPARATE phases: timing
    # round-robins one mini-block per quality per round so drift hits every
    # row equally, with median over rounds*iters samples per row and a
    # monotone-noise sanity flag.
    c9_state: dict[int, tuple] = {}
    c9_rows: dict[str, dict] = {}
    rlayout = make_layout(H, W, "420", 120)

    def _c9_build(qualities, min_points):
        for q in qualities:
            if not budget_left() and len(c9_state) >= min_points:
                _log(f"c9 build truncated before Q{q} (budget)")
                break
            rplan, rfns, rqt_host, rqt_dev, rtabs, rluts = _pipeline_fns(
                rlayout, q, B, mesh)
            rhdr = build_headers(rlayout, list(rqt_host), *rtabs)
            launch, collect = _launch_collect(
                rlayout, rplan, rfns, rqt_dev, rluts, frames_dev, rhdr, B)
            routs, _ = collect(launch())          # compile + warm
            sq = _psnr_bpp(routs[0], frames[0], q)
            c9_state[q] = (rplan, rfns, rqt_dev, rluts, launch, collect, sq)

    def _c9_time(rounds=2, iters=4):
        samples: dict[int, list] = {q: [] for q in c9_state}
        d2h: dict[int, int] = {}
        for _ in range(rounds):
            for q, (_pl, _f, _qt, _lu, launch, collect, _sq) \
                    in c9_state.items():
                pending = launch()
                for _ in range(iters):
                    t0 = time.perf_counter()
                    nxt = launch()
                    _, d2h[q] = collect(pending)
                    samples[q].append(time.perf_counter() - t0)
                    pending = nxt
                collect(pending)
        for q, (pl, fns_q, qt_q, lut_q, _la, _co, sq) in c9_state.items():
            ss = sorted(samples[q])
            dev = _device_only(pl, fns_q, qt_q, lut_q, frames_dev, B, H * W)
            c9_rows[f"q{q}"] = {
                "mpix_per_s": round(mpix / ss[len(ss) // 2], 2),
                "device_only_mpix_per_s": dev, "d2h_bytes": d2h[q], **sq}
            _log(f"c9 Q{q}+DRI120: {c9_rows[f'q{q}']['mpix_per_s']} MPix/s "
                 f"(device-only {dev}, {d2h[q]} B down); bpp {sq['bpp']} "
                 f"psnr {sq['psnr_db']}")
        # monotone-noise sanity: e2e throughput should not INCREASE with
        # quality (higher Q -> more content bytes down the link). Flag
        # inversions instead of publishing them silently.
        qs = sorted(c9_state)
        for lo, hi in zip(qs, qs[1:]):
            r_lo, r_hi = c9_rows[f"q{lo}"], c9_rows[f"q{hi}"]
            if r_hi["mpix_per_s"] > r_lo["mpix_per_s"] * 1.10:
                r_hi["noise_flag"] = (
                    f"e2e rate exceeds Q{lo}'s by >10% — link noise; judge "
                    f"device_only_mpix_per_s")
                _log(f"c9 noise flag on Q{hi}: {r_hi['noise_flag']}")
        return c9_rows

    # contract-critical endpoints up front; the curve's interior points run
    # LAST (c9_extend below) so a cold-cache run never spends the whole
    # budget on the sweep and skips the other configs
    def c9():
        _c9_build((50, 95), min_points=1)
        return _c9_time()


    # ---- config :10 — optimized-Huffman two-pass, 4K ---------------------
    def c10():
        from jpgenc_tpu.api import encode as encode_one
        img4k = synth_frame(2160, 3840)
        # device-resident input (the production shape — upload measured
        # separately below)
        img4k_dev = jax.device_put(img4k)
        img4k_dev.block_until_ready()
        data4k = encode_one(img4k_dev, quality=75, optimize=True)  # warm
        # median of per-iteration times, like every other config
        iters = []
        for _ in range(5):
            t0 = time.perf_counter()
            data4k = encode_one(img4k_dev, quality=75, optimize=True)
            iters.append(time.perf_counter() - t0)
        iters.sort()
        sec4k = iters[len(iters) // 2]
        # anchor encoded optimize=True too — this row's own file is
        # optimized, and an unoptimized anchor overstated the bpp win on
        # this smooth synthetic frame
        q4k = _psnr_bpp(data4k, img4k, 75, optimize=True)
        row = {"mpix_per_s": round(2160 * 3840 / 1e6 / sec4k, 2), **q4k}
        t0 = time.perf_counter()
        data4k_up = encode_one(img4k, quality=75, optimize=True)
        row["e2e_upload_mpix_per_s"] = round(
            2160 * 3840 / 1e6 / (time.perf_counter() - t0), 2)
        assert data4k_up == data4k
        _log(f"c10 4K optimize: {row['mpix_per_s']} MPix/s "
             f"(e2e+upload {row['e2e_upload_mpix_per_s']}); "
             f"bpp {q4k['bpp']} psnr {q4k['psnr_db']}")
        return row


    # ---- config :11 — batched multi-image encode (one device),
    # double-buffered: chunk k+1's upload overlaps chunk k's encode --------
    def c11():
        from jpgenc_tpu.parallel.mesh import stage_batch
        n_chunks = 3
        staged = stage_batch(frames, quality=75, subsampling="420", mesh=mesh)
        t0 = time.perf_counter()
        for k in range(n_chunks):
            cur = staged
            if k + 1 < n_chunks:
                staged = stage_batch(frames, quality=75, subsampling="420",
                                     mesh=mesh)
            encode_batch(frames, quality=75, subsampling="420", mesh=mesh,
                         staged=cur)
        bsec = time.perf_counter() - t0
        n_imgs = n_chunks * B_UP
        row = {
            "images": n_imgs,
            "note": "slice of the 1024-image config on one device, e2e "
                    "incl. double-buffered upload; multi-host scaling "
                    "exercised in tests/test_multiprocess.py",
            "e2e_mpix_per_s": round(n_imgs * H * W / 1e6 / bsec, 2)}
        _log(f"c11 batch e2e: {row['e2e_mpix_per_s']} MPix/s ({n_imgs} imgs)")
        return row


    # ---- decode throughput ----------------------------------------------
    def cdec():
        from jpgenc_tpu.api import decode as decode_one
        from jpgenc_tpu.api import decode_batch
        # operating point: 64 frames in 32-frame chunks
        nb_dec, ch = 64, 32
        files = [outs[i % B_UP] for i in range(nb_dec)]
        # PRIMARY: device-resident decode (to_device=True) — pixels stay in
        # device memory for a training input pipeline, the production
        # decode shape; chunking pipelines the coefficient uploads behind
        # the per-chunk reconstructions
        def force(outs):
            jax.block_until_ready(outs)
        force(decode_batch(files, to_device=True, chunk=ch))  # compile+warm
        # median of one-shot batches (cross-call pipelining was measured
        # and does NOT help: the host-side parse/entropy/staging work
        # serializes against the previous call's device chunks)
        iters = []
        for _ in range(5):
            t0 = time.perf_counter()
            force(decode_batch(files, to_device=True, chunk=ch))
            iters.append(time.perf_counter() - t0)
        iters.sort()
        dsec_dev = iters[len(iters) // 2]
        row = {"mpix_per_s": round(nb_dec * H * W / 1e6 / dsec_dev, 2),
               "batch": nb_dec, "chunk": ch,
               "note": "to_device (pixels stay in HBM), chunk-pipelined"}
        # device-only rate: coefficients pre-staged in device memory,
        # timing covers ONLY the densify+reconstruction dispatches
        from jpgenc_tpu.decoder import stage_recon
        run, h2d = stage_recon(files, chunk=ch)
        force(run())                        # warm + staging fence
        iters = []
        for _ in range(5):
            t0 = time.perf_counter()
            force(run())
            iters.append(time.perf_counter() - t0)
        iters.sort()
        row["device_only_mpix_per_s"] = round(
            nb_dec * H * W / 1e6 / iters[len(iters) // 2], 2)
        row["h2d_bytes"] = h2d
        # secondary: with the RGB host download (8 files)
        files8 = files[:8]
        decode_batch(files8)                                # compile + warm
        t0 = time.perf_counter()
        for _ in range(2):
            decode_batch(files8)
        dsec = (time.perf_counter() - t0) / 2
        row["download_mpix_per_s"] = round(len(files8) * H * W / 1e6 / dsec, 2)
        decode_one(outs[0])                                 # compile + warm
        t0 = time.perf_counter()
        for i in range(2):
            decode_one(outs[i])
        row["single_mpix_per_s"] = round(H * W / 1e6
                                         / ((time.perf_counter() - t0) / 2), 2)
        # single-image decode of a DRI file (median-of-5). This row rides
        # the packed upload path; the segment-parallel threaded scan decode
        # only matters for large (>= ~512 KB/thread) scans and is covered
        # by tests/test_native.py.
        from jpgenc_tpu.api import encode as encode_one
        dri_file = encode_one(frames[0], quality=75, restart_interval=8)
        decode_one(dri_file)                                # compile + warm
        iters = []
        for _ in range(5):
            t0 = time.perf_counter()
            decode_one(dri_file)
            iters.append(time.perf_counter() - t0)
        iters.sort()
        row["single_dri_mpix_per_s"] = round(
            H * W / 1e6 / iters[len(iters) // 2], 2)
        _log(f"decode 1080p: to_device {row['mpix_per_s']} MPix/s; "
             f"+download {row['download_mpix_per_s']}; "
             f"single {row['single_mpix_per_s']}; "
             f"single+DRI {row['single_dri_mpix_per_s']}")
        return row


    # e2e including upload through the production batch path (B_UP fresh
    # frames cross the link each iteration)
    def c8_e2e():
        mpix_up = B_UP * H * W / 1e6
        outs2 = encode_batch(frames, quality=75, subsampling="420", mesh=mesh)
        t0 = time.perf_counter()
        for _ in range(2):
            outs2 = encode_batch(frames, quality=75, subsampling="420",
                                 mesh=mesh)
        e2e = mpix_up / ((time.perf_counter() - t0) / 2)
        assert outs2[0] == outs[0], "batched paths disagree"
        configs["1080p_420_q75"]["e2e_upload_mpix_per_s"] = round(e2e, 2)
        _log(f"c8 e2e+upload: {e2e:.2f} MPix/s")
        return {"e2e_upload_mpix_per_s": round(e2e, 2),
                "note": "also recorded on the 1080p_420_q75 row"}

    # ---- conformance mode: libjpeg-exact integer pipeline ----------------
    def c_islow():
        fns_i = dict(fns)

        def _enc_islow(frames_d, qt, splan, scan_flat, luts):
            zz = fns["zz_islow"](frames_d, qt)
            return fns["entropy_bytes_shared"](zz, splan, luts)

        fns_i["encode_bytes"] = _enc_islow
        isec, iouts, iex = _run_pipeline(layout, plan, fns_i, qt_dev, luts,
                                         frames_dev, hdr, B, n_iter=6,
                                         npix=H * W)
        iq = _psnr_bpp(iouts[0], frames[0], 75)
        row = {"mpix_per_s": round(mpix / isec, 2), **iex, **iq,
               "note": "dct_method=islow — files byte-identical to "
                       "libjpeg-turbo (pillow_bpp equals bpp exactly)"}
        _log(f"c8i islow 1080p: {row['mpix_per_s']} MPix/s "
             f"(device-only {iex['device_only_mpix_per_s']}); "
             f"bpp {iq['bpp']} (pillow {iq['pillow_bpp']})")
        return row

    # ---- 4:2:2 / 4:4:4 throughput rows (BASELINE.json:8 covers all three
    # subsampling modes) -----------------------------------------------------
    def _c_sub(sub):
        slayout = make_layout(H, W, sub, 0)
        splan, sfns, sqt_host, sqt_dev, stabs, sluts = _pipeline_fns(
            slayout, 75, B, mesh)
        shdr = build_headers(slayout, list(sqt_host), *stabs)
        ssec, souts, sex = _run_pipeline(slayout, splan, sfns, sqt_dev,
                                         sluts, frames_dev, shdr, B,
                                         n_iter=8, npix=H * W)
        sq = _psnr_bpp(souts[0], frames[0], 75, subsampling=sub)
        row = {"mpix_per_s": round(mpix / ssec, 2), **sex, **sq}
        _log(f"c8-{sub} 1080p {sub} Q75: {row['mpix_per_s']} MPix/s "
             f"(device-only {sex['device_only_mpix_per_s']}); "
             f"bpp {sq['bpp']} psnr {sq['psnr_db']}")
        return row

    # ---- batched two-pass optimized Huffman (config :10 at production
    # scale — the 4K row covers the single-image sync floor; this row
    # covers the batched device pipeline: pass-1 histogram + per-image
    # table build + pass 2, device-resident input, zero staging) ---------
    def c_opt():
        from jpgenc_tpu.parallel.mesh import encode_batch
        outs_o = encode_batch(frames_dev, quality=75, subsampling="420",
                              mesh=mesh, optimize=True)    # compile + warm
        iters = []
        for _ in range(5):
            t0 = time.perf_counter()
            outs_o = encode_batch(frames_dev, quality=75, subsampling="420",
                                  mesh=mesh, optimize=True)
            iters.append(time.perf_counter() - t0)
        iters.sort()
        row = {"mpix_per_s": round(mpix / iters[len(iters) // 2], 2),
               **_psnr_bpp(outs_o[0], frames[0], 75, optimize=True),
               "note": "device-resident input, per-image custom tables"}
        _log(f"c10b batched optimize 1080p: {row['mpix_per_s']} MPix/s; "
             f"bpp {row['bpp']} (pillow {row['pillow_bpp']})")
        return row

    _config("qsweep_dri", c9)
    _config("1080p_422_q75", lambda: _c_sub("422"))
    _config("1080p_444_q75", lambda: _c_sub("444"))
    _config("1080p_islow_q75", c_islow)
    _config("1080p_420_q75_optimized", c_opt)
    _config("gray512_q75", c7)
    _config("4k_optimized", c10)
    _config("decode_1080p", cdec)
    _config("e2e_upload", c8_e2e)
    _config("batch_sharded", c11)

    # extend the rate-distortion curve with whatever budget remains. The
    # re-timing round-robins ALL built qualities in one window, so the
    # endpoint rows measured earlier are REPLACED by same-window numbers.
    if isinstance(configs.get("qsweep_dri"), dict) \
            and "error" not in configs["qsweep_dri"] \
            and "skipped" not in configs["qsweep_dri"]:
        try:
            _c9_build((10, 75, 25, 90), min_points=0)
            if budget_left():
                _c9_time()
            else:
                _log("c9 re-time skipped (budget) — endpoint rows keep "
                     "their first-phase timings")
        except Exception as e:
            _log(f"qsweep extension: ERROR {e}")

    # end-of-run D2H re-probe on the spare buffer staged by _link_probe:
    # drift between this and link["d2h_mb_s"] bounds how much the transfer
    # rate moved under the rows above
    t0 = time.perf_counter()
    np.asarray(d2h_spare)
    link["d2h_mb_s_end"] = round(
        (d2h_spare.nbytes >> 20) / (time.perf_counter() - t0), 1)
    _log(f"link probe (end): d2h {link['d2h_mb_s_end']} MB/s "
         f"(start {link['d2h_mb_s']})")

    # roofline-style cost model per benched layout (SURVEY.md section 6:
    # the bench driver exposes the FLOPs/bytes accounting)
    from jpgenc_tpu.utils.profiling import flops_bytes_estimate
    cost_model = {}
    for name, sub, dri in (("1080p_420", "420", 0), ("1080p_422", "422", 0),
                           ("1080p_444", "444", 0), ("1080p_420_dri120",
                                                     "420", 120)):
        cost_model[name] = flops_bytes_estimate(make_layout(H, W, sub, dri))
    cost_model["gray512"] = flops_bytes_estimate(
        make_layout(512, 512, "gray", 0))
    cost_model["4k_420"] = flops_bytes_estimate(
        make_layout(2160, 3840, "420", 0))
    for name, cm in cost_model.items():
        _log(f"cost model {name}: {cm}")

    # Full detail goes to stderr; stdout carries ONE COMPACT line,
    # size-guarded below so a reader of the output's tail can parse it.
    detail = {
        "metric": "MPix/s on one device, baseline JPEG encode @ Q=75 (1080p "
                  "RGB 4:2:0, batched, device pipeline + packed-bytes "
                  "download + host file assembly)",
        "value": round(headline, 2),
        "unit": "MPix/s",
        "backend": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "link_probe": link,
        "configs": configs,
        "cost_model": cost_model,
    }
    _log("DETAIL " + json.dumps(detail))

    def _compact_row(row):
        if not isinstance(row, dict):
            return row
        keep = {}
        for k in ("mpix_per_s", "bpp", "psnr_db", "e2e_upload_mpix_per_s",
                  "e2e_mpix_per_s", "download_mpix_per_s",
                  "single_mpix_per_s", "single_dri_mpix_per_s",
                  "error", "skipped"):
            if k in row:
                keep[k] = row[k] if not isinstance(row[k], str) \
                    else row[k][:60]
        if "device_only_mpix_per_s" in row:     # short key: line is size-
            keep["dev"] = row["device_only_mpix_per_s"]   # guarded at 1900
        if "noise_flag" in row:
            keep["noise"] = 1
        return keep

    compact_configs = {}
    for name, row in configs.items():
        if name == "qsweep_dri":
            compact_configs[name] = {q: _compact_row(r)
                                     for q, r in row.items()} \
                if isinstance(row, dict) else row
        else:
            compact_configs[name] = _compact_row(row)

    compact_link = {k: link[k] for k in
                    ("h2d_mb_s", "d2h_mb_s", "d2h_mb_s_end", "rt_small_ms")
                    if k in link}
    line_obj = {
        "metric": "MPix/s on one device, baseline JPEG encode @ Q=75, "
                  "1080p RGB 4:2:0",
        "value": round(headline, 2),
        "unit": "MPix/s",
        "backend": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "link": compact_link,
        "configs": compact_configs,
    }
    line = json.dumps(line_obj, separators=(",", ":"))
    if len(line) > 1900:  # keep the line readable from a 2000-char tail
        line_obj["configs"] = {
            name: (row.get("mpix_per_s") if isinstance(row, dict) else None)
            for name, row in compact_configs.items() if name != "qsweep_dri"}
        line_obj["qsweep"] = {
            q: [r.get("mpix_per_s"), r.get("dev")]
            for q, r in compact_configs.get("qsweep_dri", {}).items()
            if isinstance(r, dict)}
        line = json.dumps(line_obj, separators=(",", ":"))
    print(line[:1990])


if __name__ == "__main__":
    main()
