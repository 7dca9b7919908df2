"""Public API (SURVEY.md component #22, layer F): encode / decode / encode_batch."""
from __future__ import annotations

import numpy as np

from jpgenc_tpu import tables as T
from jpgenc_tpu.config import EncodeConfig
from jpgenc_tpu.container.jfif import build_headers
from jpgenc_tpu.engine import (get_plan, luts_from_tables, qtables_for_quality,
                               scan_caps, segments_to_scan)
from jpgenc_tpu.ops.pack import w_blk_for_quality
from jpgenc_tpu.huffman import build_codes, optimize_tables
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.decoder import decode, decode_batch  # noqa: F401  (public API re-exports)
from jpgenc_tpu.ref.encoder import standard_tables


def encode(img, quality: int = 75, subsampling: str = "420",
           restart_interval: int = 0, optimize: bool = False,
           dct_method: str = "float") -> bytes:
    """Baseline JFIF encode of a [H,W] grayscale or [H,W,3] RGB uint8 image,
    computed on the default JAX device.

    img may be a numpy array (uploaded per call) or a device-resident
    jax.Array (no upload — the production shape when pixels are already in
    HBM, e.g. from a data pipeline or decode(to_device=True)).

    dct_method='islow' selects the libjpeg-exact integer pipeline: the
    output file is byte-identical to libjpeg-turbo's at matched settings
    (tests/test_islow_parity.py). 'float' (default) is the matmul throughput
    path — same PSNR/bpp envelope, different low-order coefficient
    rounding."""
    import jax
    cfg = EncodeConfig(quality=quality, subsampling=subsampling,
                       restart_interval=restart_interval,
                       optimize_huffman=optimize, dct_method=dct_method)
    if not isinstance(img, jax.Array):
        img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError("image must be uint8")
    mode = "gray" if img.ndim == 2 else cfg.subsampling
    layout = make_layout(img.shape[0], img.shape[1], mode, cfg.restart_interval)
    plan = get_plan(layout)
    qt_host, qt_dev = qtables_for_quality(cfg.quality)

    # Fallback chain (SURVEY.md hard part 1 capacity design): tight caps
    # first, then safe caps, then true-worst-case caps with the
    # never-overflowing w_blk=56 block bucket — so even noise-like content
    # stays on the device pipeline. The host word path below is a safety net
    # that no input should reach.
    w_blk_q = w_blk_for_quality(cfg.quality)
    tiers = [(scan_caps(layout, cfg.quality, "tight")[0], w_blk_q),
             (scan_caps(layout, cfg.quality, "safe")[0], max(w_blk_q, 24)),
             (scan_caps(layout, cfg.quality, "worst")[0], 56)]
    tiers = [t for i, t in enumerate(tiers) if t not in tiers[:i]]
    islow = cfg.dct_method == "islow"
    if cfg.optimize_huffman:
        # pass 1 caches the SCAN-ORDERED zigzag tensor and computes the
        # symbol histogram in the same dispatch: neither pass pays the
        # raster->scan gather, and pass 2 feeds the entropy stage directly
        # (SURVEY.md call stack 4.3)
        zz, freq_dev = (plan.zz_islow_and_histogram(img, qt_dev) if islow
                        else plan.zz_and_histogram(img, qt_dev))
        freq = np.asarray(freq_dev)
        n_tabs = 1 if layout.is_gray else 2
        dc_tables = [build_codes(*optimize_tables(freq[0, t].astype(np.int64)))
                     for t in range(n_tabs)]
        ac_tables = [build_codes(*optimize_tables(freq[1, t].astype(np.int64)))
                     for t in range(n_tabs)]
        luts = luts_from_tables(dc_tables, ac_tables)
        for cap_u, w_blk in tiers:
            scan, ok = plan.entropy_scan_bytes_zz(zz, luts, cap_u, w_blk)
            if ok:
                break
        if not ok:  # capacity overflow: host finalize on the full word buffer
            seg_words, seg_bits = plan.entropy_segments_zz(zz, luts)
            scan = segments_to_scan(np.asarray(seg_words), np.asarray(seg_bits))
    elif islow:
        dc_tables, ac_tables = standard_tables()
        luts = luts_from_tables(dc_tables, ac_tables)
        zz = plan.zz_scan_islow(img, qt_dev)
        for cap_u, w_blk in tiers:
            scan, ok = plan.entropy_scan_bytes_zz(zz, luts, cap_u, w_blk)
            if ok:
                break
        if not ok:
            seg_words, seg_bits = plan.entropy_segments_zz(zz, luts)
            scan = segments_to_scan(np.asarray(seg_words), np.asarray(seg_bits))
    else:
        dc_tables, ac_tables = standard_tables()
        luts = luts_from_tables(dc_tables, ac_tables)
        for cap_u, w_blk in tiers:
            scan, ok = plan.encode_scan_bytes(img, qt_dev, luts, cap_u, w_blk)
            if ok:
                break
        if not ok:
            seg_words, seg_bits = plan.encode_segments(img, qt_dev, luts)
            scan = segments_to_scan(np.asarray(seg_words), np.asarray(seg_bits))

    hdr = build_headers(layout, list(qt_host), dc_tables, ac_tables)
    return hdr + scan + b"\xff\xd9"
