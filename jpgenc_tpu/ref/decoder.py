"""Reference decoder reconstruction (numpy float64) — the exact-arithmetic
anchor for the device decode paths (SURVEY.md section 5 item 2: every device
stage diffs against a small numpy reference).

Implements T.81 reconstruction semantics end to end: dequant -> ideal IDCT
-> round + [0, 255] range limit per component SAMPLE -> centered triangle
("fancy") chroma upsample -> full-range BT.601 -> round/clip. The sample
range limit is the r5 fuzz-audit finding: without it, ringing overshoot
leaks through the (linear) upsample+color chain and decoded pixels drift
from every oracle on sharp/noisy content.

Oracle caveat (measured in an earlier round): libjpeg's integer islow
IDCT deviates from exact arithmetic by up to ~20/255 on coefficients
outside its IEEE-1180 accuracy domain (|coef| <= ~300) — Pillow, OpenCV
and TF agree with each other EXACTLY there because they share the code,
not because they are right. Device paths are therefore tested tightly
against THIS reference and loosely against the oracles.
"""
from __future__ import annotations

import numpy as np

from jpgenc_tpu import tables as T
from jpgenc_tpu.ops.transform import _KIDCT_ZZ


def upsample_fancy_ref(a: np.ndarray, axis: int) -> np.ndarray:
    """2x centered 3:1 triangle upsample along `axis`, edges replicated
    (float64 twin of ops/color._upsample2_axis)."""
    idx = np.arange(a.shape[axis])
    prev = np.maximum(idx - 1, 0)
    nxt = np.minimum(idx + 1, a.shape[axis] - 1)
    t = np.take(a, idx, axis)
    even = 0.75 * t + 0.25 * np.take(a, prev, axis)
    odd = 0.75 * t + 0.25 * np.take(a, nxt, axis)
    out = np.stack([even, odd], axis=axis + 1)
    shp = list(a.shape)
    shp[axis] *= 2
    return out.reshape(shp)


def _upsample_axis_ref(a: np.ndarray, f: int, axis: int) -> np.ndarray:
    """Factor-f upsample along `axis`: fancy triangle for f == 2, sample
    replication otherwise (the same fallback ops/color.upsample_fancy
    takes for foreign 4:1:1 / 4:1:0 factors)."""
    if f == 1:
        return a
    if f == 2:
        return upsample_fancy_ref(a, axis)
    return np.repeat(a, f, axis=axis)


def reconstruct_ref(layout, blocks: np.ndarray, qts) -> np.ndarray:
    """[n_total, 64] zigzag coefficient blocks + quant tables -> uint8
    pixels (cropped), exact float64 arithmetic.

    qts: a per-COMPONENT sequence of [64] natural-order tables, or a dict
    keyed by quant-table id — the dict form is only valid when the
    layout's 0/1 id convention matches the file's DQT slots (foreign
    files may use any Tq per component: pass the per-component form,
    as exact_decode does)."""
    zz = np.asarray(T.ZIGZAG)
    k = np.asarray(_KIDCT_ZZ, np.float64)
    offs = layout.comp_offsets
    planes = []
    for i, c in enumerate(layout.comps):
        q = qts[c.qtab] if isinstance(qts, dict) else qts[i]
        q = np.asarray(q).reshape(64).astype(np.float64)
        bl = np.asarray(blocks[offs[i]:offs[i] + c.n_blocks], np.float64)
        px = (bl * q[zz]) @ k + 128.0          # [n, 64] row-major samples
        bw = c.plane_w // 8
        plane = px.reshape(c.plane_h // 8, bw, 8, 8) \
            .transpose(0, 2, 1, 3).reshape(c.plane_h, c.plane_w)
        # T.81 sample range limit: round + clamp BEFORE upsample/color
        planes.append(np.clip(np.round(plane), 0, 255))
    h, w = layout.height, layout.width
    if layout.is_gray:
        return planes[0][:h, :w].astype(np.uint8)
    c0 = layout.comps[0]
    cb, cr = planes[1], planes[2]
    cb = _upsample_axis_ref(_upsample_axis_ref(cb, c0.vs, 0), c0.hs, 1)
    cr = _upsample_axis_ref(_upsample_axis_ref(cr, c0.vs, 0), c0.hs, 1)
    y = planes[0]
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136286 * (cb - 128.0) - 0.714136286 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    rgb = np.stack([r, g, b], axis=-1)[:h, :w]
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def exact_decode(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 pixels via the reference reconstruction.
    Quant tables are resolved per COMPONENT from the parsed frame (foreign
    files may assign any DQT slot id to any component)."""
    from jpgenc_tpu.decoder import (_qts_of, decode_scan_to_blocks,
                                    layout_from_parsed, parse_jpeg)
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    blocks = decode_scan_to_blocks(parsed, layout)
    return reconstruct_ref(layout, blocks, _qts_of(parsed))
