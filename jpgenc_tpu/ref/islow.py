"""Integer 'islow' transform pipeline — libjpeg-compatible fixed-point math.

SURVEY.md §8 hard part 3 names full scan-byte parity with libjpeg as the
stretch goal beyond the byte-exact-headers contract: the float matmul path
cannot match libjpeg's scan bytes because jpeg_fdct_islow rounds at two
fixed points mid-transform. This module re-derives that arithmetic from the
classical Loeffler-Ligtenberg-Moshovitz factorization with libjpeg's
published scaling conventions (CONST_BITS=13, PASS1_BITS=2, descale =
round-half-up at each pass), plus the matching fixed-point color transform
(SCALEBITS=16 with the 0.5-epsilon chroma rounding fudge) and the
alternating-bias 2x2 chroma mean. With these, quantized coefficients — and
therefore whole files — are byte-identical to libjpeg-turbo's baseline
encoder at matched settings (tested against the Pillow oracle).

NumPy reference tier (M0): the device (jnp) twin lives in
ops/transform.py:fdct8x8_islow and ops/color.py islow variants; both are
equality-tested against this module, which is itself equality-tested
against Pillow-produced files decoded back to coefficients.
"""
from __future__ import annotations

import numpy as np

CONST_BITS = 13
PASS1_BITS = 2

# FIX(x) = round(x * 2^13) of the LLM rotation constants
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172


def _descale(x, n):
    """round-half-up then arithmetic shift (libjpeg DESCALE)."""
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, pass1: bool):
    """One 8-point islow pass over the last axis of int64 data [..., 8]."""
    d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., i] for i in range(8))
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4

    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    if pass1:
        out0 = (tmp10 + tmp11) << PASS1_BITS
        out4 = (tmp10 - tmp11) << PASS1_BITS
        shift = CONST_BITS - PASS1_BITS
    else:
        out0 = _descale(tmp10 + tmp11, PASS1_BITS)
        out4 = _descale(tmp10 - tmp11, PASS1_BITS)
        shift = CONST_BITS + PASS1_BITS

    z1 = (tmp12 + tmp13) * _F_0_541196100
    out2 = _descale(z1 + tmp13 * _F_0_765366865, shift)
    out6 = _descale(z1 - tmp12 * _F_1_847759065, shift)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * _F_1_175875602

    t4 = tmp4 * _F_0_298631336
    t5 = tmp5 * _F_2_053119869
    t6 = tmp6 * _F_3_072711026
    t7 = tmp7 * _F_1_501321110
    z1 = z1 * -_F_0_899976223
    z2 = z2 * -_F_2_562915447
    z3 = z3 * -_F_1_961570560 + z5
    z4 = z4 * -_F_0_390180644 + z5

    out7 = _descale(t4 + z1 + z3, shift)
    out5 = _descale(t5 + z2 + z4, shift)
    out3 = _descale(t6 + z2 + z3, shift)
    out1 = _descale(t7 + z1 + z4, shift)
    return np.stack([out0, out1, out2, out3, out4, out5, out6, out7],
                    axis=-1)


def fdct8x8_islow(blocks: np.ndarray) -> np.ndarray:
    """Level-shifted int blocks [..., 8, 8] -> islow DCT coefficients
    (scaled x8), bit-exact to jpeg_fdct_islow: rows first (output scaled
    2^PASS1_BITS), then columns (descaled back)."""
    x = blocks.astype(np.int64)
    x = _fdct_1d(x, pass1=True)                       # over rows' last axis
    x = _fdct_1d(np.swapaxes(x, -1, -2), pass1=False)
    return np.swapaxes(x, -1, -2)


def quantize_islow(coef: np.ndarray, qtable64: np.ndarray) -> np.ndarray:
    """libjpeg forward_DCT quantization of x8-scaled islow coefficients:
    divide by 8*q with round-half-away-from-zero done in magnitude space
    (temp += qval>>1 before truncating division)."""
    q = (qtable64.astype(np.int64) << 3).reshape((1,) * (coef.ndim - 2)
                                                 + (8, 8))
    mag = np.abs(coef.astype(np.int64)) + (q >> 1)
    return (np.sign(coef) * (mag // q)).astype(np.int32)


# --- fixed-point color transform (jccolor-compatible) ----------------------

SCALEBITS = 16
_ONE_HALF = 1 << (SCALEBITS - 1)
_CBCR_OFFSET = 128 << SCALEBITS


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def rgb_to_ycbcr_islow(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> [H, W, 3] uint8 YCbCr, bit-exact to libjpeg's
    rgb_ycc_convert table arithmetic (the chroma channels use the
    0.5-epsilon rounding fudge: + ONE_HALF - 1)."""
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + _ONE_HALF) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> SCALEBITS
    return np.stack([y, cb, cr], axis=-1).astype(np.uint8)


def downsample_h2v2_islow(plane: np.ndarray) -> np.ndarray:
    """libjpeg h2v2_downsample: 2x2 mean with the alternating +1/+2 bias
    ("trick to avoid systematic bias toward large output values"); bias
    restarts at 1 on every output row. plane: [H, W] uint8 with H, W even."""
    p = plane.astype(np.int32)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)[None, :]
    return ((s + bias) >> 2).astype(np.uint8)


def downsample_h2v1_islow(plane: np.ndarray) -> np.ndarray:
    """libjpeg h2v1_downsample: horizontal pair mean, alternating bias 0/1
    per output column, restarting each row."""
    p = plane.astype(np.int32)
    s = p[:, 0::2] + p[:, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 0, 1)[None, :]
    return ((s + bias) >> 1).astype(np.uint8)


# --- full libjpeg-geometry pipeline: image -> zigzag coefficient blocks ----

def image_to_zigzag_islow(img: np.ndarray, layout, qtables) -> np.ndarray:
    """uint8 image -> concatenated [n_total, 64] ZIGZAG blocks (raster per
    component), bit-exact to libjpeg-turbo's baseline encoder:

    - fixed-point color convert (rgb_to_ycbcr_islow)
    - horizontal edge expansion at FULL resolution to rx*wib*8 before
      downsampling (jcsample expand_right_edge); vertical expansion pads
      full-res only to a multiple of the sampling ratio, then duplicates
      the last DOWNSAMPLED row to fill the block grid (jcprepct pads the
      iMCU row in the post-downsample buffer) — the asymmetry matters
    - alternating-bias box means (downsample_h2v2/h2v1_islow)
    - islow FDCT + magnitude-space quantization rounding
    - jccoefct dummy blocks for the MCU padding beyond width/height_in_
      blocks: AC = 0, DC chains from the previous block in MCU block order

    layout: jpgenc_tpu.layout.FrameLayout; qtables: per-table-id natural
    order [64] arrays (dict or sequence indexed by comp.qtab).
    """
    from jpgenc_tpu import tables as T

    H, W = img.shape[:2]
    if layout.is_gray:
        ycc_planes = [img if img.ndim == 2 else img[..., 0]]
    else:
        ycc = rgb_to_ycbcr_islow(img)
        ycc_planes = [ycc[..., i] for i in range(3)]
    hs_max = layout.comps[0].hs
    vs_max = layout.comps[0].vs

    parts = []
    for ci, c in enumerate(layout.comps):
        qt = np.asarray(qtables[c.qtab]).reshape(8, 8)
        rx, ry = hs_max // c.hs, vs_max // c.vs
        cw, ch = -(-W * c.hs // hs_max), -(-H * c.vs // vs_max)
        wib, hib = -(-cw // 8), -(-ch // 8)
        bw, bh = layout.mcus_x * c.hs, layout.mcus_y * c.vs
        plane = ycc_planes[ci]
        if rx == 1 and ry == 1:
            p = np.pad(plane, ((0, hib * 8 - H), (0, wib * 8 - W)),
                       mode="edge")
        else:
            fr = np.pad(plane,
                        ((0, (-H) % ry), (0, rx * wib * 8 - W)), mode="edge")
            ds = downsample_h2v2_islow(fr) if ry == 2 \
                else downsample_h2v1_islow(fr)
            p = np.pad(ds, ((0, hib * 8 - ds.shape[0]), (0, 0)), mode="edge")
        blocks = p.reshape(hib, 8, wib, 8).transpose(0, 2, 1, 3) \
            .reshape(-1, 8, 8).astype(np.int64) - 128
        q = quantize_islow(fdct8x8_islow(blocks), qt).reshape(hib, wib, 8, 8)

        full = np.zeros((bh, bw, 8, 8), np.int32)
        full[:hib, :wib] = q
        for x in range(wib, bw):                      # dummy columns
            full[:hib, x, 0, 0] = full[:hib, wib - 1, 0, 0]
        for y in range(hib, bh):                      # dummy rows
            for x in range(bw):
                if x % c.hs == 0:
                    prev = full[y - 1, x - x % c.hs + c.hs - 1, 0, 0]
                else:
                    prev = full[y, x - 1, 0, 0]
                full[y, x, 0, 0] = prev
        nat = full.reshape(bh * bw, 64)
        parts.append(nat[:, np.asarray(T.ZIGZAG)])
    return np.concatenate(parts, axis=0)
