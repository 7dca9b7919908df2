"""Device (jnp) twin of ref/islow.py — libjpeg-exact integer encode path.

Everything is int32 (libjpeg's own working width; the largest islow
intermediate is ~4.1e8 < 2^31) and static-shape: the edge-expansion /
dummy-block geometry is resolved to numpy index maps at trace time from the
FrameLayout, so under jit the whole pixels->zigzag pipeline compiles to pad
/ reshape / integer-matmul-free VPU arithmetic plus one final gather for the
jccoefct dummy-DC chains. Bit-identical to ref/islow.py (tested), which is
byte-identical to libjpeg-turbo (tests/test_islow_parity.py).

The integer path trades the matmul (the float K1's home) for exactness — it is
the conformance mode, not the throughput mode.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from jpgenc_tpu import tables as T
from jpgenc_tpu.layout import FrameLayout
from jpgenc_tpu.ref import islow as R

_I32 = jnp.int32


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, pass1: bool):
    """One 8-point islow pass over the last axis ([..., 8] int32)."""
    c = [d[..., i] for i in range(8)]
    tmp0, tmp7 = c[0] + c[7], c[0] - c[7]
    tmp1, tmp6 = c[1] + c[6], c[1] - c[6]
    tmp2, tmp5 = c[2] + c[5], c[2] - c[5]
    tmp3, tmp4 = c[3] + c[4], c[3] - c[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    if pass1:
        out0 = (tmp10 + tmp11) << R.PASS1_BITS
        out4 = (tmp10 - tmp11) << R.PASS1_BITS
        shift = R.CONST_BITS - R.PASS1_BITS
    else:
        out0 = _descale(tmp10 + tmp11, R.PASS1_BITS)
        out4 = _descale(tmp10 - tmp11, R.PASS1_BITS)
        shift = R.CONST_BITS + R.PASS1_BITS

    z1 = (tmp12 + tmp13) * R._F_0_541196100
    out2 = _descale(z1 + tmp13 * R._F_0_765366865, shift)
    out6 = _descale(z1 - tmp12 * R._F_1_847759065, shift)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * R._F_1_175875602
    t4 = tmp4 * R._F_0_298631336
    t5 = tmp5 * R._F_2_053119869
    t6 = tmp6 * R._F_3_072711026
    t7 = tmp7 * R._F_1_501321110
    z1 = z1 * -R._F_0_899976223
    z2 = z2 * -R._F_2_562915447
    z3 = z3 * -R._F_1_961570560 + z5
    z4 = z4 * -R._F_0_390180644 + z5

    out7 = _descale(t4 + z1 + z3, shift)
    out5 = _descale(t5 + z2 + z4, shift)
    out3 = _descale(t6 + z2 + z3, shift)
    out1 = _descale(t7 + z1 + z4, shift)
    return jnp.stack([out0, out1, out2, out3, out4, out5, out6, out7],
                     axis=-1)


def fdct8x8_islow(blocks):
    """Level-shifted int32 blocks [..., 8, 8] -> x8-scaled islow DCT."""
    x = _fdct_1d(blocks.astype(_I32), pass1=True)
    x = _fdct_1d(jnp.swapaxes(x, -1, -2), pass1=False)
    return jnp.swapaxes(x, -1, -2)


def quantize_islow(coef, qtable64):
    """Magnitude-space rounded division by 8*q (libjpeg forward_DCT)."""
    q = (qtable64.astype(_I32) << 3).reshape(
        (1,) * (coef.ndim - 2) + (8, 8))
    mag = jnp.abs(coef) + (q >> 1)
    return jnp.sign(coef) * (mag // q)


def rgb_to_ycbcr_islow(rgb):
    """[..., 3] uint8 -> 3 int32 planes, libjpeg rgb_ycc table arithmetic."""
    r = rgb[..., 0].astype(_I32)
    g = rgb[..., 1].astype(_I32)
    b = rgb[..., 2].astype(_I32)
    f = R._fix
    y = (f(0.29900) * r + f(0.58700) * g + f(0.11400) * b
         + R._ONE_HALF) >> R.SCALEBITS
    cb = (-f(0.16874) * r - f(0.33126) * g + f(0.50000) * b
          + R._CBCR_OFFSET + R._ONE_HALF - 1) >> R.SCALEBITS
    cr = (f(0.50000) * r - f(0.41869) * g - f(0.08131) * b
          + R._CBCR_OFFSET + R._ONE_HALF - 1) >> R.SCALEBITS
    return y, cb, cr


def _downsample(p, rx: int, ry: int):
    """Alternating-bias box mean (h2v2 / h2v1), int32 in/out."""
    if ry == 2:
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        bias = jnp.asarray(np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
                           .astype(np.int32))[None, :]
        return (s + bias) >> 2
    s = p[:, 0::2] + p[:, 1::2]
    bias = jnp.asarray(np.where(np.arange(s.shape[1]) % 2 == 0, 0, 1)
                       .astype(np.int32))[None, :]
    return (s + bias) >> 1


def _dummy_maps(layout: FrameLayout):
    """Trace-time numpy geometry per component: (wib, hib, dc_src, real).

    dc_src [bh*bw] — for every block in the padded grid, the flat index of
    the REAL block whose quantized DC it carries (jccoefct dummy chains
    resolved); real [bh*bw] bool — True where the block's AC survives.
    """
    out = []
    H, W = layout.height, layout.width
    hs_max, vs_max = layout.comps[0].hs, layout.comps[0].vs
    for c in layout.comps:
        cw = -(-W * c.hs // hs_max)
        ch = -(-H * c.vs // vs_max)
        wib, hib = -(-cw // 8), -(-ch // 8)
        bw, bh = layout.mcus_x * c.hs, layout.mcus_y * c.vs
        src = np.zeros((bh, bw), np.int64)
        src[:hib, :wib] = (np.arange(hib)[:, None] * bw
                           + np.arange(wib)[None, :])
        for x in range(wib, bw):                      # dummy columns
            src[:hib, x] = src[:hib, wib - 1]
        for y in range(hib, bh):                      # dummy rows (chained)
            for x in range(bw):
                if x % c.hs == 0:
                    src[y, x] = src[y - 1, x - x % c.hs + c.hs - 1]
                else:
                    src[y, x] = src[y, x - 1]
        real = np.zeros((bh, bw), bool)
        real[:hib, :wib] = True
        out.append((cw, ch, wib, hib, src.reshape(-1), real.reshape(-1)))
    return out


def image_to_zigzag_islow(img, layout: FrameLayout, qtabs) -> jnp.ndarray:
    """uint8 image (jnp/np) -> [n_total, 64] int32 ZIGZAG blocks, raster
    per component — the jit-able twin of ref.islow.image_to_zigzag_islow.
    qtabs: [n_tables, 64] int32 natural order (device array)."""
    H, W = layout.height, layout.width
    if layout.is_gray:
        planes = [img.astype(_I32) if img.ndim == 2
                  else img[..., 0].astype(_I32)]
    else:
        planes = list(rgb_to_ycbcr_islow(img))
    hs_max, vs_max = layout.comps[0].hs, layout.comps[0].vs
    zz = jnp.asarray(np.asarray(T.ZIGZAG))
    geom = _dummy_maps(layout)

    parts = []
    for ci, c in enumerate(layout.comps):
        cw, ch, wib, hib, dc_src, real = geom[ci]
        rx, ry = hs_max // c.hs, vs_max // c.vs
        plane = planes[ci]
        if rx == 1 and ry == 1:
            p = jnp.pad(plane, ((0, hib * 8 - H), (0, wib * 8 - W)),
                        mode="edge")
        else:
            # horizontal: FULL-RES edge expansion to rx*wib*8 BEFORE the
            # box mean (jcsample expand_right_edge); vertical: full-res
            # only to a sampling-ratio multiple, then the last DOWNSAMPLED
            # row fills the block grid (jcprepct) — asymmetric on purpose
            fr = jnp.pad(plane, ((0, (-H) % ry), (0, rx * wib * 8 - W)),
                         mode="edge")
            ds = _downsample(fr, rx, ry)
            p = jnp.pad(ds, ((0, hib * 8 - ds.shape[0]), (0, 0)),
                        mode="edge")
        blocks = p.reshape(hib, 8, wib, 8).transpose(0, 2, 1, 3) \
            .reshape(-1, 8, 8) - 128
        q = quantize_islow(fdct8x8_islow(blocks),
                           qtabs[c.qtab]).reshape(hib * wib, 64)

        # embed into the padded MCU grid with the dummy-block rule: every
        # padded-grid block gathers its DC-source block's row (a real block
        # maps to itself — dc_src is always real), then dummy AC is zeroed
        bw = layout.mcus_x * c.hs
        full_src = (dc_src // bw) * wib + dc_src % bw  # real-grid row index
        gathered = q[jnp.asarray(full_src)]            # [bh*bw, 64]
        out = jnp.where(jnp.asarray(real)[:, None] | (jnp.arange(64) == 0),
                        gathered, 0)
        parts.append(out[:, zz])
    return jnp.concatenate(parts, axis=0)
