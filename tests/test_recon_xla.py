"""Decode reconstruction (dequantize, IDCT, sample range limit, fancy
upsample, colour: decoder.pixel_fn as XLA compiles it) vs the float64
reference decoder (ref.decoder), for single, batched and sharded decode.

Policy: |d| <= 1 on at most 1e-3 of the pixels. The IDCT operator is
rounded from float64 once (ops.transform._KIDCT_ZZ), so exact half-way
samples (DC-only blocks) round alike on both sides; what remains is
float32 accumulation order near a rounding boundary.
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import jpgenc_tpu.decoder as D
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ref.decoder import exact_decode, reconstruct_ref


def _parity(out, ref, max_frac=1e-3):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    d = np.abs(out.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1, f"max diff {d.max()}"
    assert (d > 0).mean() <= max_frac, f"mismatch fraction {(d > 0).mean()}"


def _random_blocks(lay, seed, amp):
    rng = np.random.default_rng(seed)
    n_total = sum(c.n_blocks for c in lay.comps)
    blocks = rng.integers(-amp, amp, (n_total, 64)).astype(np.int32)
    qts = [rng.integers(1, 40, 64).astype(np.int32) for _ in lay.comps]
    return blocks, qts


@pytest.mark.parametrize("sub,h,w", [
    ("420", 32, 128), ("420", 61, 128), ("420", 257, 1920),
    ("420", 64, 130),                   # mcus_x = 9
    ("422", 16, 128), ("422", 47, 250), ("444", 100, 64),
])
def test_pixel_fn_vs_reference(sub, h, w):
    """Random dense coefficients (ringing, range-limit clipping) straight
    through pixel_fn vs reconstruct_ref."""
    lay = make_layout(h, w, sub)
    blocks, qts = _random_blocks(lay, h * 7919 + w, 30)
    out = D.pixel_fn(lay)(jnp.asarray(blocks), [jnp.asarray(q) for q in qts])
    _parity(out, reconstruct_ref(lay, blocks, qts))


@pytest.mark.parametrize("h,w", [(64, 64), (61, 128), (512, 512)])
def test_gray_pixel_fn_vs_reference(h, w):
    lay = make_layout(h, w, "gray")
    blocks, qts = _random_blocks(lay, h * 1000 + w, 60)
    out = D.pixel_fn(lay)(jnp.asarray(blocks), [jnp.asarray(qts[0])])
    _parity(out, reconstruct_ref(lay, blocks, qts))


def _pillow_jpeg(img, q, subsampling, **kw):
    buf = io.BytesIO()
    if subsampling is not None:
        kw["subsampling"] = subsampling
    Image.fromarray(img).save(buf, "JPEG", quality=q, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("sub,q,h,w", [
    (2, 75, 120, 128), (2, 50, 61, 128), (1, 90, 64, 128), (0, 35, 48, 128),
    (2, 92, 80, 250),          # width not MCU-aligned: crop path
    (2, 75, 64, 130),          # mcus_x = 9
])
def test_decode_vs_reference(rng, sub, q, h, w):
    img = np.clip(rng.normal(128, 50, (h, w, 3)), 0, 255).astype(np.uint8)
    data = _pillow_jpeg(img, q, sub)
    _parity(D.decode(data), exact_decode(data))


def test_decode_exceptions_and_dri(rng):
    """High-contrast content at high quality produces |coef| > 127 escape
    entries in the packed upload; DRI exercises multi-segment scans."""
    img = (rng.integers(0, 2, (96, 128, 3)) * 255).astype(np.uint8)
    data = _pillow_jpeg(img, 95, 2, restart_marker_blocks=2)
    from jpgenc_tpu.container.parser import parse_jpeg
    parsed = parse_jpeg(data)
    pk = D.scan_packed(parsed, D.layout_from_parsed(parsed))
    if pk is not None:
        assert pk[1].size > 0, "expected escape exceptions in this fixture"
    _parity(D.decode(data), exact_decode(data))


def test_decode_batch_chunked_vs_reference(rng):
    imgs = [np.clip(rng.normal(128, 45, (61, 128, 3)), 0, 255)
            .astype(np.uint8) for _ in range(5)]
    datas = [_pillow_jpeg(im, 75, 2) for im in imgs]
    outs = D.decode_batch(datas, chunk=2)
    assert len(outs) == 5
    for a, data in zip(outs, datas):
        _parity(a, exact_decode(data))
    dev = D.decode_batch(datas, to_device=True, chunk=2)
    assert [c.shape[0] for c in dev] == [2, 2, 1]


def test_mesh_decode_vs_reference(rng):
    """Sharded decode_batch on the 8-device CPU mesh."""
    from jpgenc_tpu.parallel import mesh as M
    imgs = [np.clip(rng.normal(128, 45, (61, 128, 3)), 0, 255)
            .astype(np.uint8) for _ in range(4)]
    datas = [_pillow_jpeg(im, 75, 2) for im in imgs]
    for a, data in zip(M.decode_batch(datas, to_device=False), datas):
        _parity(a, exact_decode(data))


def test_decode_crops_padded_width(rng):
    """Reconstruction runs on the MCU-padded planes and crops on device."""
    img = np.clip(rng.normal(128, 40, (16, 250, 3)), 0, 255).astype(np.uint8)
    data = _pillow_jpeg(img, 80, 1)
    out = D.decode(data)
    assert out.shape == (16, 250, 3)
    _parity(out, exact_decode(data))


def test_dc_only_blocks_round_like_reference():
    """DC-only blocks reconstruct to DC*q/8 + 128, exactly half-way for
    many (DC, q). The float64-built IDCT row is exactly 1/8, so such
    samples round as the reference rounds them; a float32-built row
    (0.12499999) put whole blocks one level apart."""
    lay = make_layout(8, 8 * 120, "gray")
    dcs = np.arange(-60, 60)
    for q0 in (3, 5, 9, 12, 13):
        blocks = np.zeros((120, 64), np.int32)
        blocks[:, 0] = dcs
        q = np.full(64, 7, np.int32)
        q[0] = q0
        out = D.pixel_fn(lay)(jnp.asarray(blocks), [jnp.asarray(q)])
        np.testing.assert_array_equal(
            np.asarray(out), reconstruct_ref(lay, blocks, [q]),
            err_msg=f"q0={q0}")


def test_decode_gray_single_and_batch(rng):
    img = np.clip(rng.normal(128, 50, (61, 128)), 0, 255).astype(np.uint8)
    data = _pillow_jpeg(img, 80, None)
    ref = exact_decode(data)
    _parity(D.decode(data), ref)
    for a in D.decode_batch([data] * 3, chunk=2):
        _parity(a, ref)
