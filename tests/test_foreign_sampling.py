"""Decode-side coverage of the rarer legal baseline samplings (T.81 allows
sampling factors 1-4): 4:1:1 (DV sources), 4:4:0 and 4:1:0 files decode
through the full pipeline — parser, native/python entropy decode, XLA
reconstruction (the fused Pallas kernel's triangle operators only model
1x/2x factors and must gate off).

The encoder deliberately emits only 444/422/420/gray; fixtures are built
from the factor-general reference pieces (ref.encoder + container.jfif),
and Pillow both decodes our files (spec-validity oracle) and anchors the
pixel comparison.
"""
import io

import numpy as np
import pytest
from PIL import Image

import jpgenc_tpu.decoder as D
from jpgenc_tpu import tables as T
from jpgenc_tpu.container.jfif import build_headers
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ref import encoder as R
from jpgenc_tpu.utils.metrics import psnr


def _foreign_file(img, mode, quality=75, restart_interval=0):
    lay = make_layout(img.shape[0], img.shape[1], mode, restart_interval)
    qts = [T.scale_qtable(T.QTABLE_LUMA, quality),
           T.scale_qtable(T.QTABLE_CHROMA, quality)]
    zz = R.image_to_zigzag(img, lay, [qts[c.qtab] for c in lay.comps])
    dc_t, ac_t = R.standard_tables()
    scan = R.entropy_scan(lay, zz, dc_t, ac_t)
    hdr = build_headers(lay, qts, dc_t, ac_t)
    return hdr + scan + b"\xff\xd9", lay, zz


@pytest.mark.parametrize("mode,dims", [
    ("411", (64, 96)), ("440", (61, 64)), ("410", (48, 64)),
])
def test_foreign_sampling_decode(rng, mode, dims):
    img = np.clip(rng.normal(128, 40, dims + (3,)), 0, 255).astype(np.uint8)
    data, lay, zz = _foreign_file(img, mode)

    # spec-validity oracle: Pillow/libjpeg decodes the file
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert pil.shape == img.shape

    # coefficient round-trip is bit-identical (BASELINE core invariant)
    lay2, blocks, _ = D.decode_to_coefficients(data)
    assert lay2.subsampling == mode
    np.testing.assert_array_equal(blocks, zz)

    # pixel reconstruction agrees with the libjpeg anchor up to the
    # legal decoder freedoms (IDCT rounding, upsample filter choice)
    out = D.decode(data)
    assert out.shape == img.shape
    assert psnr(out, pil) > 30.0


def test_foreign_sampling_with_restarts(rng):
    img = np.clip(rng.normal(128, 40, (64, 96, 3)), 0, 255).astype(np.uint8)
    data, lay, zz = _foreign_file(img, "411", restart_interval=2)
    _, blocks, _ = D.decode_to_coefficients(data)
    np.testing.assert_array_equal(blocks, zz)
    out = D.decode(data)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(out, pil) > 30.0


@pytest.mark.parametrize("mode,dims", [
    ("411", (64, 96)), ("440", (61, 64)), ("410", (48, 64)),
])
def test_foreign_sampling_exact_reference(rng, mode, dims):
    """The exact-arithmetic reference decoder handles foreign samplings
    (replication fallback for factors != 2, per-component quant-table
    resolution) and the device decode tracks it within rounding."""
    from jpgenc_tpu.ref.decoder import exact_decode
    img = np.clip(rng.normal(128, 40, dims + (3,)), 0, 255).astype(np.uint8)
    data, lay, zz = _foreign_file(img, mode)
    own = D.decode(data).astype(np.int64)
    ref = exact_decode(data).astype(np.int64)
    d = np.abs(own - ref)
    assert d.max() <= 3, f"{mode}: own vs exact ref maxdiff {d.max()}"
