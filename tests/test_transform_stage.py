"""Transform stage (colour, subsample, FDCT, quantize, zigzag in scan order:
engine.pixels_to_scan) vs the NumPy reference encoder.

The float DCT sums its products in another order than the reference, so a
coefficient within an ulp of a rounding boundary may flip by one; the
round-trip tests gate correctness exactly (same policy as test_m1_device).
"""
import numpy as np
import pytest

from jpgenc_tpu.engine import pixels_to_scan, qtables_for_quality
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ref.encoder import image_to_zigzag


def _compare(img, layout, quality):
    qt_host, qt = qtables_for_quality(quality)
    got = np.asarray(pixels_to_scan(img, layout, qt))
    s_pad = layout.n_segments * layout.blocks_per_segment
    assert got.shape == (s_pad, 64)
    assert not got[layout.n_scan:].any(), "padding slots must be zero"
    ref = image_to_zigzag(img, layout, list(qt_host))[
        np.asarray(layout.scan_flat)]
    diff = np.abs(got[:layout.n_scan].astype(np.int64) - ref)
    assert diff.max() <= 1, f"max |d| {diff.max()}"
    assert (diff != 0).mean() < 2e-3


@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 75, 92])
def test_transform_matches_reference(mode, quality):
    local = np.random.default_rng(1234 + quality + len(mode))
    h, w = (96, 64) if mode == "420" else (64, 64)
    img = (local.integers(0, 255, (h, w), dtype=np.uint8) if mode == "gray"
           else local.integers(0, 255, (h, w, 3), dtype=np.uint8))
    _compare(img, make_layout(h, w, mode, 0), quality)


def test_transform_unpadded_dims():
    """Non-MCU-aligned image with restarts: replicate padding and segment
    padding slots flow through."""
    img = np.random.default_rng(77).integers(0, 255, (50, 42, 3),
                                             dtype=np.uint8)
    _compare(img, make_layout(50, 42, "420", 2), 75)


# --- the coefficient bound catches a TF32 product -----------------------------
#
# chip_smoke.py holds the float coefficients to |d| <= 1 on at most 1e-4 of
# them, and every float32 product pins Precision.HIGHEST. These tests plant
# TF32 rounding (10-bit mantissa operands, float32 accumulation) into the
# [n,64]@[64,64] FDCT product of a 1080p smoke frame and check which smoke
# comparisons it would fail. Both ways of converting float32 to TF32 are
# planted: truncation, and rounding to nearest.

def _tf32(a, nearest: bool):
    import jax
    import jax.numpy as jnp
    u = jax.lax.bitcast_convert_type(a.astype(jnp.float32), jnp.uint32)
    if nearest:
        u = u + jnp.uint32(0x1000)
    return jax.lax.bitcast_convert_type(u & jnp.uint32(0xFFFFE000),
                                        jnp.float32)


def _plane_to_zigzag_tf32(nearest: bool):
    import jax
    import jax.numpy as jnp

    from jpgenc_tpu import tables as T
    from jpgenc_tpu.ops import transform as X

    def p2z(plane, qtable_nat):
        x = X.blockify(plane).reshape(-1, 64) - jnp.float32(128.0)
        q_zz = qtable_nat.reshape(64).astype(jnp.float32)[
            jnp.asarray(T.ZIGZAG)]
        coef = jnp.dot(_tf32(x, nearest),
                       _tf32(jnp.asarray(X._KDCT_ZZ), nearest),
                       precision=jax.lax.Precision.HIGHEST)
        return X.round_half_away(coef / q_zz[None, :]).astype(jnp.int32)
    return p2z


@pytest.fixture(scope="module")
def smoke_frame():
    from jpgenc_tpu.utils.fixtures import synth_batch
    return synth_batch(1080, 1920, 1)[0], make_layout(1080, 1920, "420", 0)


@pytest.mark.parametrize("quality,tf32,caught", [
    (75, None, False), (95, None, False),
    (75, "truncate", True), (95, "truncate", True), (95, "nearest", True)])
def test_coefficient_bound_vs_tf32(smoke_frame, monkeypatch, quality, tf32,
                                   caught):
    """HIGHEST passes the 1e-4 bound. A TF32 product fails it in the Q95
    tier (both conversions) and in the Q75 flagship when it truncates; a
    rounding TF32 product stays under the bound at Q75, so the Q95 tier
    phase is the check that catches it."""
    import jax

    import chip_smoke
    from jpgenc_tpu.engine import pixels_to_blocks
    from jpgenc_tpu.ops import transform as X

    img, lay = smoke_frame
    qt_host, qt = qtables_for_quality(quality)
    if tf32:
        monkeypatch.setattr(X, "plane_to_zigzag",
                            _plane_to_zigzag_tf32(tf32 == "nearest"))
    got = np.asarray(jax.jit(lambda i: pixels_to_blocks(i, lay, qt))(img))
    ref = image_to_zigzag(img, lay, list(qt_host))
    if caught:
        with pytest.raises(AssertionError):
            chip_smoke.check_close(got, ref, 1e-4, "tf32")
    else:
        chip_smoke.check_close(got, ref, 1e-4, "coefficients")
