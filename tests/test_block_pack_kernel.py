"""Kernel A (Triton entropy block pack, ops/pallas/block_pack.py) in
interpret mode vs the XLA formulation (ops.entropy.make_pieces ->
ops.pack.block_pack): bit-identical buffers and bit counts across layouts,
restart intervals (padded slots), capacity tiers, overflowing blocks and
per-image tables. The GPU lane (test_gpu_lane.py) compiles it on the card.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jpgenc_tpu.engine import (get_plan, luts_from_tables, pack_kernel_default,
                               pixels_to_scan, qtables_for_quality,
                               scan_to_segments_blocked)
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops.entropy import make_pieces
from jpgenc_tpu.ops.pack import block_pack, w_blk_for_quality
from jpgenc_tpu.ops.pallas.block_pack import (TILE, fused_block_pack,
                                              padded_words, slot_metadata)
from jpgenc_tpu.ref.encoder import standard_tables
from jpgenc_tpu.utils.fixtures import synth_frame

CASES = [
    (128, 256, "420", 0),
    (120, 120, "420", 3),      # short last segment -> padded slots
    (64, 126, "422", 2),       # replicate-pad to the MCU grid
    (48, 62, "444", 0),
    (112, 128, "420", 1),      # every MCU its own segment
    (64, 128, "gray", 0),      # gray: one block per MCU, luma tables only
    (100, 64, "gray", 3),      # gray + DRI: short last segment
    (64, 136, "420", 0),       # mcus_x = 9
    (64, 72, "gray", 0),       # gray mcus_x = 9
]


#: kernel inputs are padded to this many slots (invalid, so they pack to
#: nothing) so each tier compiles its interpret-mode kernel once
S_FIXED = 1024


def _pair(zz, splan, luts, w_blk):
    ref_buf, ref_bits = block_pack(*make_pieces(zz, splan, luts), w_blk)
    s = zz.shape[0]
    meta = [jnp.pad(m.astype(jnp.int32), (0, S_FIXED - s))
            for m in slot_metadata(splan, zz)]
    buf, bits = fused_block_pack(jnp.pad(zz, ((0, S_FIXED - s), (0, 0))),
                                 *meta, luts=luts, w_blk=w_blk,
                                 interpret=True)
    assert not np.asarray(bits[s:]).any()
    return (np.asarray(ref_buf), np.asarray(ref_bits),
            np.asarray(buf[:s]), np.asarray(bits[:s]))


def _frame_case(h, w, sub, dri, w_blk, quality=75):
    lay = make_layout(h, w, sub, dri)
    splan = get_plan(lay).plan
    _, qt = qtables_for_quality(quality)
    luts = luts_from_tables(*standard_tables())
    img = synth_frame(h, w, channels=0 if sub == "gray" else 3)
    zz = pixels_to_scan(img, lay, qt)
    return _pair(zz, splan, luts, w_blk)


@pytest.mark.parametrize("h,w,sub,dri", CASES)
@pytest.mark.parametrize("w_blk", [8, 16, 24])
def test_kernel_matches_xla_pack(h, w, sub, dri, w_blk):
    ref_buf, ref_bits, buf, bits = _frame_case(h, w, sub, dri, w_blk)
    assert buf.shape == ref_buf.shape == (ref_bits.shape[0], w_blk)
    np.testing.assert_array_equal(bits, ref_bits)
    np.testing.assert_array_equal(buf, ref_buf)


def test_kernel_non_power_of_two_tiers():
    """The 12- and 56-word tiers run at 16/64 words and are sliced back."""
    for w_blk in (12, 56):
        ref_buf, ref_bits, buf, bits = _frame_case(120, 120, "420", 3, w_blk,
                                                   quality=95)
        np.testing.assert_array_equal(bits, ref_bits)
        np.testing.assert_array_equal(buf, ref_buf)


def test_padded_words_and_tile_padding():
    assert [padded_words(w) for w in (8, 12, 16, 24, 56)] == \
        [8, 16, 16, 32, 64]
    # a slot count that is not a TILE multiple: padding slots are dropped
    lay = make_layout(24, 40, "gray", 0)
    s = lay.n_segments * lay.blocks_per_segment
    assert s % TILE
    _, qt = qtables_for_quality(75)
    zz = pixels_to_scan(synth_frame(24, 40, channels=0), lay, qt)
    splan = get_plan(lay).plan
    luts = luts_from_tables(*standard_tables())
    buf, bits = fused_block_pack(zz, *slot_metadata(splan, zz), luts=luts,
                                 w_blk=8, interpret=True)
    ref_buf, ref_bits = block_pack(*make_pieces(zz, splan, luts), 8)
    assert bits.shape == (s,) and buf.shape == (s, 8)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(ref_bits))
    np.testing.assert_array_equal(np.asarray(buf), np.asarray(ref_buf))


def test_pack_kernel_default_follows_platform():
    gpu, cpu = SimpleNamespace(platform="gpu"), SimpleNamespace(platform="cpu")
    assert pack_kernel_default([gpu, gpu])
    assert not pack_kernel_default([gpu, cpu])
    assert not pack_kernel_default([cpu])
    assert not pack_kernel_default()          # tests run on the CPU


@pytest.mark.parametrize("mode,rst,q", [
    ("gray", 0, 75),
    ("gray", 3, 75),
    ("420", 0, 75),
    ("422", 2, 50),
    ("444", 0, 90),
])
def test_kernel_matches_on_fixtures(mode, rst, q, gray_image, rgb_image):
    img = gray_image if mode == "gray" else rgb_image
    lay = make_layout(img.shape[0], img.shape[1], mode, rst)
    plan = get_plan(lay)
    _, qt = qtables_for_quality(q)
    zz = pixels_to_scan(img, lay, qt)
    luts = luts_from_tables(*standard_tables())
    ref_buf, ref_bits, buf, bits = _pair(zz, plan.plan, luts,
                                         w_blk_for_quality(q))
    np.testing.assert_array_equal(bits, ref_bits)
    np.testing.assert_array_equal(buf, ref_buf)


def test_kernel_extreme_values(rng):
    """Saturated noise: large amplitudes, ZRL runs, EOB-less blocks, and
    blocks overflowing the 8-word tier (contributions past it dropped, as
    the XLA scatter drops them)."""
    img = (rng.integers(0, 2, (64, 64), dtype=np.uint8) * 255)
    lay = make_layout(64, 64, "gray", 2)
    _, qt = qtables_for_quality(95)
    zz = pixels_to_scan(img, lay, qt)
    luts = luts_from_tables(*standard_tables())
    for w_blk in (8, 56):
        ref_buf, ref_bits, buf, bits = _pair(zz, get_plan(lay).plan, luts,
                                             w_blk)
        np.testing.assert_array_equal(bits, ref_bits)
        np.testing.assert_array_equal(buf, ref_buf)
    assert ref_bits.max() > 8 * 32


def test_segments_blocked_kernel_vs_xla():
    """The whole blocked pack (kernel -> segment merge -> overflow flag)
    with per-image tables under vmap, as the batched optimize pass runs."""
    lay = make_layout(64, 64, "420", 2)
    splan = get_plan(lay).plan
    _, qt = qtables_for_quality(75)
    imgs = np.stack([synth_frame(64, 64, seed=s) for s in (1, 2)])
    zz = jax.vmap(lambda im: pixels_to_scan(im, lay, qt))(jnp.asarray(imgs))
    dc, ac = standard_tables()
    luts = luts_from_tables(dc, ac)
    luts_b = jax.tree.map(lambda x: jnp.stack([x, x[::-1]]), luts)

    def run(kernel):
        return jax.vmap(lambda z, lt: scan_to_segments_blocked(
            z, splan, lt, lay.n_segments, 8, kernel=kernel,
            interpret=True))(zz, luts_b)

    for a, b in zip(run(True), run(False)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
