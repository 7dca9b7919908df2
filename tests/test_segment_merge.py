"""Segment merge (ops.pack.segments_from_blocks: per-block bitstreams ->
per-segment streams, one sorted scatter) vs the per-slot packer
(ops.pack.pack_segments), plus a hand-built bit-level case and the
overflow flag of the blocked pack."""
import numpy as np
import pytest

from jpgenc_tpu.engine import (get_plan, luts_from_tables, pixels_to_scan,
                               qtables_for_quality, scan_to_segments_blocked)
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops.entropy import make_pieces
from jpgenc_tpu.ops.pack import (block_pack, pack_segments,
                                 segments_from_blocks, words_per_segment)
from jpgenc_tpu.ref.encoder import standard_tables


def _case(img, mode, rst, quality, w_blk=24):
    layout = make_layout(img.shape[0], img.shape[1], mode, rst)
    plan = get_plan(layout)
    _, qt = qtables_for_quality(quality)
    luts = luts_from_tables(*standard_tables())
    zz = pixels_to_scan(img, layout, qt)
    pv, pl_ = make_pieces(zz, plan.plan, luts)
    return layout, zz, plan, luts, pv, pl_


def _used_equal(a_w, a_b, b_w, b_b):
    a_w, b_w = np.asarray(a_w), np.asarray(b_w)
    np.testing.assert_array_equal(np.asarray(a_b), np.asarray(b_b))
    used = (np.asarray(a_b) + 31) // 32
    for s in range(a_w.shape[0]):
        np.testing.assert_array_equal(a_w[s, :used[s]], b_w[s, :used[s]],
                                      err_msg=f"segment {s}")


@pytest.mark.parametrize("mode,rst", [("gray", 0), ("gray", 3), ("420", 2),
                                      ("444", 0)])
def test_merge_matches_per_slot_packer(mode, rst, gray_image, rgb_image):
    img = gray_image if mode == "gray" else rgb_image
    layout, _, _, _, pv, pl_ = _case(img, mode, rst, 75)
    n_seg = layout.n_segments
    spb = layout.blocks_per_segment
    buf, bits = block_pack(pv, pl_, 24)
    got_w, got_b = segments_from_blocks(buf, bits, n_seg, spb * 24 + 2)
    ref_w, ref_b = pack_segments(pv, pl_, n_seg, words_per_segment(spb))
    _used_equal(got_w, got_b, ref_w, ref_b)


def test_merge_hand_built_bits():
    """Three blocks of 5, 40 and 27 bits concatenate MSB-first; two
    segments of three blocks each keep their own streams."""
    rng = np.random.default_rng(3)
    lens = np.array([5, 40, 27, 0, 64, 1], np.int32)
    bitstr = [rng.integers(0, 2, n) for n in lens]
    buf = np.zeros((6, 2), np.uint32)
    for i, bs in enumerate(bitstr):
        for j, b in enumerate(bs):
            buf[i, j // 32] |= np.uint32(int(b) << (31 - j % 32))
    w, b = segments_from_blocks(buf, lens, 2, 3 * 2 + 2)
    w, b = np.asarray(w), np.asarray(b)
    assert list(b) == [72, 65]
    for s in range(2):
        want = np.concatenate(bitstr[3 * s:3 * s + 3])
        got = np.unpackbits(w[s].astype(">u4").view(np.uint8))
        np.testing.assert_array_equal(got[:want.size], want)
        assert not got[want.size:].any()


def test_blocked_pack_flags_overflow(rng):
    """A block needing more than w_blk words raises the overflow flag (the
    caller then retries a bigger tier); the worst tier never overflows."""
    img = (rng.integers(0, 2, (64, 64), dtype=np.uint8) * 255)
    layout, zz, plan, luts, _, _ = _case(img, "gray", 0, 95)
    _, _, ovf = scan_to_segments_blocked(zz, plan.plan, luts,
                                         layout.n_segments, 4, kernel=False)
    assert bool(ovf)
    w, b, ovf = scan_to_segments_blocked(zz, plan.plan, luts,
                                         layout.n_segments, 56, kernel=False)
    assert not bool(ovf)
    pv, pl_ = make_pieces(zz, plan.plan, luts)
    ref_w, ref_b = pack_segments(pv, pl_, layout.n_segments,
                                 words_per_segment(layout.blocks_per_segment))
    _used_equal(w, b, ref_w, ref_b)
