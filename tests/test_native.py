"""Native C++ scan codec vs the pure-Python reference paths."""
import numpy as np
import pytest

from jpgenc_tpu import native
from jpgenc_tpu.api import encode
from jpgenc_tpu.container.parser import parse_jpeg
from jpgenc_tpu.decoder import decode_scan_to_blocks, layout_from_parsed
from jpgenc_tpu.engine import segments_to_scan

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain")


def _python_decode(parsed, layout):
    """Force the pure-Python fallback path."""
    import jpgenc_tpu.decoder as D
    orig = native.available
    try:
        native.available = lambda: False
        return D.decode_scan_to_blocks(parsed, layout)
    finally:
        native.available = orig


@pytest.mark.parametrize("kwargs", [
    dict(quality=75),
    dict(quality=30, restart_interval=3),
    dict(quality=90, optimize=True),
])
def test_native_decode_matches_python_gray(gray_image, kwargs):
    data = encode(gray_image, **kwargs)
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    nat = decode_scan_to_blocks(parsed, layout)
    ref = _python_decode(parsed, layout)
    np.testing.assert_array_equal(nat, ref)


@pytest.mark.parametrize("sub", ["420", "422", "444"])
def test_native_decode_matches_python_color(rgb_image, sub):
    data = encode(rgb_image, quality=75, subsampling=sub, restart_interval=2)
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    nat = decode_scan_to_blocks(parsed, layout)
    ref = _python_decode(parsed, layout)
    np.testing.assert_array_equal(nat, ref)


def test_native_decode_pillow_file(rgb_image):
    """Decode a libjpeg-produced file, not just our own output."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgb_image).save(buf, format="JPEG", quality=80)
    parsed = parse_jpeg(buf.getvalue())
    layout = layout_from_parsed(parsed)
    nat = decode_scan_to_blocks(parsed, layout)
    ref = _python_decode(parsed, layout)
    np.testing.assert_array_equal(nat, ref)


def test_native_finalize_matches_host(gray_image):
    from jpgenc_tpu.engine import (get_plan, luts_from_tables,
                                   qtables_for_quality)
    from jpgenc_tpu.layout import make_layout
    from jpgenc_tpu.ref.encoder import standard_tables
    layout = make_layout(*gray_image.shape, "gray", 4)
    plan = get_plan(layout)
    _, qt = qtables_for_quality(75)
    dc_t, ac_t = standard_tables()
    seg_w, seg_b = plan.encode_segments(gray_image, qt,
                                        luts_from_tables(dc_t, ac_t))
    seg_w, seg_b = np.asarray(seg_w), np.asarray(seg_b)
    orig = native.available
    try:
        native.available = lambda: False    # pure-Python reference side
        ref = segments_to_scan(seg_w, seg_b, first_rst=2)
    finally:
        native.available = orig
    assert native.finalize_scan(seg_w, seg_b, 2) == ref


def test_native_decode_rejects_truncated_stream(gray_image):
    """Truncated scans must raise, not fabricate coefficients (both paths)."""
    data = encode(gray_image, quality=75, restart_interval=2)
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    parsed.scan_data = parsed.scan_data[:len(parsed.scan_data) // 3]
    with pytest.raises(ValueError):
        decode_scan_to_blocks(parsed, layout)
    with pytest.raises(ValueError):
        _python_decode(parsed, layout)


def test_native_decode_rejects_truncated_single_segment(gray_image):
    data = encode(gray_image, quality=75)
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    parsed.scan_data = parsed.scan_data[:len(parsed.scan_data) // 4]
    with pytest.raises(ValueError):
        decode_scan_to_blocks(parsed, layout)


def test_native_optimize_tables_matches_python():
    """C++ T.81 K.2 builder is an exact port of the Python implementation,
    including the highest-symbol tie-break and ADJUST_BITS length folding."""
    from jpgenc_tpu.huffman import _optimize_tables_py, build_codes
    assert native.available(), "native library must build in CI"
    rng = np.random.default_rng(7)
    cases = [
        rng.integers(0, 10_000, 256),             # dense uniform
        rng.integers(0, 3, 256),                  # sparse, heavy ties
        np.where(np.arange(256) < 20,
                 2 ** np.arange(256, dtype=np.float64).clip(0, 40), 0
                 ).astype(np.int64),              # skewed: triggers ADJUST_BITS
        np.eye(256, dtype=np.int64)[17] * 5,      # single symbol
        np.ones(256, dtype=np.int64),             # all equal (max ties)
    ]
    for _ in range(20):
        n_sym = int(rng.integers(1, 257))
        f = np.zeros(256, np.int64)
        idx = rng.choice(256, n_sym, replace=False)
        f[idx] = rng.integers(1, 1_000_000, n_sym)
        cases.append(f)
    for f in cases:
        f = np.asarray(f, np.int64)
        got = native.optimize_tables(f)
        assert got is not None
        bits_n, vals_n = got
        bits_p, vals_p = _optimize_tables_py(f)
        np.testing.assert_array_equal(bits_n, bits_p)
        np.testing.assert_array_equal(vals_n, vals_p)
        build_codes(bits_n, vals_n)               # must be a valid table


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_threaded_decode_matches_serial(rgb_image, mode):
    """Segment-parallel decode (restart segments across threads) is
    bit-identical to the serial walk, for both the dense and the
    direct-sparse emit paths — including the pair ORDER of the sparse form
    (per-thread buffers concatenate in segment order)."""
    from jpgenc_tpu.decoder import scan_pairs
    data = encode(rgb_image, quality=85, subsampling="420",
                  restart_interval=1)
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    assert layout.n_segments >= 4   # enough segments to actually fan out
    if mode == "dense":
        serial = decode_scan_to_blocks(parsed, layout, n_threads=1)
        for nt in (0, 2, 3, 8):
            np.testing.assert_array_equal(
                decode_scan_to_blocks(parsed, layout, n_threads=nt), serial)
    else:
        si, sv = scan_pairs(parsed, layout, n_threads=1)
        for nt in (0, 2, 3, 8):
            ti, tv = scan_pairs(parsed, layout, n_threads=nt)
            np.testing.assert_array_equal(ti, si)
            np.testing.assert_array_equal(tv, sv)


def test_threaded_decode_more_threads_than_segments(gray_image):
    """Thread count is capped by segment count (and a no-restart scan is one
    segment -> serial), with identical results."""
    data = encode(gray_image, quality=75)          # no DRI: 1 segment
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    np.testing.assert_array_equal(
        decode_scan_to_blocks(parsed, layout, n_threads=16),
        decode_scan_to_blocks(parsed, layout, n_threads=1))


def test_threaded_decode_rejects_truncated_stream(rgb_image):
    """Malformed-stream detection survives the threaded path."""
    data = encode(rgb_image, quality=75, restart_interval=1)
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    parsed.scan_data = parsed.scan_data[:len(parsed.scan_data) // 3]
    with pytest.raises(ValueError):
        decode_scan_to_blocks(parsed, layout, n_threads=4)


class TestPackedDecode:
    """native.decode_scan_packed + decoder._densify_packed: the 2-byte
    (delta, val_s8) coefficient upload form must reproduce exactly what the
    pair/dense forms decode, including value escapes (|v| > 127) and
    phantom hops (gaps > 255)."""

    @staticmethod
    def _unpack_host(main, eidx, evals, layout, n64):
        """NumPy reference of decoder._densify_packed: the delta chain is
        in SCAN-POSITION space; pos -> flat via the layout's scan table."""
        pos = np.cumsum(main[:, 0].astype(np.int64)) - 1
        val = main[:, 1].view(np.int8).astype(np.int32)
        sf = np.asarray(layout.scan_flat, np.int64)
        ok = pos < sf.size * 64
        idx = sf[pos[ok] >> 6] * 64 + (pos[ok] & 63)
        dense = np.zeros(n64, np.int32)
        dense[idx] = val[ok]
        dense[eidx] = evals
        return dense

    def _roundtrip(self, img, **kw):
        from jpgenc_tpu.decoder import (decode_scan_to_blocks,
                                        layout_from_parsed, scan_packed)
        data = encode(img, **kw)
        parsed = parse_jpeg(data)
        layout = layout_from_parsed(parsed)
        pk = scan_packed(parsed, layout)
        assert pk is not None
        dense = decode_scan_to_blocks(parsed, layout).reshape(-1)
        got = self._unpack_host(*pk, layout, dense.size)
        np.testing.assert_array_equal(got, dense)
        return pk

    def test_packed_matches_dense_color_dri(self, rgb_image):
        self._roundtrip(rgb_image, quality=80, subsampling="420",
                        restart_interval=2)

    def test_packed_escapes(self, rng):
        """High-contrast content at Q95 produces |v| > 127 coefficients."""
        img = rng.integers(0, 256, (64, 64, 3), np.uint8)
        pk = self._roundtrip(img, quality=95)
        assert pk[1].size > 0, "expected value escapes in noise at Q95"

    def test_packed_phantoms(self, rng):
        """A flat mid-gray image (DC = 0 everywhere) with two bright dots:
        runs of all-zero blocks make scan-position gaps > 255 (phantom
        hops)."""
        img = np.full((128, 128), 128, np.uint8)
        img[8, 8] = img[100, 100] = 255
        pk = self._roundtrip(img, quality=50)
        assert (pk[0][:, 0] == 255).any(), "expected phantom hops"

    def test_packed_device_decode_matches(self, rgb_image, gray_image,
                                          pixel_parity):
        """Full decode() (packed device path) == dense-forced decode
        (knife-edge pixel-parity bound: different upload forms compile to
        different executables — see the pixel_parity fixture)."""
        import jpgenc_tpu.decoder as D
        for img, kw in ((rgb_image, dict(quality=92, subsampling="422")),
                        (gray_image, dict(quality=75, restart_interval=4))):
            data = encode(img, **kw)
            got = D.decode(data)
            orig = native.available
            try:
                native.available = lambda: False     # python dense path
                ref = D.decode(data)
            finally:
                native.available = orig
            pixel_parity(got, ref)

    def test_packed_batch_matches_single(self, rng, pixel_parity):
        from jpgenc_tpu.decoder import decode, decode_batch
        imgs = [rng.integers(0, 256, (48, 64, 3), np.uint8)
                for _ in range(5)]
        files = [encode(i, quality=85) for i in imgs]
        got = decode_batch(files, chunk=2)
        for g, f in zip(got, files):
            pixel_parity(g, decode(f))

    def test_packed_flat_bridging(self, rng, pixel_parity):
        """Chunk-flat stream: frames with empty/sparse coefficient streams
        (flat gray = all-zero) between dense frames exercise the bridge
        phantoms across whole frames."""
        from jpgenc_tpu.decoder import decode, decode_batch
        imgs = [np.full((48, 64, 3), 128, np.uint8),      # empty stream
                rng.integers(0, 256, (48, 64, 3), np.uint8),
                np.full((48, 64, 3), 128, np.uint8),
                rng.integers(0, 256, (48, 64, 3), np.uint8)]
        files = [encode(i, quality=75) for i in imgs]
        got = decode_batch(files, chunk=4)
        for g, f in zip(got, files):
            pixel_parity(g, decode(f))

    def test_packed_dense_fallback(self, rgb_image, monkeypatch,
                                   pixel_parity):
        """When packed loses to dense (pathological content), decode()
        host-unpacks the packed stream instead of entropy-decoding twice —
        pixels must be identical."""
        import jpgenc_tpu.decoder as D
        data = encode(rgb_image, quality=90, restart_interval=3)
        ref = D.decode(data)
        monkeypatch.setattr(D, "_packed_wins", lambda *a: False)
        pixel_parity(D.decode(data), ref)

    def test_pairs_from_packed_matches_scan_pairs(self, rng):
        """The no-second-decode fallback conversion (packed -> pairs on
        host) must reproduce scan_pairs exactly, escapes and phantoms
        included."""
        from jpgenc_tpu.decoder import (_pairs_from_packed,
                                        layout_from_parsed, scan_packed,
                                        scan_pairs)
        img = rng.integers(0, 256, (64, 80, 3), np.uint8)   # escapes @ Q95
        img[:16] = 128                                      # phantom gaps
        data = encode(img, quality=95, restart_interval=2)
        parsed = parse_jpeg(data)
        layout = layout_from_parsed(parsed)
        pk = scan_packed(parsed, layout)
        gi, gv = _pairs_from_packed(pk, layout)
        ri, rv = scan_pairs(parsed, layout)
        np.testing.assert_array_equal(np.sort(gi), np.sort(ri))
        dense_g = np.zeros(64 * sum(c.n_blocks for c in layout.comps),
                           np.int32)
        dense_r = dense_g.copy()
        dense_g[gi] = gv
        dense_r[ri] = rv
        np.testing.assert_array_equal(dense_g, dense_r)

    def test_packed_threaded_matches_serial(self, rng):
        """Segment-parallel packed emission: the merged stream decodes to
        the same coefficients as the serial walk (the per-range delta
        chains are re-bridged at concat), across thread counts."""
        from jpgenc_tpu.decoder import layout_from_parsed, scan_packed
        img = rng.integers(0, 256, (96, 128, 3), np.uint8)
        img[:32] = 128                      # empty blocks -> phantom gaps
        data = encode(img, quality=92, restart_interval=1)
        parsed = parse_jpeg(data)
        layout = layout_from_parsed(parsed)
        assert layout.n_segments >= 8
        n64 = 64 * sum(c.n_blocks for c in layout.comps)
        ref = self._unpack_host(*scan_packed(parsed, layout, n_threads=1),
                                layout, n64)
        for nt in (2, 3, 8, 0):
            got = self._unpack_host(
                *scan_packed(parsed, layout, n_threads=nt), layout, n64)
            np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("hw", [(1, 1), (7, 5), (16, 1), (17, 31)])
    def test_packed_decode_odd_geometries(self, rng, hw, pixel_parity):
        """Tiny/odd image geometries through the packed device path equal
        the python dense reference (1-pixel, single-row/column, non-MCU
        sizes)."""
        import jpgenc_tpu.decoder as D
        h, w = hw
        for img, kw in ((rng.integers(0, 256, (h, w), np.uint8), {}),
                        (rng.integers(0, 256, (h, w, 3), np.uint8),
                         {"subsampling": "420"})):
            data = encode(img, quality=85, **kw)
            got = D.decode(data)
            orig = native.available
            try:
                native.available = lambda: False
                ref = D.decode(data)
            finally:
                native.available = orig
            np.testing.assert_array_equal(got, ref)


def test_native_library_keyed_on_source_and_abi():
    """The loaded library is the one built from this source (its file name
    carries the source hash) and reports the ABI the bindings expect."""
    import hashlib
    import os
    assert native.available()
    with open(native._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert os.path.basename(native._so_path()) == \
        f"libscan_codec-{digest}.so"
    assert native.LIB.scan_codec_abi() == native.ABI_VERSION
