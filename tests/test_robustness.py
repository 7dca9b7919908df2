"""Decoder robustness + encode fallback-chain tests.

The decoder must fail with a clean ValueError — never KeyError/IndexError/
segfault — on truncated, bit-flipped, or structurally foreign baseline files,
and must decode files whose Huffman/quant table ids differ from the canonical
assignment. The encoder's capacity fallback chain must keep even pathological
noise content on the device pipeline (tight -> safe -> worst tiers), never
reaching the host word path.
"""
import numpy as np
import pytest

from jpgenc_tpu.api import decode, encode
from jpgenc_tpu.container.parser import parse_jpeg


def _decode_ok_or_valueerror(data: bytes):
    try:
        decode(data)
    except ValueError:
        pass


class TestFuzz:
    def test_truncations(self, rgb_image):
        data = encode(rgb_image, quality=75, restart_interval=4)
        for frac in (0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99):
            _decode_ok_or_valueerror(data[:int(len(data) * frac)])

    def test_truncations_gray(self, gray_image):
        data = encode(gray_image, quality=85)
        for cut in (2, 3, 4, 10, 21, len(data) - 3, len(data) - 1):
            _decode_ok_or_valueerror(data[:cut])

    def test_byte_flips(self, rgb_image, rng):
        data = bytearray(encode(rgb_image, quality=75, restart_interval=8))
        for _ in range(40):
            pos = int(rng.integers(2, len(data)))
            orig = data[pos]
            data[pos] = int(rng.integers(0, 256))
            _decode_ok_or_valueerror(bytes(data))
            data[pos] = orig

    def test_marker_corruptions(self, gray_image):
        data = encode(gray_image, quality=75)
        # corrupt each marker byte in the header region
        for pos in range(2, min(64, len(data) - 1)):
            mutated = data[:pos] + bytes([data[pos] ^ 0xFF]) + data[pos + 1:]
            _decode_ok_or_valueerror(mutated)

    def test_garbage_prefixes(self):
        for blob in (b"", b"\x00", b"\xff", b"\xff\xd8", b"\xff\xd8\xff",
                     b"PNG not a jpeg", b"\xff\xd8\xff\xe0\x00\x01",
                     b"\xff\xd8" + b"\xff" * 32):
            _decode_ok_or_valueerror(blob)


class TestForeignFiles:
    def test_unsupported_sampling_factor_message(self, rgb_image):
        data = bytearray(encode(rgb_image, quality=75, subsampling="420"))
        # SOF0 luma sampling byte: find FFC0, comp list starts at +10
        i = data.find(b"\xff\xc0")
        samp_pos = i + 4 + 6 + 1  # marker+len + prec/h/w/nc + comp id
        assert data[samp_pos] == 0x22
        # 3x1 luma: legal JPEG (factors 1-4) but outside the decoder's
        # mode map (4:1:1 / 4:4:0 / 4:1:0 are covered since round 4 —
        # tests/test_foreign_sampling.py)
        data[samp_pos] = 0x31
        with pytest.raises(ValueError, match="[Uu]nsupported sampling"):
            decode(bytes(data))
        data[samp_pos] = 0x22    # restore luma; break a CHROMA factor
        data[samp_pos + 3] = 0x21
        with pytest.raises(ValueError, match="[Uu]nsupported sampling"):
            decode(bytes(data))

    def test_noncanonical_table_ids(self, gray_image):
        """A gray file rewritten to use Huffman table id 1 (legal; our encoder
        emits id 0) must decode identically via the by-id table mapping."""
        data = encode(gray_image, quality=75)
        ref = decode(data)
        mutated = bytearray(data)
        # DHT segments: set Th 0 -> 1 (keep Tc)
        i = 0
        while True:
            i = mutated.find(b"\xff\xc4", i)
            if i < 0:
                break
            tcth = mutated[i + 4]
            mutated[i + 4] = (tcth & 0xF0) | 0x01
            i += 2
        # SOS Td/Ta: 0x00 -> 0x11
        i = mutated.find(b"\xff\xda")
        mutated[i + 6] = 0x11
        out = decode(bytes(mutated))
        np.testing.assert_array_equal(out, ref)

    def test_high_table_ids_decode_via_native_path(self, gray_image,
                                                   monkeypatch):
        """A legal baseline file using Huffman table ids 2/3 (T.81 allows
        Th 0-3) must decode through the NATIVE decoder, not the ~1000x
        slower pure-Python per-bit reader. The Python
        fallback always builds per-bit LUTs via _decode_lut, so poisoning
        it proves the native path handled the scan."""
        from jpgenc_tpu import native
        if not native.available():
            pytest.skip("native library unavailable")
        data = encode(gray_image, quality=75)
        ref = decode(data)
        mutated = bytearray(data)
        # DHT segments: Tc0 (DC) -> Th 2, Tc1 (AC) -> Th 3
        i = 0
        while True:
            i = mutated.find(b"\xff\xc4", i)
            if i < 0:
                break
            tcth = mutated[i + 4]
            mutated[i + 4] = (tcth & 0xF0) | (2 if tcth >> 4 == 0 else 3)
            i += 2
        # SOS Td/Ta: 0x00 -> 0x23
        i = mutated.find(b"\xff\xda")
        mutated[i + 6] = 0x23

        import jpgenc_tpu.decoder as D

        def _boom(*a, **k):
            raise AssertionError("pure-Python decode path reached for a "
                                 "native-decodable Th=2/3 file")

        monkeypatch.setattr(D, "_decode_lut", _boom)
        out = decode(bytes(mutated))
        np.testing.assert_array_equal(out, ref)
        # dense native entry point too (decode() rides scan_packed)
        parsed = parse_jpeg(bytes(mutated))
        from jpgenc_tpu.decoder import (decode_scan_to_blocks,
                                        layout_from_parsed)
        blocks = decode_scan_to_blocks(parsed, layout_from_parsed(parsed))
        assert blocks.shape[1] == 64

    def test_missing_huffman_table_is_valueerror(self, gray_image):
        data = encode(gray_image, quality=75)
        mutated = bytearray(data)
        i = mutated.find(b"\xff\xda")
        mutated[i + 6] = 0x33      # references undefined table id 3
        with pytest.raises(ValueError, match="Huffman table"):
            decode(bytes(mutated))

    def test_four_component_sof_is_valueerror(self, rgb_image):
        data = bytearray(encode(rgb_image, quality=75))
        i = data.find(b"\xff\xc0")
        data[i + 9] = 4            # component count
        with pytest.raises(ValueError):
            decode(bytes(data))


class TestOptimizedTablesLengthLimit:
    def test_deep_tree_histograms_keep_all_symbols(self, rng):
        """Regression: histograms whose Huffman tree exceeds 16 levels must
        still assign every symbol a (length-limited) code. SORT_INPUT used to
        drop symbols with pre-ADJUST_BITS code sizes > 16 (first hit by the
        4K optimize config)."""
        from jpgenc_tpu.huffman import build_codes, optimize_tables
        for _ in range(50):
            freq = np.zeros(256, np.int64)
            n = int(rng.integers(2, 60))
            syms = rng.choice(256, n, replace=False)
            freq[syms] = (2 ** rng.integers(0, 40, n)).astype(np.int64)
            bits, vals = optimize_tables(freq)
            t = build_codes(bits, vals)
            assert int(bits.sum()) == vals.size
            assert all(t.length[s] > 0 for s in syms)
            assert int(t.length[syms].max()) <= 16


class TestFallbackChain:
    def test_noise_image_never_leaves_device_pipeline(self, rng, monkeypatch):
        """Pure-noise content overflows the tight tier; the chain must finish
        on the device worst tier, never the host word path."""
        import jpgenc_tpu.api as api_mod

        def _boom(*a, **k):
            raise AssertionError("host word path reached — fallback chain broken")

        monkeypatch.setattr(api_mod, "segments_to_scan", _boom)
        noise = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        for q in (75, 90, 95):
            data = encode(noise, quality=q, subsampling="444")
            parsed = parse_jpeg(data)
            assert parsed.width == 64
            dec = decode(data)
            assert dec.shape == noise.shape

    def test_worst_tier_caps_cover_worst_case(self):
        from jpgenc_tpu.engine import scan_caps
        from jpgenc_tpu.layout import make_layout
        from jpgenc_tpu.ops.pack import MAX_BLOCK_BITS
        lay = make_layout(64, 64, "444", 2)
        cap_u, cap_s = scan_caps(lay, 95, "worst")
        worst_data = sum(c.n_blocks for c in lay.comps) * MAX_BLOCK_BITS // 8
        assert cap_u >= worst_data + 2 * lay.n_segments
        assert cap_s >= 2 * worst_data  # all-FF stuffing

    def test_batch_overflow_falls_back_per_image(self, rng):
        """A noisy image inside a batch must round-trip byte-identically to
        its single-image encode, via the device finalize fallback."""
        from jpgenc_tpu.parallel.mesh import encode_batch
        imgs = np.stack([
            np.clip(rng.normal(128, 8, (32, 32, 3)), 0, 255).astype(np.uint8),
            rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),   # noise
        ])
        for optimize in (False, True):
            outs = encode_batch(imgs, quality=90, subsampling="444",
                                optimize=optimize)
            for i in range(2):
                ref = encode(imgs[i], quality=90, subsampling="444",
                             optimize=optimize)
                assert outs[i] == ref
