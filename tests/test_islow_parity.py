"""Full-FILE byte parity with libjpeg-turbo (SURVEY.md §8 hard part 3's
stretch goal, beyond the byte-exact-headers contract): the integer islow
pipeline (ref/islow.py) reproduces Pillow's encoder output byte-for-byte —
headers AND entropy scan — at matched settings.

Oracle chain: Pillow (libjpeg-turbo 12.x) encodes; we re-encode the same
pixels through rgb_ycc fixed-point -> libjpeg edge expansion -> biased box
means -> jpeg_fdct_islow -> magnitude-rounded quantization -> jccoefct
dummy blocks -> our canonical Huffman writer, and compare whole files.
"""
import io

import numpy as np
import pytest
from PIL import Image

from jpgenc_tpu.container.jfif import build_headers
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ref.encoder import entropy_scan, standard_tables
from jpgenc_tpu.ref.islow import image_to_zigzag_islow
from jpgenc_tpu.tables import QTABLE_CHROMA, QTABLE_LUMA, scale_qtable
from jpgenc_tpu.utils.fixtures import synth_frame

_PIL_SUBS = {"444": 0, "422": 1, "420": 2}


def _ours(img, quality, mode, restart=0):
    layout = make_layout(img.shape[0], img.shape[1], mode, restart)
    if mode == "gray":
        qts = [scale_qtable(QTABLE_LUMA, quality)]
    else:
        qts = [scale_qtable(QTABLE_LUMA, quality),
               scale_qtable(QTABLE_CHROMA, quality)]
    zz = image_to_zigzag_islow(img, layout, qts)
    dc_t, ac_t = standard_tables()
    if mode == "gray":
        dc_t, ac_t = dc_t[:1], ac_t[:1]
    hdr = build_headers(layout, qts, dc_t, ac_t)
    return hdr + entropy_scan(layout, zz, dc_t, ac_t) + b"\xff\xd9"


def _pillow(img, quality, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality,
                              **({} if mode == "gray"
                                 else {"subsampling": _PIL_SUBS[mode]}),
                              **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
@pytest.mark.parametrize("q", [50, 75, 90])
def test_whole_file_byte_parity(mode, q):
    img = synth_frame(120, 136)
    if mode == "gray":
        img = img[:, :, 0]
    assert _ours(img, q, mode) == _pillow(img, q, mode)


@pytest.mark.parametrize("hw", [(16, 16), (17, 23), (60, 60), (121, 130),
                                (47, 111), (128, 144)])
def test_byte_parity_sizes_420(hw):
    """Every padding/dummy-block geometry: exact multiples, odd dims,
    partial blocks, dummy rows+columns."""
    img = synth_frame(*hw)
    assert _ours(img, 75, "420") == _pillow(img, 75, "420")


def test_byte_parity_sizes_422_gray():
    for hw in [(17, 23), (60, 62), (121, 130)]:
        img = synth_frame(*hw)
        assert _ours(img, 80, "422") == _pillow(img, 80, "422")
        assert _ours(img[:, :, 0], 85, "gray") == \
            _pillow(img[:, :, 0], 85, "gray")


def test_byte_parity_noise():
    """Noise content exercises every SSSS bucket and run pattern."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    assert _ours(img, 75, "420") == _pillow(img, 75, "420")
    assert _ours(img, 95, "444") == _pillow(img, 95, "444")


def test_byte_parity_restart_markers():
    """Pillow restart_marker_rows=1 -> DRI = MCUs/row; RSTn cadence,
    numbering and segment 1-padding must all line up for byte equality."""
    img = synth_frame(64, 80)
    pil = _pillow(img, 75, "420", restart_marker_rows=1)
    layout = make_layout(64, 80, "420", 5)       # 80/16 = 5 MCUs per row
    qts = [scale_qtable(QTABLE_LUMA, 75), scale_qtable(QTABLE_CHROMA, 75)]
    zz = image_to_zigzag_islow(img, layout, qts)
    dc_t, ac_t = standard_tables()
    ours = build_headers(layout, qts, dc_t, ac_t) + \
        entropy_scan(layout, zz, dc_t, ac_t) + b"\xff\xd9"
    assert ours == pil


def test_byte_parity_optimized_huffman():
    """optimize=True: our T.81 K.2 table builder (adjust-BITS, all-ones
    reservation, libjpeg tie-breaking) emits the SAME custom tables as
    libjpeg's jpeg_gen_optimal_table — whole file byte-identical."""
    from jpgenc_tpu.huffman import build_codes, optimize_tables
    from jpgenc_tpu.ref.encoder import symbol_histogram

    img = synth_frame(64, 80)
    pil = _pillow(img, 75, "420", optimize=True)
    layout = make_layout(64, 80, "420", 0)
    qts = [scale_qtable(QTABLE_LUMA, 75), scale_qtable(QTABLE_CHROMA, 75)]
    zz = image_to_zigzag_islow(img, layout, qts)
    freq = symbol_histogram(layout, zz)
    dc_o = [build_codes(*optimize_tables(freq[0, t])) for t in range(2)]
    ac_o = [build_codes(*optimize_tables(freq[1, t])) for t in range(2)]
    ours = build_headers(layout, qts, dc_o, ac_o) + \
        entropy_scan(layout, zz, dc_o, ac_o) + b"\xff\xd9"
    assert ours == pil


def test_api_islow_byte_parity():
    """The PRODUCTION path (api.encode(dct_method='islow') — device jnp
    pipeline + fused entropy kernels + device finalize) emits files
    byte-identical to Pillow/libjpeg-turbo, including two-pass optimize."""
    from jpgenc_tpu import api

    img = synth_frame(120, 136)
    for mode in ("444", "422", "420"):
        assert api.encode(img, quality=75, subsampling=mode,
                          dct_method="islow") == _pillow(img, 75, mode)
    gray = img[:, :, 0]
    assert api.encode(gray, quality=90, dct_method="islow") == \
        _pillow(gray, 90, "gray")
    # two-pass optimized Huffman through the device histogram
    assert api.encode(img, quality=75, subsampling="420", optimize=True,
                      dct_method="islow") == \
        _pillow(img, 75, "420", optimize=True)
    # restart markers (DRI = MCUs per row at 420: 136 -> 9)
    assert api.encode(img, quality=75, subsampling="420",
                      restart_interval=9, dct_method="islow") == \
        _pillow(img, 75, "420", restart_marker_rows=1)


def test_batch_islow_byte_parity():
    """mesh.encode_batch(dct_method='islow') on the 8-device CPU mesh:
    every image byte-identical to Pillow (incl. per-image optimize)."""
    from jpgenc_tpu.parallel.mesh import encode_batch

    imgs = np.stack([synth_frame(47, 111, seed=7 + i) for i in range(8)])
    outs = encode_batch(imgs, quality=75, subsampling="420",
                        dct_method="islow")
    for i in range(8):
        assert outs[i] == _pillow(imgs[i], 75, "420")
    outs = encode_batch(imgs[:4], quality=80, subsampling="420",
                        optimize=True, dct_method="islow")
    for i in range(4):
        assert outs[i] == _pillow(imgs[i], 80, "420", optimize=True)


def test_striped_islow_byte_parity_aligned():
    """encode_striped(dct_method='islow') with MCU-aligned dims is
    byte-identical to libjpeg at the same DRI (stripe boundaries are
    restart boundaries; the stripes' DC resets mirror libjpeg's)."""
    from jpgenc_tpu.parallel.mesh import encode_striped

    img = synth_frame(128, 80)          # 8 MCU rows of 16 -> 4 stripes
    data = encode_striped(img, n_stripes=4, quality=75, subsampling="420",
                          restart_interval=5, dct_method="islow")
    # Pillow: restart_marker_rows=2 -> DRI = 2 MCU rows... use rows=... no:
    # DRI must equal 5 MCUs (one MCU row = 5). restart_marker_rows=1 -> 5.
    # Our stripe interval 5 = one MCU row -> segments align.
    assert data == _pillow(img, 75, "420", restart_marker_rows=1)


def test_byte_parity_random_matrix():
    """Randomized sweep: 16 seeded (size, quality, mode) combos through the
    NumPy islow reference, every file byte-identical to Pillow."""
    rng = np.random.default_rng(42)
    modes = ["gray", "444", "422", "420"]
    for trial in range(16):
        h = int(rng.integers(9, 150))
        w = int(rng.integers(9, 150))
        q = int(rng.choice([35, 60, 75, 85, 97]))
        mode = modes[trial % 4]
        img = synth_frame(h, w, noise=float(rng.integers(0, 30)),
                          seed=trial)
        if mode == "gray":
            img = img[:, :, 0]
        assert _ours(img, q, mode) == _pillow(img, q, mode), \
            f"trial {trial}: {h}x{w} q{q} {mode}"


@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
def test_islow_jnp_matches_numpy_ref(mode):
    """Unit tier: the device (jnp) islow pipeline is bit-identical to the
    NumPy reference across modes and awkward geometries."""
    import jax
    import jax.numpy as jnp

    from jpgenc_tpu.ops.islow import image_to_zigzag_islow as dev

    for hw in [(64, 80), (47, 111), (17, 23)]:
        img = synth_frame(*hw)
        if mode == "gray":
            img = img[:, :, 0]
        layout = make_layout(hw[0], hw[1], mode, 0)
        qts = [scale_qtable(QTABLE_LUMA, 75),
               scale_qtable(QTABLE_CHROMA, 75)]
        ref = image_to_zigzag_islow(img, layout, qts)
        qtabs = jnp.asarray(np.stack([q.reshape(64) for q in qts]))
        got = np.asarray(jax.jit(
            lambda x, q, lay=layout: dev(x, lay, q))(img, qtabs))
        np.testing.assert_array_equal(got, ref)


def test_striped_islow_byte_parity_odd_dims():
    """encode_striped(dct_method='islow') on NON-MCU-aligned dims: the
    stripe layouts carry the true width (dummy-column rule) and the tail
    stripe re-encodes under its true-height layout (dummy-row chains), so
    the file is byte-identical to libjpeg for all dims."""
    from jpgenc_tpu.parallel.mesh import encode_striped

    # ragged color: 61 rows -> 4 MCU rows of 16 (3 stripes: 2+1+1 kept);
    # odd width 77 -> 5 MCUs/row, default ragged DRI = 5
    img = synth_frame(61, 77)
    data = encode_striped(img, n_stripes=3, quality=75, subsampling="420",
                          dct_method="islow")
    assert data == _pillow(img, 75, "420", restart_marker_rows=1)

    # non-ragged gray with a mid-MCU bottom edge: 39 rows -> 5 block rows,
    # 5 stripes of 1 row each; DRI = 7 MCUs (one row at width 50)
    gray = synth_frame(39, 50)[:, :, 0]
    data = encode_striped(gray, n_stripes=5, quality=90, dct_method="islow")
    assert data == _pillow(gray, 90, "gray", restart_marker_rows=1)


def test_striped_islow_optimize_byte_parity_odd_dims():
    """optimize=True over the islow stripe lane on odd dims: the SPMD
    histogram's padding-row counts are corrected before table building, so
    the custom-table file matches libjpeg's optimize=True output exactly."""
    from jpgenc_tpu.parallel.mesh import encode_striped

    img = synth_frame(45, 64)            # 3 MCU rows, ragged over 2 stripes
    data = encode_striped(img, n_stripes=2, quality=75, subsampling="420",
                          optimize=True, dct_method="islow")
    assert data == _pillow(img, 75, "420", optimize=True,
                           restart_marker_rows=1)
