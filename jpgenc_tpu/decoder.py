"""Decoder (SURVEY.md components #19-#21, call stack 4.4).

Host side: marker parse + sequential Huffman scan decode (inherently serial —
T.81 section F.2.2) producing the exact quantized zigzag coefficient tensor the
encoder emitted. Device side: dezigzag, dequantize, IDCT, upsample, YCbCr->RGB.

The core invariant (BASELINE.json:5): decode_to_coefficients(encode(img))
is bit-identical to the encoder's quantized coefficients at matched tables.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from jpgenc_tpu import native
from jpgenc_tpu import tables as T
from jpgenc_tpu.container.parser import ParsedJpeg, parse_jpeg
from jpgenc_tpu.huffman import HuffTable
from jpgenc_tpu.layout import FrameLayout, make_layout
from jpgenc_tpu.ops import color as C
from jpgenc_tpu.ops import transform as X
from jpgenc_tpu.ref.bitio import unstuff_bytes


class _BitReader:
    """MSB-first bit reader over unstuffed entropy bytes."""

    __slots__ = ("bits", "pos", "n")

    def __init__(self, data: np.ndarray):
        self.bits = np.unpackbits(data)
        self.pos = 0
        self.n = self.bits.size

    def read_bit(self) -> int:
        if self.pos >= self.n:
            raise ValueError("bitstream exhausted")
        b = int(self.bits[self.pos])
        self.pos += 1
        return b

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.n:
            raise ValueError("bitstream exhausted")
        v = 0
        for b in self.bits[self.pos:self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v


def _decode_lut(tbl: HuffTable) -> dict[tuple[int, int], int]:
    """(length, code) -> symbol."""
    out = {}
    for sym in range(256):
        l = int(tbl.length[sym])
        if l:
            out[(l, int(tbl.code[sym]))] = sym
    return out


def _read_symbol(br: _BitReader, lut: dict[tuple[int, int], int]) -> int:
    code = 0
    for l in range(1, 17):
        code = (code << 1) | br.read_bit()
        sym = lut.get((l, code))
        if sym is not None:
            return sym
    raise ValueError("invalid Huffman code in scan")


def _extend(v: int, s: int) -> int:
    """T.81 F.2.2.1 EXTEND: amplitude bits -> signed value."""
    if s == 0:
        return 0
    return v if v >= (1 << (s - 1)) else v - (1 << s) + 1


def _tables_by_id(d: dict) -> list:
    """Huffman tables as native rows indexed BY table id (T.81 allows Th
    0-3 in baseline files); a slot the file does not define stays None —
    native._pack_tables leaves it empty, and it is never referenced (ids
    are validated against the tables present by the callers)."""
    return [d.get(i) for i in range(4)]


def _sparse_cap(nnz: int) -> int:
    """Power-of-2 sparse-row capacity bucket (bounds jit retraces)."""
    return max(4096, 1 << int(np.ceil(np.log2(max(nnz, 1)))))


def _sparse_wins(cap: int, n64: int) -> bool:
    """True when the [3, cap] int16 sparse upload beats dense int16."""
    return 6 * cap < 2 * n64


def decode_scan_to_blocks(parsed: ParsedJpeg, layout: FrameLayout,
                          n_threads: int = 0) -> np.ndarray:
    """Entropy-decode the scan into the concatenated [n_total, 64] block array.

    Uses the native C++ decoder (jpgenc_tpu.native) when available — with
    `n_threads` segment-parallel workers over restart segments (0 = auto;
    1 = serial); the pure Python reader below is the reference fallback and
    stays test-covered.

    Table assignments come from the file's SOS header (parsed.comps), not the
    canonical layout ids, so foreign baseline files with unusual Td/Ta
    assignments decode with the right tables.
    """
    comp_dc = [c.dc_tab for c in parsed.comps]
    comp_ac = [c.ac_tab for c in parsed.comps]
    for cid, (d, a) in enumerate(zip(comp_dc, comp_ac)):
        if d not in parsed.dc_tables:
            raise ValueError(
                f"component {cid} references undefined DC Huffman table {d}")
        if a not in parsed.ac_tables:
            raise ValueError(
                f"component {cid} references undefined AC Huffman table {a}")

    if native.available() and all(0 <= t <= 3 for t in comp_dc + comp_ac):
        out = native.decode_scan(
            parsed.scan_data, layout, comp_dc, comp_ac,
            _tables_by_id(parsed.dc_tables), _tables_by_id(parsed.ac_tables),
            n_threads=n_threads)
        if out is not None:
            return out
    dc_luts = {i: _decode_lut(t) for i, t in parsed.dc_tables.items()}
    ac_luts = {i: _decode_lut(t) for i, t in parsed.ac_tables.items()}

    # split at RST markers (they are never stuffed, so a raw byte scan is safe)
    segs: list[bytes] = []
    data = parsed.scan_data
    start = 0
    i = 0
    while i < len(data) - 1:
        if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
            segs.append(data[start:i])
            start = i + 2
            i += 2
        else:
            i += 1
    segs.append(data[start:])
    if len(segs) != layout.n_segments:
        raise ValueError(f"expected {layout.n_segments} restart segments, found {len(segs)}")

    n_total = sum(c.n_blocks for c in layout.comps)
    out = np.zeros((n_total, 64), dtype=np.int32)

    spb = layout.blocks_per_segment
    for s, seg in enumerate(segs):
        br = _BitReader(unstuff_bytes(seg))
        pred = [0] * len(layout.comps)
        j0 = s * spb
        j1 = min(j0 + spb, layout.n_scan)
        for j in range(j0, j1):
            ci = int(layout.scan_comp[j])
            blk = out[layout.scan_flat[j]]
            ssss = _read_symbol(br, dc_luts[comp_dc[ci]])
            diff = _extend(br.read_bits(ssss), ssss)
            pred[ci] += diff
            blk[0] = pred[ci]
            k = 1
            while k < 64:
                rs = _read_symbol(br, ac_luts[comp_ac[ci]])
                r, sz = rs >> 4, rs & 15
                if sz == 0:
                    if rs == T.ZRL:
                        k += 16
                        continue
                    break  # EOB
                k += r
                if k > 63:
                    raise ValueError("run overflows block")
                blk[k] = _extend(br.read_bits(sz), sz)
                k += 1
    return out


from jpgenc_tpu.utils.lru import LRUCache  # noqa: E402

#: bounded: one jitted reconstruction per (geometry, batch, sparse) key
_RECON = LRUCache(32)

def _rows_from_pairs(idx: np.ndarray, val: np.ndarray, size: int,
                     cap: int | None = None) -> np.ndarray:
    """Nonzero coefficient pairs -> [3, cap] int16 sparse triple rows
    (idx_lo, idx_hi, value), idx = flat position. Baseline quantized
    coefficients are ~97% zeros at photographic qualities, so this is the
    form that crosses the host->device link (6.3 MB dense -> ~0.5 MB at
    1080p Q75).
    Padding entries carry an out-of-bounds idx (`size`) and are dropped by
    the device-side scatter (mode='drop')."""
    n = idx.size
    if cap is None:
        cap = _sparse_cap(n)
    out = np.empty((3, cap), np.int16)
    out[0, :n] = (idx & 0xFFFF).astype(np.int16)
    out[1, :n] = (idx >> 16).astype(np.int16)
    out[2, :n] = val.astype(np.int16)
    out[0, n:] = np.uint16(size & 0xFFFF).view(np.int16)
    out[1, n:] = np.uint16(size >> 16).view(np.int16)
    out[2, n:] = 0
    return out


def _sparsify(blocks: np.ndarray, cap: int | None = None) -> np.ndarray:
    """Dense [n_total, 64] coefficients -> [3, cap] int16 sparse rows."""
    nz = np.flatnonzero(blocks)
    return _rows_from_pairs(nz.astype(np.int64),
                            blocks.reshape(-1)[nz], blocks.size, cap)


def scan_pairs(parsed: ParsedJpeg, layout: FrameLayout, n_threads: int = 0
               ) -> tuple[np.ndarray, np.ndarray]:
    """Entropy-decode the scan directly to nonzero coefficient pairs
    (flat idx, int16 value) — the native C++ decoder emits this form
    without ever materializing the dense [n_total, 64] tensor, decoding
    restart segments across `n_threads` workers (0 = auto; 1 = serial —
    batch paths pass 1 and parallelize across images instead); the Python
    reference decode + flatnonzero is the fallback."""
    comp_dc = [c.dc_tab for c in parsed.comps]
    comp_ac = [c.ac_tab for c in parsed.comps]
    if native.available() and all(0 <= t <= 3 for t in comp_dc + comp_ac) \
            and all(t in parsed.dc_tables for t in comp_dc) \
            and all(t in parsed.ac_tables for t in comp_ac):
        out = native.decode_scan_sparse(
            parsed.scan_data, layout, comp_dc, comp_ac,
            _tables_by_id(parsed.dc_tables), _tables_by_id(parsed.ac_tables),
            n_threads=n_threads)
        if out is not None:
            return out
    blocks = decode_scan_to_blocks(parsed, layout, n_threads=n_threads)
    nz = np.flatnonzero(blocks)
    return nz.astype(np.int64), blocks.reshape(-1)[nz].astype(np.int16)


def scan_packed(parsed: ParsedJpeg, layout: FrameLayout, n_threads: int = 0
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Entropy-decode the scan to the packed 2-byte-per-coefficient form
    (native.decode_scan_packed), decoding restart segments across
    `n_threads` workers (0 = auto; 1 = serial — batch paths pass 1 and
    parallelize across images instead). Returns None when the native
    library is unavailable, the capacity heuristic overflows, or table ids
    fall outside the native range — callers fall back to `scan_pairs`."""
    comp_dc = [c.dc_tab for c in parsed.comps]
    comp_ac = [c.ac_tab for c in parsed.comps]
    if native.available() and all(0 <= t <= 3 for t in comp_dc + comp_ac) \
            and all(t in parsed.dc_tables for t in comp_dc) \
            and all(t in parsed.ac_tables for t in comp_ac):
        return native.decode_scan_packed(
            parsed.scan_data, layout, comp_dc, comp_ac,
            _tables_by_id(parsed.dc_tables), _tables_by_id(parsed.ac_tables),
            n_threads=n_threads)
    return None


def _densify(sparse, n_total: int):
    """[3, cap] int16 sparse rows -> [n_total, 64] int16 blocks on device."""
    idx = (sparse[0].astype(jnp.int32) & 0xFFFF) | \
        (sparse[1].astype(jnp.int32) << 16)
    flat = jnp.zeros((n_total * 64,), jnp.int16)
    return flat.at[idx].set(sparse[2], mode="drop").reshape(n_total, 64)


def _densify_packed(main_u8, exc, scan_flat_ext, n_total: int):
    """Packed 2-byte (delta, val_s8) stream + [3, cap] exception rows ->
    [n_total, 64] int16 blocks on device (see native.decode_scan_packed).

    The delta chain lives in SCAN-POSITION space (pos = cumsum(delta) - 1;
    strictly monotonic even for interleaved color, where flat indices jump
    between component regions); the device maps pos -> flat via the static
    per-layout scan table, extended with an out-of-bounds sentinel so pad
    hops past the scan drop out of the scatter. Phantom hops write 0 into
    positions that are zero anyway; exceptions scatter second, overwriting
    their escape bytes."""
    # The main scatter is an ADD, not a set: trailing (255, 0) pad hops can
    # overflow the int32 position cumsum for multi-M-entry streams, and a
    # wrapped position may land back IN range — but every pad/phantom
    # carries value 0, so adding it anywhere is a no-op, while real
    # positions are strictly increasing (guarded < 2^31) and unique, where
    # add == set. Exceptions scatter SECOND with .set, overwriting their
    # -128 escape bytes.
    pos = jnp.cumsum(main_u8[:, 0].astype(jnp.int32)) - 1
    val = jax.lax.bitcast_convert_type(main_u8[:, 1],
                                       jnp.int8).astype(jnp.int16)
    j = jnp.clip(pos >> 6, 0, scan_flat_ext.shape[0] - 1)
    idx = scan_flat_ext[j] * 64 + (pos & 63)
    flat = jnp.zeros((n_total * 64,), jnp.int16)
    flat = flat.at[idx].add(val, mode="drop")
    eidx = (exc[0].astype(jnp.int32) & 0xFFFF) | \
        (exc[1].astype(jnp.int32) << 16)
    return flat.at[eidx].set(exc[2], mode="drop").reshape(n_total, 64)


def _pad_packed(main: np.ndarray, eidx: np.ndarray, evals: np.ndarray,
                cap_main: int, cap_exc: int, size: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Pad the native packed stream to the (cap_main, cap_exc) buckets:
    main pads are (255, 0) phantoms (keep walking the tail, writing zeros
    into zero positions until the index leaves the array and drops);
    exception pads carry an out-of-bounds index."""
    n = main.shape[0]
    out = np.empty((cap_main, 2), np.uint8)
    out[:n] = main
    out[n:, 0] = 255
    out[n:, 1] = 0
    return out, _rows_from_pairs(eidx.astype(np.int64), evals, size, cap_exc)


def _exc_cap(n: int) -> int:
    """Power-of-2 exception-list capacity bucket (min 256)."""
    return max(256, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _eighth_cap(n: int) -> int:
    """Capacity bucket at 1/8-power-of-2 granularity (waste <= 12.5% —
    the chunk-flat packed stream is upload-bytes-bound, so the plain
    power-of-2 bucket's up-to-2x padding is real link time)."""
    n = max(n, 4096)
    p = 1 << max(0, int(np.ceil(np.log2(n))) - 3)
    return -(-n // p) * p


def _flatten_packed(packed: list, n_scan64: int, n64: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate per-frame packed streams into ONE chunk-flat stream in
    GLOBAL scan-position space (frame f's positions live at
    [f*n_scan64, (f+1)*n_scan64)): frame boundaries are bridged by
    adjusting each frame's first delta and inserting (255, 0) phantom hops
    for gaps > 255 — phantoms only ever write zeros into trailing/leading
    zero positions, so the chunk decodes with a single exact-size upload
    and ONE scatter instead of per-frame cap-padded buffers. Returns the
    unpadded (main [n, 2] u8, exception global flat idx i64, exception
    values i16); pad with `_pad_packed(..., size=B*n64)`."""
    parts = []
    exc_idx_parts, exc_val_parts = [], []
    prev = -1                     # last written global pos
    for f, (main, eidx, evals) in enumerate(packed):
        base = f * n_scan64
        if main.shape[0]:
            first = base + int(main[0, 0]) - 1     # global pos of 1st entry
            last = base + int(main[:, 0].astype(np.int64).sum()) - 1
            gap = first - prev
            k = (gap - 1) // 255                   # bridge phantom hops
            if k:
                ph = np.zeros((k, 2), np.uint8)
                ph[:, 0] = 255
                parts.append(ph)
            if k or f:
                main = main.copy()
                main[0, 0] = gap - 255 * k
            parts.append(main)
            prev = last
        if eidx.size:
            exc_idx_parts.append(eidx.astype(np.int64) + f * n64)
            exc_val_parts.append(evals)
    main_all = np.concatenate(parts) if parts else np.zeros((0, 2), np.uint8)
    eidx = (np.concatenate(exc_idx_parts) if exc_idx_parts
            else np.zeros(0, np.int64))
    evals = (np.concatenate(exc_val_parts) if exc_val_parts
             else np.zeros(0, np.int16))
    return main_all, eidx, evals


def _pairs_from_packed(pk: tuple, layout: FrameLayout
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Convert a packed stream to (flat idx, int16 value) pairs on host —
    phantoms (value 0) dropped, escapes (-128) replaced from the exception
    list in emit order. Lets the pair/dense fallbacks reuse an
    already-decoded packed stream instead of entropy-decoding the scan a
    second time."""
    main, eidx, evals = pk
    pos = np.cumsum(main[:, 0].astype(np.int64)) - 1
    val = main[:, 1].view(np.int8)
    keep = val != 0
    pos = pos[keep]
    sf = np.asarray(layout.scan_flat, np.int64)
    idx = sf[pos >> 6] * 64 + (pos & 63)
    out = val[keep].astype(np.int16)
    esc = np.flatnonzero(out == -128)      # 1:1, in emit order
    out[esc] = evals
    return idx, out


def _packed_wins(cap_main: int, cap_exc: int, n64: int) -> bool:
    """True when the packed upload beats the dense int16 tensor."""
    return 2 * cap_main + 6 * cap_exc < 2 * n64


def pixel_fn(layout: FrameLayout):
    """The single-image device reconstruction: ([n_total, 64] coefficient
    blocks, per-component [64] natural-order quant tables) -> uint8 pixels
    cropped to the true image size. Traceable — the building block for the
    jitted/vmapped/sharded decode paths (here and parallel.mesh)."""
    offs = layout.comp_offsets
    comps = layout.comps
    h, w = layout.height, layout.width

    if layout.is_gray:
        def _pix(blocks, qts):
            plane = X.zigzag_to_plane(blocks[:comps[0].n_blocks], qts[0],
                                      comps[0].plane_h, comps[0].plane_w)
            return jnp.clip(jnp.round(plane[:h, :w]), 0, 255).astype(jnp.uint8)
    else:
        c0 = comps[0]

        def _pix(blocks, qts):
            # T.81 reconstruction semantics (and every libjpeg-family
            # decoder): IDCT output SAMPLES are rounded and range-limited
            # to [0, 255] per component BEFORE chroma upsampling and color
            # conversion. Without this, ringing overshoot on sharp/noisy
            # content propagates through the (linear) upsample+color chain
            # differently than the oracles — measured up to 27/255 off at
            # isolated overshoot pixels while Pillow and OpenCV agreed
            # exactly (r5 fuzz audit).
            planes = [
                jnp.clip(jnp.round(X.zigzag_to_plane(
                    blocks[offs[i]:offs[i] + comps[i].n_blocks],
                    qts[i], comps[i].plane_h, comps[i].plane_w)), 0, 255)
                for i in range(3)]
            y = planes[0]
            cb = C.upsample_fancy(planes[1], c0.hs, c0.vs)
            cr = C.upsample_fancy(planes[2], c0.hs, c0.vs)
            rgb = C.ycbcr_to_rgb(jnp.stack([y, cb, cr], axis=-1))
            return jnp.clip(jnp.round(rgb[:h, :w]), 0, 255).astype(jnp.uint8)

    return _pix


def _recon_jit(layout: FrameLayout, batch: int = 0, sparse: bool = False,
               form: str | None = None):
    """One jitted blocks->pixels pipeline per layout geometry (the whole
    reconstruction — dezigzag/dequant/IDCT/upsample/color — compiles to a
    single device dispatch instead of per-component un-jitted helpers).
    batch > 0 builds the vmapped form over [B, ...] inputs and
    [B, n_comps, 64] quant tables (decode_batch). Output is cropped to the
    true image size ON DEVICE (static slice) so the MCU padding rows never
    cross the link.

    form selects the coefficient upload layout, densified on device in the
    SAME dispatch (the host->device link is the decode bottleneck):
    - "dense": [n_total, 64] int16 blocks
    - "pairs" (or sparse=True): [3, cap] int16 rows (`_sparsify`)
    - "packed": ([cap, 2] u8 (delta, val_s8) stream, [3, cap_exc] int16
      exception rows) — see `_densify_packed`, 2 bytes/coefficient
    - "packedflat": one chunk-flat packed stream for the whole batch
      (`_flatten_packed`)
    """
    if form is None:
        form = "pairs" if sparse else "dense"
    key = (layout.height, layout.width, layout.subsampling, batch, form)
    fn = _RECON.get(key)
    if fn is not None:
        return fn
    n_total = sum(c.n_blocks for c in layout.comps)

    _pix = pixel_fn(layout)

    if form in ("packed", "packedflat"):
        # static per-layout scan table + OOB sentinel, baked into the
        # executable as a constant (never crosses the link per call)
        sf_ext = jnp.asarray(np.append(
            np.asarray(layout.scan_flat, np.int64), n_total).astype(np.int32))

    if form == "pairs":
        def _fn(sp, qts):
            return _pix(_densify(sp, n_total), qts)
    elif form == "packed":
        def _fn(main, exc, qts):
            return _pix(_densify_packed(main, exc, sf_ext, n_total), qts)
    elif form == "packedflat":
        # one chunk-flat stream for the WHOLE batch (see _flatten_packed):
        # a single exact-size upload + one scatter into [B*n64], then the
        # vmapped per-frame reconstruction. Not vmapped over main/exc.
        n_scan64 = layout.n_scan * 64
        B = batch

        def _flat_fn(main, exc, qts):
            # main scatter is an ADD for pad-hop int32-wrap safety (see
            # _densify_packed): pads carry value 0, so a wrapped position
            # adds nothing; real positions are unique (add == set)
            pos = jnp.cumsum(main[:, 0].astype(jnp.int32)) - 1
            frame = pos // n_scan64
            j = jnp.clip(pos - frame * n_scan64, 0, n_scan64 - 1)
            val = jax.lax.bitcast_convert_type(main[:, 1],
                                               jnp.int8).astype(jnp.int16)
            idx = frame * (n_total * 64) + \
                sf_ext[jnp.minimum(j >> 6, sf_ext.shape[0] - 1)] * 64 + \
                (j & 63)
            flat = jnp.zeros((B * n_total * 64,), jnp.int16)
            flat = flat.at[idx].add(val, mode="drop")
            eidx = (exc[0].astype(jnp.int32) & 0xFFFF) | \
                (exc[1].astype(jnp.int32) << 16)
            flat = flat.at[eidx].set(exc[2], mode="drop")
            return jax.vmap(_pix)(flat.reshape(B, n_total, 64), qts)

        fn = jax.jit(_flat_fn)
        _RECON[key] = fn
        return fn
    else:
        _fn = _pix

    fn = jax.jit(jax.vmap(_fn) if batch else _fn)
    _RECON[key] = fn
    return fn


def reconstruct_pixels(layout: FrameLayout, all_blocks: np.ndarray,
                       qtables, to_device: bool = False):
    """Device reconstruction: blocks -> uint8 image, cropped to original size.

    qtables: dict keyed by the layout's quant-table ids, or a per-component
    sequence of [64]-element natural-order tables (foreign files may assign
    any Tq per component).

    to_device=True returns the on-device jax.Array instead of downloading —
    the production shape when decoded pixels feed a training input pipeline.
    """
    if isinstance(qtables, dict):
        qts = [np.asarray(qtables[c.qtab]) for c in layout.comps]
    else:
        qts = [np.asarray(q) for q in qtables]
    qts = [jnp.asarray(q.reshape(64).astype(np.int32)) for q in qts]
    # baseline coefficients fit i16 (|DC| <= 1024, SSSS <= 10 for AC) and
    # are ~97% zeros at photographic qualities: upload the SPARSE form
    # (one put) and densify inside the recon dispatch (6.3 MB dense ->
    # ~0.5 MB sparse at 1080p Q75). Pathological dense content (sparse
    # encoding would be bigger) falls back to the dense upload.
    sp = _sparsify(all_blocks)
    if sp.nbytes < all_blocks.size * 2:
        out = _recon_jit(layout, sparse=True)(jnp.asarray(sp), qts)
    else:
        out = _recon_jit(layout)(jnp.asarray(all_blocks.astype(np.int16)),
                                 qts)
    return out if to_device else np.asarray(out)


def layout_from_parsed(parsed: ParsedJpeg) -> FrameLayout:
    return make_layout(parsed.height, parsed.width, parsed.subsampling,
                       parsed.restart_interval)


def decode_to_coefficients(data: bytes) -> tuple[FrameLayout, np.ndarray, dict]:
    """JPEG bytes -> (layout, [n_total, 64] zigzag int32 blocks, qtables)."""
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    blocks = decode_scan_to_blocks(parsed, layout)
    return layout, blocks, parsed.qtables


def _recon_from_pairs(layout: FrameLayout, idx, val, qts_list,
                      to_device: bool):
    """Nonzero pairs -> pixels: sparse upload + in-dispatch densify when
    smaller than the dense tensor, dense upload otherwise."""
    n_total = sum(c.n_blocks for c in layout.comps)
    qts = [jnp.asarray(np.asarray(q).reshape(64).astype(np.int32))
           for q in qts_list]
    n64 = n_total * 64
    cap = _sparse_cap(idx.size)
    if _sparse_wins(cap, n64):
        sp = _rows_from_pairs(idx, val, n64, cap)
        out = _recon_jit(layout, sparse=True)(jnp.asarray(sp), qts)
    else:
        dense = np.zeros(n64, np.int16)
        dense[idx] = val
        out = _recon_jit(layout)(jnp.asarray(dense.reshape(n_total, 64)),
                                 qts)
    return out if to_device else np.asarray(out)


def _qts_of(parsed: ParsedJpeg) -> list:
    qts = []
    for ci, c in enumerate(parsed.comps):
        if c.qtab not in parsed.qtables:
            raise ValueError(
                f"component {ci} references undefined quant table {c.qtab}")
        qts.append(parsed.qtables[c.qtab])
    return qts


def decode(data: bytes, to_device: bool = False):
    """JPEG bytes -> uint8 image ([H,W] grayscale or [H,W,3] RGB).

    to_device=True keeps the decoded pixels in HBM (returns a jax.Array)
    instead of downloading — for feeding device-side input pipelines.

    Coefficients cross the host->device link (the decode bottleneck) in
    the smallest available form: packed 2-byte (delta, val) stream when
    the native decoder is available and it beats dense, else sparse pairs,
    else dense.
    """
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    n64 = sum(c.n_blocks for c in layout.comps) * 64
    pk = scan_packed(parsed, layout)
    if pk is not None:
        main, eidx, evals = pk
        qts_host = [np.asarray(q).reshape(64).astype(np.int32)
                    for q in _qts_of(parsed)]
        cap_m, cap_e = _sparse_cap(main.shape[0]), _exc_cap(eidx.size)
        qts = [jnp.asarray(q) for q in qts_host]
        if _packed_wins(cap_m, cap_e, n64):
            mp, exc = _pad_packed(main, eidx, evals, cap_m, cap_e, n64)
            out = _recon_jit(layout, form="packed")(
                jnp.asarray(mp), jnp.asarray(exc), qts)
        else:
            # pathological dense content: unpack on host (no second
            # entropy decode) and upload the dense tensor
            idx2, val2 = _pairs_from_packed(pk, layout)
            dense = np.zeros(n64, np.int16)
            dense[idx2] = val2
            out = _recon_jit(layout)(
                jnp.asarray(dense.reshape(n64 // 64, 64)), qts)
        return out if to_device else np.asarray(out)
    idx, val = scan_pairs(parsed, layout)
    return _recon_from_pairs(layout, idx, val, _qts_of(parsed),
                             to_device=to_device)


def decode_batch(datas: list[bytes], to_device: bool = False,
                 chunk: int | None = None):
    """Decode same-geometry JPEGs with batched device reconstruction.

    Host side parses + entropy-decodes each scan (native C++, the GIL is
    released during the call so a thread pool gives real parallelism);
    device side runs vmapped dispatches, amortizing the per-dispatch cost
    of single-image decode. Falls back to per-image decode when geometries
    differ.

    chunk=N splits the batch into N-image sub-dispatches ENQUEUED back to
    back: chunk i+1's coefficient upload overlaps chunk i's reconstruction
    (JAX async dispatch). All chunks share one sparse capacity bucket, so
    at most two executables compile (full chunk, plus a remainder one only
    when chunk does not divide the batch). Default (None) keeps the
    single-dispatch path.

    to_device=True returns the decoded pixels still in HBM — zero
    download, the training-input-pipeline shape: a stacked
    [B, H, W(, 3)] jax.Array when chunk is None, or a LIST of per-chunk
    stacked arrays whenever chunk is set — even if the batch fits one
    chunk, so callers with a fixed chunk see one type regardless of batch
    size (device-side concatenation would re-copy ~6 MB/frame through
    HBM; consumers iterate chunks instead).
    """
    if not datas:
        return []
    chunked = chunk is not None
    prep = _recon_jobs(datas, chunk)
    if prep is None:
        # geometry INCLUDES the restart interval: the segment layout drives
        # the scan decode, so a mixed-DRI batch must go per-image
        if to_device:
            raise ValueError("to_device=True requires same-geometry inputs")
        return [decode(d) for d in datas]
    jobs = prep
    outs_d = []
    for job in jobs:
        # each job materializes its chunk's host arrays lazily, so chunk
        # i+1's padding/stacking overlaps chunk i's device work exactly as
        # the old inline loop did
        fn, args, qts = job()
        outs_d.append(fn(*(jnp.asarray(a) for a in args), qts))
    if to_device:
        return outs_d if chunked else outs_d[0]
    # each np.asarray blocks only on its own chunk; later chunks keep
    # computing while earlier ones download
    return [a[i] for o in outs_d for a in (np.asarray(o),)
            for i in range(a.shape[0])]


def stage_recon(datas: list[bytes], chunk: int | None = None):
    """Pre-stage a same-geometry batch's coefficient streams in HBM and
    return `(run, h2d_bytes)` where `run()` executes ONLY the device-side
    densify + reconstruction dispatches (returning the per-chunk device
    pixel arrays) and `h2d_bytes` is the coefficient payload the staging
    uploaded. Bench/profiling helper: separates the device decode rate
    from host parse/entropy-decode and the host->device transfer. Time
    `run()` after one warm call that ends in `block_until_ready` (it also
    guarantees the staged transfers completed)."""
    prep = _recon_jobs(datas, chunk)
    if prep is None:
        raise ValueError("stage_recon requires same-geometry inputs")
    staged = []
    h2d = 0
    for job in prep:
        fn, args, qts = job()
        h2d += sum(a.nbytes for a in args)
        staged.append((fn, [jnp.asarray(a) for a in args], qts))

    def run():
        return [fn(*dev, qts) for fn, dev, qts in staged]
    return run, h2d


def _recon_jobs(datas: list[bytes], chunk: int | None):
    """Host-side half of decode_batch: parse + entropy-decode + upload-form
    selection. Returns a list of per-chunk thunks, each yielding
    (jitted_recon_fn, host_input_arrays, device_qt_slices) — or None when
    the batch mixes geometries and must go per-image."""
    parsed = [parse_jpeg(d) for d in datas]

    def _geom(p):
        return (p.height, p.width, p.subsampling, p.restart_interval)

    if any(_geom(p) != _geom(parsed[0]) for p in parsed):
        return None
    layout = layout_from_parsed(parsed[0])

    # across-image parallelism via the pool; within-image segment threading
    # (n_threads=0 auto) only when there's a single image to decode —
    # nesting both would oversubscribe the cores
    nth = 1 if len(parsed) > 1 else 0
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(8, len(datas))) as ex:
        packed = list(ex.map(
            lambda p: scan_packed(p, layout, n_threads=nth), parsed))

    qts_b = [[np.asarray(q).reshape(64).astype(np.int32)
              for q in _qts_of(p)] for p in parsed]
    n_comps = len(parsed[0].comps)
    # shared power-of-2 caps across the batch -> one executable per chunk
    # size; the packed 2-byte form is preferred, pairs/dense the fallbacks
    n_total = sum(c.n_blocks for c in layout.comps)
    n64 = n_total * 64
    b = len(datas)
    if chunk is None or chunk >= b:
        chunk = b
    n_scan64 = layout.n_scan * 64

    # +1: the clamped pad frame B must still index below 2^31
    use_packed = (all(p is not None for p in packed)
                  and (chunk + 1) * n_scan64 < 2**31)
    flats = None
    if use_packed:
        # chunk-flat streams: exact-size upload + ONE scatter per chunk
        # (per-frame power-of-2 cap buckets pad up to 2x the bytes)
        flats = [_flatten_packed(packed[c0:c0 + chunk], n_scan64, n64)
                 for c0 in range(0, b, chunk)]
        cap_m = _eighth_cap(max(m.shape[0] for m, _, _ in flats))
        cap_e = _exc_cap(max(e.size for _, e, _ in flats))
        use_packed = _packed_wins(cap_m, cap_e, chunk * n64)
    if not use_packed:
        # packed lost the size race / 2^31 guard, or some frames lacked a
        # packed stream: reuse every already-decoded packed stream and
        # entropy-decode only the frames that need it
        redo = [f for f, p in enumerate(packed) if p is None]
        pairs = [None if p is None else _pairs_from_packed(p, layout)
                 for p in packed]
        if redo:
            with ThreadPoolExecutor(max_workers=min(8, len(redo))) as ex:
                for f, pr in zip(redo, ex.map(
                        lambda f: scan_pairs(parsed[f], layout,
                                             n_threads=nth), redo)):
                    pairs[f] = pr
        nnz_max = max(i.size for i, _ in pairs)
        cap = _sparse_cap(nnz_max)
        sparse = _sparse_wins(cap, n64)

    # quant tables: ONE upload per component for the whole batch; chunks
    # take device-side slices (each per-chunk jnp.asarray would be its own
    # small transfer with fixed dispatch overhead)
    qts_all = [jnp.asarray(np.stack([row[i] for row in qts_b]))
               for i in range(n_comps)]

    jobs = []
    for ci, c0 in enumerate(range(0, b, chunk)):
        nb = len(parsed[c0:c0 + chunk])
        qts = [q[c0:c0 + nb] for q in qts_all]
        if use_packed:
            def job(ci=ci, nb=nb, qts=qts):
                mp, exc = _pad_packed(*flats[ci], cap_m, cap_e, nb * n64)
                return (_recon_jit(layout, batch=nb, form="packedflat"),
                        (mp, exc), qts)
        elif sparse:
            def job(c0=c0, nb=nb, qts=qts):
                rows = pairs[c0:c0 + chunk]
                sp = np.stack(
                    [_rows_from_pairs(i, v, n64, cap) for i, v in rows])
                return (_recon_jit(layout, batch=nb, sparse=True), (sp,),
                        qts)
        else:
            def job(c0=c0, nb=nb, qts=qts):
                rows = pairs[c0:c0 + chunk]
                dense = np.zeros((len(rows), n64), np.int16)
                for r, (i, v) in enumerate(rows):
                    dense[r, i] = v
                return (_recon_jit(layout, batch=nb),
                        (dense.reshape(-1, n_total, 64),), qts)
        jobs.append(job)
    return jobs
