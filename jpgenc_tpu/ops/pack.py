"""Device bitstream packing: parallel-prefix offsets + conflict-free scatter
(SURVEY.md component #15, hard part 1 — the kernel the throughput target is
bound by).

Pipeline (all fixed shapes, per restart segment):
  1. per-slot register build: each scan slot's <=4 pieces (ZRLs + code/amp)
     are concatenated MSB-first into a 96-bit register (3 u32 words) + length.
  2. exclusive prefix-sum of slot bit-lengths within each segment -> bit offset.
  3. each slot's register, funnel-shifted by (offset mod 32), is scatter-ADDed
     into up to 4 consecutive u32 words of the segment buffer. Bit ranges are
     disjoint by construction, so add == or and duplicate word indices (block
     boundaries) combine correctly under XLA's deterministic scatter-add.

Output: [n_seg, W] big-endian-bit u32 words + per-segment bit counts. The host
(or C++ native tier) does the only remaining work: slice to ceil(bits/8) bytes,
set the 1-padding in the final byte, FF00-stuff, join with RSTn markers
(BASELINE.json:5 "leaving only final byte-stuffing on host").

Segment buffers are sized for the true worst case (every coefficient nonzero:
<=1713 bits/block with 16-bit codes) so packing can never overflow; perf paths
can pass a smaller W together with overflow detection via the returned bit
counts.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_I32 = jnp.int32
_U32 = jnp.uint32

# Worst-case bits per 8x8 block: DC (16-bit code + 11 amp) + 63 AC values
# (16-bit code + 10 amp) + at most 3 ZRLs (16 bits each).
MAX_BLOCK_BITS = 27 + 63 * 26 + 3 * 16


def words_per_segment(blocks_per_segment: int) -> int:
    """Worst-case u32 words for one restart segment (+3 slack for scatter spill)."""
    return -(-blocks_per_segment * MAX_BLOCK_BITS // 32) + 3


def _shift_into_word(v: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """v (u32) logically shifted by s bits (+ = left) and truncated to a u32 word.

    |s| >= 32 yields 0. Shift amounts are clamped so XLA never sees an
    out-of-range shift (undefined in HLO).
    """
    v = v.astype(_U32)
    sl = jnp.clip(s, 0, 31).astype(_U32)
    sr = jnp.clip(-s, 0, 31).astype(_U32)
    left = jnp.where((s >= 0) & (s < 32), v << sl, _U32(0))
    right = jnp.where((s < 0) & (s > -32), v >> sr, _U32(0))
    return left | right


def build_registers(piece_val: jnp.ndarray,
                    piece_len: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Concatenate each slot's pieces MSB-first into 96-bit registers.

    piece_val/piece_len: [..., P] u32/i32 with per-piece values right-aligned.
    Returns (reg [..., 3] u32 with bit 0 of the stream at bit 31 of word 0,
    total_len [...] i32). Total must be <= 96 bits.
    """
    shape = piece_val.shape[:-1]
    npieces = piece_val.shape[-1]
    reg = [jnp.zeros(shape, _U32) for _ in range(3)]
    pos = jnp.zeros(shape, _I32)
    for p in range(npieces):
        v = piece_val[..., p]
        ln = piece_len[..., p]
        # value's LSB sits at register bit (96 - pos - ln) counting from LSB
        a = 96 - pos - ln
        for t in range(3):
            # word t covers register bits [95-32t .. 64-32t]
            reg[t] = reg[t] | _shift_into_word(v, a - 64 + 32 * t)
        pos = pos + ln
    return jnp.stack(reg, axis=-1), pos


def w_blk_for_quality(quality: int) -> int:
    """FIRST-tier per-block word capacity for the block-granular pack path.

    The pack's word merge and the segment merge's scatter taps both scale
    with w_blk, so the first tier is sized for typical photographic content
    (measured max ~123 bits/block at Q75 on the fixtures; 8 words = 256 bits
    is 2x headroom).
    Overflow escalates through the capacity ladder (api.encode: 24-word safe
    tier, then the 56-word worst tier that covers MAX_BLOCK_BITS and can
    never overflow).

    Tiers are sized from per-block word statistics measured across a
    smooth fixture, sigma-60 noise, hard edges and dense texture: worst
    content needs 10 words at Q85, 12 at Q90, 15 at Q95. Q81-90 therefore
    use 12 (w8 would overflow hard content at these qualities and cost a
    full ladder retry). Q91-95 use 16 (covers the 15-word worst case).
    Q96+ keep 24 (extreme-quality noise can exceed 16 words/block).
    Pathological content escalates through the ladder as before.
    """
    if quality <= 80:
        return 8
    if quality <= 90:
        return 12
    if quality <= 95:
        return 16
    return 24


def block_pack(piece_val: jnp.ndarray, piece_len: jnp.ndarray,
               w_blk: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pack each block's pieces into its own [w_blk]-word buffer.

    This is pack_segments with one segment per block — the first stage of the
    block-granular pipeline (SURVEY.md hard part 1 redesign: scatter index
    count drops from slots*4 to blocks*(w_blk+1)). Returns
    (buf [n_blocks, w_blk] u32 MSB-first, bits [n_blocks] i32). A block whose
    stream exceeds w_blk*32 bits overflows (contributions dropped); callers
    must check `bits.max()` and fall back to the worst-case path.
    """
    n_blocks = piece_val.shape[0]
    return pack_segments(piece_val, piece_len, n_blocks, w_blk)


def segments_from_blocks(buf: jnp.ndarray, bits: jnp.ndarray,
                         n_seg: int, w_seg: int) -> tuple[jnp.ndarray,
                                                          jnp.ndarray]:
    """Concatenate per-block bitstreams into per-segment streams.

    buf: [n_blocks, W] u32 per-block buffers; bits: [n_blocks]. n_blocks must
    be n_seg * blocks_per_segment (scan order, segment-major). Gather-free:
    per-block funnel shift by the segment-relative bit offset (elementwise,
    static word taps) + one fully-sorted flat scatter-add of
    n_blocks*(W+1) words.
    """
    n_blocks, w = buf.shape
    spb = n_blocks // n_seg
    b2 = bits.reshape(n_seg, spb)
    csum = jnp.cumsum(b2, axis=1)
    seg_bits = csum[:, -1]
    off = (csum - b2).reshape(-1)                     # [n_blocks] exclusive
    r = (off & 31).astype(_I32)[:, None]              # bit shift within word
    w0 = (off >> 5).astype(_I32)

    # funnel-shift each row right by r bits, spilling into word W
    prev = jnp.concatenate(
        [jnp.zeros((n_blocks, 1), _U32), buf[:, :-1]], axis=1)
    lo = jnp.concatenate([buf, jnp.zeros((n_blocks, 1), _U32)], axis=1)
    hi = jnp.concatenate([prev, buf[:, -1:]], axis=1)
    sh = _shift_into_word(lo, -r) | _shift_into_word(hi, 32 - r)  # [n, W+1]

    seg_of = jnp.repeat(jnp.arange(n_seg, dtype=_I32), spb)
    base = seg_of * w_seg + w0                        # [n_blocks], sorted
    out = jnp.zeros(n_seg * w_seg, _U32)
    for i in range(w + 1):   # per-tap: base+i stays sorted; windows overlap
        out = out.at[base + i].add(sh[:, i], mode="drop",
                                   indices_are_sorted=True)
    return out.reshape(n_seg, w_seg), seg_bits


def walign_for(blocks_per_segment: int) -> int:
    """Static per-layout wcompact chunk width in words: segment starts in
    the compact stream are walign-word aligned, making the multi-segment
    compaction a chunk ROW gather whose index count is cap_w/walign.
    Bigger chunks halve the gather indices but waste up to 4*walign-4 pad
    bytes per segment, so the width scales with the segment size: a DRI=4
    file's 24-block segments stay on small chunks instead of paying ~256
    pad bytes against ~500 content bytes. The choice is a
    pure function of the layout, so every consumer of the stream (device
    compaction, host finalize, native C++ finalize, capacity and
    prefix-length computations) derives the same value."""
    if blocks_per_segment >= 256:
        return 64
    if blocks_per_segment >= 64:
        return 32
    if blocks_per_segment >= 16:
        return 16
    return 8


def seg_nwords_aligned(nbits, walign: int):
    """Words a segment occupies in the wcompact stream: ceil(bits/32)
    rounded up to the walign chunk (walign_for(layout.blocks_per_segment)
    — every caller must derive it from the SAME layout). Shared by the
    device compaction, the host finalize offsets and every
    capacity/prefix-length computation (np and jnp arrays both work)."""
    nw = (nbits + 31) >> 5
    return (nw + (walign - 1)) & -walign


def wcompact_unstuffed(seg_words: jnp.ndarray, seg_bits: jnp.ndarray,
                       cap_w: int, walign: int
                       ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Device-side finalize at WORD granularity: segments -> one compact
    u32 stream whose little-endian MEMORY IMAGE is the unstuffed byte
    stream (each word byte-swapped on device, so the host just views the
    downloaded buffer as bytes).

    Compared to the byte-level compact_unstuffed this removes the 4x
    byte-expansion entirely for the no-DRI case (a pure bswap of a static
    word slice) and cuts the
    restart-interval gather to a quarter of the indices (word- instead of
    byte-granular; segments start walign-chunk-aligned in the stream —
    the pad bytes are covered by scan_caps' per-segment slack).

    The host (engine.finalize_host_w / native.finalize_wcompact) slices
    each segment's ceil(bits/8) bytes at offset 4*wbase[s], sets the T.81
    F.1.2.3 1-padding in the final byte, stuffs FF->FF00 and joins with
    RSTn markers.

    seg_words: [n_seg, W] u32 MSB-first; seg_bits: [n_seg] i32.
    cap_w: static output capacity in WORDS. Output is only valid when
      sum(ceil(bits/32)) <= cap_w — the caller checks on host and falls
      back to a bigger tier on overflow.

    Returns (wstream [cap_w] u32, nbits [n_seg] i32).
    """
    n_seg, w = seg_words.shape
    words_i = jax.lax.bitcast_convert_type(seg_words, _I32)
    nbits = seg_bits.astype(_I32)

    def bswap(x):
        return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00) |
                ((x & 0xFF00) << 8) | (x << 24))

    if n_seg == 1:
        k = min(cap_w, w)
        out = bswap(words_i[0, :k])
        if k < cap_w:
            out = jnp.pad(out, (0, cap_w - k))
        return jax.lax.bitcast_convert_type(out, jnp.uint32), nbits

    # multi-segment (restart intervals): segment starts are walign-aligned
    # in the compact stream (seg_nwords_aligned — the host finalize uses
    # the same offsets), so the compaction is a CHUNK row gather:
    # cap_w/walign data-dependent row indices instead of cap_w word
    # indices.
    wshift = walign.bit_length() - 1
    nw = (nbits + 31) >> 5                            # content words
    nwa = seg_nwords_aligned(nbits, walign)
    wbase = jnp.cumsum(nwa) - nwa                     # aligned starts
    cap_c = -(-cap_w // walign)

    # chunk -> segment map: mark starts, prefix-count (duplicate starts from
    # empty segments resolve to the LAST one — it owns the chunk)
    marks = jnp.zeros((cap_c,), _I32).at[wbase >> wshift].add(1,
                                                              mode="drop")
    s = jnp.clip(jnp.cumsum(marks) - 1, 0, n_seg - 1)  # [cap_c]

    # source rows: segment words padded to whole chunks, viewed
    # [rows, walign]
    w8 = -(-w // walign)
    rows = jnp.pad(words_i, ((0, 0), (0, w8 * walign - w))) \
        .reshape(n_seg * w8, walign)
    q8 = jnp.arange(cap_c, dtype=_I32) - (wbase[s] >> wshift)
    chunk = rows[s * w8 + jnp.clip(q8, 0, w8 - 1)]     # [cap_c, walign] rows

    off = q8[:, None] * walign + jnp.arange(walign, dtype=_I32)[None, :]
    out = jnp.where(off < nw[s][:, None], bswap(chunk), 0)
    out = out.reshape(-1)[:cap_w]
    return jax.lax.bitcast_convert_type(out, jnp.uint32), nbits


def compact_unstuffed(seg_words: jnp.ndarray, seg_bits: jnp.ndarray,
                      cap_u: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Device-side finalize: segments -> one COMPACT unstuffed byte stream.

    Each segment is sliced to ceil(bits/8) bytes with its 1-bit padding set
    (T.81 F.1.2.3) and the runs are packed back-to-back WITHOUT restart
    markers. FF->FF00 stuffing and RSTn insertion happen on host at memcpy
    speed (native.finalize_compact) — exactly the "final byte-stuffing on
    host" the BASELINE.json:5 contract keeps off-device. Compared to a
    device-side stuffing pass this kills the output scatter and, for the
    dominant single-segment (no-DRI) case, the per-byte gather too: the
    stream is a STATIC byte-extract of the segment words.

    seg_words: [n_seg, W] u32 MSB-first; seg_bits: [n_seg] i32.
    cap_u: static output capacity in bytes. Output is only valid when
      sum(nbytes) <= cap_u — the caller checks on host and falls back to a
      bigger tier on overflow.

    Returns (u [cap_u] u8, nbytes [n_seg] i32).
    """
    n_seg, w = seg_words.shape
    wb = 4 * w
    nbytes = ((seg_bits + 7) >> 3).astype(_I32)
    pad_mask = ((1 << ((-seg_bits) & 7)) - 1).astype(_I32)
    words_i = jax.lax.bitcast_convert_type(seg_words, _I32)

    if n_seg == 1:
        # single segment: the stream IS the first cap_u bytes of the words —
        # pure static slice + elementwise byte extract, no gather at all
        k = min(cap_u, wb)
        word = words_i[0, :-(-k // 4)]
        sh = jnp.array([24, 16, 8, 0], _I32)
        b = ((word[:, None] >> sh[None, :]) & 0xFF).reshape(-1)[:k]
        if k < cap_u:
            b = jnp.pad(b, (0, cap_u - k))
        # set the final byte's 1-padding elementwise (a 1-element scatter
        # would batch poorly under vmap)
        last = jnp.clip(nbytes[0] - 1, 0, cap_u - 1)
        b = jnp.where(jnp.arange(cap_u, dtype=_I32) == last,
                      b | pad_mask[0], b)
        return b.astype(jnp.uint8), nbytes

    # multi-segment (restart intervals): gather bytes through the segment map
    base = jnp.cumsum(nbytes) - nbytes                # exclusive
    p = jnp.arange(cap_u, dtype=_I32)
    s = jnp.clip(jnp.searchsorted(base, p, side="right") - 1, 0, n_seg - 1)
    q = p - base[s]
    in_data = q < nbytes[s]
    qc = jnp.clip(q, 0, wb - 1)
    word = words_i.reshape(-1)[s * w + (qc >> 2)]
    byte = (word >> ((3 - (qc & 3)) * 8)) & 0xFF
    byte = byte | jnp.where(q == nbytes[s] - 1, pad_mask[s], 0)
    u = jnp.where(in_data, byte, 0)
    return u.astype(jnp.uint8), nbytes


def pack_segments(piece_val: jnp.ndarray, piece_len: jnp.ndarray,
                  n_seg: int, words: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pack pieces into per-segment bitstreams.

    piece_val/piece_len: [S, 64, 4] from ops.entropy.make_pieces, where
    S = n_seg * blocks_per_segment.
    Returns (seg_words [n_seg, words] u32 MSB-first, seg_bits [n_seg] i32).
    """
    reg, slot_len = build_registers(piece_val, piece_len)   # [S,3], [S]
    s_total = slot_len.reshape(n_seg, -1)                    # [n_seg, spb]
    csum = jnp.cumsum(s_total, axis=1)
    seg_bits = csum[:, -1]
    offset = csum - s_total                                  # exclusive prefix
    w0 = (offset >> 5).astype(_I32)                          # first word index
    r = (offset & 31).astype(_I32)                           # bit shift within

    regs = reg.reshape(n_seg, -1, 3)                         # [n_seg, spb, 3]
    out = jnp.zeros((n_seg, words), _U32)
    seg_ix = jnp.arange(n_seg, dtype=_I32)[:, None]
    for t in range(4):
        hi = regs[:, :, t - 1] if t >= 1 else jnp.zeros_like(regs[:, :, 0])
        lo = regs[:, :, t] if t <= 2 else jnp.zeros_like(regs[:, :, 0])
        contrib = _shift_into_word(lo, -r) | _shift_into_word(hi, 32 - r)
        out = out.at[seg_ix, w0 + t].add(contrib, mode="drop")
    return out, seg_bits
