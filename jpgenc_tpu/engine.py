"""Device encode engine: per-layout compiled pipelines + host finalize.

This orchestrates SURVEY.md call stacks 4.1-4.3 on device:

  pixels (u8, HBM) -> [K1] color/subsample/FDCT/quantize/zigzag
                   -> scan-order gather -> [K2] symbolize -> [K3] pack
  -> (seg_words, seg_bits) -> host: byte-slice + 1-pad + FF00-stuff + RSTn join

Exactly two host/device crossings per image (input upload, packed-scan
download), per the BASELINE.json:5 contract.

Pipelines are jitted per FrameLayout (static shapes); Huffman LUTs and quant
tables are traced arguments so optimized-table pass 2 reuses the same
executable. Compiled plans are cached process-wide.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jpgenc_tpu import tables as T
from jpgenc_tpu.huffman import HuffTable
from jpgenc_tpu.layout import FrameLayout
from jpgenc_tpu.ops import color as C
from jpgenc_tpu.ops import transform as X
from jpgenc_tpu.ops.entropy import EntropyLUTs, SymbolPlan, make_pieces, symbol_histogram
from jpgenc_tpu.ops.pack import (MAX_BLOCK_BITS, block_pack, pack_segments,
                                 seg_nwords_aligned, segments_from_blocks,
                                 walign_for, wcompact_unstuffed,
                                 words_per_segment)
from jpgenc_tpu.ref.bitio import stuff_bytes


def make_symbol_plan(layout: FrameLayout) -> SymbolPlan:
    """Pad scan-order index arrays to whole segments; lift to device arrays."""
    s = layout.n_scan
    spb = layout.blocks_per_segment
    s_pad = layout.n_segments * spb
    pad = s_pad - s

    def _pad(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)]) if pad else a

    dc_tab = np.array([layout.comps[ci].dc_tab for ci in layout.scan_comp], np.int32)
    ac_tab = np.array([layout.comps[ci].ac_tab for ci in layout.scan_comp], np.int32)
    valid = np.ones(s, bool)
    return SymbolPlan(
        prev_same=jnp.asarray(_pad(layout.prev_same, -1)),
        dc_tab=jnp.asarray(_pad(dc_tab, 0)),
        ac_tab=jnp.asarray(_pad(ac_tab, 0)),
        valid=jnp.asarray(_pad(valid, False)),
    )


def make_scan_gather(layout: FrameLayout) -> np.ndarray:
    s = layout.n_scan
    s_pad = layout.n_segments * layout.blocks_per_segment
    flat = np.zeros(s_pad, np.int32)
    flat[:s] = layout.scan_flat
    return flat


def luts_from_tables(dc_tables: list[HuffTable],
                     ac_tables: list[HuffTable]) -> EntropyLUTs:
    def rows(tabs):
        out = np.zeros((2, 256), np.int64)
        for i, t in enumerate(tabs[:2]):
            out[i] = (np.asarray(t.code, np.int64) << 5) | np.asarray(t.length)
        if len(tabs) == 1:
            out[1] = out[0]
        return jnp.asarray(out.astype(np.int32))
    return EntropyLUTs(dc=rows(dc_tables), ac=rows(ac_tables))


# ---------------------------------------------------------------------------
# Traced pipeline pieces (layout is static via closure; tables are traced args)
# ---------------------------------------------------------------------------

def pixels_to_blocks(img: jnp.ndarray, layout: FrameLayout,
                     qtabs: jnp.ndarray) -> jnp.ndarray:
    """u8 image -> concatenated [n_total_blocks, 64] int32 zigzag blocks.

    qtabs: [2, 64] float-convertible quant tables (natural order).
    """
    c0 = layout.comps[0]
    if layout.is_gray:
        plane = C.pad_replicate(img, c0.plane_h, c0.plane_w).astype(jnp.float32)
        return X.plane_to_zigzag(plane, qtabs[0])
    padded = C.pad_replicate(img, c0.plane_h, c0.plane_w)
    ycc = C.rgb_to_ycbcr(padded)
    planes = [ycc[..., 0],
              C.subsample(ycc[..., 1], c0.hs, c0.vs),
              C.subsample(ycc[..., 2], c0.hs, c0.vs)]
    parts = [X.plane_to_zigzag(p, qtabs[comp.qtab])
             for p, comp in zip(planes, layout.comps)]
    return jnp.concatenate(parts, axis=0)


def blocks_to_scan(all_blocks: jnp.ndarray, scan_flat: jnp.ndarray) -> jnp.ndarray:
    return all_blocks[scan_flat]


#: scan-slot count above which the K1 stage runs as a lax.scan over MCU-row
#: bands (bounds live intermediate footprint for 4K+ images — the SURVEY §6
#: "long-context" mechanism; 1080p and below keep the whole-plane fast path)
BAND_SLOT_THRESHOLD = 50_000


def band_rows_for(layout: FrameLayout) -> int | None:
    """MCU rows per K1 band, or None for the whole-plane path.

    Picks the largest divisor of mcus_y that is <= 16 so bands tile the
    plane exactly (worst case 1: one MCU row per scan step)."""
    if layout.n_mcus * layout.blocks_per_mcu < BAND_SLOT_THRESHOLD:
        return None
    best = 1
    for d in range(2, 17):
        if layout.mcus_y % d == 0:
            best = d
    return best


def _mcu_group(y, cb, cr, rows: int, mx: int, hs: int, vs: int):
    """Raster per-component zigzag blocks -> interleaved scan order
    (T.81 A.2.3) for `rows` MCU rows, via static reshapes only."""
    yg = (y.reshape(rows, vs, mx, hs, 64)
          .transpose(0, 2, 1, 3, 4)
          .reshape(rows, mx, vs * hs, 64))
    cbg = cb.reshape(rows, mx, 1, 64)
    crg = cr.reshape(rows, mx, 1, 64)
    return jnp.concatenate([yg, cbg, crg], axis=2).reshape(-1, 64)


def pixels_to_scan(img: jnp.ndarray, layout: FrameLayout,
                   qtabs: jnp.ndarray,
                   band_rows: int | None = None) -> jnp.ndarray:
    """u8 image -> [n_seg * blocks_per_segment, 64] zigzag blocks directly in
    the interleaved scan order (T.81 A.2.3) via static reshapes — replaces
    the pixels_to_blocks + scan-gather pair (a 49k-row data-dependent gather)
    with pure layout ops. Padding slots beyond n_scan are zero blocks
    (SymbolPlan.valid masks them).

    band_rows selects the banded path: a lax.scan over groups of MCU rows so
    intermediate buffers stay bounded regardless of image size (4K+, SURVEY
    §6). Bit-identical to the whole-plane path (same per-block numerics).
    Defaults to band_rows_for(layout).
    """
    if band_rows is None:
        band_rows = band_rows_for(layout)
    s_pad = layout.n_segments * layout.blocks_per_segment
    c0 = layout.comps[0]
    my, mx, hs, vs = layout.mcus_y, layout.mcus_x, c0.hs, c0.vs
    if layout.is_gray:
        plane = C.pad_replicate(img, c0.plane_h, c0.plane_w).astype(jnp.float32)
        if band_rows and band_rows < my:
            bands = plane.reshape(my // band_rows, band_rows * 8, c0.plane_w)

            def step(_, band):
                return None, X.plane_to_zigzag(band, qtabs[0])

            _, zz = jax.lax.scan(step, None, bands)
            zz = zz.reshape(-1, 64)
        else:
            zz = X.plane_to_zigzag(plane, qtabs[0])   # raster == scan order
    else:
        padded = C.pad_replicate(img, c0.plane_h, c0.plane_w)
        if band_rows and band_rows < my:
            band_h = layout.mcu_h * band_rows
            bands = padded.reshape(my // band_rows, band_h, c0.plane_w, 3)

            def step(_, band):
                ycc = C.rgb_to_ycbcr(band)
                y = X.plane_to_zigzag(ycc[..., 0], qtabs[0])
                cb = X.plane_to_zigzag(C.subsample(ycc[..., 1], hs, vs),
                                       qtabs[1])
                cr = X.plane_to_zigzag(C.subsample(ycc[..., 2], hs, vs),
                                       qtabs[1])
                return None, _mcu_group(y, cb, cr, band_rows, mx, hs, vs)

            _, zz = jax.lax.scan(step, None, bands)
            zz = zz.reshape(-1, 64)
        else:
            ycc = C.rgb_to_ycbcr(padded)
            y = X.plane_to_zigzag(ycc[..., 0], qtabs[0])
            cb = X.plane_to_zigzag(C.subsample(ycc[..., 1], hs, vs), qtabs[1])
            cr = X.plane_to_zigzag(C.subsample(ycc[..., 2], hs, vs), qtabs[1])
            zz = _mcu_group(y, cb, cr, my, mx, hs, vs)
    if s_pad > zz.shape[0]:
        zz = jnp.pad(zz, ((0, s_pad - zz.shape[0]), (0, 0)))
    return zz


def scan_to_segments(zz_scan: jnp.ndarray, plan: SymbolPlan, luts: EntropyLUTs,
                     n_seg: int, words: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    pv, pl = make_pieces(zz_scan, plan, luts)
    return pack_segments(pv, pl, n_seg, words)


def pack_kernel_default(devices=None) -> bool:
    """Whether the entropy pack runs as the Triton kernel A
    (ops/pallas/block_pack.py): on GPUs only. Pass the devices the
    computation actually targets (e.g. a mesh's) when they may differ from
    the default backend's."""
    devs = devices if devices is not None else jax.devices()
    return all(d.platform == "gpu" for d in devs)


def scan_to_segments_blocked(zz_scan: jnp.ndarray, plan: SymbolPlan,
                             luts: EntropyLUTs, n_seg: int, w_blk: int,
                             kernel: bool | None = None,
                             interpret: bool = False
                             ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Block-granular pack: per-block buffers then one sorted merge scatter.

    10x fewer scatter indices than the per-slot path (SURVEY.md hard part 1
    redesign). `kernel` selects the per-block stage: the Triton kernel A
    (default on GPUs, see pack_kernel_default) or the XLA formulation
    make_pieces -> block_pack; both are bit-identical. `interpret` runs the
    kernel on the CPU (tests only). Returns (seg_words, seg_bits,
    overflowed) — `overflowed` is a traced bool scalar; when True the words
    are invalid and the caller must retry a bigger tier.
    """
    if kernel is None:
        kernel = pack_kernel_default()
    spb = zz_scan.shape[0] // n_seg
    w_seg = spb * w_blk + 2
    if zz_scan.dtype != jnp.int32:
        zz_scan = zz_scan.astype(jnp.int32)
    if kernel:
        from jpgenc_tpu.ops.pallas.block_pack import (fused_block_pack,
                                                      slot_metadata)
        buf, bits = fused_block_pack(zz_scan, *slot_metadata(plan, zz_scan),
                                     luts=luts, w_blk=w_blk,
                                     interpret=interpret)
    else:
        pv, pl = make_pieces(zz_scan, plan, luts)
        buf, bits = block_pack(pv, pl, w_blk)
    seg_words, seg_bits = segments_from_blocks(buf, bits, n_seg, w_seg)
    return seg_words, seg_bits, jnp.max(bits) > w_blk * 32


# ---------------------------------------------------------------------------
# Compiled plan cache
# ---------------------------------------------------------------------------

class DevicePlan:
    """Holds per-layout static device arrays + jitted callables."""

    def __init__(self, layout: FrameLayout):
        self.layout = layout
        # stable identity for cross-module executable-cache keys: id(self)
        # can be reused by the allocator after an LRU eviction, so caches
        # must never key on object identity
        self.key = (layout.height, layout.width, layout.subsampling,
                    layout.restart_interval)
        self.plan = make_symbol_plan(layout)
        self.scan_flat = jnp.asarray(make_scan_gather(layout))
        self.n_seg = layout.n_segments
        self.words = words_per_segment(layout.blocks_per_segment)

        lay = layout
        n_seg, words = self.n_seg, self.words

        @jax.jit
        def _encode(img, qtabs, plan, scan_flat, luts):
            blocks = pixels_to_blocks(img, lay, qtabs)
            zz = blocks_to_scan(blocks, scan_flat)
            w, b = scan_to_segments(zz, plan, luts, n_seg, words)
            return w, b

        @jax.jit
        def _blocks(img, qtabs):
            return pixels_to_blocks(img, lay, qtabs)

        @jax.jit
        def _entropy(blocks, plan, scan_flat, luts):
            zz = blocks_to_scan(blocks, scan_flat)
            return scan_to_segments(zz, plan, luts, n_seg, words)

        @jax.jit
        def _hist(blocks, plan, scan_flat):
            zz = blocks_to_scan(blocks, scan_flat)
            return symbol_histogram(zz, plan)

        # scan-ordered variants (the optimize-mode production path): pass 1
        # caches the SCAN-ORDERED zigzag tensor, so neither pass pays the
        # raster->scan gather and pass 2 feeds the entropy stage directly
        # (call stack 4.3)
        @jax.jit
        def _zz(img, qtabs):
            return pixels_to_scan(img, lay, qtabs)

        @jax.jit
        def _hist_zz(zz, plan):
            return symbol_histogram(zz.astype(jnp.int32), plan)

        @jax.jit
        def _zz_hist(img, qtabs, plan):
            # optimize pass 1 in ONE dispatch: transform + histogram (zz
            # stays in device memory for pass 2)
            zz = pixels_to_scan(img, lay, qtabs)
            return zz, symbol_histogram(zz.astype(jnp.int32), plan)

        sflat = self.scan_flat   # closed over: layout-static, so the
                                 # scan-order gather constant-folds

        @jax.jit
        def _zz_islow(img, qtabs):
            # libjpeg-exact integer pipeline (ops/islow.py), scan-ordered —
            # feeds the same entropy stage as the float path
            from jpgenc_tpu.ops.islow import image_to_zigzag_islow
            return image_to_zigzag_islow(img, lay, qtabs)[sflat]

        @jax.jit
        def _zz_islow_hist(img, qtabs, plan):
            from jpgenc_tpu.ops.islow import image_to_zigzag_islow
            zz = image_to_zigzag_islow(img, lay, qtabs)[sflat]
            return zz, symbol_histogram(zz, plan)

        @jax.jit
        def _entropy_zz(zz, plan, luts):
            return scan_to_segments(zz.astype(jnp.int32), plan, luts,
                                    n_seg, words)

        self._encode = _encode
        self._blocks = _blocks
        self._entropy = _entropy
        self._hist = _hist
        self._zz = _zz
        self._hist_zz = _hist_zz
        self._zz_hist = _zz_hist
        self._zz_islow = _zz_islow
        self._zz_islow_hist = _zz_islow_hist
        self._entropy_zz = _entropy_zz
        from jpgenc_tpu.utils.lru import LRUCache
        self._bytes_fns = LRUCache(8)   # (cap_u, w_blk) -> jitted pipelines
        self._prefix_guess = 1024   # adaptive speculative-fetch length (u32 words)

    def bytes_fns(self, cap_u: int, w_blk: int) -> dict:
        """Jitted pixels->compact-unstuffed-scan pipelines for a capacity.

        Only `cap_u` bytes ever cross the device->host boundary instead of
        the worst-case packed-word buffer; the host then does the one piece
        of work the BASELINE.json:5 contract keeps on host (FF00 stuffing +
        RSTn joins, finalize_host). The pack runs block-granular with
        `w_blk` words per block; the last returned value flags per-block
        overflow (invalid output -> caller retries a bigger tier).
        """
        key = (cap_u, w_blk)
        if key not in self._bytes_fns:
            lay, n_seg = self.layout, self.n_seg
            cap_w = cap_u // 4
            wal = walign_for(lay.blocks_per_segment)
            kernel = pack_kernel_default()

            @jax.jit
            def _encode_bytes(img, qtabs, plan, scan_flat, luts):
                zz = pixels_to_scan(img, lay, qtabs)
                w, b, ovf = scan_to_segments_blocked(zz, plan, luts, n_seg,
                                                     w_blk, kernel=kernel)
                return wcompact_unstuffed(w, b, cap_w, wal) + (ovf,)

            @jax.jit
            def _entropy_bytes(blocks, plan, scan_flat, luts):
                zz = blocks_to_scan(blocks, scan_flat)
                w, b, ovf = scan_to_segments_blocked(zz, plan, luts, n_seg,
                                                     w_blk, kernel=kernel)
                return wcompact_unstuffed(w, b, cap_w, wal) + (ovf,)

            @jax.jit
            def _entropy_bytes_zz(zz, plan, luts):
                w, b, ovf = scan_to_segments_blocked(zz, plan, luts,
                                                     n_seg, w_blk,
                                                     kernel=kernel)
                return wcompact_unstuffed(w, b, cap_w, wal) + (ovf,)

            self._bytes_fns[key] = {"encode": _encode_bytes,
                                    "entropy": _entropy_bytes,
                                    "entropy_zz": _entropy_bytes_zz}
        return self._bytes_fns[key]

    def _finish_bytes(self, outs, cap_u, first_rst, n_rst, n_seg_keep=-1):
        u_dev, nbits_dev, ovf_dev = outs
        # speculative single round trip: metadata + a guessed stream prefix
        # packed into ONE device array (one transfer instead of three);
        # refetch only when the guess fell short. Units are u32 WORDS of the wcompact stream
        # (ops.pack.wcompact_unstuffed).
        handle, k = combined_fetch(u_dev, nbits_dev, ovf_dev,
                                   self._prefix_guess)
        up, nbits, ovf = split_fetch(np.asarray(handle), k,
                                     nbits_dev.shape[-1])
        wal = walign_for(self.layout.blocks_per_segment)
        total_w = int(seg_nwords_aligned(nbits.astype(np.int64), wal).sum())
        if bool(ovf) or total_w > cap_u // 4:
            return b"", False
        if total_w > up.shape[-1]:
            up = fetch_prefix(u_dev, total_w)
        self._prefix_guess = max(total_w, 1024)
        if n_seg_keep >= 0:
            # ragged stripe tail: the trailing segments cover only padding
            # MCU rows and are dropped from the emitted scan (the wcompact
            # stream is segment-ordered, so a prefix slice is exact)
            nbits = nbits[:n_seg_keep]
        if n_rst < 0:
            n_rst = len(nbits) - 1
        return finalize_host_w(up, nbits, first_rst, n_rst, wal), True

    def encode_scan_bytes(self, img, qtabs, luts, cap_u: int,
                          w_blk: int, first_rst: int = 0, n_rst: int = -1,
                          n_seg_keep: int = -1):
        """Full device encode -> (scan bytes, ok). ok=False on any overflow.

        first_rst/n_rst override the RSTn numbering for stripe sub-images
        (n_rst=-1 selects the whole-image default of n_segments-1);
        n_seg_keep >= 0 keeps only the first n_seg_keep segments (ragged
        stripe tails drop their padding-row segments).
        """
        fns = self.bytes_fns(cap_u, w_blk)
        outs = fns["encode"](img, qtabs, self.plan, self.scan_flat, luts)
        return self._finish_bytes(outs, cap_u, first_rst, n_rst, n_seg_keep)

    def entropy_scan_bytes(self, blocks, luts, cap_u: int,
                           w_blk: int, first_rst: int = 0, n_rst: int = -1):
        """Entropy-only device encode (pass 2 of optimize mode) -> bytes."""
        fns = self.bytes_fns(cap_u, w_blk)
        outs = fns["entropy"](blocks, self.plan, self.scan_flat, luts)
        return self._finish_bytes(outs, cap_u, first_rst, n_rst)

    def entropy_scan_bytes_zz(self, zz, luts, cap_u: int, w_blk: int,
                              first_rst: int = 0, n_rst: int = -1,
                              n_seg_keep: int = -1):
        """Entropy-only encode from SCAN-ORDERED blocks (optimize pass 2)."""
        fns = self.bytes_fns(cap_u, w_blk)
        outs = fns["entropy_zz"](zz, self.plan, luts)
        return self._finish_bytes(outs, cap_u, first_rst, n_rst, n_seg_keep)

    # -- public ------------------------------------------------------------

    def encode_segments(self, img, qtabs, luts):
        return self._encode(img, qtabs, self.plan, self.scan_flat, luts)

    def blocks(self, img, qtabs):
        return self._blocks(img, qtabs)

    def zz_scan(self, img, qtabs):
        """Scan-ordered quantized zigzag blocks."""
        return self._zz(img, qtabs)

    def entropy_segments(self, blocks, luts):
        return self._entropy(blocks, self.plan, self.scan_flat, luts)

    def entropy_segments_zz(self, zz, luts):
        return self._entropy_zz(zz, self.plan, luts)

    def histogram(self, blocks):
        return self._hist(blocks, self.plan, self.scan_flat)

    def histogram_zz(self, zz):
        return self._hist_zz(zz, self.plan)

    def zz_and_histogram(self, img, qtabs):
        """Optimize-mode pass 1: (scan-ordered zigzag blocks, symbol
        histogram) in a single device dispatch."""
        return self._zz_hist(img, qtabs, self.plan)

    def zz_scan_islow(self, img, qtabs):
        """libjpeg-exact integer pixels->scan-ordered zigzag (conformance
        mode — output files byte-identical to libjpeg-turbo's)."""
        return self._zz_islow(img, qtabs)

    def zz_islow_and_histogram(self, img, qtabs):
        return self._zz_islow_hist(img, qtabs, self.plan)


from jpgenc_tpu.utils.lru import LRUCache  # noqa: E402

#: bounded: a long-lived service over heterogeneous geometries must not
#: accumulate executables forever (one DevicePlan holds ~10 jitted callables)
_PLANS = LRUCache(16)


def get_plan(layout: FrameLayout) -> DevicePlan:
    key = (layout.height, layout.width, layout.subsampling, layout.restart_interval)
    plan = _PLANS.get(key)
    if plan is None:
        plan = DevicePlan(layout)
        _PLANS[key] = plan
    return plan


# ---------------------------------------------------------------------------
# Host finalize: the one host-side pass of the production path
# ---------------------------------------------------------------------------

def prefix_slice(u_dev, total: int):
    """Device-side slice covering `total` bytes of a byte stream (last
    axis), rounded up to a power of two so only a handful of slice
    executables is ever compiled."""
    k = _prefix_k(u_dev, total)
    return u_dev if k >= u_dev.shape[-1] else u_dev[..., :k]


def fetch_prefix(u_dev, total: int) -> np.ndarray:
    """Transfer only a prefix covering `total` bytes of a device byte stream
    (last axis). The capacity buffer is mostly empty at typical bitrates,
    and the device->host link is the scarce resource."""
    return np.asarray(prefix_slice(u_dev, total))


def _prefix_k(u_dev, total: int) -> int:
    cap = u_dev.shape[-1]
    if total >= cap:
        return cap
    return min(cap, max(1 << max(0, (total - 1).bit_length()), 4096))


@partial(jax.jit, static_argnames=("k",))
def _combined_fetch_jit(u, nbits, ovf, k: int):
    pre = jax.lax.bitcast_convert_type(u[..., :k], jnp.int32)
    if ovf.ndim < nbits.ndim:
        ovf = ovf[..., None]
    return jnp.concatenate([pre, nbits.astype(jnp.int32),
                            ovf.astype(jnp.int32)], axis=-1)


def combined_fetch(u_dev, nbits_dev, ovf_dev, guess: int):
    """Enqueue ONE device array carrying (u32-word prefix of length >= guess,
    per-segment bit counts, overflow flag) along the last axis.

    `jax.device_get` of a 3-tuple pays one transfer per array; packing the
    metadata into the prefix buffer makes collect() a single sync. The D2H
    transfer is issued EAGERLY (copy_to_host_async): it starts the moment
    the encode finishes on device instead of when the consumer blocks in
    np.asarray, so in pipelined loops it overlaps the next batch's
    compute. Returns (handle, k) — unpack the fetched np array with
    `split_fetch(arr, k, n_seg)`."""
    k = _prefix_k(u_dev, max(guess, 1))
    handle = _combined_fetch_jit(u_dev, nbits_dev, ovf_dev, k)
    handle.copy_to_host_async()
    return handle, k


def split_fetch(arr: np.ndarray, k: int, n_seg: int):
    """Host unpack of a combined_fetch download -> (u_words_i32 [..., k],
    nbits [..., n_seg], ovf bool[...])."""
    return (arr[..., :k], arr[..., k:k + n_seg],
            arr[..., k + n_seg] != 0)


def finalize_host(u: np.ndarray, nbytes: np.ndarray, first_rst: int,
                  n_rst: int) -> bytes:
    """Compact unstuffed segment bytes -> stuffed scan with RSTn joins.

    The host half of ops.pack.compact_unstuffed: FF->FF00 stuffing plus RSTn
    markers after the first `n_rst` segments, numbered from `first_rst`
    (stripe concatenation passes the stripe's global first segment index —
    SURVEY.md hard part 5). C++ (native.finalize_compact) with a vectorized
    NumPy fallback.
    """
    from jpgenc_tpu import native
    if native.available():
        out = native.finalize_compact(u, nbytes, first_rst, n_rst)
        if out is not None:
            return out
    parts = []
    p = 0
    for s, nb in enumerate(np.asarray(nbytes)):
        nb = int(nb)
        seg = u[p:p + nb]
        p += nb
        ff = np.flatnonzero(seg == 0xFF)
        parts.append((np.insert(seg, ff + 1, 0) if ff.size else seg).tobytes())
        if s < n_rst:
            parts.append(bytes([0xFF, 0xD0 + ((first_rst + s) & 7)]))
    return b"".join(parts)


def finalize_host_w(up: np.ndarray, nbits: np.ndarray, first_rst: int,
                    n_rst: int, walign: int) -> bytes:
    """Word-compact device stream -> stuffed scan with RSTn joins.

    The host half of ops.pack.wcompact_unstuffed: the downloaded u32
    buffer's memory image IS the unstuffed byte stream (device bswap),
    with segment s's ceil(bits/8) bytes at byte offset 4*wbase[s]. Sets
    the T.81 F.1.2.3 1-padding, stuffs FF->FF00 and inserts RSTn markers
    after the first `n_rst` segments, numbered from `first_rst`. C++
    (native.finalize_wcompact) with a vectorized NumPy fallback.
    """
    from jpgenc_tpu import native
    if native.available():
        out = native.finalize_wcompact(up, nbits, first_rst, n_rst, walign)
        if out is not None:
            return out
    b = np.ascontiguousarray(up).view(np.uint8)
    parts = []
    wb = 0
    for s, bits in enumerate(np.asarray(nbits)):
        bits = int(bits)
        nbytes = (bits + 7) >> 3
        seg = b[4 * wb:4 * wb + nbytes].copy()
        pad = nbytes * 8 - bits
        if pad and nbytes:
            seg[-1] |= (1 << pad) - 1
        ff = np.flatnonzero(seg == 0xFF)
        parts.append((np.insert(seg, ff + 1, 0) if ff.size else seg).tobytes())
        if s < n_rst:
            parts.append(bytes([0xFF, 0xD0 + ((first_rst + s) & 7)]))
        wb += int(seg_nwords_aligned(bits, walign))   # chunked starts
    return b"".join(parts)


def segments_to_scan(seg_words: np.ndarray, seg_bits: np.ndarray,
                     first_rst: int = 0) -> bytes:
    """[n_seg, W] u32 + [n_seg] bits -> stuffed entropy bytes with RSTn between
    segments. `first_rst` offsets the RSTn numbering (stripe concatenation
    across chips passes the global segment index here — SURVEY.md hard part 5).
    """
    from jpgenc_tpu import native
    if native.available():
        out = native.finalize_scan(seg_words, seg_bits, first_rst)
        if out is not None:
            return out
    n_seg = seg_words.shape[0]
    parts = []
    be = seg_words.astype(">u4")
    for s in range(n_seg):
        bits = int(seg_bits[s])
        nbytes = (bits + 7) // 8
        raw = np.frombuffer(be[s].tobytes(), np.uint8)[:nbytes].copy()
        pad = nbytes * 8 - bits
        if pad:
            raw[-1] |= (1 << pad) - 1
        parts.append(stuff_bytes(raw))
        if s < n_seg - 1:
            parts.append(bytes([0xFF, 0xD0 + ((first_rst + s) % 8)]))
    return b"".join(parts)


def scan_caps(layout: FrameLayout, quality: int,
              tier: str = "safe") -> tuple[int, int]:
    """(cap_u, cap_s) static buffer capacities for the device finalize.

    Sized from a quality-bucketed bits-per-coefficient-pixel heuristic,
    clamped to the true worst case. The device stuffing pass and the
    device->host download both scale with the cap, so encode tries the
    "tight" tier first (covers typical photographic content), retries with
    "safe" (covers noise-like content), and finally "worst" — true
    worst-case capacities that can NEVER overflow (paired with w_blk=56,
    which covers MAX_BLOCK_BITS), so even pathological content stays on the
    device pipeline. The host word path survives only as a last-resort
    safety net.
    """
    # +4*walign bytes/segment: chunk-aligned segment starts in the
    # wcompact stream (ops.pack.seg_nwords_aligned) waste up to
    # 4*walign - 4 pad bytes each
    wal = walign_for(layout.blocks_per_segment)
    worst = sum(c.n_blocks for c in layout.comps) * MAX_BLOCK_BITS // 8 + \
        4 * wal * layout.n_segments + 8
    if tier == "worst":
        # stuffing at most doubles the data bytes (every byte 0xFF)
        return worst, 2 * worst + 16
    px = sum(c.plane_h * c.plane_w for c in layout.comps)
    if tier == "tight":
        bpp = 0.5 if quality <= 80 else (1.0 if quality <= 92 else 2.0)
    else:
        bpp = 2.0 if quality <= 80 else (4.0 if quality <= 92 else 7.0)
    cap_u = min(int(px * bpp / 8) + 1024 + 4 * wal * layout.n_segments,
                worst)
    cap_u = -(-cap_u // 1024) * 1024
    cap_s = cap_u + cap_u // 16 + 64
    return cap_u, cap_s


def qtables_for_quality(quality: int) -> tuple[np.ndarray, jnp.ndarray]:
    """(host [2,64] int32 natural-order tables, device copy)."""
    q = np.stack([T.scale_qtable(T.QTABLE_LUMA, quality),
                  T.scale_qtable(T.QTABLE_CHROMA, quality)])
    return q, jnp.asarray(q)
