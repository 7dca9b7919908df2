"""Pallas (Triton) kernel A: fused per-block entropy pack for the GPU.

One program takes a tile of quantized zigzag blocks straight to per-block
packed bitstreams, keeping every intermediate in registers:

  zz [T, 64] -> AC run-length analysis: the 64-bit nonzero mask of each block
                (two u32 halves, one reduction each) and the top set bit of
                its part below each lane give the previous nonzero
                position, so no cummax is needed
             -> SSSS/amplitude (bit lengths from the float32 exponent)
             -> Huffman LUT lookups as indexed loads from the [2*256] tables
             -> per-slot 96-bit registers (up to 3 ZRL pieces + code|amp)
             -> in-block exclusive bit-offset prefix (cumsum)
             -> word merge into [T, W] by compare-reduce (W a power of two)

Only the packed words and the per-block bit counts reach device memory; the
XLA formulation (ops.entropy.make_pieces -> ops.pack.block_pack) round-trips
the [S, 64, 4] piece tensors and scatter-adds every piece word. The two are
bit-identical (tests compare them exactly). The DC predecessor gather stays
in XLA (`slot_metadata`): it is one [S] gather.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from jpgenc_tpu.ops.entropy import EntropyLUTs, SymbolPlan
from jpgenc_tpu.ops.pack import _shift_into_word

_I32 = jnp.int32
_U32 = jnp.uint32

#: blocks per program
TILE = 32


def padded_words(w_blk: int) -> int:
    """Kernel output width: Triton block dims are powers of two, so the
    12/24/56-word tiers are computed at 16/32/64 and sliced back."""
    return 1 << max(0, (w_blk - 1).bit_length())


def _bit_length(v):
    """Bit length of |v| for |v| < 2^24, from the float32 exponent (Triton
    does not lower a tensor clz). For coefficients this is SSSS (T.81
    Table F.1)."""
    av = jnp.abs(v)
    e = (jax.lax.bitcast_convert_type(av.astype(jnp.float32), _I32) >> 23) & 0xFF
    return jnp.where(av == 0, 0, e - 126)


def _top_bit(m):
    """Index of the highest set bit of a nonzero u32 (two exact 16-bit
    halves, since float32 rounds wider values)."""
    hi = (m >> 16).astype(_I32)
    lo = (m & 0xFFFF).astype(_I32)
    return jnp.where(hi != 0, 15 + _bit_length(hi), _bit_length(lo) - 1)


def _amp(v, s):
    """Amplitude field: v if v >= 0 else its one's complement in s bits."""
    return (jnp.where(v >= 0, v, v + (1 << s) - 1) & ((1 << s) - 1)).astype(_U32)


def _shl(v, s):
    """u32 left shift with s >= 32 giving 0."""
    return jnp.where(s < 32, v << jnp.clip(s, 0, 31).astype(_U32), _U32(0))


def _kernel(zz_ref, dcdiff_ref, actab_ref, dctab_ref, valid_ref,
            ac_ref, dc_ref, buf_ref, bits_ref, *, n_words: int):
    v = zz_ref[...].astype(_I32)                       # [T, 64]
    t = v.shape[0]
    pos = jax.lax.broadcasted_iota(_I32, (t, 64), 1)
    nz = (v != 0) & (pos > 0)
    actab = actab_ref[...]                             # [T]
    valid = (valid_ref[...] != 0)[:, None]             # [T, 1]

    # --- run lengths: previous nonzero position strictly before each lane,
    # from the block's 64-bit nonzero mask (bits are disjoint: sum == or)
    low = pos & 31
    bit = jnp.where(nz, _U32(1) << low.astype(_U32), _U32(0))
    lo = jnp.sum(jnp.where(pos < 32, bit, _U32(0)), axis=1)[:, None]
    hi = jnp.sum(jnp.where(pos >= 32, bit, _U32(0)), axis=1)[:, None]
    below = (_U32(1) << low.astype(_U32)) - _U32(1)
    m_lo = jnp.where(pos < 32, lo & below, lo)
    m_hi = jnp.where(pos < 32, _U32(0), hi & below)
    prev = jnp.where(m_hi != 0, 32 + _top_bit(m_hi),
                     jnp.where(m_lo != 0, _top_bit(m_lo), 0))
    run = pos - prev - 1
    eob_here = (hi >> 31) == 0                         # [T, 1] last coef zero

    s_ac = _bit_length(v)
    amp_ac = _amp(v, s_ac)
    sym = (((run & 15) << 4) | s_ac) & 255

    # --- Huffman LUT lookups: (code << 5) | len entries, indexed loads
    tab = actab[:, None] * 256
    e_ac = ac_ref[tab + sym]                           # [T, 64]
    zrl = ac_ref[tab + 0xF0]                           # [T, 1]
    eob = ac_ref[tab]
    dcdiff = dcdiff_ref[...][:, None]
    s_dc = _bit_length(dcdiff)
    e_dc = dc_ref[dctab_ref[...][:, None] * 256 + s_dc]

    # --- the slot's main piece: DC at lane 0, AC value symbol, EOB at 63
    main_val = _shl((e_ac >> 5).astype(_U32), s_ac) | amp_ac
    main_len = jnp.where(nz & valid, (e_ac & 31) + s_ac, 0)
    eob63 = (pos == 63) & eob_here
    main_val = jnp.where(eob63, (eob >> 5).astype(_U32), main_val)
    main_len = jnp.where(eob63 & valid, eob & 31, main_len)
    dc_val = _shl((e_dc >> 5).astype(_U32), s_dc) | _amp(dcdiff, s_dc)
    main_val = jnp.where(pos == 0, dc_val, main_val)
    main_len = jnp.where(pos == 0, jnp.where(valid, (e_dc & 31) + s_dc, 0),
                         main_len)

    # --- registers: up to 3 ZRL pieces then the main piece (96 bits)
    n_zrl = jnp.where(nz & valid, run >> 4, 0)
    zval = (zrl >> 5).astype(_U32)
    zlen = zrl & 31
    reg = [jnp.zeros((t, 64), _U32) for _ in range(3)]
    p_off = jnp.zeros((t, 64), _I32)
    for p in range(4):
        if p < 3:
            on = n_zrl > p
            pv = jnp.where(on, zval, _U32(0))
            plen = jnp.where(on, zlen, 0)
        else:
            pv, plen = main_val, main_len
        a = 96 - p_off - plen
        for w in range(3):
            reg[w] = reg[w] | _shift_into_word(pv, a - 64 + 32 * w)
        p_off = p_off + plen

    # --- in-block exclusive bit offsets, then word-aligned contributions
    off = jnp.cumsum(p_off, axis=1) - p_off
    d = off >> 5
    r = off & 31
    zero = jnp.zeros((t, 64), _U32)
    w4 = [_shift_into_word(reg[j] if j <= 2 else zero, -r) |
          _shift_into_word(reg[j - 1] if j >= 1 else zero, 32 - r)
          for j in range(4)]

    # --- merge: word w gathers the lanes whose contribution j lands on it
    col = jax.lax.broadcasted_iota(_I32, (t, n_words), 1)
    buf = jnp.zeros((t, n_words), _U32)
    for w in range(n_words):
        acc = zero
        for j in range(4):
            acc = jnp.where(d == w - j, w4[j], acc)
        buf = jnp.where(col == w, jnp.sum(acc, axis=1)[:, None], buf)
    buf_ref[...] = buf
    bits_ref[...] = jnp.sum(p_off, axis=1)


@functools.partial(jax.jit, static_argnames=("w_blk", "interpret"))
def fused_block_pack(zz_scan: jnp.ndarray, dcdiff: jnp.ndarray,
                     actab: jnp.ndarray, dctab: jnp.ndarray,
                     valid: jnp.ndarray, luts: EntropyLUTs, w_blk: int,
                     interpret: bool = False
                     ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """zz blocks (+ per-slot metadata from `slot_metadata`) -> per-block
    packed buffers: (buf [S, w_blk] u32 MSB-first, bits [S] i32), identical
    to ops.pack.block_pack over ops.entropy.make_pieces.

    S is padded to a TILE multiple (padding slots are invalid, so they pack
    to nothing). `interpret` runs the kernel on the CPU, for tests.
    """
    s = zz_scan.shape[0]
    s_pad = -(-s // TILE) * TILE
    n_words = padded_words(w_blk)

    def pad(a):
        return jnp.pad(a, ((0, s_pad - s),) + ((0, 0),) * (a.ndim - 1))

    col = pl.BlockSpec((TILE,), lambda i: (i,))
    table = pl.BlockSpec((512,), lambda i: (0,))
    buf, bits = pl.pallas_call(
        functools.partial(_kernel, n_words=n_words),
        grid=(s_pad // TILE,),
        in_specs=[pl.BlockSpec((TILE, 64), lambda i: (i, 0)),
                  col, col, col, col, table, table],
        out_specs=(pl.BlockSpec((TILE, n_words), lambda i: (i, 0)), col),
        out_shape=(jax.ShapeDtypeStruct((s_pad, n_words), _U32),
                   jax.ShapeDtypeStruct((s_pad,), _I32)),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="entropy_block_pack",
    )(pad(zz_scan.astype(_I32)),
      *(pad(x.astype(_I32)) for x in (dcdiff, actab, dctab, valid)),
      luts.ac.reshape(512).astype(_I32), luts.dc.reshape(512).astype(_I32))
    return buf[:s, :w_blk], bits[:s]


def slot_metadata(plan: SymbolPlan, zz_scan: jnp.ndarray):
    """XLA pre-pass: DC differences (one [S] gather) + per-slot table ids."""
    s = zz_scan.shape[0]
    dc = zz_scan[:, 0].astype(_I32)
    prev_idx = jnp.clip(plan.prev_same, 0, s - 1)
    prev_dc = jnp.where(plan.prev_same >= 0, dc[prev_idx], 0)
    return dc - prev_dc, plan.ac_tab, plan.dc_tab, plan.valid
