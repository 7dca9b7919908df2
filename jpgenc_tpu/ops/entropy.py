"""Device entropy stage: DC DPCM, branch-free AC run-length symbolization,
Huffman code lookup, symbol histograms (SURVEY.md components #9-#13, hard part 2).

Everything is fixed-shape (T.81's variable-length symbol stream is laid out as
a dense [slots, 64, 4] piece tensor with zero-length invalid pieces):

  lane 0..2: up-to-three ZRL codes preceding a value symbol (runs of >=16 zeros)
  lane 3:    DC (slot position 0) or AC (run,size) code with amplitude bits
             appended, or EOB at position 63 when the block's tail is zero.

Each piece is one (value, bit-length) pair with value <= 27 bits (16-bit code +
11 amplitude bits), so a u32 lane suffices. The bit-packer (ops/pack.py)
consumes pieces without caring what they mean.

T.81 references: F.1.2.1 (DC DPCM, magnitude categories), F.1.2.2 (AC RLE,
ZRL=0xF0, EOB=0x00), Tables F.1/F.2 (SSSS / one's-complement amplitudes).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_I32 = jnp.int32
_U32 = jnp.uint32


class EntropyLUTs(NamedTuple):
    """Dense Huffman encode tables, one row per table id (0=luma, 1=chroma).

    Entries are packed (code << 5) | code_len (code <= 16 bits, len <= 5
    bits) so every symbol costs one gather instead of two.
    """
    dc: jnp.ndarray  # [2, 256] int32 packed
    ac: jnp.ndarray  # [2, 256] int32 packed


class SymbolPlan(NamedTuple):
    """Static per-layout scan-order arrays (host-precomputed, device-resident)."""
    prev_same: jnp.ndarray   # [S] int32, DC predecessor slot or -1
    dc_tab: jnp.ndarray      # [S] int32 table id per slot
    ac_tab: jnp.ndarray      # [S] int32
    valid: jnp.ndarray       # [S] bool (False for segment padding slots)


def _ssss(v: jnp.ndarray) -> jnp.ndarray:
    """Magnitude category: bit length of |v| (T.81 Table F.1). v int32."""
    return (32 - jax.lax.clz(jnp.abs(v))).astype(_I32)


def _amp_bits(v: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Amplitude field: v if v>=0 else one's complement in s bits."""
    raw = jnp.where(v >= 0, v, v + (1 << s) - 1)
    return (raw & ((1 << s) - 1)).astype(_U32)


class Analysis(NamedTuple):
    dc_s: jnp.ndarray      # [S] SSSS of the DC diff
    dc_amp: jnp.ndarray    # [S] uint32 amplitude bits
    ac_s: jnp.ndarray      # [S, 64] SSSS per coefficient (pos 0 unused)
    ac_amp: jnp.ndarray    # [S, 64] uint32
    ac_sym: jnp.ndarray    # [S, 64] RRRRSSSS symbol per nonzero position
    n_zrl: jnp.ndarray     # [S, 64] int32 count of ZRL codes before position
    nz: jnp.ndarray        # [S, 64] bool, nonzero AC (pos 0 forced False)
    eob: jnp.ndarray       # [S] bool, block emits EOB


def analyze(zz_scan: jnp.ndarray, plan: SymbolPlan) -> Analysis:
    """Shared symbol analysis for both the packer and the histogram pass.

    zz_scan: [S, 64] int32 quantized zigzag blocks in scan order.
    """
    s_, _ = zz_scan.shape
    dc = zz_scan[:, 0]
    prev_idx = jnp.clip(plan.prev_same, 0, s_ - 1)
    prev_dc = jnp.where(plan.prev_same >= 0, dc[prev_idx], 0)
    diff = dc - prev_dc
    dc_s = _ssss(diff)
    dc_amp = _amp_bits(diff, dc_s)

    nz = zz_scan != 0
    nz = nz.at[:, 0].set(False)                      # DC handled separately
    pos = jax.lax.broadcasted_iota(_I32, zz_scan.shape, 1)
    marker = jnp.where(nz, pos, 0)                   # position 0 seeds run start
    prev_nz = jnp.concatenate(
        [jnp.zeros((s_, 1), _I32), jax.lax.cummax(marker, axis=1)[:, :-1]], axis=1)
    run = pos - prev_nz - 1                          # zeros before this nonzero
    ac_s = _ssss(zz_scan)
    ac_amp = _amp_bits(zz_scan, ac_s)
    ac_sym = ((run & 15) << 4) | ac_s
    n_zrl = jnp.where(nz, run >> 4, 0)
    eob = ~nz[:, 63]                                 # EOB iff last coef is zero
    return Analysis(dc_s, dc_amp, ac_s, ac_amp, ac_sym, n_zrl, nz, eob)


def _lut(table: jnp.ndarray, tab_id: jnp.ndarray, sym: jnp.ndarray) -> jnp.ndarray:
    """table [2,256] gathered at (tab_id broadcast, sym)."""
    flat = table.reshape(-1)
    idx = tab_id.reshape(tab_id.shape + (1,) * (sym.ndim - tab_id.ndim)) * 256 + sym
    return flat[idx]


def make_pieces(zz_scan: jnp.ndarray, plan: SymbolPlan,
                luts: EntropyLUTs) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[S, 64] scan blocks -> piece tensor ([S, 64, 4] u32 values, [S, 64, 4] i32 lens)."""
    a = analyze(zz_scan, plan)
    S = zz_scan.shape[0]
    v = plan.valid

    # --- lane 3 at position 0: DC code + amplitude
    dc_e = _lut(luts.dc, plan.dc_tab, a.dc_s)
    dc_code = (dc_e >> 5).astype(_U32)
    dc_clen = dc_e & 31
    dc_val = (dc_code << a.dc_s.astype(_U32)) | a.dc_amp
    dc_len = jnp.where(v, dc_clen + a.dc_s, 0)

    # --- lane 3 at positions 1..63: AC value symbol (or EOB at 63)
    ac_e = _lut(luts.ac, plan.ac_tab, a.ac_sym)
    ac_code = (ac_e >> 5).astype(_U32)
    ac_clen = ac_e & 31
    main_val = (ac_code << a.ac_s.astype(_U32)) | a.ac_amp
    main_len = jnp.where(a.nz & v[:, None], ac_clen + a.ac_s, 0)

    eob_e = _lut(luts.ac, plan.ac_tab, jnp.zeros((S,), _I32))
    eob_code = (eob_e >> 5).astype(_U32)
    eob_clen = eob_e & 31
    main_val = main_val.at[:, 63].set(
        jnp.where(a.eob, eob_code, main_val[:, 63]))
    main_len = main_len.at[:, 63].set(
        jnp.where(a.eob & v, eob_clen, main_len[:, 63]))
    main_val = main_val.at[:, 0].set(dc_val)
    main_len = main_len.at[:, 0].set(dc_len)

    # --- lanes 0..2: ZRL codes
    zrl_e = _lut(luts.ac, plan.ac_tab, jnp.full((S,), 0xF0, _I32))
    zrl_code = (zrl_e >> 5).astype(_U32)
    zrl_clen = zrl_e & 31
    lanes_v = []
    lanes_l = []
    for i in range(3):
        on = a.nz & (a.n_zrl > i) & v[:, None]
        lanes_v.append(jnp.where(on, zrl_code[:, None], _U32(0)))
        lanes_l.append(jnp.where(on, zrl_clen[:, None], 0))
    piece_val = jnp.stack(lanes_v + [main_val], axis=2)
    piece_len = jnp.stack(lanes_l + [main_len], axis=2)
    return piece_val, piece_len.astype(_I32)


def _make_ac_bin_maps():
    """Static 160-bin <-> 256-symbol maps (value symbols: run 0..15 x ssss
    1..10, packed bin = run*10 + ssss-1). Plain numpy so the constants are
    re-lifted fresh under every trace (a cached jnp constant created inside
    one trace leaks as a tracer into the next)."""
    import numpy as np
    sym_of_bin = np.zeros(256, np.int32)
    take = np.zeros(256, bool)
    for b in range(160):
        s256 = ((b // 10) << 4) | (b % 10 + 1)
        sym_of_bin[s256] = b
        take[s256] = True
    return sym_of_bin, take


_AC_SYM_OF_BIN, _AC_BIN_TAKE = _make_ac_bin_maps()


def symbol_histogram(zz_scan: jnp.ndarray, plan: SymbolPlan) -> jnp.ndarray:
    """Per-table symbol frequencies for the two-pass optimized-Huffman mode.

    Returns [2 (dc,ac), 2 (table id), 256] int32 counts — the device side of
    SURVEY.md call stack 4.3 (psum across chips happens at the caller).

    Formulated as a COMPARE-REDUCE over a dense 160-bin value-symbol domain
    (run 0..15 x ssss 1..10) instead of a scatter-add: XLA fuses the virtual
    [S*64, 160] equality broadcast into the reduction, so the data makes one
    pass with no data-dependent indices. Table-id split uses the difference
    trick: count (bin & tab==0) and total(bin), table 1 = total - table 0.
    """
    a = analyze(zz_scan, plan)
    v = plan.valid
    freq = jnp.zeros((2, 2, 256), _I32)

    # AC value symbols over the packed 160-bin domain
    ac_on = a.nz & v[:, None]
    run = a.ac_sym >> 4
    ssss = a.ac_sym & 15
    packed = jnp.where(ac_on, run * 10 + ssss - 1, -1).reshape(-1)
    tab = jnp.broadcast_to(plan.ac_tab[:, None], a.ac_sym.shape).reshape(-1)
    bins = jnp.arange(160, dtype=_I32)
    t0 = ((packed[:, None] == bins[None, :]) &
          (tab[:, None] == 0)).sum(axis=0, dtype=_I32)
    tot = (packed[:, None] == bins[None, :]).sum(axis=0, dtype=_I32)
    sym_of_bin, take = _AC_SYM_OF_BIN, _AC_BIN_TAKE
    freq = freq.at[1, 0].set(jnp.where(take, t0[sym_of_bin], 0))
    freq = freq.at[1, 1].set(jnp.where(take, (tot - t0)[sym_of_bin], 0))

    # DC: one SSSS symbol (0..11) per valid block
    dbins = jnp.arange(12, dtype=_I32)
    dsym = jnp.where(v, a.dc_s, -1)
    d0 = ((dsym[:, None] == dbins[None, :]) &
          (plan.dc_tab[:, None] == 0)).sum(axis=0, dtype=_I32)
    dtot = (dsym[:, None] == dbins[None, :]).sum(axis=0, dtype=_I32)
    freq = freq.at[0, 0, :12].set(d0)
    freq = freq.at[0, 1, :12].set(dtot - d0)

    # ZRL multiplicity + EOB (scalar sums, not scatters)
    zrl_n = jnp.where(ac_on, a.n_zrl, 0)
    for t_ in range(2):
        m = plan.ac_tab == t_
        freq = freq.at[1, t_, 0xF0].add(
            jnp.where(m, zrl_n.sum(axis=1), 0).sum())
        freq = freq.at[1, t_, 0].add(jnp.where(m & a.eob & v, 1, 0).sum())
    return freq
