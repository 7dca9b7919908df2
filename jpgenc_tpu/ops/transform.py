"""Device transform stage: level shift, 8x8 FDCT/IDCT, quantize, zigzag
(SURVEY.md components #7, #8, #21; T.81 sections A.3.3, A.3.6).

The FDCT is two 8x8 matmuls per block (`C @ X @ C.T`), folded with the
zigzag into one [n,64]@[64,64] product. Every float32 product here pins
Precision.HIGHEST: a GPU would otherwise be free to run it in TF32, which
keeps about three decimal digits and moves quantized coefficients.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from jpgenc_tpu import tables as T
from jpgenc_tpu.ref.encoder import dct_matrix

_C = np.asarray(dct_matrix(np.float32))  # host constant, lifted at trace time
_C64 = np.asarray(dct_matrix(np.float64))


def blockify(plane: jnp.ndarray) -> jnp.ndarray:
    """[H, W] -> [H//8 * W//8, 8, 8] raster block order."""
    h, w = plane.shape
    return (plane.reshape(h // 8, 8, w // 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 8, 8))


def deblockify(blocks: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    return (blocks.reshape(h // 8, w // 8, 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(h, w))


def fdct_blocks(blocks: jnp.ndarray) -> jnp.ndarray:
    """2-D T.81 FDCT of level-shifted float32 blocks [n, 8, 8]."""
    c = jnp.asarray(_C)
    return jnp.einsum("ij,njk,lk->nil", c, blocks, c,
                      precision=jax.lax.Precision.HIGHEST)


def idct_blocks(coef: jnp.ndarray) -> jnp.ndarray:
    """Inverse of fdct_blocks: C.T @ Y @ C."""
    c = jnp.asarray(_C)
    return jnp.einsum("ji,njk,kl->nil", c, coef, c,
                      precision=jax.lax.Precision.HIGHEST)


def round_half_away(x: jnp.ndarray) -> jnp.ndarray:
    """Frozen quantizer rounding rule (matches ref.encoder.round_half_away)."""
    return jnp.trunc(x + jnp.copysign(jnp.float32(0.5), x))


# [64, 64] fused FDCT+zigzag operator: column k of _KDCT_ZZ computes zigzag
# coefficient k of the 2-D DCT from a row-major flattened 8x8 block, i.e.
# vec(C @ X @ C.T)[ZZ[k]] = vec(X) @ kron(C, C).T[:, ZZ[k]]. One [n,64]@[64,64]
# matmul replaces n pairs of 8x8 matmuls.
_KDCT_ZZ = np.kron(_C, _C).T[:, np.asarray(T.ZIGZAG)].astype(np.float32)


def plane_to_zigzag(plane_f32: jnp.ndarray, qtable_nat: jnp.ndarray) -> jnp.ndarray:
    """Padded float32 plane -> [n_blocks, 64] int32 quantized zigzag coefficients.

    The transform stage K1 (SURVEY.md call stack 4.1): level shift, FDCT,
    quantize, zigzag — one matmul, then the quantizer divide.
    """
    x = blockify(plane_f32).reshape(-1, 64) - jnp.float32(128.0)
    q_zz = qtable_nat.reshape(64).astype(jnp.float32)[jnp.asarray(T.ZIGZAG)]
    coef = jnp.dot(x, jnp.asarray(_KDCT_ZZ),
                   precision=jax.lax.Precision.HIGHEST)
    return round_half_away(coef / q_zz[None, :]).astype(jnp.int32)


# [64, 64] fused dezigzag+IDCT operator (_KDCT_ZZ's inverse — kron(C, C) is
# orthogonal): row k is the pixel-domain basis image of zigzag coefficient k,
# so reconstruction is one [n,64]@[64,64] matmul instead of a 64-lane
# gather plus batched 8x8 einsums. Built in float64 and rounded once, so
# the entries that are exact binary fractions (the DC row is 1/8) are exact:
# a DC-only block then reconstructs to its exact sample value, and a
# half-way sample rounds the same way here and in ref.decoder.
_KIDCT_ZZ = np.kron(_C64, _C64)[np.asarray(T.ZIGZAG), :].astype(np.float32)


def zigzag_to_plane(zz: jnp.ndarray, qtable_nat: jnp.ndarray,
                    h: int, w: int) -> jnp.ndarray:
    """Decoder reconstruction: [n, 64] zigzag ints -> float32 plane (unclipped).

    Dequant (in zigzag order) -> fused dezigzag+IDCT matmul -> +128
    (SURVEY.md component #21).
    """
    q_zz = qtable_nat.reshape(64).astype(jnp.float32)[jnp.asarray(T.ZIGZAG)]
    coef = zz.astype(jnp.float32) * q_zz[None, :]
    px = jnp.dot(coef, jnp.asarray(_KIDCT_ZZ),
                 precision=jax.lax.Precision.HIGHEST) + jnp.float32(128.0)
    return deblockify(px.reshape(-1, 8, 8), h, w)
