"""Block interleaving (type-3 <-> type-4 bits), EN 300 392-2 Section 8.2.4.1.

Reference behaviour: src/lower_mac/tetra_interleave.c:36-59 — the
permutation k = 1 + (a*i mod K).

Design: the permutation is precomputed once as an index tensor and
applied with a batched gather (`jnp.take`), so interleaving any number
of blocks is a single vectorised op.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

__all__ = ["interleave_indices", "block_interleave", "block_deinterleave",
           "matrix_interleave_indices"]


@functools.lru_cache(maxsize=16)
def interleave_indices(K: int, a: int) -> tuple[np.ndarray, np.ndarray]:
    """(gather_interleave, gather_deinterleave) index arrays of length K.

    out_interleaved = in[gather_interleave]; out_deinterleaved = in[gather_deinterleave].
    k(i) = 1 + (a*i) % K maps input position i-1 -> output position k-1.
    """
    i = np.arange(1, K + 1, dtype=np.int64)
    k = 1 + (a * i) % K
    deint = (k - 1).astype(np.int32)           # deinterleave: out[i-1] = in[k-1]
    intl = np.empty(K, dtype=np.int32)          # interleave: out[k-1] = in[i-1]
    intl[k - 1] = i - 1
    return intl, deint


def block_interleave(K: int, a: int, bits):
    """type-3 -> type-4 over ubits/soft [..., K]."""
    idx, _ = interleave_indices(K, a)
    return jnp.take(bits, jnp.asarray(idx), axis=-1)


def block_deinterleave(K: int, a: int, bits):
    """type-4 -> type-3 over ubits/soft [..., K]."""
    _, idx = interleave_indices(K, a)
    return jnp.take(bits, jnp.asarray(idx), axis=-1)


@functools.lru_cache(maxsize=8)
def matrix_interleave_indices(lines: int, columns: int) -> np.ndarray:
    """Matrix (row-in, column-out) interleaver, EN 300 395-2 Section 5.5.3.

    out[i*lines + j] = in[j*columns + i]. (The reference's implementation
    at src/lower_mac/tetra_interleave.c:62-82 is buggy and unused; this is
    the intended spec permutation.)
    """
    j, i = np.meshgrid(np.arange(lines), np.arange(columns))
    return (j * columns + i).reshape(-1).astype(np.int32)
