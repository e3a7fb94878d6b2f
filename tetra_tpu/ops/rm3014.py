"""Shortened (30,14) Reed-Muller code for the AACH broadcast block.

Reference behaviour: src/lower_mac/tetra_rm3014.c — systematic encode
(14 info bits + 16 parity from the Section 8.2.3.2 generator), decode =
truncate (no correction in the reference; reference rx path doesn't even
call it, see tetra_lower_mac.c:268-271).

Design: encode is a GF(2) matmul with the [14, 30] systematic
generator; decode adds nearest-codeword correction via a precomputed
syndrome table (a strict superset of the reference's behaviour, off by
default for bit-parity).
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from tetra_tpu.constants import RM3014_GEN
from tetra_tpu.utils.bits import gf2_matmul

__all__ = ["generator_matrix", "encode", "decode", "encode_uint"]


@functools.lru_cache(maxsize=1)
def generator_matrix() -> np.ndarray:
    """[14, 30] systematic generator: identity(14) || RM3014_GEN."""
    return np.concatenate([np.eye(14, dtype=np.uint8), RM3014_GEN], axis=1)


def encode(bits14):
    """ubits [..., 14] -> codeword ubits [..., 30]."""
    return gf2_matmul(bits14, jnp.asarray(generator_matrix()))


def encode_uint(value: int) -> int:
    """14-bit uint -> 30-bit codeword (reference tetra_rm3014_compute)."""
    bits = np.array([(value >> (13 - i)) & 1 for i in range(14)], dtype=np.uint8)
    cw = (bits @ generator_matrix()) % 2
    out = 0
    for b in cw:
        out = (out << 1) | int(b)
    return out


@functools.lru_cache(maxsize=1)
def _parity_check() -> np.ndarray:
    """[30, 16] parity-check matrix H^T: syndrome = cw @ H^T."""
    # For systematic G = [I | P], H = [P^T | I], H^T = [[P],[I16]].
    return np.concatenate([RM3014_GEN, np.eye(16, dtype=np.uint8)], axis=0)


@functools.lru_cache(maxsize=1)
def _syndrome_table() -> np.ndarray:
    """syndrome (16-bit int) -> 30-bit error-pattern row index, single-bit errors."""
    Ht = _parity_check()
    table = np.full(1 << 16, -1, dtype=np.int32)
    for pos in range(30):
        syn = 0
        for r in range(16):
            if Ht[pos, r]:
                syn |= 1 << (15 - r)
        table[syn] = pos
    return table


def decode(bits30, correct: bool = False):
    """codeword ubits [..., 30] -> (info ubits [..., 14], syndrome_ok [...]).

    With correct=False this is the reference's truncation decode
    (tetra_rm3014.c:92-96) plus an error *detection* flag; with
    correct=True single-bit errors are fixed first.
    """
    syn_bits = gf2_matmul(bits30, jnp.asarray(_parity_check()))
    ok = jnp.all(syn_bits == 0, axis=-1)
    if correct:
        weights = (1 << jnp.arange(15, -1, -1, dtype=jnp.int32))
        syn = jnp.sum(syn_bits.astype(jnp.int32) * weights, axis=-1)
        errpos = jnp.asarray(_syndrome_table())[syn]  # -1 if not single-bit
        flip = (jnp.arange(30) == errpos[..., None]) & (errpos[..., None] >= 0)
        bits30 = jnp.bitwise_xor(bits30.astype(jnp.int8), flip.astype(jnp.int8))
        ok = ok | (errpos >= 0)
    return bits30[..., :14], ok
