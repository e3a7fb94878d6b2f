"""TETRA scrambling (type-4 <-> type-5 bits), EN 300 392-2 Section 8.2.5.

Reference behaviour: src/lower_mac/tetra_scramb.c — a 32-tap Fibonacci
LFSR whose output keystream is XORed over the block.

Design: the LFSR output is *linear* in the 32 initial state bits, so
instead of a sequential bit loop we precompute (once, on host) a GF(2)
matrix M[32, n] with ks = init_bits @ M mod 2. Keystream generation for
any (possibly traced) scrambling code is then a single tiny matmul that
batches over carriers, and descrambling is one fused XOR.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from tetra_tpu.constants import SCRAMB_TAPS, SCRAMB_INIT
from tetra_tpu.utils.bits import gf2_matmul

__all__ = [
    "SCRAMB_INIT", "keystream_matrix", "keystream_np", "scramb_get_init",
    "keystream", "scramb_bits", "init_to_bits",
]


@functools.lru_cache(maxsize=8)
def keystream_matrix(n: int) -> np.ndarray:
    """M[32, n] over GF(2): keystream = state_bits @ M.

    state_bits[j] = bit j of the uint32 LFSR state (LSB first). Computed
    symbolically: track, for every state bit, its mask over initial bits.
    """
    # masks[j] = 32-bit mask over initial state bits for current state bit j
    masks = np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))
    out = np.zeros((32, n), dtype=np.uint8)
    for i in range(n):
        # output bit = XOR of state bits at index (32 - y) for tap y
        fb = np.uint64(0)
        for y in SCRAMB_TAPS:
            fb ^= masks[32 - y]
        # record: keystream bit i is linear comb 'fb' of initial bits
        for j in range(32):
            if fb >> np.uint64(j) & np.uint64(1):
                out[j, i] = 1
        # state = (state >> 1) | (bit << 31)
        masks[:31] = masks[1:]
        masks[31] = fb
    return out


def keystream_np(init: int, n: int) -> np.ndarray:
    """Host-side keystream for a concrete init (numpy, for tests/tables)."""
    state_bits = np.array([(init >> j) & 1 for j in range(32)], dtype=np.uint8)
    return (state_bits @ keystream_matrix(n)) % 2


def scramb_get_init(mcc: int, mnc: int, colour: int) -> int:
    """Cell scrambling code (reference src/lower_mac/tetra_scramb.c:87-99)."""
    mcc &= 0x3FF
    mnc &= 0x3FFF
    colour &= 0x3F
    return ((colour | (mnc << 6) | (mcc << 20)) << 2) | SCRAMB_INIT


def init_to_bits(init):
    """uint32 scrambling code -> LSB-first 32-bit ubits (traced-compatible)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return ((jnp.uint32(init)[..., None] >> shifts) & 1).astype(jnp.int8)


def keystream(init, n: int):
    """Keystream [..., n] for (batched, possibly traced) uint32 init."""
    m = jnp.asarray(keystream_matrix(n))
    return gf2_matmul(init_to_bits(init), m)


def scramb_bits(init, bits):
    """XOR-apply the scrambling keystream over ubits [..., n].

    Works for both directions (scramble/descramble), matching
    reference src/lower_mac/tetra_scramb.c:77-85.
    """
    n = bits.shape[-1]
    return jnp.bitwise_xor(bits.astype(jnp.int8), keystream(init, n))
