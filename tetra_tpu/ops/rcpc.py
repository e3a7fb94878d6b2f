"""RCPC coding (type-2 <-> type-3 bits), EN 300 392-2 Section 8.2.3.1.

Reference behaviour: src/lower_mac/tetra_conv_enc.c — a rate-1/4 (data)
or rate-1/3 (speech) K=5 mother code plus 7 puncturing schemes.

Design:
- The mother encoder is feed-forward: each output bit is an XOR of
  shifted copies of the input, so encoding a whole (batched) block is a
  handful of vector XORs — no sequential state machine.
- Puncturing/depuncturing are precomputed index maps applied as
  gather/scatter, batched over blocks.
- Depuncturing emits a *soft* mother sequence directly: punctured
  positions become 0 (erasure), carrying the exact semantics of the
  reference's 0xff markers + viterbi soft mapping
  (src/lower_mac/tetra_conv_enc.c:226-248, src/lower_mac/viterbi.c:6-25).
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from tetra_tpu.constants import PUNCT_SCHEMES, CONV_GENERATORS_CCH, CONV_GENERATORS_TCH

__all__ = [
    "conv_encode", "puncture_indices", "puncture", "depuncture_soft",
    "depuncture_hard",
]


def conv_encode(bits, generators=CONV_GENERATORS_CCH):
    """Mother-code encode ubits [..., L] -> [..., L*N].

    Matches reference src/lower_mac/tetra_conv_enc.c:43-74: the encoder
    starts from the all-zero state; output order per step is G1..GN.
    """
    bits = bits.astype(jnp.int8)
    n = len(generators)
    outs = []
    for taps in generators:
        g = bits
        for d in taps:
            # input delayed by d, zero-padded at the front (zero initial state)
            shifted = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(d, 0)])[..., :-d]
            g = jnp.bitwise_xor(g, shifted)
        outs.append(g)
    # interleave as [g1(t0), g2(t0), .., gN(t0), g1(t1), ...]
    stacked = jnp.stack(outs, axis=-1)  # [..., L, N]
    return stacked.reshape(*bits.shape[:-1], bits.shape[-1] * n)


@functools.lru_cache(maxsize=32)
def puncture_indices(scheme: str, type3_len: int) -> np.ndarray:
    """k-indices (0-based into the mother sequence) for j = 1..type3_len.

    Implements k = period*((i-1)/t) + P[i - t*((i-1)/t)] with i = i_func(j)
    (reference src/lower_mac/tetra_conv_enc.c:196-248).
    """
    P, t, period, ifunc = PUNCT_SCHEMES[scheme]
    P = np.asarray(P, dtype=np.int64)
    j = np.arange(1, type3_len + 1, dtype=np.int64)
    if ifunc == "eq":
        i = j
    elif ifunc == "292":
        i = j + (j - 1) // 65
    elif ifunc == "148":
        i = j + (j - 1) // 35
    else:  # pragma: no cover
        raise ValueError(ifunc)
    q = (i - 1) // t
    k = period * q + P[i - t * q]
    return (k - 1).astype(np.int32)


def puncture(scheme: str, mother, type3_len: int):
    """Select type-3 bits from the mother sequence [..., L*N] -> [..., type3_len]."""
    idx = jnp.asarray(puncture_indices(scheme, type3_len))
    return jnp.take(mother, idx, axis=-1)


def depuncture_soft(scheme: str, soft_type3, mother_len: int):
    """Scatter soft type-3 values into a zero (erasure) mother sequence.

    soft_type3: [..., type3_len] float/int soft values (+ for bit 0).
    Returns [..., mother_len] soft mother sequence with 0 at punctured
    positions — exactly the reference's 0xff-erasure + soft-0 semantics.
    """
    idx = jnp.asarray(puncture_indices(scheme, soft_type3.shape[-1]))
    shape = soft_type3.shape[:-1] + (mother_len,)
    out = jnp.zeros(shape, dtype=soft_type3.dtype)
    return out.at[..., idx].set(soft_type3)


def depuncture_hard(scheme: str, type3, mother_len: int, erasure=255):
    """Hard-bit depuncture with explicit erasure marker (for parity tests)."""
    idx = jnp.asarray(puncture_indices(scheme, type3.shape[-1]))
    shape = type3.shape[:-1] + (mother_len,)
    out = jnp.full(shape, erasure, dtype=jnp.int32)
    return out.at[..., idx].set(type3.astype(jnp.int32))
