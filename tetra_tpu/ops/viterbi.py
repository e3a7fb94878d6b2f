"""Soft-decision Viterbi decoder for the TETRA 16-state codes.

Reference behaviour: src/lower_mac/viterbi.c + viterbi_cch.c /
viterbi_tch.c (tables) with the actual ACS done by libosmocore's
osmo_conv_decode. Soft convention: +127 = bit 0, -127 = bit 1, 0 =
erasure (src/lower_mac/viterbi.c:6-25).

Design: the trellis is tiny (16 states, radix-2) and every TETRA FEC
block is short (<= 288 steps) and tail-terminated, so blocks are
independent — the parallel axis is the *batch* (carriers x slots), not
time. Branch metrics for all steps are one small matmul; ACS is a
`lax.scan` over time with states vectorised; traceback is a reverse
scan over stored decisions. This module is the XLA version and the
semantics reference; `decode_fast` is the one point that picks the
fused GPU kernel (tetra_tpu.ops.viterbi_pallas) instead.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

from tetra_tpu.constants import CONV_GENERATORS_CCH, CONV_GENERATORS_TCH

__all__ = [
    "trellis_signs", "decode", "decode_segmented", "decode_fast",
    "decode_cch", "decode_tch", "hard_to_soft",
]

_NEG = np.float32(-1e6)  # large enough to exclude invalid paths, small enough that f32 adds of ±127 stay exact

# predecessor structure of the de Bruijn state graph:
# state s = (d0..d3) with s' = ((s & 7) << 1) | b  (viterbi_cch.c:43-47)
_P0 = np.arange(16, dtype=np.int32) >> 1
_P1 = _P0 | 8
_BIT = np.arange(16, dtype=np.int32) & 1


@functools.lru_cache(maxsize=4)
def trellis_signs(generators) -> np.ndarray:
    """[16, 2, N] correlation signs: +1 where expected output bit is 0.

    Output bit for generator taps from state s with input b:
    g = b xor XOR_d s>>(d-1) (state bit j = delay-j register,
    matching the reference encoder tetra_conv_enc.c:43-74 and the
    osmo trellis tables in viterbi_cch.c:35-47).
    """
    n = len(generators)
    signs = np.zeros((16, 2, n), dtype=np.float32)
    for s in range(16):
        for b in (0, 1):
            for gi, taps in enumerate(generators):
                bit = b
                for d in taps:
                    bit ^= (s >> (d - 1)) & 1
                signs[s, b, gi] = 1.0 - 2.0 * bit
    return signs


def hard_to_soft(bits, erasure_marker: int = 255):
    """Hard/erasure-marked bits -> soft values (viterbi.c:6-25 semantics)."""
    bits = bits.astype(jnp.int32)
    return jnp.where(bits == erasure_marker, 0,
                     jnp.where(bits == 0, 127, -127)).astype(jnp.float32)


def decode(soft, n_sym: int, generators=CONV_GENERATORS_CCH):
    """Decode soft mother bits [..., >= n_sym*N] -> hard bits [..., n_sym].

    Maximises correlation; starts from the all-zero state; picks the best
    end state (equivalent to libosmocore's flush-terminated decode fed
    zero-padding, see viterbi.c:6-10 where the input buffer is
    zero-initialised beyond the block).
    """
    n = len(generators)
    signs = jnp.asarray(trellis_signs(tuple(map(tuple, generators))))
    batch = soft.shape[:-1]
    soft_t = soft[..., : n_sym * n].reshape(*batch, n_sym, n).astype(jnp.float32)
    # branch metrics for every (step, state, input bit): one small matmul
    bm = jnp.einsum("...tn,sbn->...tsb", soft_t, signs,
                    preferred_element_type=jnp.float32,
                    precision=lax.Precision.HIGHEST)
    bm = jnp.moveaxis(bm, -3, 0)  # [T, ..., 16, 2]

    p0, p1, bvec = jnp.asarray(_P0), jnp.asarray(_P1), jnp.asarray(_BIT)

    def acs(metric, bm_t):
        c0 = jnp.take(metric, p0, axis=-1) + bm_t[..., p0, bvec]
        c1 = jnp.take(metric, p1, axis=-1) + bm_t[..., p1, bvec]
        dec = c1 > c0  # tie -> lower predecessor, like a stable max
        return jnp.where(dec, c1, c0), dec

    metric0 = jnp.full(batch + (16,), _NEG, jnp.float32).at[..., 0].set(0.0)
    metric, decs = lax.scan(acs, metric0, bm)
    end_state = jnp.argmax(metric, axis=-1).astype(jnp.int32)

    def traceback(state, dec_t):
        took_p1 = jnp.take_along_axis(dec_t, state[..., None], axis=-1)[..., 0]
        bit = (state & 1).astype(jnp.int8)
        prev = (state >> 1) | (took_p1.astype(jnp.int32) << 3)
        return prev, bit

    _, bits = lax.scan(traceback, end_state, decs, reverse=True)
    return jnp.moveaxis(bits, 0, -1)


def decode_segmented(soft, rmask, n_sym: int, boundaries: tuple,
                     generators=CONV_GENERATORS_CCH):
    """`decode` with per-row trellis restarts at static steps.

    soft [B, >= n_sym*N]; rmask [B, len(boundaries)] (nonzero = the
    trellis restarts from state 0 at that step, and the traceback of the
    segment before it starts from that segment's best end state).
    """
    n = len(generators)
    signs = jnp.asarray(trellis_signs(tuple(map(tuple, generators))))
    B = soft.shape[0]
    soft_t = soft[:, : n_sym * n].reshape(B, n_sym, n).astype(jnp.float32)
    # branch metrics [T, B, 16, 2]
    bm = jnp.moveaxis(jnp.einsum("btn,scn->btsc", soft_t, signs,
                                 preferred_element_type=jnp.float32,
                                 precision=lax.Precision.HIGHEST), 1, 0)
    reset = jnp.zeros((n_sym, B), jnp.float32)
    for i, b in enumerate(boundaries):
        reset = reset.at[b].set((rmask[:, i] != 0).astype(jnp.float32))

    p0, p1, bvec = jnp.asarray(_P0), jnp.asarray(_P1), jnp.asarray(_BIT)
    init = jnp.full((B, 16), _NEG, jnp.float32).at[:, 0].set(0.0)

    def acs(metric, xs):
        bm_t, r = xs
        bstate = jnp.argmax(metric, axis=-1).astype(jnp.int32)
        metric = jnp.where(r[:, None] > 0, init, metric)
        c0 = jnp.take(metric, p0, axis=-1) + bm_t[..., p0, bvec]
        c1 = jnp.take(metric, p1, axis=-1) + bm_t[..., p1, bvec]
        dec = c1 > c0
        return jnp.where(dec, c1, c0), (dec, bstate)

    metric, (decs, bstates) = lax.scan(acs, init, (bm, reset))
    end_state = jnp.argmax(metric, axis=-1).astype(jnp.int32)

    def traceback(state, xs):
        dec_t, bstate_t, r = xs
        took_p1 = jnp.take_along_axis(dec_t, state[..., None], axis=-1)[..., 0]
        bit = (state & 1).astype(jnp.int8)
        prev = (state >> 1) | (took_p1.astype(jnp.int32) << 3)
        prev = jnp.where(r > 0, bstate_t, prev)
        return prev, bit

    _, bits = lax.scan(traceback, end_state, (decs, bstates, reset),
                       reverse=True)
    return jnp.moveaxis(bits, 0, -1)


def decode_fast(soft, n_sym: int, generators=CONV_GENERATORS_CCH,
                rmask=None, boundaries: tuple = ()):
    """The one kernel-selection point of the Viterbi decoder: programs
    lowered for an NVIDIA GPU run the fused Pallas kernel
    (viterbi_pallas.decode_pallas); every other platform runs the XLA
    scan (`decode` / `decode_segmented`), which is the reference. Both
    are bit-identical. The choice is made per lowering platform, so a
    computation placed on the CPU of a GPU host takes the scan.

    soft [..., >= n_sym*N] -> bits [..., n_sym]; rmask [..., nb] goes
    with static `boundaries` (see decode_segmented)."""
    from tetra_tpu.ops.viterbi_pallas import decode_pallas
    generators = tuple(map(tuple, generators))
    batch = soft.shape[:-1]
    flat = soft.reshape((-1, soft.shape[-1]))
    boundaries = tuple(boundaries)
    if boundaries:
        rm = jnp.asarray(rmask).reshape((-1, len(boundaries)))
    else:
        rm = jnp.zeros((flat.shape[0], 0), jnp.float32)

    def scan(s, r):
        if boundaries:
            return decode_segmented(s, r, n_sym, boundaries, generators)
        return decode(s, n_sym, generators)

    def kernel(s, r):
        return decode_pallas(s, n_sym, generators, r if boundaries else None,
                             boundaries)

    out = lax.platform_dependent(flat, rm, cuda=kernel, default=scan)
    return out.reshape(*batch, n_sym)


def decode_cch(soft, n_sym: int):
    """Control-channel code (viterbi_cch.c)."""
    return decode_fast(soft, n_sym, CONV_GENERATORS_CCH)


def decode_tch(soft, n_sym: int):
    """Traffic/speech code (viterbi_tch.c)."""
    return decode_fast(soft, n_sym, CONV_GENERATORS_TCH)
