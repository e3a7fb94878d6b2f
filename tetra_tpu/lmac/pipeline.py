"""Lower-MAC decode pipeline (type-5 -> type-1 bits), batched.

Reference behaviour: src/lower_mac/tetra_lower_mac.c:143-357 — per
block: descramble, deinterleave, depuncture, Viterbi, CRC16. Block
parameters from the table at tetra_lower_mac.c:55-102.

Design: one fused, jit-compiled tensor program per block kind.
The batch axis is (carriers x slots); all shapes are static per kind, so
XLA fuses descramble-XOR + gather + soft-map + scatter around the
Viterbi scan, and the CRC check is a single matmul. Whole sync/normal
bursts decode as a unit (both constituent blocks at once).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tetra_tpu import constants as C
from tetra_tpu.ops import scramble, interleave, rcpc, viterbi, crc, rm3014
from tetra_tpu.phy import burst as burst_mod

__all__ = ["BlockResult", "decode_block", "decode_bbk", "decode_sync_burst",
           "decode_ndb_burst", "decode_schf_burst", "sb1_sync_fields"]


class BlockResult(NamedTuple):
    type1: jax.Array    # [..., type1_bits] decoded bits
    crc_ok: jax.Array   # [...] bool
    type2: jax.Array    # [..., type2_bits] (incl. CRC + tail, for debug/parity)


@functools.lru_cache(maxsize=8)
def _fec_matrix(kind: str):
    """Composed deinterleave+depuncture+soft-map as ONE one-hot matrix:
    mother = sign(type4) @ P with P[deint[j], punct[j]] = 127. One
    matmul (exact: one non-zero integer product per output) replaces
    the deinterleave gather + depuncture scatter."""
    n345, n2, _, ia, _ = C.BLOCK_PARAMS[kind]
    punct = rcpc.puncture_indices("2_3", n345)
    _, deint = interleave.interleave_indices(n345, ia)
    P = np.zeros((n345, n2 * 4), np.float32)
    for j in range(n345):
        P[deint[j], punct[j]] = 127.0
    return P


def _decode_fec(kind: str, type5, scramb_init) -> BlockResult:
    """Shared FEC slice for CRC-protected block kinds."""
    n345, n2, n1, ia, _ = C.BLOCK_PARAMS[kind]
    assert type5.shape[-1] == n345, (kind, type5.shape)
    type4 = scramble.scramb_bits(scramb_init, type5)
    sgn = (1 - 2 * type4.astype(jnp.int8)).astype(jnp.float32)
    mother = jnp.dot(sgn, jnp.asarray(_fec_matrix(kind)),
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    type2 = viterbi.decode_cch(mother, n2)
    ok = crc.crc16_check(type2[..., : n1 + 16])
    return BlockResult(type2[..., :n1], ok, type2)


@functools.partial(jax.jit, static_argnames=("kind",))
def decode_block(kind: str, type5, scramb_init) -> BlockResult:
    """Decode one CRC16-protected block kind: SB1/SB2/NDB/SCH_HU/SCH_F.

    SB1 always uses the predefined BSCH scrambling
    (tetra_lower_mac.c:178-186); pass scramb_init for the others.
    """
    if kind == "SB1":
        scramb_init = jnp.uint32(C.SCRAMB_INIT)
    return _decode_fec(kind, type5, scramb_init)


@functools.partial(jax.jit, static_argnames=("reference_mode",))
def decode_bbk(type5, scramb_init, reference_mode: bool = True):
    """AACH broadcast block: descramble + RM(30,14).

    reference_mode=True mirrors tetra_lower_mac.c:268-271 (straight
    copy-through of the systematic bits, crc_ok always true); False adds
    real parity checking + single-bit correction.
    """
    type4 = scramble.scramb_bits(scramb_init, type5)
    if reference_mode:
        info = type4[..., :14]
        ok = jnp.ones(type4.shape[:-1], dtype=bool)
    else:
        info, ok = rm3014.decode(type4, correct=True)
    return BlockResult(info, ok, type4)


@jax.jit
def decode_sync_burst(bursts, scramb_init):
    """Decode batched sync bursts [..., 510] into all three blocks.

    Returns dict of BlockResults keyed SB1/BBK/SB2, mirroring the three
    tp_sap_udata_ind calls in tetra_burst.c:346-352.
    """
    sb1_t5, bbk_t5, sb2_t5 = burst_mod.split_sync_burst(bursts)
    return {
        "SB1": _decode_fec("SB1", sb1_t5, jnp.uint32(C.SCRAMB_INIT)),
        "BBK": decode_bbk(bbk_t5, scramb_init),
        "SB2": _decode_fec("SB2", sb2_t5, scramb_init),
    }


@jax.jit
def decode_ndb_burst(bursts, scramb_init):
    """Normal burst with two half-slot blocks (train seq p / NORM_2),
    mirroring tetra_burst.c:354-361."""
    bbk_t5, blk1_t5, blk2_t5 = burst_mod.split_norm_burst(bursts)
    return {
        "BBK": decode_bbk(bbk_t5, scramb_init),
        "NDB1": _decode_fec("NDB", blk1_t5, scramb_init),
        "NDB2": _decode_fec("NDB", blk2_t5, scramb_init),
    }


@jax.jit
def decode_schf_burst(bursts, scramb_init):
    """Normal burst carrying one full-slot SCH/F block (train seq n /
    NORM_1), mirroring tetra_burst.c:362-372."""
    bbk_t5, blk1_t5, blk2_t5 = burst_mod.split_norm_burst(bursts)
    schf_t5 = jnp.concatenate([blk1_t5, blk2_t5], axis=-1)
    return {
        "BBK": decode_bbk(bbk_t5, scramb_init),
        "SCH_F": _decode_fec("SCH_F", schf_t5, scramb_init),
    }


def sb1_sync_fields(type1):
    """Extract SYNC PDU fields from SB1 type-1 bits [..., 60].

    Field offsets from tetra_lower_mac.c:283-310. Returns a dict of
    integer arrays (batched).
    """
    def u(lo, n):
        b = type1[..., lo:lo + n].astype(jnp.int32)
        w = (1 << jnp.arange(n - 1, -1, -1, dtype=jnp.int32))
        return jnp.sum(b * w, axis=-1)

    cc = u(4, 6)
    mcc = u(31, 10)
    mnc = u(41, 14)
    return {
        "system_code": u(0, 4),
        "colour_code": cc,
        "tn": u(10, 2) + 1,
        "fn": u(12, 5),
        "mn": u(17, 6),
        "sharing_mode": u(23, 2),
        "ts_reserved": u(25, 3),
        "mcc": mcc,
        "mnc": mnc,
        # cell scrambling code for subsequent blocks (tetra_lower_mac.c:303)
        "scramb_init": (((mcc.astype(jnp.uint32) << 20)
                         | (mnc.astype(jnp.uint32) << 6)
                         | cc.astype(jnp.uint32)) << 2) | C.SCRAMB_INIT,
    }
