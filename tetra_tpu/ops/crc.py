"""CRC16-CCITT (bit-granular) and LLC FCS-32 as GF(2) affine maps.

Reference behaviour: src/lower_mac/crc_simple.c:46-106 (CRC16, init
0xFFFF, poly 0x1021, MSB-first over unpacked bits; check constant
0x1D0F) and src/tetra_llc_pdu.c:105-126 (FCS-32, poly 0x04C11DB7, init
0xFFFFFFFF with a short-frame left shift, final complement).

Design: a CRC over a fixed-length bit vector is affine over GF(2):
crc(x) = x @ M_L  xor  C_L. We precompute (M, C) per length once on
host; the device-side check over a batch of blocks is then a single
small matmul — no bit-serial loop, and it fuses with the rest of the
decode pipeline.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from tetra_tpu.constants import CRC16_POLY, CRC16_INIT, TETRA_CRC_OK, FCS32_POLY
from tetra_tpu.utils.bits import gf2_matmul

__all__ = [
    "crc16_matrix", "crc16_bits_np", "crc16_bits", "crc16_check",
    "crc16_value", "fcs32_np", "fcs32_matrix", "fcs32", "TETRA_CRC_OK",
]


def _crc16_step(crc: int, bit: int) -> int:
    crc ^= bit << 15
    crc = ((crc << 1) ^ CRC16_POLY) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def crc16_bits_np(bits) -> int:
    """Host bit-serial CRC16 (oracle-equivalent; for table building/tests)."""
    crc = CRC16_INIT
    for b in np.asarray(bits).reshape(-1):
        crc = _crc16_step(crc, int(b) & 1)
    return crc


@functools.lru_cache(maxsize=32)
def crc16_matrix(length: int) -> tuple[np.ndarray, np.ndarray]:
    """(M[length,16], C[16]) with crc_bits = bits @ M xor C (MSB-first crc bits).

    Built by symbolic LFSR propagation: each CRC register bit is tracked
    as a GF(2) linear function of the message bits plus a constant.
    """
    # rows: 16 register bits (bit 15 = MSB); value: mask over message bits
    # represented as a python-int bitmask, plus constant bit.
    masks = [0] * 16
    consts = [(CRC16_INIT >> (15 - r)) & 1 for r in range(16)]  # row r = crc bit 15-r
    # We track crc bits MSB-first: reg[0] is crc bit15.
    for i in range(length):
        # crc ^= bit << 15  -> reg[0] ^= x_i
        masks[0] ^= 1 << i
        # branch on (crc & 0x8000) == reg[0]; shift left and conditionally xor poly
        top_m, top_c = masks[0], consts[0]
        masks = masks[1:] + [0]
        consts = consts[1:] + [0]
        for r in range(16):
            if (CRC16_POLY >> (15 - r)) & 1:
                masks[r] ^= top_m
                consts[r] ^= top_c
    M = np.zeros((length, 16), dtype=np.uint8)
    for r in range(16):
        for i in range(length):
            if (masks[r] >> i) & 1:
                M[i, r] = 1
    C = np.asarray(consts, dtype=np.uint8)
    return M, C


def crc16_bits(bits):
    """Batched CRC16 over ubits [..., L] -> crc bits [..., 16] (MSB first)."""
    L = bits.shape[-1]
    M, C = crc16_matrix(L)
    return jnp.bitwise_xor(gf2_matmul(bits, jnp.asarray(M)), jnp.asarray(C, dtype=jnp.int8))


def crc16_value(bits):
    """Batched CRC16 -> uint32 value [...]."""
    cb = crc16_bits(bits).astype(jnp.uint32)
    weights = (1 << jnp.arange(15, -1, -1, dtype=jnp.uint32))
    return jnp.sum(cb * weights, axis=-1)


def crc16_check(bits):
    """True where crc16(bits) == TETRA_CRC_OK (reference tetra_lower_mac.c:259)."""
    return crc16_value(bits) == TETRA_CRC_OK


# ---------------- FCS-32 (LLC) ----------------

def fcs32_np(bits) -> int:
    """Host FCS-32 matching reference src/tetra_llc_pdu.c:105-126."""
    bits = np.asarray(bits).reshape(-1)
    n = len(bits)
    crc = 0xFFFFFFFF
    if n < 32:
        crc = (crc << (32 - n)) & 0xFFFFFFFF
    for b in bits:
        bit = (int(b) ^ (crc >> 31)) & 1
        crc = (crc << 1) & 0xFFFFFFFF
        if bit:
            crc ^= FCS32_POLY
    return crc ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=32)
def fcs32_matrix(length: int) -> tuple[np.ndarray, np.ndarray]:
    """(M[length,32], C[32]) with fcs_bits = bits @ M xor C, MSB-first."""
    masks = [0] * 32
    init = 0xFFFFFFFF
    if length < 32:
        init = (init << (32 - length)) & 0xFFFFFFFF
    consts = [(init >> (31 - r)) & 1 for r in range(32)]
    for i in range(length):
        top_m = masks[0] ^ (1 << i)   # bit = x_i xor crc_msb
        top_c = consts[0]
        masks = masks[1:] + [0]
        consts = consts[1:] + [0]
        for r in range(32):
            if (FCS32_POLY >> (31 - r)) & 1:
                masks[r] ^= top_m
                consts[r] ^= top_c
    # final complement
    consts = [c ^ 1 for c in consts]
    M = np.zeros((length, 32), dtype=np.uint8)
    for r in range(32):
        for i in range(length):
            if (masks[r] >> i) & 1:
                M[i, r] = 1
    return M, np.asarray(consts, dtype=np.uint8)


def fcs32(bits):
    """Batched FCS-32 over ubits [..., L] -> fcs bits [..., 32] (MSB first)."""
    L = bits.shape[-1]
    M, C = fcs32_matrix(L)
    return jnp.bitwise_xor(gf2_matmul(bits, jnp.asarray(M)), jnp.asarray(C, dtype=jnp.int8))
