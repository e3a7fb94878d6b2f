"""Burst construction / field split / training-sequence search.

Reference behaviour: src/phy/tetra_burst.c — continuous-downlink burst
builders (9.4.4.2.5/2.6), field-offset splitters, and the sequential
22-bit-window training-sequence scanner.

Design: burst build/split are static slice/concat maps. The
training-sequence search is a batched matched-filter correlation: slide
each ±1-mapped template over the bit stream with one small matmul per
template length and compare against the exact-match score; argmin over
positions replaces the scan loop.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tetra_tpu import constants as C

__all__ = [
    "sum_up_phase", "calc_phase_adj", "phase_adj_bits",
    "build_sync_c_d_burst", "build_norm_c_d_burst",
    "split_sync_burst", "split_norm_burst", "train_seq_match", "find_train_seq",
]

_TRAIN_SEQS = {
    C.TETRA_TRAIN_NORM_1: C.TRAIN_N,
    C.TETRA_TRAIN_NORM_2: C.TRAIN_P,
    C.TETRA_TRAIN_NORM_3: C.TRAIN_Q,
    C.TETRA_TRAIN_SYNC: C.TRAIN_Y,
    C.TETRA_TRAIN_EXT: C.TRAIN_X,
}
# reference scan priority at equal offset: y, n, p, q, x (tetra_burst.c:305-338)
_PRIORITY = (C.TETRA_TRAIN_SYNC, C.TETRA_TRAIN_NORM_1, C.TETRA_TRAIN_NORM_2,
             C.TETRA_TRAIN_NORM_3, C.TETRA_TRAIN_EXT)


def sum_up_phase(bits: np.ndarray) -> int:
    """Cumulative pi/4 phase of dibit symbols (tetra_burst.c:133-151)."""
    bits = np.asarray(bits).reshape(-1, 2)
    phases = np.array([C.BITS2PHASE[(int(a), int(b))] for a, b in bits])
    return int(phases.sum())


def calc_phase_adj(phase: int) -> int:
    """-(phase mod 8) wrapped to [-3, 3], C-truncation semantics
    (tetra_burst.c:117-128)."""
    adj = -(int(np.fmod(phase, 8)))
    if adj > 3:
        adj -= 8
    elif adj < -3:
        adj += 8
    return adj


def phase_adj_bits(burst: np.ndarray, which: str) -> np.ndarray:
    """Phase-adjustment dibit for range `which` per Table 8.14.

    Deliberate deviation from the reference: tetra_burst.c:162 indexes
    its phase2bits table without the PHASE()+3 offset, which reads out
    of bounds for negative adjustments (undefined behaviour). We emit
    the spec-intended symbol (phase2bits[PHASE(adj)]). No receiver path
    ever reads these bits (burst splitters skip them), so decode parity
    is unaffected.
    """
    n1, n2 = C.PHASE_ADJ_N[which]
    seg = burst[2 * (n1 - 1): 2 * (n1 - 1) + 2 * (1 + n2 - n1)]
    adj = calc_phase_adj(sum_up_phase(seg))
    return np.asarray(C.PHASE2BITS[adj], dtype=np.uint8)


def build_sync_c_d_burst(sb, bb, bkn) -> np.ndarray:
    """9.4.4.2.6 synchronization continuous downlink burst
    (tetra_burst.c:169-216). sb: 120 scrambled sync bits, bb: 30
    scrambled broadcast bits, bkn: 216 scrambled block-2 bits."""
    burst = np.zeros(510, dtype=np.uint8)
    burst[0:12] = C.TRAIN_Q[10:22]
    # bits 12:14 = hc placeholder
    burst[14:94] = C.FREQ_CORR
    burst[94:214] = np.asarray(sb, dtype=np.uint8)
    burst[214:252] = C.TRAIN_Y
    burst[252:282] = np.asarray(bb, dtype=np.uint8)
    burst[282:498] = np.asarray(bkn, dtype=np.uint8)
    # bits 498:500 = hd placeholder
    burst[500:510] = C.TRAIN_Q[0:10]
    burst[12:14] = phase_adj_bits(burst, "HC")
    burst[498:500] = phase_adj_bits(burst, "HD")
    return burst


def build_norm_c_d_burst(bkn1, bb, bkn2, two_log_chan: bool) -> np.ndarray:
    """9.4.4.2.5 normal continuous downlink burst (tetra_burst.c:218-267)."""
    burst = np.zeros(510, dtype=np.uint8)
    burst[0:12] = C.TRAIN_Q[10:22]
    # bits 12:14 = ha placeholder
    burst[14:230] = np.asarray(bkn1, dtype=np.uint8)
    burst[230:244] = np.asarray(bb, dtype=np.uint8)[0:14]
    burst[244:266] = C.TRAIN_P if two_log_chan else C.TRAIN_N
    burst[266:282] = np.asarray(bb, dtype=np.uint8)[14:30]
    burst[282:498] = np.asarray(bkn2, dtype=np.uint8)
    # bits 498:500 = hb placeholder
    burst[500:510] = C.TRAIN_Q[0:10]
    burst[12:14] = phase_adj_bits(burst, "HA")
    burst[498:500] = phase_adj_bits(burst, "HB")
    return burst


def split_sync_burst(burst):
    """SB burst [..., 510] -> (sb1 [...,120], bbk [...,30], sb2 [...,216]),
    matching tetra_burst_rx_cb TETRA_TRAIN_SYNC (tetra_burst.c:346-352)."""
    sb1 = burst[..., C.SB_BLK1_OFFSET: C.SB_BLK1_OFFSET + C.SB_BLK1_BITS]
    bbk = burst[..., C.SB_BBK_OFFSET: C.SB_BBK_OFFSET + C.SB_BBK_BITS]
    sb2 = burst[..., C.SB_BLK2_OFFSET: C.SB_BLK2_OFFSET + C.SB_BLK2_BITS]
    return sb1, bbk, sb2


def split_norm_burst(burst):
    """NDB burst [..., 510] -> (bbk [...,30], blk1 [...,216], blk2 [...,216]),
    matching tetra_burst_rx_cb TETRA_TRAIN_NORM_* (tetra_burst.c:354-372).
    For SCH/F (train seq n) the caller concatenates blk1||blk2."""
    bbk1 = burst[..., C.NDB_BBK1_OFFSET: C.NDB_BBK1_OFFSET + C.NDB_BBK1_BITS]
    bbk2 = burst[..., C.NDB_BBK2_OFFSET: C.NDB_BBK2_OFFSET + C.NDB_BBK2_BITS]
    bbk = jnp.concatenate([bbk1, bbk2], axis=-1)
    blk1 = burst[..., C.NDB_BLK1_OFFSET: C.NDB_BLK1_OFFSET + C.NDB_BLK_BITS]
    blk2 = burst[..., C.NDB_BLK2_OFFSET: C.NDB_BLK2_OFFSET + C.NDB_BLK_BITS]
    return bbk, blk1, blk2


@functools.lru_cache(maxsize=1)
def _templates():
    """±1 templates and lengths for the 5 training sequences."""
    return {tid: (np.asarray(1 - 2 * seq.astype(np.int32), dtype=np.float32), len(seq))
            for tid, seq in _TRAIN_SEQS.items()}


def _correlate_left(x, tmpl):
    """y[..., t] = sum_j x[..., t+j] * tmpl[j] via lax.conv (left-aligned,
    zero-padded past the end) — streams at O(L), no windowed-gather
    materialisation."""
    batch = x.shape[:-1]
    L = x.shape[-1]
    n = len(tmpl)
    # XLA conv is cross-correlation: y[t] = sum_j x[t+j] * kernel[j],
    # exactly the left-aligned correlation we want (no kernel flip)
    kernel = jnp.asarray(np.asarray(tmpl, np.float32)).reshape(1, 1, n)
    out = jax.lax.conv_general_dilated(
        x.reshape(-1, 1, L), kernel, window_strides=(1,),
        padding=[(0, n - 1)], precision=jax.lax.Precision.HIGHEST)
    return out[:, 0, :].reshape(*batch, L)


def train_seq_match(bits, mask: int = 0x1F, tol: int = 0):
    """Match map of the 5 training sequences over ubits [..., L].

    Returns match [..., L, 5]: True where the full sequence for
    priority-rank r (y,n,p,q,x) starts at that bit offset. Positions
    closer than a sequence length to the end never match (same bound as
    the reference's remain_len check, tetra_burst.c:305-312).

    Implemented as a correlation of ±1-mapped bits with each template:
    exact match <=> correlation == template length; each mismatched bit
    lowers the correlation by 2, so `tol` allows up to that many bit
    errors per sequence. tol=0 (default) is the reference's exact
    matcher; degraded-signal modes (fastpath soft) use tol=2 so a
    ~1e-2 hard BER does not break lock maintenance (P[>2 errors in 22
    bits] ~ 1e-3 vs P[>=1] ~ 0.2) — a deliberate enhancement over the
    reference, which loses the slot on any training-sequence bit error.
    """
    x = (1.0 - 2.0 * bits.astype(jnp.float32))
    L = x.shape[-1]
    outs = []
    for rank, tid in enumerate(_PRIORITY):
        tmpl, n = _templates()[tid]
        if not (mask >> tid) & 1:
            outs.append(jnp.zeros(x.shape[:-1] + (L,), dtype=bool))
            continue
        corr = _correlate_left(x, tmpl)
        valid = jnp.arange(L) <= L - n
        outs.append((corr >= float(n - 2 * tol)) & valid)
    return jnp.stack(outs, axis=-1)


def find_train_seq(bits, mask: int = 0x1F):
    """First training-sequence hit: (train_id [...], offset [...], found [...]).

    Matches the reference scanner's semantics (first offset; priority
    y,n,p,q,x at equal offset — tetra_burst.c:269-339) but evaluates all
    offsets in parallel.
    """
    match = train_seq_match(bits, mask)  # [..., L, 5]
    L = match.shape[-2]
    any_pos = jnp.any(match, axis=-1)  # [..., L]
    offset = jnp.argmax(any_pos, axis=-1)  # first True
    found = jnp.any(any_pos, axis=-1)
    at = jnp.take_along_axis(match, offset[..., None, None].repeat(5, -1), axis=-2)[..., 0, :]
    rank = jnp.argmax(at, axis=-1)
    prio = jnp.asarray(np.array(_PRIORITY, dtype=np.int32))
    train_id = prio[rank]
    return train_id, offset.astype(jnp.int32), found
