"""Kind-compacted whole-slot FEC decode: one Viterbi pass per slot.

Reference behaviour: src/lower_mac/tetra_lower_mac.c:143-274 decodes
each burst according to its training-sequence kind (SYNC -> SB1+SB2,
NORM_1 -> SCH/F, NORM_2 -> NDBx2), one block at a time.

Design: lmac.steady.locked_step_bits evaluates EVERY burst
interpretation on every slot (~2.8x redundant Viterbi work) because
branching per slot is not batchable. This module removes the
redundancy without any host round-trip: every interpretation is a
sequence of tail-terminated trellis *segments* whose total length is
<= 288 steps, so all three kinds map onto ONE 288-step segmented
Viterbi pass with per-lane restarts at the static boundaries
{80, 144, 224}:

  SYNC : [SB1 80][SB2 144][pad 64]      resets at 80, 224
  SCH/F: [SCH_F 288]                    no resets
  NDB  : [NDB1 144][NDB2 144]           reset at 144

Descramble/deinterleave/depuncture collapse to one gather through
precomputed per-kind (mother-position -> slot-position, keystream-
position) index maps, so the whole mixed-traffic lower MAC is one
gather + one Viterbi kernel + tiny CRC matmuls per chunk — the same
cost as the single-kind fast path. Bit-exact vs locked_step_bits on
each slot's classified interpretation (tests/test_fused.py).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tetra_tpu import constants as C
from tetra_tpu.ops import scramble, interleave, rcpc, viterbi, crc
from tetra_tpu.lmac.pipeline import BlockResult

__all__ = ["decode_slots_fused", "decode_segmented", "BOUNDARIES"]

N_SYM = 288                   # unified trellis length (= SCH/F)
N_MOTHER = N_SYM * 4
BOUNDARIES = (80, 144, 224)   # union of per-kind segment starts
# CRC16-checked bit ranges of the decoded output (incl. the 16 CRC
# bits): SB1, SB2, SCH/F, NDB1, NDB2 — the kinds' crc_ok flags
CRC_SEGS = ((0, 76), (80, 140), (0, 284), (0, 140), (144, 140))
_KS_CELL = 432                # cell keystream prefix needed by any kind
_KS_FIXED_OFF = _KS_CELL      # BSCH keystream region in the ks vector
_KS_PAD = _KS_CELL + 120      # zero pad position
_SLOT_PAD = C.BITS_PER_TS     # zero pad position in the slot vector


@functools.lru_cache(maxsize=1)
def _maps():
    """Per-kind assembly tables (kind axis: 0=SYNC, 1=SCH/F, 2=NDB).

    Per kind, the slot's <=432 transmitted payload bits are pulled by
    two STATIC gathers (slot positions sel_slot, keystream positions
    sel_ks), XORed, sign-mapped, and spread into the 1152-wide unified
    mother buffer by ONE one-hot matmul P[k] (entries 127 at
    (payload index, mother position); exact — one non-zero product per
    output). Pad rows of P are zero, so kind 0's 96 unused inputs and
    all punctured mother positions come out 0 (erasure).

    rmask[k, b]: 1 where kind k's trellis restarts at BOUNDARIES[b]
    bbk_pidx[k, 30]: slot positions of the broadcast block
    """
    L = 432
    sel_slot = np.full((3, L), _SLOT_PAD, np.int32)
    sel_ks = np.full((3, L), _KS_PAD, np.int32)
    P = np.zeros((3, L, N_MOTHER), np.float32)

    def fill(kind, l_off, m_off, n345, ia, slot_off, ks_off):
        punct = rcpc.puncture_indices("2_3", n345)
        _, deint = interleave.interleave_indices(n345, ia)
        for j in range(n345):
            x = int(deint[j])
            l = l_off + j
            sel_slot[kind, l] = (slot_off(x) if callable(slot_off)
                                 else slot_off + x)
            sel_ks[kind, l] = ks_off + x
            P[kind, l, m_off + int(punct[j])] = 127.0

    # SYNC: SB1 (fixed BSCH scrambling) then SB2 (cell scrambling)
    fill(0, 0, 0, 120, 11, C.SB_BLK1_OFFSET, _KS_FIXED_OFF)
    fill(0, 120, 320, 216, 101, C.SB_BLK2_OFFSET, 0)
    # SCH/F: blk1||blk2 interleaved as one 432-bit block
    fill(1, 0, 0, 432, 103,
         lambda x: C.NDB_BLK1_OFFSET + x if x < 216
         else C.NDB_BLK2_OFFSET + (x - 216), 0)
    # NDB: two independent 216-bit blocks, each a fresh keystream
    fill(2, 0, 0, 216, 101, C.NDB_BLK1_OFFSET, 0)
    fill(2, 216, 576, 216, 101, C.NDB_BLK2_OFFSET, 0)

    rmask = np.array([[1, 0, 1],     # SYNC: SB2 @80, pad @224
                      [0, 0, 0],     # SCH/F
                      [0, 1, 0]],    # NDB: NDB2 @144
                     np.float32)
    bbk = np.zeros((3, 30), np.int32)
    bbk[0] = C.SB_BBK_OFFSET + np.arange(30)
    bbk[1] = bbk[2] = np.concatenate([
        C.NDB_BBK1_OFFSET + np.arange(C.NDB_BBK1_BITS),
        C.NDB_BBK2_OFFSET + np.arange(C.NDB_BBK2_BITS)])
    ks_fixed = scramble.keystream_np(C.SCRAMB_INIT, 120).astype(np.int8)
    return sel_slot, sel_ks, P, rmask, bbk, ks_fixed


_SLOT_W = 512                 # slot vector padded to a lane-tile multiple


@functools.lru_cache(maxsize=1)
def _maps_planes():
    """Gather-free assembly tables: the slot-position gather sel_slot is
    COMPOSED into the spread matrix, so the per-slot work is pure
    elementwise XOR/select plus one matmul.

    P2[k, p, m]: the one-hot spread from slot position p (not payload
    index l) straight to unified mother position m, for kind k. Rows
    for non-payload positions (training/pad/BBK) are zero.

    The keystream arrangement is done per CARRIER (far fewer rows than
    slots) and broadcast, so no per-slot gather remains.
    """
    sel_slot, sel_ks, P, rmask, bbk, ks_fixed = _maps()
    P2 = np.zeros((3, _SLOT_W, N_MOTHER), np.float32)
    for k in range(3):
        for l in range(432):
            p = int(sel_slot[k, l])
            if p < C.BITS_PER_TS:
                P2[k, p] = P[k, l]
    return P2


def decode_segmented(soft, rmask):
    """XLA scan reference of the unified 288-step segmented decode."""
    return viterbi.decode_segmented(soft, rmask, N_SYM, BOUNDARIES)


def assemble_soft(slots, inits, kinds, soft_input: bool = False):
    """Kind-masked FEC assembly: slots [..., 510] (+ broadcastable
    scrambling codes + kinds) -> (soft [N, 1152] unified mother buffer,
    rm [N, 3] restart mask, ks_cell).

    GATHER-FREE per slot: the descramble is an XOR against per-kind
    keystream PLANES indexed by slot position (built gather+scatter on
    the un-broadcast carrier shape, broadcast into the XOR), and the
    slot-position -> mother-position gather plus depuncture/
    deinterleave spread is ONE one-hot matmul P2 (see _maps_planes);
    the three kinds' sign planes are concatenated with inactive kinds
    zeroed by the per-slot kind mask, one [N, 3*512] x [3*512, 1152]
    product. Every output is a single product of integers (±1/0 or a
    soft value times 127), so the float32 contraction at HIGHEST
    precision is exact.
    """
    batch = slots.shape[:-1]
    N = int(np.prod(batch)) if batch else 1
    in_dtype = jnp.float32 if soft_input else jnp.int8
    slots_b = slots.astype(in_dtype)
    inits_b = jnp.asarray(inits, jnp.uint32)   # broadcastable to batch
    kinds_b = jnp.broadcast_to(kinds, batch)
    k = jnp.clip(kinds_b, 0, 2)

    sel_slot, sel_ks, P, rmask_t, bbk_pidx, ks_fixed = _maps()
    P2 = _maps_planes()
    ks_cell = scramble.keystream(inits_b, _KS_CELL)   # [inits_shape, 432]
    ksv = jnp.concatenate([
        ks_cell,
        jnp.broadcast_to(jnp.asarray(ks_fixed), ks_cell.shape[:-1] + (120,)),
        jnp.zeros(ks_cell.shape[:-1] + (1,), jnp.int8)], axis=-1)
    src = jnp.pad(slots_b, [(0, 0)] * len(batch)
                  + [(0, _SLOT_W - C.BITS_PER_TS)])

    parts = []
    for kk in range(3):
        # kind-k keystream ARRANGED BY SLOT POSITION, built on the
        # un-broadcast carrier shape (gather+scatter over ~C rows) and
        # broadcast into the per-slot XOR — the per-slot path is then
        # gather-free (the slot-position gather lives in P2's rows)
        plane = jnp.zeros(ksv.shape[:-1] + (_SLOT_W,), jnp.int8).at[
            ..., jnp.asarray(sel_slot[kk])].set(
            jnp.take(ksv, jnp.asarray(sel_ks[kk]), axis=-1))
        mask = (k == kk)[..., None]
        if soft_input:
            # descramble = sign flip; amplitudes carried through
            sgn = jnp.where(mask, src * (1 - 2 * plane.astype(jnp.float32)),
                            0.0)
        else:
            sgn = jnp.where(mask, 1 - 2 * (src ^ plane).astype(jnp.int8),
                            0).astype(jnp.float32)
        parts.append(jnp.broadcast_to(sgn, batch + sgn.shape[-1:]))
    rm = jnp.take(jnp.asarray(rmask_t), k, axis=0).reshape(N, 3)
    x = jnp.concatenate(parts, axis=-1).reshape(N, -1)
    soft = jnp.dot(x, jnp.asarray(np.concatenate(P2, axis=0)),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return soft, rm, ks_cell


@functools.partial(jax.jit, static_argnames=("soft_input",))
def decode_slots_fused(slots, inits, kinds, soft_input: bool = False):
    """Mixed-kind batched lower MAC: slots [..., 510] + per-slot
    scrambling codes [...] (any shape broadcastable to the slot batch —
    normally per-carrier [C, 1]) + classified kinds [...] (0 SYNC /
    1 SCH/F / 2 NDB / -1 none, from steady.verify_train_seq) ->
    decoded blocks.

    Returns the locked_step_bits result structure (sb1/sb2/bbk/schf/
    ndb1/ndb2 BlockResults + kinds + crc_ok) with ONE Viterbi pass per
    slot; each kind's fields are only meaningful on slots OF that kind
    (other lanes hold whatever the unified trellis produced there).

    soft_input=True takes per-bit soft reliabilities (positive = bit 0,
    dqpsk.demodulate_soft_slotwise_ri) instead of hard bits; descramble
    becomes a sign flip and the (linear) assembly matmul carries the
    amplitudes into the soft Viterbi — ~2 dB over hard slicing.
    """
    batch = slots.shape[:-1]
    N = int(np.prod(batch)) if batch else 1
    in_dtype = jnp.float32 if soft_input else jnp.int8
    slots_f = slots.reshape(N, C.BITS_PER_TS).astype(in_dtype)
    kinds_f = jnp.broadcast_to(kinds, batch).reshape(N)
    k = jnp.clip(kinds_f, 0, 2)
    _, _, _, _, bbk_pidx, _ = _maps()

    soft, rm, ks_cell = assemble_soft(slots, inits, kinds,
                                      soft_input=soft_input)
    bits = viterbi.decode_fast(soft, N_SYM, rmask=rm,
                               boundaries=BOUNDARIES)          # [N, 288]
    oks = [crc.crc16_check(bits[:, off:off + ln]) for off, ln in CRC_SEGS]
    ks30 = jnp.broadcast_to(
        ks_cell[..., :30], batch + (30,)).reshape(N, 30)

    def block(t2, n1, ok):
        return BlockResult(t2[..., :n1].reshape(*batch, n1),
                           ok.reshape(batch), t2.reshape(*batch, t2.shape[-1]))

    sb1 = block(bits[:, :80], 60, oks[0])
    sb2 = block(bits[:, 80:224], 124, oks[1])
    schf = block(bits, 268, oks[2])
    ndb1 = block(bits[:, :144], 124, oks[3])
    ndb2 = block(bits[:, 144:288], 124, oks[4])

    # broadcast block: kind-selected position, fresh cell keystream,
    # reference copy-through semantics (tetra_lower_mac.c:268-271);
    # BBK has no FEC, so soft inputs are hard-sliced here
    slots_h = ((slots_f < 0).astype(jnp.int8) if soft_input
               else slots_f)
    bbk_sync = jnp.take(slots_h, jnp.asarray(bbk_pidx[0]), axis=-1)
    bbk_norm = jnp.take(slots_h, jnp.asarray(bbk_pidx[1]), axis=-1)
    bbk_t4 = jnp.where((k == 0)[:, None], bbk_sync, bbk_norm) ^ ks30
    bbk = BlockResult(bbk_t4[:, :14].reshape(*batch, 14),
                      jnp.ones(batch, bool), bbk_t4.reshape(*batch, 30))

    crc_ok = jnp.where(
        kinds == 0, sb1.crc_ok & sb2.crc_ok,
        jnp.where(kinds == 1, schf.crc_ok,
                  jnp.where(kinds == 2, ndb1.crc_ok & ndb2.crc_ok, False)))
    return {"kinds": kinds, "crc_ok": crc_ok, "sb1": sb1, "sb2": sb2,
            "schf": schf, "ndb1": ndb1, "ndb2": ndb2, "bbk": bbk}
