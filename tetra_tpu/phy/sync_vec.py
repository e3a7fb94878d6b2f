"""Vectorised burst synchroniser: the device-side twin of phy.sync.

Reference behaviour: src/phy/tetra_burst_sync.c stepped 64 bits at a
time (tetra-rx.c:86), as replayed exactly by phy.sync.align_stream.

Design: per-carrier synchroniser state is a small int32 pytree and
each 64-bit feed quantum is one `lax.scan` step of pure `where`-selects
— no data-dependent control flow, so the whole multi-carrier lock state
machine runs on device with host time flat in carrier count
(SURVEY.md §7.1 "per-carrier vectorized state pytree"). The expensive
part — training-sequence search inside the reference's *current buffer
window* — collapses to O(1) per step:

* one matched-filter pass builds the exact-match map (phy.burst);
* a reverse cumulative-min turns it into next-match-at-or-after tables;
* tetra_find_train_seq's polluted 22-bit prefilter (it primes with
  in[0..19] and never shifts in in[20], so matches at window offsets
  0..18 are invisible, and offsets 19/20 are visible only under the
  closed-form conditions below — validated against the bit-level
  register emulation in tests/test_sync_vec.py) reduces to:
      visible(k>=21) = True
      visible(k==20) = bits[q-1] == pat[0]
      visible(k==19) = bits[q-1] == pat[0] and pat[1] == pat[0]
  Invisible candidates are skipped by chasing the next-match table; two
  chases suffice because the training sequences only self-overlap at
  shifts >= 16 (so at most candidates k, k+16, k+32 can precede the
  first certainly-visible offset 21).

Decisions are bit-identical to align_stream (property-tested on
randomised corrupt streams over 64 carriers, tests/test_sync_vec.py).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tetra_tpu import constants as C
from tetra_tpu.phy import burst as burst_mod
from tetra_tpu.phy.sync import (AlignedSlot, SyncEvent, RING_BITS, FEED_BITS,
                                _PRIO, _SEQS, _SEQ_LEN)

__all__ = ["VecSyncCarry", "sync_scan", "MultiSync"]

_BIG = np.int32(1 << 27)
# LOCKED-mask columns (SYNC|NORM_1|NORM_2) in priority order
_COLS = (0, 1, 2)
_MASK = (1 << C.TETRA_TRAIN_SYNC) | (1 << C.TETRA_TRAIN_NORM_1) \
    | (1 << C.TETRA_TRAIN_NORM_2)
# closed-form prefilter constants per column
_PAT0 = tuple(int(_SEQS[c][0]) for c in _COLS)
_PAT1_EQ_PAT0 = tuple(bool(_SEQS[c][1] == _SEQS[c][0]) for c in _COLS)


@dataclass
class VecSyncCarry:
    """Per-carrier synchroniser state, absolute stream positions
    (host-side int64 so indefinitely long streams never wrap)."""
    state: np.ndarray        # [B] 0=UNLOCKED 1=KNOW_FSTART 2=LOCKED
    buf_start: np.ndarray    # [B]
    bits_in_buf: np.ndarray  # [B]
    nfs: np.ndarray          # [B] next_frame_start
    slot_index: np.ndarray   # [B]
    fed: int = 0             # common scan position (same stream length/carrier)

    @classmethod
    def zeros(cls, n: int) -> "VecSyncCarry":
        z = lambda: np.zeros(n, dtype=np.int64)
        return cls(z(), z(), z(), z(), z(), 0)


@functools.partial(jax.jit, static_argnames=("steps", "feed", "tol"))
def sync_scan(bits, state0, buf_start0, nbuf0, nfs0, slot0, fed0,
              steps: int, feed: int = FEED_BITS, tol: int = 0):
    """Run `steps` feed quanta of the reference state machine over
    bits [B, L] (chunk-relative positions, int32).

    tol: training-sequence bit-error tolerance (burst.train_seq_match)
    — 0 replays the reference's exact matcher; degraded-signal modes
    use 2 so lock maintenance survives ~1e-2 hard BER.

    Returns (final carry tuple, per-step outputs dict of [steps, B]):
      burst      processed-slot flag (TDMA clock advances)
      emit       aligned-slot flag
      col        winning column 0/1/2 (-1 when none)
      slot       slot start offset
      found      SYNC acquisition flag
      found_rel  buffer-relative acquisition offset (the reference log)
      bad        bad-offset flag;  bad_rel   its offset inside the slot
      lost       lock-loss flag
    """
    B, L = bits.shape
    idx = jnp.arange(L, dtype=jnp.int32)
    match = burst_mod.train_seq_match(bits, _MASK, tol=tol)  # [B, L, 5]

    nms, viz20s = [], []
    prev = jnp.concatenate(
        [jnp.zeros((B, 1), bits.dtype), bits[:, :-1]], axis=1)
    for ci, c in enumerate(_COLS):
        v = jnp.where(match[..., c], idx, jnp.int32(L))
        nm = lax.cummin(v[:, ::-1], axis=1)[:, ::-1]
        # sentinel column so gathers at q+1 == L are safe
        nms.append(jnp.concatenate(
            [nm, jnp.full((B, 1), L, jnp.int32)], axis=1))
        viz20s.append(prev == _PAT0[ci])

    def gather(arr, pos):
        pos = jnp.clip(pos, 0, L).astype(jnp.int32)
        return jnp.take_along_axis(arr, pos[:, None], axis=1)[:, 0]

    def first_match(ci, a, b):
        """First visible+fitting match of column ci in buffer window
        [a, b), or _BIG. Mirrors phy.sync._find for one column."""
        nm = nms[ci]
        q = gather(nm, a)
        for _ in range(2):  # chase polluted-invisible candidates
            k = q - a
            vis = (k >= 21)
            vis20 = gather(viz20s[ci], q)
            vis = vis | ((k == 20) & vis20)
            if _PAT1_EQ_PAT0[ci]:
                vis = vis | ((k == 19) & vis20)
            q = jnp.where((q < L) & ~vis, gather(nm, q + 1), q)
        fit = q + _SEQ_LEN[ci] <= b
        return jnp.where(fit & (q < L), q, _BIG)

    def step(carry, _):
        state, buf_start, nbuf, nfs, slot_index, fed = carry

        # make_bitbuf_space + append (tetra_burst_sync.c:38-66)
        delta = jnp.maximum(0, feed - (RING_BITS - nbuf))
        nbuf = nbuf + feed - delta
        buf_start = buf_start + delta
        fed = fed + feed

        a = buf_start
        b = buf_start + nbuf

        # UNLOCKED: scan for SYNC once >= 2 slots buffered
        q0 = first_match(0, a, b)
        found = (state == 0) & (nbuf >= 2 * C.BITS_PER_TS) & (q0 < _BIG)
        found_rel = jnp.where(found, q0 - a, 0)
        state_u = jnp.where(found, 1, state)
        nfs_u = jnp.where(found, q0 + 296, nfs)

        # KNOW_FSTART (only pre-existing; a fresh acquisition waits a call)
        kf = (state == 1) & (a + nbuf >= nfs)
        nbuf = jnp.where(kf, nbuf - (nfs - a), nbuf)
        buf_start = jnp.where(kf, nfs, buf_start)
        nfs_k = jnp.where(kf, nfs + C.BITS_PER_TS, nfs_u)
        state_k = jnp.where(kf, 2, state_u)

        # LOCKED: process at most one slot
        lk = ((state == 2) | kf) & (nbuf >= C.BITS_PER_TS)
        slot = buf_start
        blim = buf_start + nbuf
        qs = [first_match(ci, slot, blim) for ci in range(3)]
        keys = [jnp.where(q < _BIG, q * 4 + ci, _BIG * 4)
                for ci, q in enumerate(qs)]
        key = jnp.minimum(jnp.minimum(keys[0], keys[1]), keys[2])
        has = key < _BIG * 4
        qw = key >> 2
        col = jnp.where(has, (key & 3).astype(jnp.int32), -1)
        if tol:
            # tolerant matching multiplies near-matches; position-first
            # scanning would then let a spurious earlier hit shadow the
            # true training sequence and drop the slot as bad_offset.
            # Check the EXPECTED offsets first (SYNC@214 / NORM@244 —
            # where a locked receiver knows the sequence must be) and
            # only fall back to the reference's first-match scan when
            # neither holds. Exact mode (tol=0) keeps the reference
            # scan untouched.
            def at(ci, p):
                mb = match[..., _COLS[ci]]
                return gather(mb, p) & (p + _SEQ_LEN[ci] <= blim)
            e0 = at(0, slot + C.SYNC_TRAIN_OFFSET)
            e1 = at(1, slot + C.NORM_TRAIN_OFFSET)
            e2 = at(2, slot + C.NORM_TRAIN_OFFSET)
            eh = e0 | e1 | e2
            ecol = jnp.where(e0, 0, jnp.where(e1, 1, 2))
            eq = jnp.where(e0, slot + C.SYNC_TRAIN_OFFSET,
                           slot + C.NORM_TRAIN_OFFSET)
            col = jnp.where(eh, ecol, col)
            qw = jnp.where(eh, eq, qw)
            has = has | eh
        rel = qw - slot

        is_sync = lk & (col == 0)
        sync_ok = is_sync & (rel == C.SYNC_TRAIN_OFFSET)
        is_norm = lk & ((col == 1) | (col == 2))
        norm_ok = is_norm & (rel == C.NORM_TRAIN_OFFSET)
        lost = lk & ~has
        bad = (is_sync & ~sync_ok) | (is_norm & ~norm_ok)
        emit = sync_ok | norm_ok

        state_out = jnp.where((is_sync & ~sync_ok) | lost, 0, state_k)
        slot_index = slot_index + lk.astype(jnp.int32)
        adv = jnp.where(lk, C.BITS_PER_TS, 0)
        out = {
            "burst": lk, "emit": emit, "col": col, "slot": slot,
            "found": found, "found_rel": found_rel,
            "found_q": jnp.where(found, q0, 0),
            "bad": bad, "bad_rel": jnp.where(bad, rel, 0), "lost": lost,
        }
        return (state_out, buf_start + adv, nbuf - adv, nfs_k + adv,
                slot_index, fed), out

    carry0 = (state0.astype(jnp.int32), buf_start0.astype(jnp.int32),
              nbuf0.astype(jnp.int32), nfs0.astype(jnp.int32),
              slot0.astype(jnp.int32), jnp.int32(fed0))
    return lax.scan(step, carry0, None, length=steps)


_STATE_NAME = {0: "UNLOCKED", 1: "KNOW_FSTART", 2: "LOCKED"}


class MultiSync:
    """Host wrapper: chunked streaming over [B, L] bit arrays with an
    absolute-position carry, emitting per-carrier AlignedSlot/SyncEvent
    lists identical to phy.sync.align_stream per carrier."""

    def __init__(self, n_carriers: int, feed: int = FEED_BITS):
        self.carry = VecSyncCarry.zeros(n_carriers)
        self.n = n_carriers
        self.feed = feed

    def scan(self, bits, base_offset: int = 0):
        """bits [B, L] covering absolute [base_offset, base_offset+L).
        Only whole feed quanta are consumed (callers keep the tail).
        Returns (slots_per_carrier, events_per_carrier); offsets are
        ABSOLUTE stream positions (unlike align_stream's chunk-relative
        ones), since multi-carrier callers slice a shared ring."""
        cy = self.carry
        bits = np.asarray(bits, dtype=np.uint8)
        B, L = bits.shape
        assert B == self.n
        end_abs = base_offset + L
        steps = int((end_abs - cy.fed) // self.feed)
        slots = [[] for _ in range(B)]
        events = [[] for _ in range(B)]
        if steps <= 0:
            return slots, events
        if cy.buf_start.min() < base_offset or cy.fed < base_offset:
            raise ValueError("carry refers to bits before this chunk")

        rel = lambda x: (x - base_offset).astype(np.int32)
        (st, bs, nb, nfs, si, _fed), out = sync_scan(
            jnp.asarray(bits, jnp.int8),
            jnp.asarray(cy.state.astype(np.int32)),
            jnp.asarray(rel(cy.buf_start)),
            jnp.asarray(cy.bits_in_buf.astype(np.int32)),
            jnp.asarray(np.maximum(rel(cy.nfs), -1)),
            jnp.asarray(cy.slot_index.astype(np.int32) * 0),
            np.int32(cy.fed - base_offset), steps, self.feed)
        # three device->host transfers, not one per array: each fetch
        # is a synchronising round-trip, and this method runs once per
        # ingest chunk
        i8_keys = ("burst", "emit", "found", "bad", "lost", "col")
        i32_keys = ("slot", "found_rel", "found_q", "bad_rel")
        pk8 = np.asarray(jnp.stack([out[k].astype(jnp.int8)
                                    for k in i8_keys]))
        pk32 = np.asarray(jnp.stack([out[k] for k in i32_keys]))
        cyv = np.asarray(jnp.stack([st, bs, nb, nfs, si]))
        out = {k: pk8[i] for i, k in enumerate(i8_keys)}
        out.update({k: pk32[i] for i, k in enumerate(i32_keys)})
        st, bs, nb, nfs, si = cyv

        # rebuild ordered per-carrier event/slot lists (host, numpy masks)
        seq0 = 0  # per-carrier seq restarts per chunk; ordering is per step
        for b in range(B):
            sidx = int(cy.slot_index[b])
            seq = seq0
            for t in np.flatnonzero(out["burst"][:, b] | out["found"][:, b]):
                t = int(t)
                if out["found"][t, b]:
                    seq += 1
                    events[b].append(SyncEvent(
                        "found_sync",
                        int(out["found_q"][t, b]) + base_offset,
                        int(out["found_rel"][t, b]), seq))
                    continue
                sidx += 1
                seq += 1
                burst_seq = seq
                slot_abs = int(out["slot"][t, b]) + base_offset
                events[b].append(SyncEvent("burst", slot_abs, 0, burst_seq))
                if out["emit"][t, b]:
                    slots[b].append(AlignedSlot(
                        slot_abs, _PRIO[int(out["col"][t, b])],
                        sidx, burst_seq))
                elif out["bad"][t, b]:
                    seq += 1
                    events[b].append(SyncEvent("bad_offset", slot_abs,
                                               int(out["bad_rel"][t, b]), seq))
                elif out["lost"][t, b]:
                    seq += 1
                    events[b].append(SyncEvent("lost", slot_abs, 0, seq))

        # persist carry with absolute positions
        cy.state = np.asarray(st, np.int64)
        cy.buf_start = np.asarray(bs, np.int64) + base_offset
        cy.bits_in_buf = np.asarray(nb, np.int64)
        cy.nfs = np.asarray(nfs, np.int64) + base_offset
        cy.slot_index = cy.slot_index + np.asarray(si, np.int64)
        cy.fed += steps * self.feed
        return slots, events

    def min_buf_start(self) -> int:
        return int(self.carry.buf_start.min())
