"""Steady-state locked receiver step: IQ -> decoded blocks, one program.

The hunt for initial lock needs a full-stream correlation
(phy.sync / phy.burst.train_seq_match), but once locked the receiver
only needs to (a) demodulate, (b) slice, (c) verify the training
sequence at the slot's two legal offsets (sync@214 / normal@244 —
tetra_burst_sync.c:123,133), and (d) run the FEC pipeline. This module
fuses that entire per-chunk fast path into one jitted tensor program
over [carriers, slots] — the throughput configuration the benchmarks
measure, and the path rx uses between re-acquisitions.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tetra_tpu import constants as C
from tetra_tpu.phy import dqpsk
from tetra_tpu.lmac import pipeline

__all__ = ["verify_train_seq", "classify_train_seq", "locked_step_bits",
           "locked_step_iq", "locked_step_fused"]


def _dot(w, seq):
    """±1 training-window correlation (exact small integers)."""
    return jnp.dot(w, seq, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def classify_train_seq(slots, min_agree: float = 0.75):
    """Noise-tolerant slot classification: nearest training template by
    bit-agreement fraction, -1 below `min_agree`.

    verify_train_seq (exact match, the reference's criterion) drops a
    locked slot on ANY training-bit error — at low SNR that, not the
    FEC, becomes the decode floor. In steady state the slot grid is
    known, so nearest-template classification is sound; acquisition
    (phy.sync) keeps the reference's exact matching.
    """
    y = jnp.asarray((1 - 2 * C.TRAIN_Y.astype(np.int32)).astype(np.float32))
    nseq = jnp.asarray((1 - 2 * C.TRAIN_N.astype(np.int32)).astype(np.float32))
    p = jnp.asarray((1 - 2 * C.TRAIN_P.astype(np.int32)).astype(np.float32))
    # slice the training windows FIRST: casting the full slot tensor to
    # f32 materialises a 4x copy of every slot just to read 60 bits
    w_sync = 1.0 - 2.0 * slots[
        ..., C.SYNC_TRAIN_OFFSET:C.SYNC_TRAIN_OFFSET + 38].astype(jnp.float32)
    w_norm = 1.0 - 2.0 * slots[
        ..., C.NORM_TRAIN_OFFSET:C.NORM_TRAIN_OFFSET + 22].astype(jnp.float32)
    fr = lambda corr, n: (corr / n + 1.0) * 0.5
    f_sync = fr(_dot(w_sync, y), 38.0)
    f_n = fr(_dot(w_norm, nseq), 22.0)
    f_p = fr(_dot(w_norm, p), 22.0)
    stacked = jnp.stack([f_sync, f_n, f_p], axis=-1)
    kind = jnp.argmax(stacked, axis=-1).astype(jnp.int32)
    best = jnp.max(stacked, axis=-1)
    return jnp.where(best >= min_agree, kind, -1)


def verify_train_seq(slots):
    """Classify aligned slots [..., 510] by their training sequence.

    Returns int32 [...]: 0 = sync (y@214), 1 = SCH/F (n@244),
    2 = NDB (p@244), -1 = no match (lock lost).
    """
    y = jnp.asarray((1 - 2 * C.TRAIN_Y.astype(np.int32)).astype(np.float32))
    nseq = jnp.asarray((1 - 2 * C.TRAIN_N.astype(np.int32)).astype(np.float32))
    p = jnp.asarray((1 - 2 * C.TRAIN_P.astype(np.int32)).astype(np.float32))
    w_sync = 1.0 - 2.0 * slots[
        ..., C.SYNC_TRAIN_OFFSET:C.SYNC_TRAIN_OFFSET + 38].astype(jnp.float32)
    w_norm = 1.0 - 2.0 * slots[
        ..., C.NORM_TRAIN_OFFSET:C.NORM_TRAIN_OFFSET + 22].astype(jnp.float32)
    is_sync = _dot(w_sync, y) == 38.0
    is_n = _dot(w_norm, nseq) == 22.0
    is_p = _dot(w_norm, p) == 22.0
    return jnp.where(is_sync, 0, jnp.where(is_n, 1, jnp.where(is_p, 2, -1)))


@jax.jit
def locked_step_fused(slots, inits):
    """Kind-compacted steady step: classify each slot's training
    sequence, then ONE segmented-Viterbi pass decodes every slot under
    its own interpretation (lmac.fused) — the all-kinds coverage of
    locked_step_bits at the single-interpretation cost, with no host
    round-trip for the kind map."""
    from tetra_tpu.lmac import fused as fused_mod
    kinds = verify_train_seq(slots)
    out = fused_mod.decode_slots_fused(
        slots, inits[(...,) + (None,) * (slots.ndim - 1 - inits.ndim)],
        kinds)
    return out


@functools.partial(jax.jit, static_argnames=("decoders",))
def locked_step_bits(slots, inits, decoders: tuple = ("sync", "schf", "ndb")):
    """Aligned slots [C, S, 510] + per-carrier scrambling codes [C] ->
    decoded blocks + per-slot training classification.

    All configured burst interpretations are evaluated and selected by
    kind (redundant compute instead of divergent control flow, SURVEY.md
    §7.3). `decoders` statically selects which interpretations to run:
    a deployment decoding a traffic-heavy downlink can drop the unused
    ones and reclaim their Viterbi work; decoders=("fused",) instead
    routes through the kind-compacted single-pass path (locked_step_fused)
    which covers all kinds at single-interpretation cost. Slots whose
    classified kind has no configured decoder report crc_ok=False (and
    can be routed to a slow path by the caller).
    """
    if decoders == ("fused",):
        return locked_step_fused(slots, inits)
    kinds = verify_train_seq(slots)
    inits_b = inits[:, None].astype(jnp.uint32)
    out = {"kinds": kinds}
    false = jnp.zeros(kinds.shape, dtype=bool)
    ok_sync = ok_schf = ok_ndb = false
    sync_bbk = norm_bbk = None
    if "sync" in decoders:
        sync = pipeline.decode_sync_burst(slots, inits_b)
        out.update(sb1=sync["SB1"], sb2=sync["SB2"])
        sync_bbk = sync["BBK"]
        ok_sync = sync["SB1"].crc_ok & sync["SB2"].crc_ok
    if "schf" in decoders:
        schf = pipeline.decode_schf_burst(slots, inits_b)
        out["schf"] = schf["SCH_F"]
        norm_bbk = schf["BBK"]
        ok_schf = schf["SCH_F"].crc_ok
    if "ndb" in decoders:
        ndb = pipeline.decode_ndb_burst(slots, inits_b)
        out.update(ndb1=ndb["NDB1"], ndb2=ndb["NDB2"])
        if norm_bbk is None:
            norm_bbk = ndb["BBK"]
        ok_ndb = ndb["NDB1"].crc_ok & ndb["NDB2"].crc_ok
    # BBK position depends on the burst kind (tetra_burst.c:346-372:
    # SB_BBK_OFFSET on sync bursts, NDB_BBK1/2 on normal bursts), so
    # with mixed decoders the broadcast block must be kind-selected
    if sync_bbk is not None and norm_bbk is not None:
        is_sync = (kinds == 0)[..., None]
        out["bbk"] = pipeline.BlockResult(
            jnp.where(is_sync, sync_bbk.type1, norm_bbk.type1),
            jnp.where(kinds == 0, sync_bbk.crc_ok, norm_bbk.crc_ok),
            jnp.where(is_sync, sync_bbk.type2, norm_bbk.type2))
    elif sync_bbk is not None or norm_bbk is not None:
        out["bbk"] = sync_bbk if sync_bbk is not None else norm_bbk
    out["crc_ok"] = jnp.where(
        kinds == 0, ok_sync,
        jnp.where(kinds == 1, ok_schf, jnp.where(kinds == 2, ok_ndb, False)))
    return out


@functools.partial(jax.jit, static_argnames=("phase_bit", "sps", "n_slots", "fast",
                                              "decoders"))
def locked_step_ri(re, im, inits, phase_bit: int = 0, sps: int = 2,
                   n_slots: int | None = None, fast: bool = True,
                   decoders: tuple = ("sync", "schf", "ndb")):
    """Full chain from planar baseband: demod -> slice -> verify -> FEC.

    re/im: [C, T] float32 at sps samples/symbol (planar re/im); slot
    boundaries assumed at bit `phase_bit` (steady-state lock).
    fast=True uses the trig-free hard-decision demod (identical bits to
    the angle+slicer path on clean/locked signals, no atan2);
    fast="slotwise" adds per-slot timing re-pick
    + blind residual-CFO correction for degraded signals (CFO ramps,
    sample-clock drift — dqpsk.demodulate_hard_slotwise_ri);
    fast="eq" additionally fits a per-slot pilot-aided T/2-spaced
    equalizer for multipath channels (phy.equalize).
    """
    if fast in ("slotwise", "soft", "eq"):
        S = n_slots if n_slots is not None else \
            (re.shape[-1] * 2 // sps - phase_bit) // C.BITS_PER_TS
        if fast == "soft":
            # soft reliabilities through the (linear) FEC assembly;
            # classification/upper layers use the hard slices
            from tetra_tpu.lmac import fused as fused_mod
            soft = dqpsk.demodulate_soft_slotwise_ri(re, im, S,
                                                     phase_bit=phase_bit,
                                                     sps=sps)
            hard = (soft <= 0).astype(jnp.int8)
            kinds = classify_train_seq(hard)
            out = fused_mod.decode_slots_fused(
                soft, inits[(...,) + (None,) * (soft.ndim - 1 - inits.ndim)],
                kinds, soft_input=True)
            out["bits"] = hard.reshape(*hard.shape[:-2], S * C.BITS_PER_TS)
            return out
        if fast == "eq":
            from tetra_tpu.phy.equalize import demodulate_hard_eq_slotwise_ri
            slots = demodulate_hard_eq_slotwise_ri(re, im, S,
                                                   phase_bit=phase_bit,
                                                   sps=sps)
        else:
            slots = dqpsk.demodulate_hard_slotwise_ri(re, im, S,
                                                      phase_bit=phase_bit,
                                                      sps=sps)
        out = locked_step_bits(slots, inits, decoders=decoders)
        out["bits"] = slots.reshape(*slots.shape[:-2], S * C.BITS_PER_TS)
        return out
    if fast:
        bits = dqpsk.demodulate_hard_ri(re, im, sps=sps)
    else:
        syms = dqpsk.demodulate_ri(re, im, sps=sps)
        bits = dqpsk.float_to_bits(syms)
    bits = bits[..., phase_bit:]
    S = n_slots if n_slots is not None else bits.shape[-1] // C.BITS_PER_TS
    slots = bits[..., : S * C.BITS_PER_TS].reshape(*bits.shape[:-1], S, C.BITS_PER_TS)
    out = locked_step_bits(slots, inits, decoders=decoders)
    out["bits"] = bits
    return out


def locked_step_iq(iq, inits, phase_bit: int = 0, sps: int = 2,
                   n_slots: int | None = None):
    """Complex-input convenience wrapper over locked_step_ri."""
    iq = jnp.asarray(iq)
    return locked_step_ri(jnp.real(iq).astype(jnp.float32),
                          jnp.imag(iq).astype(jnp.float32), inits,
                          phase_bit=phase_bit, sps=sps, n_slots=n_slots)


def _bucket(n: int) -> int:
    """Next power-of-two bucket (bounds the set of compiled shapes)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def grouped_decode(slots, slot_inits, kinds):
    """Mixed-traffic decode without redundant interpretations.

    Instead of running every burst interpretation on every slot
    (locked_step_bits), classify first, then gather each kind into its
    own padded batch and run only that kind's decoder — reclaiming the
    ~2.8x redundant Viterbi work at the cost of one small host
    round-trip for the kind map. Batch sizes are padded to power-of-two
    buckets so recompiles are bounded.

    slots: host/device array [N, 510]; slot_inits [N] uint32;
    kinds [N] int32 (0 sync / 1 schf / 2 ndb, from verify_train_seq).
    Returns {kind_name: (indices, results_dict)}.
    """
    slots = np.asarray(slots)
    slot_inits = np.asarray(slot_inits, dtype=np.uint32)
    kinds = np.asarray(kinds)
    out = {}
    groups = {"sync": (0, pipeline.decode_sync_burst),
              "schf": (1, pipeline.decode_schf_burst),
              "ndb": (2, pipeline.decode_ndb_burst)}
    for name, (kind_val, fn) in groups.items():
        idx = np.nonzero(kinds == kind_val)[0]
        if len(idx) == 0:
            continue
        b = _bucket(len(idx))
        pad_idx = np.concatenate([idx, np.repeat(idx[-1], b - len(idx))])
        batch = jnp.asarray(slots[pad_idx].astype(np.int8))
        inits = jnp.asarray(slot_inits[pad_idx])
        res = fn(batch, inits)
        trimmed = {k: pipeline.BlockResult(np.asarray(v.type1)[: len(idx)],
                                           np.asarray(v.crc_ok)[: len(idx)],
                                           np.asarray(v.type2)[: len(idx)])
                   for k, v in res.items()}
        out[name] = (idx, trimmed)
    return out
