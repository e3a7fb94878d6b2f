"""Single-fetch fused multi-carrier chunk pipeline (native control plane).

Reference behaviour: the whole per-chunk receiver loop of
src/tetra-rx.c:82-95 — burst sync, TDMA clock, lower-MAC FEC, upper-MAC
walk — over N carriers at once.

Design: every host<->device transfer and every dispatch is a fixed
cost paid per chunk, so this module collapses one ingest chunk into:

  h2d:    ONE packed-bit buffer [B, Lc/8] (8x smaller than ubits)
  device: ONE fused program — sync scan (phy.sync_vec) -> GLOBAL slot
          compaction (one argsort across carriers x steps; emitted
          slots in carrier-major order fill a fixed row budget) -> SB1
          pre-decode -> scrambling-code forward-fill (carrier-segmented
          associative scan, the device twin of the host fill in
          rx.decode_slots_multi) -> kind-compacted FEC (lmac.fused) ->
          per-kind section packing -> 8:1 bit packing -> ONE int8
          result bundle. The sync carry, scrambling codes and the ring
          tail stay device-resident between chunks, so chunk k+1 can be
          DISPATCHED before chunk k's bundle is fetched (one-deep
          pipelining).
  d2h:    ONE fetch of [G*40 + B*32] bytes, where the global row budget
          G ~= B * (chunk bits / 510 + slack) is much tighter than the
          per-carrier worst case B*maxs (relock backlog drains are rare
          and never synchronized across all carriers); per-kind section
          packing cuts each row from 53 to 40 bytes (the canonical
          406-bit row pads SYNC/NDB payloads to SCH/F width; packing
          sections contiguously needs only 288 bits). If a chunk DOES
          emit more slots than G (detected from the fetched per-carrier
          counts), `collect` transparently re-runs it from the saved
          inputs with the provably sufficient B*maxs budget.
  host:   numpy-vectorised record assembly (no per-slot Python), then
          ONE C++ walk (native/umac_exec.cpp::tetra_umac_walk2) that
          also owns the TDMA clock and SYNC side effects
          (tetra_burst_sync.c:113, tetra_lower_mac.c:283-310).

Decisions are bit-identical to the MultiSync + decode_slots_multi +
Python-bookkeeping path (tests/test_fastpath.py differential).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tetra_tpu import constants as C
from tetra_tpu.phy.sync_vec import sync_scan
from tetra_tpu.phy.sync import FEED_BITS, RING_BITS
from tetra_tpu.phy.burst import split_norm_burst
from tetra_tpu.lmac import pipeline
from tetra_tpu.lmac.fused import decode_slots_fused
from tetra_tpu.ops import scramble
from tetra_tpu.rx import _pack_selected, _PACK_BITS

__all__ = ["FastChunkPipeline", "fused_chunk", "fused_chunk_iq",
           "max_slots", "ROW_BYTES", "RING_PAD"]

ROW_BYTES = 40            # 36 packed section bytes + flags+delta+car16
_SEC_BYTES = 36           # ceil(282 / 8): worst-kind section total is
                          # SCH_F 268 + BBK 14 (vs 406 canonical)
SIDE_I32 = 8              # n_slots tail st bs nb nfs si scramb
RING_PAD = RING_BITS + 512   # device-resident tail: ring depth + slack
G_SLACK = 3               # per-carrier row-budget slack over chunk/510


def max_slots(steps: int, feed: int) -> int:
    """Static bound on slots one carrier can emit in `steps` quanta:
    each step processes at most one slot, and a slot consumes 510 bits
    of a buffer that holds at most RING_BITS and gains feed/step."""
    return int(min(steps, (RING_BITS + steps * feed) // C.BITS_PER_TS + 1))


def _fused_chunk_body(ring, chunk, end_rel, rebase, st0, bs0, nb0, nfs0,
                      fed_rel, scr0, steps: int, feed: int, g_rows: int,
                      car_offset=0, soft: bool = False, tol: int = 0):
    """One ingest chunk, fully fused on device (trace-level body shared
    by the packed-bits and IQ-front-end entry points).

    ring [B, RING_PAD] int8: last RING_PAD stream bits (device carry).
    chunk [B, lc_pad] int8: this chunk's new unpacked bits.
    end_rel: window-relative position of the true stream end.
    rebase: window base delta since the carry was written; subtracted
    from the carried rel positions (bs0, nfs0).
    st0..: sync carry (device). fed_rel: scan position rel THIS window.
    scr0 [B] uint32: per-carrier cell scrambling code carry.
    g_rows: global row budget G — emitted slots across ALL carriers,
    carrier-major; overflow is detected host-side from the per-carrier
    counts and re-run with the sufficient budget (see FastChunkPipeline).

    soft=True: ring/chunk carry int8 SOFT reliabilities (positive =
    bit 0, dqpsk.demodulate_soft_ri) instead of hard bits. Hard
    decisions for the sync scan / SB1 pre-decode / t4 payloads derive
    in-program as (soft < 0); the FEC decode gathers the soft window
    byte-granularly and runs the soft Viterbi (decode_slots_fused
    soft_input) — ~2 dB over hard slicing on noisy captures. tol:
    training-sequence bit-error tolerance for the scan (soft mode
    passes 2 so ~1e-2 hard BER does not break lock maintenance).

    Returns (bundle [G*ROW_BYTES + B*32] int8, new_ring, carry...,
    t4_full [G, 432] int8, t4_b2 [G, 216] int8).
    """
    B = ring.shape[0]
    G = g_rows
    win = jnp.concatenate([ring, chunk.astype(jnp.int8)], axis=1)
    bits = (win < 0).astype(jnp.int8) if soft else win
    L = bits.shape[1]

    with jax.named_scope("sync_scan"):
        (st, bs, nb, nfs, si, _), out = sync_scan(
            bits, st0, bs0 - rebase, nb0, nfs0 - rebase, st0 * 0,
            fed_rel, steps, feed, tol=tol)

    with jax.named_scope("compaction"):
        # ---- GLOBAL slot compaction: ONE argsort over carriers x steps.
        # Emitted slots get unique carrier-major keys c*steps + t, holes get
        # +inf; the first G sorted rows are exactly the emitted slots in the
        # order the per-carrier walk consumes them (valid rows form a
        # prefix). Row capacity is shared across carriers, so the budget
        # tracks the MEAN emit rate (chunk bits / 510) instead of the
        # per-carrier relock-backlog worst case.
        emitT = out["emit"].T.astype(bool)                      # [B, steps]
        burstT = out["burst"].T.astype(jnp.int32)
        n_slots = emitT.sum(axis=1, dtype=jnp.int32)
        big = jnp.int32(B * steps)
        keys = jnp.where(emitT,
                         jax.lax.broadcasted_iota(jnp.int32, (B, steps), 0)
                         * steps
                         + jax.lax.broadcasted_iota(jnp.int32, (B, steps), 1),
                         big).reshape(B * steps)
        gorder = jnp.argsort(keys)[:G]                          # [G]
        gvalid = jnp.take(keys, gorder) < big
        gcar = jnp.where(gvalid, gorder // steps, 0)
        kind = jnp.where(gvalid, jnp.take(out["col"].T.reshape(-1), gorder), 0)
        soff = jnp.where(gvalid,
                         jnp.take(out["slot"].T.reshape(-1), gorder), 0)

        # TDMA burst deltas: bursts (incl. own) since the previous emitted
        # slot; tail = bursts after the last one (tetra_burst_sync.c:113).
        # bc is nondecreasing, so "bc at the previous emitted step" is the
        # exclusive running max of the emit-masked cumsum.
        bc = jnp.cumsum(burstT, axis=1)
        prev = lax.associative_scan(jnp.maximum,
                                    jnp.where(emitT, bc, 0), axis=1)
        prev = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), prev[:, :-1]], axis=1)
        delta_step = jnp.where(emitT, bc - prev, 0)             # [B, steps]
        tail = bc[:, -1] - delta_step.sum(axis=1)
        delta = jnp.take(delta_step.reshape(-1), gorder)

        # ---- slot bit gather [G, 510], word-granular: packing the window
        # into uint32 words first makes the gather 32x smaller, and the
        # arbitrary bit offset becomes an elementwise funnel shift.
        w32 = jnp.left_shift(jnp.uint32(1),
                             jnp.arange(31, -1, -1, dtype=jnp.uint32))
        words = (bits.reshape(B, L // 32, 32).astype(jnp.uint32)
                 * w32).sum(-1, dtype=jnp.uint32).reshape(-1)   # [B * L/32]
        nw = C.BITS_PER_TS // 32 + 2                            # 17 words
        wstart = soff >> 5
        sh = (soff & 31).astype(jnp.uint32)[:, None]
        widx = (jnp.clip(wstart[:, None]
                         + jnp.arange(nw, dtype=jnp.int32), 0, L // 32 - 1)
                + gcar[:, None] * (L // 32))
        got = jnp.take(words, widx.reshape(-1)).reshape(G, nw)
        lo = jnp.where(sh == 0, jnp.uint32(0),
                       got[..., 1:] >> (jnp.uint32(32) - sh))
        out_words = (got[..., :nw - 1] << sh) | lo              # [G, 16+]
        shifts32 = jnp.arange(31, -1, -1, dtype=jnp.uint32)
        flat = ((out_words[..., None] >> shifts32) & 1).reshape(
            G, (nw - 1) * 32)[..., :C.BITS_PER_TS].astype(jnp.int8)

        # ---- SB1 pre-decode + scrambling-code forward fill (device twin of
        # rx.decode_slots_multi's host fill; tetra_lower_mac.c:283-310).
        # Rows are carrier-major, so the fill is a SEGMENTED inclusive scan
        # over the G axis with the carrier id as segment key.
        sb1_t5 = flat[:, C.SB_BLK1_OFFSET: C.SB_BLK1_OFFSET + C.SB_BLK1_BITS]
        with jax.named_scope("fec"):
            r1 = pipeline.decode_block("SB1", sb1_t5, jnp.uint32(0))
        t1 = r1.type1

        def field(a, b):
            w = jnp.left_shift(jnp.uint32(1),
                               jnp.arange(b - a - 1, -1, -1, dtype=jnp.uint32))
            return (t1[..., a:b].astype(jnp.uint32) * w).sum(-1)

        newinit = ((((field(31, 41) & 0x3FF) << 20)
                    | ((field(41, 55) & 0x3FFF) << 6)
                    | (field(4, 10) & 0x3F)) << 2) | C.SCRAMB_INIT
        have = gvalid & (kind == 0) & r1.crc_ok

        def ff(a, b):
            av, ah, ac = a
            bv, bh, bc_ = b
            same = ac == bc_
            return (jnp.where(bh, bv, jnp.where(same, av, bv)),
                    bh | (same & ah), bc_)

        segcar = jnp.where(gvalid, gcar, -1)   # invalid rows: own segment
        fv, fh, _ = lax.associative_scan(
            ff, (jnp.where(have, newinit, 0), have, segcar), axis=0)
        inits = jnp.where(fh, fv, jnp.take(scr0, gcar).astype(jnp.uint32))
        # per-carrier final code: the fill value at each carrier's last row
        # (scatter; carriers with no rows this chunk keep their carry)
        segend = gvalid & jnp.concatenate(
            [segcar[1:] != segcar[:-1], jnp.ones(1, bool)])
        scr_final = scr0.at[jnp.where(segend, gcar, B)].set(
            inits, mode="drop")

    # ---- kind-compacted FEC decode + per-kind section packing
    with jax.named_scope("fec"):
        if soft:
            # byte-granular gather of the SOFT window rows [G, 510]: pack
            # 4 int8 values per uint32 word (little-endian), gather ~130
            # words per row, funnel-shift by the byte offset — the same
            # trick as the bit gather above, at 8x the word count
            nw8 = C.BITS_PER_TS // 4 + 2
            words8 = lax.bitcast_convert_type(
                win.reshape(B, L // 4, 4), jnp.uint32).reshape(-1)
            sh8 = ((soff & 3) * 8).astype(jnp.uint32)[:, None]
            widx8 = (jnp.clip((soff >> 2)[:, None]
                              + jnp.arange(nw8, dtype=jnp.int32),
                              0, L // 4 - 1) + gcar[:, None] * (L // 4))
            got8 = jnp.take(words8, widx8.reshape(-1)).reshape(G, nw8)
            hi8 = jnp.where(sh8 == 0, jnp.uint32(0),
                            got8[..., 1:] << (jnp.uint32(32) - sh8))
            out_w8 = (got8[..., :nw8 - 1] >> sh8) | hi8
            flat_soft = lax.bitcast_convert_type(
                out_w8, jnp.int8).reshape(G, (nw8 - 1) * 4)[:, :C.BITS_PER_TS]
            res = decode_slots_fused(flat_soft.astype(jnp.float32), inits,
                                     kind, soft_input=True)
        else:
            res = decode_slots_fused(flat, inits, kind)
        pk = _pack_selected(res, kind)                     # [G, 408] int8

    with jax.named_scope("bundle"):
        _, b1, b2 = split_norm_burst(flat)
        t4_full = scramble.scramb_bits(
            inits, jnp.concatenate([b1, b2], axis=-1))
        t4_b2 = scramble.scramb_bits(inits, b2)

        # canonical row (A 268 | B 124 | BBK 14) pads SYNC/NDB payloads to
        # SCH/F width; laying the LIVE sections contiguously per kind needs
        # only 282 bits, so the fetched bundle shrinks, and `collect`
        # re-expands to the canonical layout in numpy
        A, Bs, K = pk[:, :268], pk[:, 268:392], pk[:, 392:406]
        z = lambda n: jnp.zeros((G, n), pk.dtype)
        lay0 = jnp.concatenate([A[:, :60], Bs, K, z(90)], axis=1)   # SYNC 198
        lay1 = jnp.concatenate([A, K, z(6)], axis=1)                # SCHF 282
        lay2 = jnp.concatenate([A[:, :124], Bs, K, z(26)], axis=1)  # NDB 262
        kk = kind[:, None]
        pay = jnp.where(kk == 0, lay0, jnp.where(kk == 1, lay1, lay2))
        w8 = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
        pay_b = (pay.reshape(-1, _SEC_BYTES, 8).astype(jnp.int32) * w8).sum(-1)
        # one flag byte: kind(2) | okA<<2 | okB<<3 | valid<<4
        flags = (kind.astype(jnp.int32)
                 | (pk[:, _PACK_BITS].astype(jnp.int32) << 2)
                 | (pk[:, _PACK_BITS + 1].astype(jnp.int32) << 3)
                 | (gvalid.astype(jnp.int32) << 4))
        # car_offset globalises carrier ids when the body runs as one shard
        # of a carrier-sharded mesh program (shard-local rows carry GLOBAL
        # carrier numbers so the host walk needs no shard arithmetic)
        gcar_g = gcar + car_offset
        row = jnp.concatenate([
            pay_b.astype(jnp.uint8),
            flags.astype(jnp.uint8)[:, None],
            jnp.clip(delta[:, None], 0, 255).astype(jnp.uint8),
            (gcar_g & 255).astype(jnp.uint8)[:, None],
            (gcar_g >> 8).astype(jnp.uint8)[:, None]], axis=1)    # [G, 40]
        side = jnp.stack([n_slots, tail, st, bs, nb, nfs, si,
                          lax.bitcast_convert_type(scr_final, jnp.int32)],
                         axis=1)
        bundle = jnp.concatenate([
            lax.bitcast_convert_type(row, jnp.int8).reshape(G * ROW_BYTES),
            lax.bitcast_convert_type(side, jnp.int8).reshape(
                B * 4 * SIDE_I32)])

    new_ring = lax.dynamic_slice(
        win, (0, end_rel - RING_PAD), (B, RING_PAD))
    return bundle, new_ring, (st, bs, nb, nfs, scr_final), t4_full, t4_b2


@functools.partial(jax.jit,
                   static_argnames=("steps", "feed", "g_rows", "lc_pad",
                                    "soft", "tol"))
def fused_chunk(ring, packed, end_rel, rebase, st0, bs0, nb0, nfs0, fed_rel,
                scr0, steps: int, feed: int, g_rows: int, lc_pad: int,
                soft: bool = False, tol: int = 0):
    """Packed-bits entry: packed [B, lc_pad//8] uint8 (8 bits/byte,
    MSB-first) -> _fused_chunk_body. On a soft pipeline, hard input
    bits become full-confidence ±1 soft values (erasure-free)."""
    B = ring.shape[0]
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    chunk = ((packed[..., None] >> shifts) & 1).reshape(B, lc_pad)
    if soft:
        chunk = (1 - 2 * chunk.astype(jnp.int32)) * 31
    return _fused_chunk_body(ring, chunk, end_rel, rebase, st0, bs0, nb0,
                             nfs0, fed_rel, scr0, steps, feed, g_rows,
                             soft=soft, tol=tol)


def _iq_to_ri(fmt: str, raw):
    """Wideband ingest format -> planar float (re, im) on device."""
    from tetra_tpu.io import stream
    if fmt == "iq4c":
        return stream.dequantize_iq4c(raw)
    if fmt == "iq4":
        return stream.dequantize_iq4(raw)
    if fmt == "iq8":
        return (raw[0::2].astype(jnp.float32), raw[1::2].astype(jnp.float32))
    if fmt == "f32i":
        # interleaved float32 [I0, Q0, I1, Q1, ...]: the complex64 host
        # buffer reinterpreted as planar re/im
        return raw[0::2], raw[1::2]
    raise ValueError(fmt)


def _iq_frontend(raw, channel_idx, fmt: str, n_chan: int, fs: float,
                 sps: int, soft: bool = False):
    """Wideband raw samples -> per-carrier hard bits (or int8 soft
    reliabilities, soft=True) [C, Lf]: dequantize -> PFB channelize ->
    resample to the demod rate -> DQPSK demod, all one traced program
    (reference per-carrier front end:
    src/demod/osmosdr-tetra_demod_fft.py:64-96, batched)."""
    from tetra_tpu.phy import dqpsk
    from tetra_tpu.phy.pfb import pfb_to_demod_rate_ri
    with jax.named_scope("dequant"):
        re, im = _iq_to_ri(fmt, raw)
    with jax.named_scope("pfb"):
        cr, ci = pfb_to_demod_rate_ri(re, im, channel_idx, n_chan, fs)
    # os=4: the 50k->36k resampler leaves the symbol clock at an
    # arbitrary fractional offset; without sub-sample timing the
    # per-carrier phase pick can land between the sps=2 phases and
    # deterministically flip marginal bits (dqpsk.demodulate_hard_ri)
    with jax.named_scope("demod"):
        if soft:
            return dqpsk.demodulate_soft_ri(cr, ci, sps=sps, os=4)
        return dqpsk.demodulate_hard_ri(cr, ci, sps=sps, os=4)


@functools.partial(jax.jit, static_argnames=(
    "fmt", "n_chan", "fs", "sps", "keep", "steps", "feed", "g_rows",
    "lc_pad", "soft", "tol"))
def fused_chunk_iq(ring, raw, channel_idx, end_rel, rebase, st0, bs0, nb0,
                   nfs0, fed_rel, scr0, fmt: str, n_chan: int, fs: float,
                   sps: int, keep: int, steps: int, feed: int, g_rows: int,
                   lc_pad: int, soft: bool = False, tol: int = 0):
    """Wideband-IQ entry: ONE device program from raw quantized RF
    samples to the fetched result bundle — dequantize + PFB + resample
    + demod + ring splice + sync scan + FEC + packing, so a chunk costs
    one upload, one dispatch and one fetch. soft=True demodulates to
    int8 reliabilities and runs the soft Viterbi (see _fused_chunk_body).

    keep: how many trailing demod bits are NEW stream bits (the leading
    bits re-derive the overlap-save history already consumed)."""
    bits_full = _iq_frontend(raw, channel_idx, fmt, n_chan, fs, sps,
                             soft=soft)
    chunk = bits_full[:, bits_full.shape[1] - keep:]
    if lc_pad != keep:
        chunk = jnp.pad(chunk, ((0, 0), (0, lc_pad - keep)))
    return _fused_chunk_body(ring, chunk, end_rel, rebase, st0, bs0, nb0,
                             nfs0, fed_rel, scr0, steps, feed, g_rows,
                             soft=soft, tol=tol)


@functools.lru_cache(maxsize=None)
def _sharded_fused_chunk(mesh, axis: str, steps: int, feed: int,
                         g_rows: int, lc_pad: int, soft: bool = False,
                         tol: int = 0):
    """shard_map-wrapped fused chunk over the mesh's carrier axis.

    Each shard runs the WHOLE chunk program — sync scan, slot
    compaction, SB1 pre-decode, scrambling fill, FEC, packing — on its
    carrier slice with a LOCAL row budget g_rows/nshards, so the
    compaction argsort never crosses shards and the program contains
    ZERO collectives: carriers are independent receivers (the
    reference's scaling mechanism is one OS process chain per carrier,
    src/receiver1:8 — here one mesh shard per carrier group). The
    fetched bundle is the in-order concatenation of per-shard bundles;
    rows carry global carrier ids via car_offset, so decisions are
    bit-identical to the unsharded program (same per-carrier math,
    same carrier-major row order)."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    ns = int(mesh.shape[axis])
    assert g_rows % ns == 0
    gl = g_rows // ns

    def body(ring, packed, end_rel, rebase, st, bs, nb, nfs, fed_rel, scr):
        B = ring.shape[0]
        car0 = lax.axis_index(axis) * B
        shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
        chunk = ((packed[..., None] >> shifts) & 1).reshape(B, lc_pad)
        if soft:
            chunk = (1 - 2 * chunk.astype(jnp.int32)) * 31
        return _fused_chunk_body(ring, chunk, end_rel, rebase, st, bs,
                                 nb, nfs, fed_rel, scr, steps, feed, gl,
                                 car_offset=car0, soft=soft, tol=tol)

    c, r = P(axis), P()
    # check_vma off: the replicated scan carries inside sync_scan /
    # the Viterbi ACS would otherwise need pcast annotations — every
    # output here is genuinely carrier-varying, nothing is psum'd
    fn = shard_map(body, mesh=mesh,
                   in_specs=(c, c, r, r, c, c, c, c, r, c),
                   out_specs=(c, c, (c, c, c, c, c), c, c),
                   check_vma=False)
    return jax.jit(fn)


@functools.partial(jax.jit, static_argnames=("fmt", "n_chan", "fs", "sps",
                                             "keep", "soft"))
def _iq_frontend_bits(raw, channel_idx, fmt: str, n_chan: int, fs: float,
                      sps: int, keep: int, soft: bool = False):
    """Front end alone (short-chunk absorb path): the trailing `keep`
    new bits (or soft values) as a device array."""
    bits_full = _iq_frontend(raw, channel_idx, fmt, n_chan, fs, sps,
                             soft=soft)
    return bits_full[:, bits_full.shape[1] - keep:]


@dataclass(eq=False)
class ChunkHandle:
    """A dispatched-but-not-fetched chunk.

    Holds a redispatch closure over the dispatch inputs so a budget
    overflow can re-run the chunk with the sufficient B*maxs row budget
    (device arrays stay alive either way; no copies are made). On such
    a re-run the handle is mutated IN PLACE so callers that gather from
    t4_full/t4_b2 by the returned slot_refs see the arrays those refs
    actually index.
    """
    bundle: object        # device [G*ROW_BYTES + B*32] int8
    t4_full: object       # device [G, 432] int8
    t4_b2: object         # device [G, 216] int8
    g_rows: int
    inputs: tuple | None = None   # (dispatch fn(scr, g_rows) -> 5-tuple,
                                  #  scrambling-code carry it ran with)
    maxs: int = 0                 # sufficient per-carrier budget


class FastChunkPipeline:
    """Host driver: device-resident ring + sync/scramble carry, packed
    h2d, deferred single-fetch results. Submit chunks with `submit`,
    fetch+decode with `collect` (callers pipeline the two)."""

    def __init__(self, n_carriers: int, feed: int = FEED_BITS,
                 mesh=None, mesh_axis: str | None = None,
                 soft: bool = False, tol: int | None = None):
        """mesh: optional jax.sharding.Mesh — the chunk program then
        runs carrier-sharded via shard_map (_sharded_fused_chunk), with
        per-shard row budgets and a concatenated bundle; n_carriers
        must divide evenly across the mesh axis. mesh_axis defaults to
        the axis of a 1-D mesh (parallel.mesh.make_mesh names it
        "carrier"); a multi-axis mesh must name it.

        soft=True: the ring carries int8 soft reliabilities, submit_iq
        demodulates soft, and the FEC runs the soft Viterbi (~2 dB on
        noisy RF); tol defaults to 2 in soft mode (training-sequence
        bit-error tolerance — burst.train_seq_match)."""
        self.n = n_carriers
        self.feed = feed
        self.soft = soft
        self.tol = (2 if soft else 0) if tol is None else tol
        self.mesh = mesh
        if mesh is not None and mesh_axis is None:
            if len(mesh.axis_names) != 1:
                raise ValueError("mesh_axis is required for a multi-axis "
                                 f"mesh {mesh.axis_names}")
            mesh_axis = mesh.axis_names[0]
        self.mesh_axis = mesh_axis
        self.shards = int(mesh.shape[mesh_axis]) if mesh is not None else 1
        assert n_carriers % self.shards == 0
        # multi-process mesh (jax.distributed): device state must be
        # created as GLOBAL arrays, chunk payloads stay numpy
        # (uncommitted -> replicated), and results are read per process
        # via collect_local
        self.multiproc = (mesh is not None and any(
            d.process_index != jax.process_index()
            for d in mesh.devices.flat))
        if self.multiproc:
            from jax.sharding import NamedSharding, PartitionSpec as P

            def mk(val):
                sh = NamedSharding(mesh, P(mesh_axis)
                                   if val.ndim else P())
                return jax.make_array_from_callback(
                    val.shape, sh, lambda idx: val[idx])
            self.ring = mk(np.zeros((n_carriers, RING_PAD), np.int8))
            z = lambda v=0: mk(np.full(n_carriers, v, np.int32))
            self.carry = (z(), z(RING_PAD), z(), z(RING_PAD),
                          mk(np.zeros(n_carriers, np.uint32)))
        else:
            self.ring = jnp.zeros((n_carriers, RING_PAD), jnp.int8)
            z = lambda v=0: jnp.full(n_carriers, v, jnp.int32)
            # (state, buf_start, bits_in_buf, next_frame_start, scramb);
            # positions are rel carry_base; abs position 0 == rel
            # RING_PAD
            self.carry = (z(), z(RING_PAD), z(), z(RING_PAD),
                          jnp.zeros(n_carriers, jnp.uint32))
        self.carry_base = -RING_PAD  # window base the carry is rel to
        self.end = 0                 # abs position of the stream end
        self.fed = 0                 # abs scan position (host-tracked)
        self._outstanding: list[ChunkHandle] = []  # dispatch order

    def submit(self, bits) -> ChunkHandle | None:
        """Dispatch one chunk of per-carrier hard bits [B, Lc].

        Accepts either host numpy bits (packed 8:1 on host, ONE h2d
        upload) or a DEVICE array (e.g. straight from the wideband
        demodulator): device bits are packed on device, so the demod ->
        decode handoff never leaves the device."""
        B, Lc = bits.shape
        assert B == self.n
        # pad the chunk to a 32-bit word boundary (the fused program's
        # slot extraction packs the window into uint32 words); the pad
        # sits beyond the true stream end and is never consumed
        lc_pad = -(-Lc // 32) * 32
        if isinstance(bits, jax.Array):
            packed = _pack_bits_device(bits, lc_pad)
        else:
            bits = np.asarray(bits, dtype=np.uint8) & 1
            if lc_pad != Lc:
                bits = np.pad(bits, ((0, 0), (0, lc_pad - Lc)))
            packed = np.packbits(bits, axis=1)

        steps = int((self.end + Lc - self.fed) // self.feed)
        if steps <= 0:
            # window grows within the ring slack; nothing to scan yet
            self.ring = _absorb(self.ring, jnp.asarray(packed),
                                np.int32(Lc), lc_pad, self.soft)
            self.end += Lc
            return None
        # multi-process: numpy stays uncommitted (replicated into the
        # global program); a committed local-device array would clash
        # with the multi-host mesh
        packed_d = packed if self.multiproc else jnp.asarray(packed)
        feed = self.feed
        mesh, axis = self.mesh, self.mesh_axis
        soft, tol = self.soft, self.tol

        def make_fn(ring0, rebase, end_rel, fed_rel, st, bs, nb, nfs):
            def dispatch(scr, g_rows):
                if mesh is not None:
                    fn = _sharded_fused_chunk(mesh, axis, steps, feed,
                                              g_rows, lc_pad, soft, tol)
                    return fn(ring0, packed_d, end_rel, rebase, st, bs,
                              nb, nfs, fed_rel, scr)
                return fused_chunk(ring0, packed_d, end_rel, rebase,
                                   st, bs, nb, nfs, fed_rel, scr,
                                   steps, feed, g_rows, lc_pad,
                                   soft, tol)
            return dispatch
        return self._submit_common(Lc, steps, make_fn)

    def submit_iq(self, raw, fmt: str, keep: int, channel_idx,
                  n_chan: int, fs: float, sps: int = 2) -> ChunkHandle | None:
        """Dispatch one WIDEBAND chunk: raw quantized RF samples in,
        the entire front end (dequantize + PFB channelize + resample +
        DQPSK demod) fused INTO the chunk program — one h2d upload, one
        dispatch, one fetched bundle per chunk; per-carrier bits never
        exist on the host.

        raw: 1-D samples in `fmt` ("iq4c"/"iq4"/"iq8"/"c64"), including
        the caller's overlap-save history refeed. keep: how many
        trailing demod bits are NEW stream bits (the caller's
        hop-alignment accounting, rx_multi._wideband_stream)."""
        lc_pad = -(-keep // 32) * 32
        steps = int((self.end + keep - self.fed) // self.feed)
        raw_d = jnp.asarray(raw)
        if steps <= 0:
            bits = _iq_frontend_bits(raw_d, channel_idx, fmt, n_chan, fs,
                                     sps, keep, self.soft)
            self.ring = _absorb_bits(self.ring, bits)
            self.end += keep
            return None
        feed = self.feed
        soft, tol = self.soft, self.tol

        def make_fn(ring0, rebase, end_rel, fed_rel, st, bs, nb, nfs):
            def dispatch(scr, g_rows):
                return fused_chunk_iq(ring0, raw_d, channel_idx, end_rel,
                                      rebase, st, bs, nb, nfs, fed_rel,
                                      scr, fmt, n_chan, fs, sps, keep,
                                      steps, feed, g_rows, lc_pad,
                                      soft, tol)
            return dispatch
        return self._submit_common(keep, steps, make_fn)

    def _submit_common(self, Lc: int, steps: int, make_fn) -> ChunkHandle:
        """Shared dispatch bookkeeping: window geometry, carry snapshot,
        dispatch, carry advance. make_fn closes over the chunk payload
        and returns dispatch(scr, g_rows) — re-invocable for budget
        overflows (the closure is ALWAYS saved: an overflow in an
        EARLIER chunk corrects the scrambling-code carry, which must be
        re-committed through chunks dispatched with the stale value)."""
        new_base = self.end - RING_PAD   # abs position of window[0]
        end_abs = self.end + Lc
        maxs = max_slots(steps, self.feed)
        # global row budget: mean emit rate + slack, never above the
        # per-carrier worst case (see _fused_chunk_body docstring)
        G = self.n * min(maxs, steps * self.feed // C.BITS_PER_TS + G_SLACK)
        st, bs, nb, nfs, scr = self.carry
        dispatch = make_fn(self.ring, np.int32(new_base - self.carry_base),
                           np.int32(end_abs - new_base),
                           np.int32(self.fed - new_base), st, bs, nb, nfs)
        bundle, ring, carry, t4f, t4b = dispatch(scr, G)
        self.ring = ring
        self.carry = carry
        self.carry_base = new_base
        self.end = end_abs
        self.fed += steps * self.feed
        h = ChunkHandle(bundle, t4f, t4b, G, (dispatch, scr), maxs)
        self._outstanding.append(h)
        return h

    def collect(self, h: ChunkHandle) -> dict:
        """Fetch one chunk's bundle and decode it to numpy arrays:
        {carrier, kind, okA, okB, delta, payload [n, 408], slot_ref,
         n_slots [B], tail [B], scramb [B]}.

        Sharded pipelines fetch the concatenation of per-shard
        bundles; valid rows form a prefix of each shard segment and
        slot_refs index the stacked per-shard t4 arrays."""
        ns = self.shards
        segs = np.asarray(h.bundle).reshape(ns, -1)
        d = self._decode_segments(h.g_rows, segs, np.arange(ns))
        if d is None:
            # budget overflow (synchronized relock backlog): re-run the
            # chunk from its saved inputs with the sufficient B*maxs
            # budget, mutating the handle in place so slot_refs keep
            # indexing the arrays the caller gathers from.  The sync
            # carry and ring are budget-independent (sync_scan /
            # dynamic_slice never see G), but the scrambling-code
            # carry IS filled from the first G compacted rows only, so
            # its corrected value must be re-committed through every
            # chunk already dispatched with the stale carry.
            if h.inputs is None or h.g_rows >= self.n * h.maxs:
                raise RuntimeError("slot compaction overflow (bound bug)")
            self._overflow_rerun(h)
            return self.collect(h)
        if h in self._outstanding:
            self._outstanding.remove(h)
        return d

    def collect_local(self, h: ChunkHandle) -> dict:
        """Multi-process variant of collect: decode ONLY this process's
        addressable shards. The carrier axis is embarrassingly parallel
        (the reference scales by one OS process per carrier,
        src/receiver1:8), so each process walks its own carriers and
        never fetches remote shards. Extra key "side_carrier" maps the
        returned n_slots/tail/scramb entries to global carrier ids."""
        ns = self.shards
        gl = h.g_rows // ns
        seg_len = gl * ROW_BYTES + (self.n // ns) * 4 * SIDE_I32
        shards = sorted(h.bundle.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        ids = np.asarray([(s.index[0].start or 0) // seg_len
                          for s in shards], np.int32)
        segs = np.stack([np.asarray(s.data) for s in shards])
        d = self._decode_segments(h.g_rows, segs, ids)
        if d is None:
            # a re-run would have to be agreed on by EVERY process
            # (divergent dispatch deadlocks the SPMD program) — size
            # G_SLACK for the workload instead
            raise RuntimeError("row-budget overflow on a multi-process "
                               "mesh; raise the budget slack")
        if h in self._outstanding:
            self._outstanding.remove(h)
        return d

    def _decode_segments(self, G: int, segs, ids) -> dict | None:
        """Parse per-shard bundle segments (shard ids `ids`) into the
        collect dict; None signals a row-budget overflow."""
        ns = self.shards
        gl = G // ns
        Bl = self.n // ns
        k = len(ids)
        rows = np.ascontiguousarray(segs[:, :gl * ROW_BYTES]) \
            .view(np.uint8).reshape(k, gl, ROW_BYTES)
        side = np.ascontiguousarray(segs[:, gl * ROW_BYTES:]) \
            .view(np.int32).reshape(k, Bl, SIDE_I32)
        tot_s = side[..., 0].sum(axis=1)                # rows per shard
        if (tot_s > gl).any():
            return None
        n_slots = side[..., 0].reshape(-1)
        side_carrier = (ids[:, None] * Bl
                        + np.arange(Bl, dtype=np.int32)).reshape(-1)
        sel = np.concatenate([rows[i, :tot_s[i]] for i in range(k)])
        slot_ref = np.concatenate(
            [ids[i] * gl + np.arange(tot_s[i], dtype=np.int32)
             for i in range(k)])
        total = len(sel)
        side = side.reshape(-1, SIDE_I32)
        f = sel[:, _SEC_BYTES].astype(np.int32)
        assert (f & 16).all(), "valid rows must form a prefix"
        cars = (sel[:, _SEC_BYTES + 2].astype(np.int32)
                | (sel[:, _SEC_BYTES + 3].astype(np.int32) << 8))
        # re-expand the per-kind packed sections to the canonical
        # [n, 408] row (A 268 | B 124 | BBK 14 | okA | okB) the native
        # walk and the GSMTAP exporter address into
        sec = np.unpackbits(np.ascontiguousarray(sel[:, :_SEC_BYTES]),
                            axis=1)
        kk = f & 3
        payload = np.zeros((total, 408), np.uint8)
        m = kk == 0
        payload[m, 0:60] = sec[m, 0:60]
        payload[m, 268:392] = sec[m, 60:184]
        payload[m, 392:406] = sec[m, 184:198]
        m = kk == 1
        payload[m, 0:268] = sec[m, 0:268]
        payload[m, 392:406] = sec[m, 268:282]
        m = kk == 2
        payload[m, 0:124] = sec[m, 0:124]
        payload[m, 268:392] = sec[m, 124:248]
        payload[m, 392:406] = sec[m, 248:262]
        return {
            "carrier": cars,
            "okA": (f >> 2) & 1,
            "okB": (f >> 3) & 1,
            "kind": kk,
            "delta": sel[:, _SEC_BYTES + 1].astype(np.int32),
            "payload": payload,
            "slot_ref": slot_ref,
            "n_slots": n_slots, "tail": side[:, 1],
            "scramb": side[:, 7].view(np.uint32),
            "side_carrier": side_carrier,
        }

    def _dispatch(self, h: ChunkHandle, g_rows: int,
                  scr_override=None) -> tuple:
        """(Re-)run a chunk from its saved dispatch closure with row
        budget g_rows, mutating the handle in place; returns the carry."""
        fn, scr = h.inputs
        if scr_override is not None:
            scr = scr_override
            h.inputs = (fn, scr)
        bundle, _, carry, t4f, t4b = fn(scr, g_rows)
        h.bundle, h.t4_full, h.t4_b2, h.g_rows = bundle, t4f, t4b, g_rows
        return carry

    def _overflow_rerun(self, h: ChunkHandle) -> None:
        """Re-run an overflowed chunk with the provably sufficient
        budget, then propagate the corrected scrambling-code carry
        through every chunk dispatched after it (one-deep pipelining
        means at most one in practice) and into the pipeline head, so
        no carrier descrambles later chunks with a stale cell code."""
        scr = self._dispatch(h, self.n * h.maxs)[4]
        later = self._outstanding[self._outstanding.index(h) + 1:]
        for h2 in later:
            if np.array_equal(np.asarray(h2.inputs[1]),
                              np.asarray(scr)):
                return          # stale carry was already correct
            scr = self._dispatch(h2, h2.g_rows, scr_override=scr)[4]
        self.carry = self.carry[:4] + (scr,)


@functools.partial(jax.jit, static_argnames=("lc_pad",))
def _pack_bits_device(bits, lc_pad: int):
    """Device-resident [B, Lc] hard bits -> packed [B, lc_pad/8] uint8
    (MSB first), the fused chunk's upload format without the upload."""
    B, Lc = bits.shape
    b = (bits.astype(jnp.uint8) & 1)
    if lc_pad != Lc:
        b = jnp.pad(b, ((0, 0), (0, lc_pad - Lc)))
    w8 = jnp.left_shift(jnp.uint8(1), jnp.arange(7, -1, -1, dtype=jnp.uint8))
    return (b.reshape(B, lc_pad // 8, 8).astype(jnp.int32)
            * w8.astype(jnp.int32)).sum(-1).astype(jnp.uint8)


@jax.jit
def _absorb_bits(ring, bits):
    """Short-chunk path, unpacked-device-bits variant (IQ front end):
    append < one feed quantum into the ring."""
    win = jnp.concatenate([ring, bits.astype(jnp.int8)], axis=1)
    return win[:, win.shape[1] - RING_PAD:]


@functools.partial(jax.jit, static_argnames=("lc_pad", "soft"))
def _absorb(ring, packed, lc, lc_pad: int, soft: bool = False):
    """Short-chunk path: append < one feed quantum into the ring."""
    B = ring.shape[0]
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    chunk = ((packed[..., None] >> shifts) & 1).reshape(B, lc_pad)
    if soft:
        chunk = (1 - 2 * chunk.astype(jnp.int32)) * 31
    win = jnp.concatenate([ring, chunk.astype(jnp.int8)], axis=1)
    return lax.dynamic_slice(win, (0, lc), (B, RING_PAD))
