"""TETRA receiver: bits in -> decoded PDUs out (the `tetra-rx` analogue).

Reference behaviour: src/tetra-rx.c + the per-slot callback chain
(tetra_burst_sync.c -> tetra_burst.c -> tetra_lower_mac.c -> upper MAC).

Design (SURVEY.md §7): the stream is processed in large chunks —
1. one batched training-sequence correlation pass over the whole chunk
   (device) + a cheap host walk for slot alignment (phy.sync),
2. batched FEC decode of all aligned slots, grouped by burst kind
   (device; SB1 first — its decode reveals the cell scrambling code,
   which is forward-filled per slot and fed to the second batch),
3. a host walk in stream order reproducing the reference's per-slot
   upper-MAC processing, logging, GSMTAP export and traffic dumps.

This turns the reference's per-bit sequential pipeline into two device
programs over [slots] batches plus byte-scale host work.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from tetra_tpu import constants as C
from tetra_tpu.tdma import TdmaTime
from tetra_tpu.phy import sync as sync_mod
from tetra_tpu.lmac import pipeline
from tetra_tpu.umac.upper_mac import UpperMac, LogicalChannel, TmvUnitdata
from tetra_tpu.llc.llc import LlcState
from tetra_tpu.crypto.crypto import CryptoState, load_keystore
from tetra_tpu.io.gsmtap import GsmtapSink
from tetra_tpu.utils.bits import bits_to_uint

__all__ = ["TetraReceiver", "is_bsch", "is_bnch"]


def is_bsch(tm: TdmaTime) -> bool:
    """(reference tetra_lower_mac.c:115-120)."""
    return tm.fn == 18 and tm.tn == 4 - ((tm.mn + 1) % 4)


def is_bnch(tm: TdmaTime) -> bool:
    """(reference tetra_lower_mac.c:122-127)."""
    return tm.fn == 18 and tm.tn == 4 - ((tm.mn + 3) % 4)


@dataclass
class RxStats:
    slots: int = 0
    crc_ok: int = 0
    crc_wrong: int = 0
    bursts: int = 0


_PACK_A, _PACK_B, _PACK_BBK = 268, 124, 14
_PACK_BITS = _PACK_A + _PACK_B + _PACK_BBK          # 406 payload columns
_PACK_W = _PACK_BITS + 2                            # + okA, okB flags
PACK_LEN_A = {0: 60, 1: 268, 2: 124}                # type-1 bits in A by kind
PACK_LEN_B = {0: 124, 1: 0, 2: 124}


@jax.jit
def _pack_selected(res, kinds):
    """Kind-select each slot's decoded blocks into ONE [n, _PACK_W]
    int8 row: [A-block type1 (sb1/schf/ndb1, zero-padded to 268) |
    B-block type1 (sb2/-/ndb2, 124) | BBK type1 (14) | okA | okB].
    One device->host fetch replaces ~19 per-block-type fetches, each
    of which would be a synchronising round-trip."""
    kk = kinds[:, None]

    def pad(x, w):
        return jnp.pad(x.astype(jnp.int8), ((0, 0), (0, w - x.shape[-1])))

    t1a = jnp.where(kk == 0, pad(res["sb1"].type1, _PACK_A),
                    jnp.where(kk == 1, res["schf"].type1.astype(jnp.int8),
                              pad(res["ndb1"].type1, _PACK_A)))
    t1b = jnp.where(kk == 0, res["sb2"].type1.astype(jnp.int8),
                    jnp.where(kk == 2, res["ndb2"].type1.astype(jnp.int8), 0))
    okA = jnp.where(kinds == 0, res["sb1"].crc_ok,
                    jnp.where(kinds == 1, res["schf"].crc_ok,
                              res["ndb1"].crc_ok))
    okB = jnp.where(kinds == 0, res["sb2"].crc_ok,
                    jnp.where(kinds == 2, res["ndb2"].crc_ok, False))
    return jnp.concatenate(
        [t1a, t1b, res["bbk"].type1.astype(jnp.int8),
         okA[:, None].astype(jnp.int8), okB[:, None].astype(jnp.int8)],
        axis=-1)


def decode_slots_multi(streams, slots_per, start_inits, packed: bool = False):
    """Cross-carrier batched two-phase FEC decode.

    streams: per-carrier host bit arrays; slots_per: matching lists of
    AlignedSlots (offsets relative to each stream); start_inits: each
    carrier's current cell scrambling code. Phase 1 decodes every SB1
    (fixed BSCH scrambling) in ONE device call; the per-slot scrambling
    code is then forward-filled on host per carrier (the
    tetra_lower_mac.c:283-310 SYNC-side-effect), and phase 2 decodes
    each burst kind in ONE device call across all carriers — device
    work is O(1) programs regardless of carrier count.

    Returns, per carrier, a list of per-slot dicts:
    {"kind": SYNC|SCHF|NDB, <block name>: BlockResult (numpy), "t4":
     descrambled pre-FEC bits for the traffic dump path}.
    """
    from tetra_tpu.ops.scramble import scramb_get_init, scramb_bits
    from tetra_tpu.phy.burst import split_norm_burst

    entries = [(c, j, s) for c, sl in enumerate(slots_per)
               for j, s in enumerate(sl)]
    sync_entries = [e for e in entries
                    if e[2].train_id == C.TETRA_TRAIN_SYNC]

    # ---- phase 1: all SB1 blocks, one device call ----
    if sync_entries:
        bursts = np.stack([streams[c][s.offset:s.offset + 510]
                           for c, _, s in sync_entries])
        sb1_t5 = bursts[:, C.SB_BLK1_OFFSET:C.SB_BLK1_OFFSET + C.SB_BLK1_BITS]
        r = pipeline.decode_block("SB1", jnp.asarray(sb1_t5), jnp.uint32(0))
        sb1_ok, sb1_t1 = np.asarray(r.crc_ok), np.asarray(r.type1)
    sync_pos = {(c, j): n for n, (c, j, _) in enumerate(sync_entries)}

    # ---- host: forward-fill per-slot scrambling codes per carrier ----
    inits = [[0] * len(sl) for sl in slots_per]
    for c, sl in enumerate(slots_per):
        cur = start_inits[c]
        for j, s in enumerate(sl):
            if s.train_id == C.TETRA_TRAIN_SYNC:
                n = sync_pos[(c, j)]
                if bool(sb1_ok[n]):
                    t1 = sb1_t1[n]
                    cur = scramb_get_init(bits_to_uint(t1[31:41]),
                                          bits_to_uint(t1[41:55]),
                                          bits_to_uint(t1[4:10]))
            inits[c][j] = cur

    # ---- phase 2: ONE kind-compacted device call for all slots ----
    # (lmac.fused: a single segmented-Viterbi pass decodes every slot
    # under its own interpretation; batch padded to a pow2 bucket so
    # compiled shapes are bounded)
    out = [[None] * len(sl) for sl in slots_per]
    if not entries:
        if packed:
            return {"packed": np.zeros((0, _PACK_W), np.int8),
                    "entries": [], "kinds": np.zeros(0, np.int32),
                    "t4_full": None, "t4_b2": None, "t4_pos": {}}
        return out
    from tetra_tpu.lmac.fused import decode_slots_fused
    from tetra_tpu.lmac.steady import _bucket
    kind_of = {C.TETRA_TRAIN_SYNC: 0, C.TETRA_TRAIN_NORM_1: 1,
               C.TETRA_TRAIN_NORM_2: 2}
    n = len(entries)
    b = _bucket(n)
    bursts = np.zeros((b, 510), np.int8)
    for m, (c, _, s) in enumerate(entries):
        bursts[m] = streams[c][s.offset:s.offset + 510]
    kinds = np.array([kind_of[s.train_id] for _, _, s in entries]
                     + [0] * (b - n), np.int32)
    ii = np.array([inits[c][j] for c, j, _ in entries]
                  + [0] * (b - n), np.uint32)
    res = decode_slots_fused(jnp.asarray(bursts), jnp.asarray(ii),
                             jnp.asarray(kinds))

    # type-4 payload bits feed the traffic dump (tetra_lower_mac.c:198-241)
    norm_n = [m for m, (_, _, s) in enumerate(entries)
              if s.train_id != C.TETRA_TRAIN_SYNC]
    t4_full = t4_b2 = None
    if norm_n:
        _, b1, b2 = split_norm_burst(jnp.asarray(bursts[norm_n]))
        iin = jnp.asarray(ii[norm_n])
        # SCH/F: one 432-bit block; NDB blk2: its own fresh keystream
        t4_full = scramb_bits(iin, jnp.concatenate([b1, b2], axis=-1))
        t4_b2 = scramb_bits(iin, b2)
    t4_pos = {m: i for i, m in enumerate(norm_n)}

    if packed:
        # the packed contract: one fetched [n, _PACK_W] row per slot,
        # t4 left ON DEVICE (fetched lazily, batched, only for slots
        # the control plane flags as traffic)
        pk = np.asarray(_pack_selected(res, jnp.asarray(kinds)))[:n]
        return {"packed": pk, "entries": entries, "kinds": kinds[:n],
                "t4_full": t4_full, "t4_b2": t4_b2, "t4_pos": t4_pos}

    res_np = {k: (np.asarray(v.type1), np.asarray(v.crc_ok),
                  np.asarray(v.type2))
              for k, v in res.items() if k not in ("kinds", "crc_ok")}
    t4_full = np.asarray(t4_full) if t4_full is not None else None
    t4_b2 = np.asarray(t4_b2) if t4_b2 is not None else None

    field_map = {
        "SYNC": [("SB1", "sb1"), ("BBK", "bbk"), ("SB2", "sb2")],
        "SCHF": [("BBK", "bbk"), ("SCH_F", "schf")],
        "NDB": [("BBK", "bbk"), ("NDB1", "ndb1"), ("NDB2", "ndb2")],
    }
    kname_of = {0: "SYNC", 1: "SCHF", 2: "NDB"}
    for m, (c, j, s) in enumerate(entries):
        kname = kname_of[kinds[m]]
        d = {"kind": kname}
        for out_key, res_key in field_map[kname]:
            t1a, oka, t2a = res_np[res_key]
            d[out_key] = pipeline.BlockResult(t1a[m], oka[m], t2a[m])
        if kname in ("SCHF", "NDB"):
            i4 = t4_pos[m]
            d["t4"] = t4_full[i4] if kname == "SCHF" else t4_b2[i4]
        out[c][j] = d
    return out


class TetraReceiver:
    def __init__(self, keystore_path: str | None = None,
                 dumpdir: str | None = None,
                 gsmtap_host: str | None = None,
                 decode_voice: bool = False,
                 log=print):
        self.log = log
        self.tcs = CryptoState()
        if keystore_path:
            load_keystore(keystore_path, self.tcs.db)
        from tetra_tpu.mle.mle import rx_tl_sdu
        self._tun = None
        self.llc = LlcState(log=self._log_inline,
                            tl_sdu_cb=lambda bits, n: rx_tl_sdu(bits, n, log=self.log),
                            ip_cb=self._ip_out)
        self.gsmtap = GsmtapSink(gsmtap_host) if gsmtap_host else None
        self.umac = UpperMac(self.tcs, self.llc,
                             gsmtap_cb=self._gsmtap_cb if self.gsmtap else None,
                             log=log)
        self.dumpdir = dumpdir
        if dumpdir:
            os.makedirs(dumpdir, exist_ok=True)
        self.decode_voice = decode_voice
        self.time = TdmaTime()
        self.scramb_init = 0         # cell scrambling code (tetra_cell_data)
        self.mcc = self.mnc = self.colour_code = 0
        self.stats = RxStats()
        self._ev_ptr = 0
        # optional TMV-SAP record tap: set to a list to collect one
        # tuple per UNITDATA.ind, mirroring tools/ref_rx.c's REC lines
        # for differential parity testing
        self.tmv_records: list | None = None
        # streaming state: retained bit buffer + resumable sync carry
        # (the analogue of the reference's 4096-bit ring, tetra_burst_sync.h:17)
        self._buf = np.zeros(0, dtype=np.uint8)
        self._buf_base = 0           # absolute stream offset of _buf[0]
        self._sync_carry = sync_mod.SyncCarry()
        self._ring_bits = 4096

    # ---- logging helpers ----

    def _log_inline(self, *args, **kwargs):
        end = kwargs.pop("end", "\n")
        self.log(" ".join(str(a) for a in args) + ("" if end == "" else ""))

    def _trim_buffer(self):
        """Drop consumed bits: the synchroniser's virtual ring buffer
        starts at carry.buf_start and is at most 4096 bits deep
        (tetra_burst_sync.h:17), so everything before it is dead."""
        keep_from = max(self._buf_base, self._sync_carry.buf_start)
        drop = keep_from - self._buf_base
        if drop > 0:
            self._buf = self._buf[drop:]
            self._buf_base = keep_from

    def _ip_out(self, packet: bytes):
        """Reassembled SNDCP IP payload -> tun0, opened lazily on first
        use (reference tetra_llc.c:93-101)."""
        if self._tun is None:
            from tetra_tpu.io.tun import TunDevice
            self._tun = TunDevice("tun0")
        self._tun.write(packet)

    def _gsmtap_cb(self, tup: TmvUnitdata):
        self.gsmtap.send(tup.tdma_time, tup.lchan, tup.tdma_time.tn - 1, tup.bits)

    # ---- block-level processing (the tp_sap_udata_ind analogue) ----

    def _ubits_str(self, bits) -> str:
        return "".join(str(int(b)) for b in bits)

    def _crc_log(self, name: str, res, type1_len: int) -> bool:
        """CRC COMP log lines (reference tetra_lower_mac.c:258-267)."""
        from tetra_tpu.utils import trace
        if trace.enabled(2):
            trace.tap(f"type1_{name}", np.asarray(res.type1),
                      meta={"time": self.time.dump()})
        ok = bool(np.asarray(res.crc_ok))
        # reproduce the numeric value for the log line
        from tetra_tpu.ops.crc import crc16_bits_np
        crc = crc16_bits_np(np.asarray(res.type2)[: type1_len + 16])
        self.log(f"CRC COMP: 0x{crc:04x} {'OK' if ok else 'WRONG'}")
        if ok:
            self.log(f"{name} {self.time.dump()} type1: "
                     f"{self._ubits_str(np.asarray(res.type1))}")
        self.stats.crc_ok += ok
        self.stats.crc_wrong += not ok
        return ok

    def _rx_sb1(self, res):
        """SYNC PDU handling (reference tetra_lower_mac.c:283-310)."""
        type1 = np.asarray(res.type1)
        ok = self._crc_log("SB1", res, 60)
        self.log("TMB-SAP SYNC CC "
                 f"{self._ubits_str(type1[4:10])}(0x{bits_to_uint(type1[4:10]):02x}) "
                 f"TN {self._ubits_str(type1[10:12])}({bits_to_uint(type1[10:12]) + 1}) "
                 f"FN {self._ubits_str(type1[12:17])}({bits_to_uint(type1[12:17]):2d}) "
                 f"MN {self._ubits_str(type1[17:23])}({bits_to_uint(type1[17:23]):2d}) "
                 f"MCC {self._ubits_str(type1[31:41])}({bits_to_uint(type1[31:41])}) "
                 f"MNC {self._ubits_str(type1[41:55])}({bits_to_uint(type1[41:55])})")
        if ok:
            self.colour_code = bits_to_uint(type1[4:10])
            self.time.tn = bits_to_uint(type1[10:12]) + 1
            self.time.fn = bits_to_uint(type1[12:17])
            self.time.mn = bits_to_uint(type1[17:23])
            self.mcc = bits_to_uint(type1[31:41])
            self.mnc = bits_to_uint(type1[41:55])
            from tetra_tpu.ops.scramble import scramb_get_init
            self.scramb_init = scramb_get_init(self.mcc, self.mnc, self.colour_code)
            # crypto state update (tetra_lower_mac.c:311-317)
            self.tcs.cc = self.colour_code
            if self.tcs.mcc != self.mcc or self.tcs.mnc != self.mnc:
                self.tcs.update_current_network(self.mcc, self.mnc)
        return ok

    def _dump_traffic(self, type4: np.ndarray, usage: int | None = None,
                      tsn: int | None = None, ssi: int | None = None,
                      voice_ks=None):
        """Traffic burst dump (reference tetra_lower_mac.c:198-241)."""
        if not self.dumpdir:
            return
        block = np.zeros(690, dtype=np.int16)
        for i in range(6):
            block[115 * i] = 0x6B21 + i
        spans = ((1, 0, 114), (116, 114, 114), (231, 228, 114), (346, 342, 90))
        for dst, src, n in spans:
            seg = type4[src:src + n]
            block[dst:dst + n] = np.where(seg != 0, -127, 127).astype(np.int16)
        if usage is None:
            usage = self.umac.cur_burst_is_traffic
        if tsn is None:
            tsn = self.time.tn - 1
        if ssi is None:
            ssi = self.umac.ssi
        path = os.path.join(self.dumpdir, f"traffic_{usage}_{tsn}.out")
        with open(path, "ab") as f:
            f.write(block.tobytes())
        with open(os.path.join(self.dumpdir, f"traffic_{usage}_{tsn}.txt"), "a") as f:
            f.write(f"{ssi}\n")
        if self.decode_voice:
            self._decode_voice_slot(type4, usage, tsn, voice_ks)

    def _voice_keystream(self):
        """274 keystream ubits for this slot's voice (reference
        tetra_crypto.c:254-282: two half slots, 137 bits each, key =
        tcs->cck, IV from the slot's TDMA time) — None when no key is
        selected or crypto/clock state is incomplete. The reference
        ships decrypt_voice_timeslot unwired; here it runs on both
        control planes (the native walk generates the same stream at
        slot time into its payload arena)."""
        from tetra_tpu.crypto.crypto import generate_keystream
        t = self.time
        if (self.tcs.cck is None or not (1 <= t.tn <= 4)
                or not (1 <= t.fn <= 18) or not (1 <= t.mn <= 60)):
            return None
        return generate_keystream(self.tcs, self.tcs.cck, t, 274)

    def _decode_voice_slot(self, type4: np.ndarray, usage: int, tsn: int,
                           voice_ks=None):
        """Beyond-reference capability: run the TCH/S speech FEC chain
        (rate-1/3 Viterbi per protection class) + ACELP reordering,
        decrypt the two 137-bit codec frames when a key is selected,
        and append them per slot to a .cod file. The reference ships
        these components unwired (SURVEY §3.5, TODO:1-2) and dumps raw
        soft bits instead."""
        import jax.numpy as jnp
        from tetra_tpu.ops import acelp
        c0, c1, c2, ok1, ok2 = acelp.tch_s_decode(jnp.asarray(type4[None, :432]))
        # speech line bits: class0 | class1 | class2 = 102+108+64 = 274
        line = np.concatenate([np.asarray(c0)[0], np.asarray(c1)[0],
                               np.asarray(c2)[0]])
        codec = np.asarray(acelp.type2_to_codec(jnp.asarray(line[None])))[0]
        if voice_ks is None:
            voice_ks = self._voice_keystream()
        if voice_ks is not None:
            codec = codec.copy()
            codec[:274] ^= np.asarray(voice_ks[:274], codec.dtype)
        path = os.path.join(self.dumpdir, f"voice_{usage}_{tsn}.cod")
        with open(path, "ab") as f:
            f.write(np.packbits(codec.astype(np.uint8)).tobytes())

    def _record_tmv(self, lchan: int, ok, blk_num: int, bits):
        if self.tmv_records is not None:
            b = np.asarray(bits)
            self.tmv_records.append(
                (self.time.tn, self.time.fn, self.time.mn, int(lchan),
                 int(bool(ok)), int(blk_num), len(b),
                 "".join(str(int(x)) for x in b)))

    def _dispatch(self, res, lchan: int, blk_num: int, type1_len: int, name: str):
        ok = self._crc_log(name, res, type1_len) if name != "BBK" else True
        if name == "BBK":
            # reference: no RM3014 check, crc_ok=1 (tetra_lower_mac.c:268-271)
            self.log(f"{name} {self.time.dump()} type1: "
                     f"{self._ubits_str(np.asarray(res.type1))}")
        self._record_tmv(lchan, ok, blk_num, res.type1)
        self.umac.rx_slot(np.asarray(res.type1), lchan, ok, self.time,
                          blk_num=blk_num, scrambling_code=self.scramb_init)

    # ---- main entry ----

    def _flush_events(self, events: list, upto_seq: int):
        """Emit sync events in reference order: the TDMA clock advances
        and 'BURST' prints once per processed slot — including lost
        ones — exactly like tetra_burst_sync.c:113-116/125-141."""
        while self._ev_ptr < len(events) and events[self._ev_ptr].seq <= upto_seq:
            e = events[self._ev_ptr]
            self._ev_ptr += 1
            if e.kind == "found_sync":
                self.log(f"found SYNC training sequence in bit #{e.detail}")
            elif e.kind == "burst":
                self.time.add_tn(1)
                self.log("\nBURST")
                self.stats.bursts += 1
                self.stats.slots += 1
            elif e.kind == "lost":
                self.log("#### could not find successive burst training sequence")
            elif e.kind == "bad_offset":
                self.log(f"#### SYNC burst at offset {e.detail}?!?")

    def process_bits(self, bits: np.ndarray, final: bool = True) -> RxStats:
        """Decode a chunk of unpacked hard bits (1 bit per byte/element).

        Streaming: pass final=False for mid-stream chunks — partial
        feed quanta at the chunk edge are retained and the synchroniser
        resumes across calls, so feeding one capture in arbitrary
        chunks is equivalent to feeding it whole. final=True (default)
        treats the chunk end as EOF, like the reference's last short
        read().
        """
        chunk = np.asarray(bits, dtype=np.uint8).reshape(-1) & 1
        self._buf = np.concatenate([self._buf, chunk])
        bits = self._buf
        from tetra_tpu.utils import trace
        events: list = []
        self._ev_ptr = 0
        slots = sync_mod.align_stream(bits, events=events,
                                      carry=self._sync_carry,
                                      base_offset=self._buf_base,
                                      flush=final)
        if trace.enabled(2):
            trace.tap("aligned_slots",
                      np.asarray([(s.offset, s.train_id) for s in slots]))
        if slots:
            decoded = decode_slots_multi([bits], [slots],
                                         [self.scramb_init])[0]
            for s, d in zip(slots, decoded):
                self._flush_events(events, s.seq)
                self._walk_slot(d)
        self._flush_events(events, 1 << 62)
        self._trim_buffer()
        return self.stats

    def _walk_slot(self, d: dict):
        """Per-slot upper-MAC processing given its decoded blocks
        (the host half of tp_sap_udata_ind + tetra_burst_rx_cb)."""
        if d["kind"] == "SYNC":
            sb1, bbk, sb2 = d["SB1"], d["BBK"], d["SB2"]
            sb1_ok = self._rx_sb1(sb1)
            self._record_tmv(LogicalChannel.BSCH, sb1_ok, 1, sb1.type1)
            self.umac.rx_slot(sb1.type1, LogicalChannel.BSCH, sb1_ok,
                              self.time, blk_num=1)
            self._dispatch(bbk, LogicalChannel.AACH, 0, 14, "BBK")
            lchan = LogicalChannel.UNKNOWN
            if is_bnch(self.time):
                self.log("BNCH FOLLOWS")
                lchan = LogicalChannel.BNCH
            self._dispatch(sb2, lchan, 2, 124, "SB2")
        elif d["kind"] == "SCHF":
            self._dispatch(d["BBK"], LogicalChannel.AACH, 0, 14, "BBK")
            if self.umac.cur_burst_is_traffic:
                self._dump_traffic(d["t4"])
            else:
                self._dispatch(d["SCH_F"], LogicalChannel.SCH_F, 0, 268,
                               "SCH/F")
        elif d["kind"] == "NDB":
            self._dispatch(d["BBK"], LogicalChannel.AACH, 0, 14, "BBK")
            if self.umac.cur_burst_is_traffic:
                # blk1 stolen in traffic mode (tetra_lower_mac.c:191-196)
                self.umac.blk1_stolen = True
                self._dispatch(d["NDB1"], LogicalChannel.UNKNOWN, 1, 124, "NDB")
                if not self.umac.blk2_stolen:
                    self._dump_traffic(d["t4"])
                else:
                    self._dispatch(d["NDB2"], LogicalChannel.UNKNOWN, 2, 124,
                                   "NDB")
            else:
                self._dispatch(d["NDB1"], LogicalChannel.UNKNOWN, 1, 124, "NDB")
                self._dispatch(d["NDB2"], LogicalChannel.UNKNOWN, 2, 124, "NDB")


def main(argv=None):
    """CLI entry point mirroring `tetra-rx [-d DUMPDIR] [-k KEYSTORE] <bits>`."""
    from tetra_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import argparse
    p = argparse.ArgumentParser(description="TETRA receiver (JAX)")
    p.add_argument("-d", dest="dumpdir", help="traffic dump directory")
    p.add_argument("-k", dest="keystore", help="crypto keystore file")
    p.add_argument("-g", dest="gsmtap", nargs="?", const="localhost",
                   help="GSMTAP export host")
    p.add_argument("-f", dest="fmt", default="auto",
                   choices=("auto", "bits", "float", "iq"),
                   help="capture format (default: infer from extension)")
    p.add_argument("--voice", action="store_true",
                   help="run the TCH/S speech FEC chain and write packed "
                        "ACELP codec frames (.cod) next to the traffic "
                        "dumps (needs -d)")
    p.add_argument("capture", help=".bits (1 byte/bit), .fl (float symbols) "
                                   "or .cfile (complex IQ)")
    args = p.parse_args(argv)
    rx = TetraReceiver(keystore_path=args.keystore, dumpdir=args.dumpdir,
                       gsmtap_host=args.gsmtap, decode_voice=args.voice)
    from tetra_tpu.io.inputs import load_capture, capture_to_bits
    kind, data = load_capture(args.capture, args.fmt)
    stats = rx.process_bits(capture_to_bits(kind, data))
    print(f"\n{stats.bursts} bursts, CRC ok/wrong = {stats.crc_ok}/{stats.crc_wrong}")


if __name__ == "__main__":
    main()
