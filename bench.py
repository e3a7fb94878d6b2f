"""Benchmark: real-time TETRA carriers decodable per card.

Stages (SURVEY.md §6 protocol, north star = 1000 realtime carriers):
  1. cold host->device copy bandwidth (measured before any compile)
  2. FEC-only: batched SCH/F lower-MAC decode (descramble -> one-hot
     matmul assembly -> fused Viterbi kernel -> CRC)
  3. full chain, kind-compacted: DQPSK demod -> train-seq classify ->
     fused single-pass decode of ALL burst kinds
  4. mixed-traffic comparison: the redundant all-interpretations path
  5. wideband: 512-channel PFB front end + full chain
  6. streaming ingest: int8 / packed 4-bit IQ chunks, double-buffered
     device_put overlapped with compute (io/stream.py)
  7. host control plane: native executor slots/s (plain and TEA1)
  8-11. integrated end to end through MultiCarrierReceiver
     (tools/bench_mc_e2e.py): per-carrier bits, the full protocol mix,
     the wideband capture clean and at 8 dB (soft), and the
     production configuration (wideband, full mix, 10% TEA1)

Methodology: every sample ends in a host fetch of a scalar (or
block_until_ready), and device throughput is computed differentially
between two batch sizes, cancelling the fixed per-call dispatch cost.
Any failing stage fails the run.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
with the card's name and power limit (nvidia-smi) and the JAX device.
vs_baseline is the ratio against the BASELINE.md north-star target of
1000 real-time carriers per card.
"""
from __future__ import annotations

import json
import time

import numpy as np

REPS = 7


def _median_time(fn, reps=REPS):
    fn()  # warm (compile)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


def main():
    import pathlib
    import sys
    import jax
    import jax.numpy as jnp
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench: needs an NVIDIA GPU; JAX found "
                 f"{jax.devices()[0].platform}")
    from tetra_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    sys.path.insert(0, str(pathlib.Path(__file__).parent / "tools"))
    import bench_mc_e2e

    # ---- stage 1: cold h2d copy bandwidth (before ANY jit compile) ----
    rng = np.random.default_rng(0)
    link = rng.normal(0, 1, (32 << 20) // 4).astype(np.float32)
    d = jax.device_put(link)
    d.block_until_ready()
    t0 = time.perf_counter()
    d = jax.device_put(link)
    d.block_until_ready()
    h2d_gbps_cold = link.nbytes / (time.perf_counter() - t0) / (1 << 30)
    del d

    from tetra_tpu.lmac import pipeline, steady
    from tetra_tpu import tx
    from tetra_tpu.ops.scramble import scramb_get_init

    # two batch sizes far enough apart that the compute difference
    # dwarfs the per-call dispatch cost and its jitter
    B_SMALL, B_BIG = 131072, 1048576
    init = scramb_get_init(262, 42, 1)

    # fixture generation on the host CPU backend (eager TX is many tiny
    # ops; keep them off the device dispatch path)
    cpu = jax.devices("cpu")[0]
    n_uniq = 64
    schf = rng.integers(0, 2, size=(n_uniq, 268)).astype(np.int8)
    aach = rng.integers(0, 2, size=(n_uniq, 14)).astype(np.int8)
    with jax.default_device(cpu):
        t5 = np.asarray(tx.encode_block("SCH_F", jnp.asarray(schf), jnp.uint32(init)))
        bb = np.asarray(tx.encode_bbk(jnp.asarray(aach), jnp.uint32(init)))
    from tetra_tpu.phy.burst import build_norm_c_d_burst
    uniq = np.stack([build_norm_c_d_burst(t5[i, :216], bb[i], t5[i, 216:], False)
                     for i in range(n_uniq)])

    # ---- stage 2: FEC-only (SCH/F) ----
    @jax.jit
    def fec_step(b, i):
        res = pipeline.decode_schf_burst(b, i)
        return res["SCH_F"].crc_ok.astype(jnp.int32).sum()

    def bursts_of(n):
        return jnp.asarray(np.tile(uniq, (n // n_uniq + 1, 1))[:n].astype(np.int8))

    times = {}
    ok_frac = None
    for B in (B_SMALL, B_BIG):
        bd = bursts_of(B)
        idd = jnp.asarray(np.full(B, init, dtype=np.uint32))
        v = int(fec_step(bd, idd))
        if B == B_BIG:
            ok_frac = v / B
        times[B] = _median_time(lambda: int(fec_step(bd, idd)))
    slots_per_s = (B_BIG - B_SMALL) / (times[B_BIG] - times[B_SMALL])
    fec_carriers = slots_per_s / (18000.0 / 255.0)

    # device-chained variant: R decodes inside ONE jit (a dynamic roll
    # defeats hoisting), rate = (R-1)*B/(t_R - t_1) — free of per-call
    # dispatch cost and jitter altogether
    B_CH = 262144
    bd_ch = bursts_of(B_CH)
    idd_ch = jnp.asarray(np.full(B_CH, init, dtype=np.uint32))

    def chained(R):
        @jax.jit
        def f(b, i0):
            def it(i, acc):
                res = pipeline.decode_schf_burst(jnp.roll(b, i, axis=0),
                                                 i0)
                return acc + res["SCH_F"].crc_ok.astype(jnp.int32).sum()
            return jax.lax.fori_loop(0, R, it, jnp.int32(0))
        return f

    f1, f8 = chained(1), chained(8)
    int(f1(bd_ch, idd_ch))
    int(f8(bd_ch, idd_ch))
    t1 = _median_time(lambda: int(f1(bd_ch, idd_ch)), reps=5)
    t8 = _median_time(lambda: int(f8(bd_ch, idd_ch)), reps=5)
    fec_chained_slots_per_s = 7 * B_CH / (t8 - t1)
    del bd_ch, idd_ch

    # ---- stage 3: full chain, kind-compacted fused decode ----
    from tetra_tpu.phy import dqpsk
    N_SLOTS = 64
    # big enough that the differential (C_BIG - C_SMALL) dwarfs the
    # per-call jitter
    C_SMALL, C_BIG = 512, 4096
    pad = np.zeros(64, np.int8)
    per_carrier_bits = np.concatenate([pad, uniq[:N_SLOTS].reshape(-1), pad])
    iq_row = dqpsk.modulate(per_carrier_bits[None].astype(np.int8), sps=2)[0]

    @jax.jit
    def chain_step(re, im, i):
        out = steady.locked_step_ri(re, im, i, phase_bit=64, n_slots=N_SLOTS,
                                    fast=True, decoders=("fused",))
        return out["crc_ok"].astype(jnp.int32).sum()

    @jax.jit
    def chain_step_all3(re, im, i):
        out = steady.locked_step_ri(re, im, i, phase_bit=64, n_slots=N_SLOTS,
                                    fast=True)
        return out["crc_ok"].astype(jnp.int32).sum()

    def chain_rate(step):
        ts = {}
        okc = None
        for CC in (C_SMALL, C_BIG):
            tiled = np.tile(iq_row, (CC, 1))
            re = jnp.asarray(np.real(tiled).astype(np.float32))
            im = jnp.asarray(np.imag(tiled).astype(np.float32))
            idd = jnp.asarray(np.full(CC, init, np.uint32))
            v = int(step(re, im, idd))
            if CC == C_BIG:
                okc = v / (CC * N_SLOTS)
            ts[CC] = _median_time(lambda: int(step(re, im, idd)))
        d_samples = (C_BIG - C_SMALL) * iq_row.shape[-1]
        return d_samples / (ts[C_BIG] - ts[C_SMALL]), okc

    chain_samples_per_s, chain_ok = chain_rate(chain_step)
    chain_carriers = chain_samples_per_s / 36000.0
    all3_samples_per_s, _ = chain_rate(chain_step_all3)
    all3_carriers = all3_samples_per_s / 36000.0

    # ---- stage 5: wideband 512-channel PFB front end + full chain ----
    from tetra_tpu.phy import pfb as pfb_mod
    N_CHAN = 512
    FS_WIDE = N_CHAN * 25_000.0

    def wide_step_factory(n_slots):
        @jax.jit
        def wide_step(wre, wim, i):
            cr, ci = pfb_mod.pfb_to_demod_rate_ri(
                wre, wim, jnp.arange(N_CHAN, dtype=jnp.int32), N_CHAN, FS_WIDE)
            out = steady.locked_step_ri(cr, ci, i, phase_bit=64,
                                        n_slots=n_slots, fast=True,
                                        decoders=("fused",))
            return out["kinds"].sum() + out["crc_ok"].astype(jnp.int32).sum()
        return wide_step

    wide_times = {}
    rng2 = np.random.default_rng(1)
    for n_slots in (8, 168):
        need_36k = 64 + n_slots * 510 + 64
        m_chan = int(need_36k * 50_000.0 / 36_000.0) + 80
        T_wide = (m_chan + 2 * 16) * (N_CHAN // 2)
        wre = jnp.asarray(rng2.normal(0, 1, T_wide).astype(np.float32))
        wim = jnp.asarray(rng2.normal(0, 1, T_wide).astype(np.float32))
        idd = jnp.asarray(np.full(N_CHAN, init, np.uint32))
        step_w = wide_step_factory(n_slots)
        wide_times[n_slots] = (_median_time(lambda: int(step_w(wre, wim, idd))),
                               T_wide)
    d_wide = wide_times[168][1] - wide_times[8][1]
    wide_samples_per_s = d_wide / (wide_times[168][0] - wide_times[8][0])
    wide_carriers = wide_samples_per_s / FS_WIDE * N_CHAN

    # ---- stage 6: streaming ingest (int8 IQ, double-buffered) ----
    from tetra_tpu.io import stream
    C_ING, SLOTS_ING, NCHUNK = 1024, 16, 6
    bits_ing = np.concatenate([pad, uniq[:SLOTS_ING].reshape(-1), pad])
    iq_ing = dqpsk.modulate(bits_ing[None].astype(np.int8), sps=2)[0]
    re8, im8 = stream.quantize_iq(np.tile(iq_ing.real, (C_ING, 1)) * 0.7,
                                  np.tile(iq_ing.imag, (C_ING, 1)) * 0.7)
    init_ing = np.full(C_ING, init, np.uint32)

    # one stacked array per chunk (one transfer RPC), scrambling codes
    # put once via static=, ONE batched device_get at the end — each
    # per-item int() would cost a device round-trip and stall the
    # put/compute overlap (see stream.stream_map transfer-economy notes)
    iq8_ing = np.stack([re8, im8])                     # [2, C, T] int8

    @jax.jit
    def ingest_step(init_d, c):
        re, im = stream.dequantize_iq(c[0], c[1])
        out = steady.locked_step_ri(re, im, init_d, phase_bit=64,
                                    n_slots=SLOTS_ING, fast=True,
                                    decoders=("fused",))
        return out["crc_ok"].astype(jnp.int32).sum()

    chunks = [iq8_ing] * NCHUNK
    ingest_samples = NCHUNK * C_ING * iq_ing.shape[-1]

    def run_ingest():
        outs = list(stream.stream_map(ingest_step, chunks, static=init_ing))
        return jax.device_get(outs)

    t_ing = _median_time(run_ingest, reps=3)
    ingest_samples_per_s = ingest_samples / t_ing
    ingest_carriers = ingest_samples_per_s / 36000.0

    # packed 4+4-bit IQ: one byte per complex sample, half the h2d
    # bytes — the right format when h2d bandwidth bounds carrier count
    iq4_ing = stream.quantize_iq4(np.tile(iq_ing.real, (C_ING, 1)) * 0.7,
                                  np.tile(iq_ing.imag, (C_ING, 1)) * 0.7)

    @jax.jit
    def ingest4_step(init_d, c):
        re, im = stream.dequantize_iq4(c)
        out = steady.locked_step_ri(re, im, init_d, phase_bit=64,
                                    n_slots=SLOTS_ING, fast=True,
                                    decoders=("fused",))
        return out["crc_ok"].astype(jnp.int32).sum()

    def run_ingest4():
        outs = list(stream.stream_map(ingest4_step, [iq4_ing] * NCHUNK,
                                      static=init_ing))
        return jax.device_get(outs)

    t_ing4 = _median_time(run_ingest4, reps=3)
    ingest4_samples_per_s = ingest_samples / t_ing4
    ingest4_carriers = ingest4_samples_per_s / 36000.0

    # ---- stage 7: control plane (host): native executor slots/s ----
    from tetra_tpu import testpdu
    from tetra_tpu.umac import native_exec
    from tetra_tpu.umac.upper_mac import UpperMac, LogicalChannel
    from tetra_tpu.tdma import TdmaTime
    from tetra_tpu.llc.llc import LlcState
    assert native_exec.available(), "native control plane did not build"
    aach_b = np.asarray(testpdu.make_access_assign_bits(0, 5, 9),
                        np.uint8)
    res_b = np.asarray(testpdu.make_resource_pdu(
        ssi=0x1234, sdu_bits=testpdu.make_bl_udata(
            testpdu.make_mle_cmce_dsetup())), np.uint8)
    N_CP, C_CP = 40000, 64
    recs = np.zeros((N_CP, 9), np.int32)
    parts = []
    off = 0
    for i in range(N_CP):
        b = aach_b if i % 2 == 0 else res_b
        lch = (LogicalChannel.AACH if i % 2 == 0
               else LogicalChannel.SCH_F)
        recs[i] = (i % C_CP, lch, 1, 0, (i % 4) + 1, (i % 18) + 1,
                   1, off, len(b))
        parts.append(b)
        off += len(b)
    all_bits = np.concatenate(parts)
    cp = native_exec.NativeControlPlane(C_CP)
    cp.process(all_bits, recs)
    t_cp = _median_time(lambda: cp.process(all_bits, recs), reps=5)
    cp_slots_per_s = N_CP / t_cp
    cp.close()
    nul = lambda *a, **k: None
    um = UpperMac(llc=LlcState(log=nul), log=nul)
    n_py = 2000
    t0 = time.perf_counter()
    for i in range(n_py):
        o, ln = recs[i, 7], recs[i, 8]
        um.rx_slot(all_bits[o:o + ln], int(recs[i, 1]), True,
                   TdmaTime(tn=int(recs[i, 4]), fn=int(recs[i, 5])))
    cp_py_slots_per_s = n_py / (time.perf_counter() - t0)

    # encrypted hot path: TEA1-encrypted MAC-RESOURCE slots,
    # decrypted inside the C++ walk (TB5 + batch TEA core;
    # reference decrypts on its hot path, tetra_crypto.c:211-252)
    from tetra_tpu.crypto.crypto import (
        CryptoState, CryptoDatabase, TetraKey, TetraNetinfo,
        decrypt_mac_element)
    from tetra_tpu.umac import mac_pdu
    from tetra_tpu.utils.bits import uint_to_bits
    MCC, MNC, CCODE, CCK_ID, CN, LA = 262, 42, 1, 7, 3710, 1234
    ni = TetraNetinfo(mcc=MCC, mnc=MNC, ksg_type=1,
                      security_class=2)
    key = TetraKey(index=0, mcc=MCC, mnc=MNC, key_type=1,
                   key_num=CCK_ID, addr=0,
                   key=bytes(range(0xA0, 0xAA)), network_info=ni)
    db = CryptoDatabase(keys=[key], nets=[ni])
    tcs = CryptoState()
    tcs.db = db
    tcs.mcc, tcs.mnc, tcs.cc = MCC, MNC, CCODE
    tcs.cn, tcs.la, tcs.cck_id, tcs.hn = CN, LA, CCK_ID, -1
    # four slot-time variants so consecutive decrypts carry
    # DIFFERENT IVs — the per-carrier keystream cache (which
    # legitimately serves multi-element slots and voice halves)
    # cannot serve cross-slot requests here
    encs = []
    for tn in range(1, 5):
        pdu = np.array(testpdu.make_resource_pdu(
            ssi=0x1234, sdu_bits=testpdu.make_bl_udata(
                testpdu.make_mle_cmce_dsetup()), fill=False))
        pdu[4:6] = [0, 1]  # encryption_mode = 1
        rsd = mac_pdu.decode_resource(pdu)
        enc = np.array(pdu, np.uint8)
        enc[:rsd.macpdu_length * 8], okx = decrypt_mac_element(
            tcs, key, pdu[:rsd.macpdu_length * 8],
            TdmaTime(tn=tn, fn=2, mn=3), rsd.bit_len)
        assert okx
        encs.append(enc)
    enc_all = np.concatenate(encs).astype(np.uint8)
    enc_len = len(encs[0])
    cp2 = native_exec.NativeControlPlane(C_CP)
    cp2.set_keys(db)
    # bootstrap per-carrier crypto state through the walk: one
    # SYNC slot (cc/mcc/mnc) whose SB2 is a CCK-flagged SYSINFO
    # (la/cn/cck id)
    sb1 = np.asarray(testpdu.make_sync_pdu(
        cc=CCODE, tn=1, fn=2, mn=3, mcc=MCC, mnc=MNC), np.uint8)
    si = np.array(testpdu.make_sysinfo_pdu(
        main_carrier=CN, la=LA), np.uint8)
    si[43] = 1
    si[44:60] = uint_to_bits(CCK_ID, 16)
    bbk14 = np.asarray(testpdu.make_access_assign_bits(), np.uint8)
    boot_bits = np.concatenate([sb1, bbk14, si]).astype(np.uint8)
    wrec = np.zeros((C_CP, 14), np.int32)
    for c in range(C_CP):
        wrec[c] = (c, 0, 1, 2, 3, 1, 1, 0, len(sb1),
                   len(sb1), 14, len(sb1) + 14, len(si), 0)
    cp2.walk(boot_bits, wrec)
    N_ENC = 20000
    erecs = np.zeros((N_ENC, 9), np.int32)
    for i in range(N_ENC):
        # vary tn per VISIT of each carrier (i // C_CP), not per
        # record index — C_CP divides 4, so an i%4 cycle would
        # pin every carrier to one tn and the per-carrier
        # keystream cache would serve every decrypt
        tn = (i // C_CP) % 4 + 1
        erecs[i] = (i % C_CP, LogicalChannel.SCH_F, 1, 0, tn, 2,
                    3, (tn - 1) * enc_len, enc_len)
    ev = cp2.process(enc_all, erecs)
    from tetra_tpu.umac.native_exec import EV as _EV
    n_dec = int((ev["kind"] == _EV.TLSDU).sum())
    assert n_dec >= N_ENC, n_dec  # every slot decrypted+parsed
    t_enc = _median_time(lambda: cp2.process(enc_all, erecs),
                         reps=5)
    cp_enc_slots_per_s = N_ENC / t_enc
    cp2.close()

    result = {
        "metric": "realtime_carriers_per_card",
        "value": chain_carriers,
        "unit": "carriers (full chain: DQPSK demod + classify + fused "
                "all-kind FEC)",
        "vs_baseline": chain_carriers / 1000.0,
        "fullchain_msamples_per_s": chain_samples_per_s / 1e6,
        "fullchain_crc_ok_frac": chain_ok,
        "allinterp_realtime_carriers": all3_carriers,
        "wideband_msamples_per_s": wide_samples_per_s / 1e6,
        "wideband_realtime_carriers": wide_carriers,
        "fec_only_slots_per_s": slots_per_s,
        "fec_only_carriers": fec_carriers,
        "fec_chained_slots_per_s": fec_chained_slots_per_s,
        "fec_crc_ok_frac": ok_frac,
        "h2d_gbps_cold": h2d_gbps_cold,
        "ingest_msamples_per_s": ingest_samples_per_s / 1e6,
        "ingest_realtime_carriers": ingest_carriers,
        "ingest4_msamples_per_s": ingest4_samples_per_s / 1e6,
        "ingest4_realtime_carriers": ingest4_carriers,
        "controlplane_native_slots_per_s": cp_slots_per_s,
        "controlplane_native_carriers": cp_slots_per_s / (18000.0 / 255.0),
        "controlplane_python_slots_per_s": cp_py_slots_per_s,
        "controlplane_native_enc_slots_per_s": cp_enc_slots_per_s,
        "card": bench_mc_e2e.card_info(),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }

    # ---- stages 8-11: integrated end to end through
    # MultiCarrierReceiver (reference unit: tetra-rx.c:82-95), 1024
    # carriers, 16 multiframes in 4 chunks; all stages share
    # common_len(16) captures, so the chunk programs compile once ----
    e2e = {
        "mc_e2e": bench_mc_e2e.run(n_car=1024, n_frames=16, n_chunks=4),
        # the FULL protocol mix (NDB/SCH_HD, stolen/STCH, traffic +
        # voice, FRAG/END chains, relocks, 10% TEA1-encrypted carriers;
        # reference workload: tetra_lower_mac.c:178-352)
        "mc_e2e_mixed": bench_mc_e2e.run_mixed(n_car=1024, n_frames=16,
                                               n_chunks=4),
        # one companded 4+4-bit wideband capture, PFB on the device
        "mc_e2e_wideband": bench_mc_e2e.run_wideband(
            n_car=1024, n_frames=16, n_chunks=4),
        # the same capture at 8 dB per-channel SNR, soft demod + soft
        # Viterbi + tolerant sync
        "mc_e2e_snr8": bench_mc_e2e.run_snr8(n_car=1024, n_frames=16,
                                             n_chunks=4),
        # the production configuration: wideband RF, full mix, 10%
        # TEA1, zero CRC errors required
        "mc_e2e_prod": bench_mc_e2e.run_prod(n_car=1024, n_frames=16,
                                             n_chunks=4),
    }
    for stage, r in e2e.items():
        for k, v in r.items():
            result[f"{stage}_{k}"] = v
    result["mc_e2e_snr8_crc_ok_frac"] = (
        e2e["mc_e2e_snr8"]["crc_ok"] / e2e["mc_e2e_wideband"]["crc_ok"])

    print(json.dumps(result))


if __name__ == "__main__":
    main()
