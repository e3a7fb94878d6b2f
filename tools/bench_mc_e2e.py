"""End-to-end MultiCarrierReceiver benchmark: N carriers of raw hard
bits (acquisition from garbage, steady slots, mixed SYNC/SCH_F
traffic) through sync_vec + fused FEC + the native control plane, as
one receiver object processing chunked input — the integration-level
number, not a kernel number. Prints one JSON line.

Usage: python tools/bench_mc_e2e.py [n_carriers] [n_frames] [chunks]
"""
import contextlib
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

from tetra_tpu import tx, testpdu
from tetra_tpu.ops.scramble import scramb_get_init, scramb_bits
from tetra_tpu.rx_multi import MultiCarrierReceiver

INIT = scramb_get_init(262, 42, 1)
BITRATE = 36_000.0  # bits/s per carrier: real-time reference

MCC, MNC, CC = 262, 42, 1
SCK = bytes(range(0xA0, 0xAA))
CCK_ID = 7
KEYSTORE = (f"network mcc {MCC} mnc {MNC} ksg_type 1 security_class 2\n"
            f"key mcc {MCC} mnc {MNC} addr 0 key_type 1 key_num {CCK_ID} "
            f"key {SCK.hex().upper()}\n")


HEAD_NOISE = 731


def median_time(fn, reps):
    """Median wall seconds of `reps` calls of fn, each ended by
    block_until_ready, after one warm call."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@contextlib.contextmanager
def recorded(owner, name):
    """Replace owner.name by a pass-through that keeps (args, kwargs,
    result) of every call; yields that list."""
    fn = getattr(owner, name)
    calls = []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them
    ("no nvidia-smi" where there is none): every timing is reported
    beside it."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except FileNotFoundError:
        return "no nvidia-smi"


def timed_passes(one_pass, reps=3):
    """Warm until stable, then time: the first warm pass pays compiles,
    and the next few can still ramp (allocator and cache effects), so
    warm passes repeat (max 4) until the pass time stops improving by
    >10%, then `reps` timed passes. Returns (mc, stats, median wall)."""
    t_prev = None
    for _ in range(4):
        t0 = time.perf_counter()
        mc, stats = one_pass()
        t = time.perf_counter() - t0
        if t_prev is not None and t > 0.9 * t_prev:
            break
        t_prev = t
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        mc, stats = one_pass()
        samples.append(time.perf_counter() - t0)
    return mc, stats, float(np.median(samples))


def common_len(n_frames):
    """Shared per-carrier capture length across ALL e2e stages: the
    mixed stream's natural length (the longest fixture: head noise +
    double-SYNC + n_frames frames + relock noise) plus a wide noise
    tail, rounded even. Every stage pads its rows to this length with
    circular_safe_pad, so the fused-chunk programs compile ONCE and
    per-carrier circular rolls never truncate a burst. The
    tail is wide (~3 kbit) so safe_rolls has a big window to spread
    carrier content shifts over (composite Gaussianity)."""
    L = HEAD_NOISE + 510 + n_frames * 2040 + 443 + 2921
    return L + (L % 2)


def safe_rolls(n_car, L, n_tail, head=HEAD_NOISE, guard=64):
    """Per-carrier circular roll offsets whose START position lands in
    the capture's screened noise (tail span or head span).

    The receiver then begins UNLOCKED in noise, acquires on the
    double-SYNC head (first SYNC consumed by acquisition — the
    reference skips the acquisition burst, tetra_burst_sync.c:80-91 —
    the second SYNC decodes SB1 and sets the cell scrambling code
    before any normal burst), and the stream END falls in noise too.
    An arbitrary roll would cold-start the receiver mid-frame: up to 3
    slots decode before any SB1 sets the scrambling code, and whether
    those garbage decodes count CRC-wrong depends on what the
    garbage-descrambled AACH happens to say — reference-faithful, but
    a nondeterministic invariant for a 0-CRC-error capture."""
    W = n_tail + head - 2 * guard
    start0 = L - n_tail + guard
    pos = (start0 + (np.arange(n_car, dtype=np.int64) * 997
                     + np.arange(n_car) % 17) % W)
    return (L - pos % L) % L


def make_stream(rng, n_frames):
    """One carrier's bit stream: garbage, a double-SYNC head
    (acquisition consumes the first SYNC — tetra_burst_sync.c:80-91 —
    the second decodes SB1 so the cell scrambling code is set before
    the first normal burst), then n_frames TDMA frames of
    [SYNC, SCH_F, SCH_F, SCH_F] bursts."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        sync = np.asarray(tx.make_sync_burst(
            testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
            testpdu.make_sysinfo_pdu(),
            testpdu.make_access_assign_bits(), jnp.uint32(INIT)), np.uint8)
        schf = [np.asarray(tx.make_schf_burst(
            testpdu.make_resource_pdu(ssi=0x400 + i),
            testpdu.make_access_assign_bits(), jnp.uint32(INIT)), np.uint8)
            for i in range(4)]
    frames = [sync]
    for f in range(n_frames):
        frames.append(sync)
        for tn in range(3):
            frames.append(schf[(f + tn) % 4])
    return np.concatenate([rng.integers(0, 2, HEAD_NOISE).astype(np.uint8)]
                          + frames)


def circular_safe_pad(row, rng, n_tail=737):
    """Append a clean-noise tail (even total length) and verify the
    CIRCULAR junction regions contain no training-sequence match, so
    the per-carrier circular rolls the multi-carrier fixtures apply
    never cut a burst mid-slot or fabricate a false lock:

    * without a tail the stream ends ON a burst boundary, and any roll
      that truncates the stream (or an even-length trim) cuts that
      final burst — a locked receiver then matches the training
      sequence of the half-present burst and emits a garbage slot
      (CRC wrong), which is exactly the mixed/wideband bench's failure
      mode before this pad;
    * with the tail, the roll junction is noise -> head-noise, i.e. a
      plain relock the capture already exercises.

    Checked spans: the tail itself, the last-burst -> tail crossing,
    and the tail-end -> stream-head circular crossing."""
    from tetra_tpu.phy.sync import compute_match_map
    if (len(row) + n_tail) % 2:
        n_tail += 1
    while True:
        tail = rng.integers(0, 2, n_tail).astype(np.uint8)
        cross_in = np.concatenate([row[-48:], tail[:48]])
        cross_junc = np.concatenate([tail[-48:], row[:48]])
        if not (compute_match_map(tail).any()
                or compute_match_map(cross_in).any()
                or compute_match_map(cross_junc).any()):
            return np.concatenate([row, tail])


def _encrypt_pdu(pdu, tn, fn, mn, skip=0, end=None):
    """Set encryption_mode=1 and XOR the ciphertext range with the
    keystream the RX will derive at the slot's TDMA time (TX mirror of
    reference tetra_crypto.c:158-252; SYSINFO advertises CCK_ID so the
    SCK above is selected, hn stays -1)."""
    from tetra_tpu.umac import mac_pdu
    from tetra_tpu.crypto.crypto import (CryptoState, TetraKey,
                                         TetraNetinfo, generate_keystream)
    from tetra_tpu.tdma import TdmaTime
    pdu = np.array(pdu)
    pdu[4:6] = [0, 1]
    off = mac_pdu.decode_resource(pdu).bit_len
    if end is None:
        end = mac_pdu.decode_resource(pdu).macpdu_length * 8
    ni = TetraNetinfo(mcc=MCC, mnc=MNC, ksg_type=1, security_class=2)
    key = TetraKey(index=0, mcc=MCC, mnc=MNC, key_type=1, key_num=CCK_ID,
                   addr=0, key=SCK, network_info=ni)
    tcs = CryptoState(mcc=MCC, mnc=MNC, cc=CC, cn=3710, la=1234, hn=-1)
    ks = generate_keystream(tcs, key, TdmaTime(tn=tn, fn=fn, mn=mn),
                            skip + (end - off))
    pdu[off:end] ^= ks[skip:]
    return pdu.astype(np.int8)


def _start_frag(ssi, sdu, total_len=268):
    """MAC-RESOURCE with length 0x3F (start of fragmentation)."""
    b = (testpdu.BitBuilder().u(0, 2).u(0, 1).u(0, 1).u(0, 2).u(0, 1)
         .u(0x3F, 6).u(1, 3).u(ssi, 24).u(0, 1).u(0, 1).u(0, 1).raw(sdu))
    return b.pad_to(total_len, 0).array(total_len)


def _mac_end(sdu, total_len=268):
    """MAC-END carrying the final fragment + a null PDU terminator."""
    li = -(-(2 + 1 + 1 + 1 + 6 + 1 + 1 + len(sdu)) // 8)
    b = (testpdu.BitBuilder().u(1, 2).u(1, 1).u(0, 1).u(0, 1).u(li, 6)
         .u(0, 1).u(0, 1).raw(sdu).pad_to(li * 8, 0)
         .u(0, 2).u(0, 1).u(0, 1).u(0, 2).u(0, 1).u(0, 6).u(0, 3))
    return b.pad_to(total_len, 0).array(total_len)


def _null_schf(total_len=268):
    return (testpdu.BitBuilder().u(0, 2).u(0, 1).u(0, 1).u(0, 2).u(0, 1)
            .u(0, 6).u(0, 3).pad_to(total_len, 0).array(total_len))


def _stolen_marker(ssi, sdu, total_len=124):
    """RESOURCE with length 0x3E: this STCH block fills the half slot
    and announces the second block is ALSO stolen."""
    b = (testpdu.BitBuilder().u(0, 2).u(0, 1).u(0, 1).u(0, 2).u(0, 1)
         .u(0x3E, 6).u(1, 3).u(ssi, 24).u(0, 1).u(0, 1).u(0, 1).raw(sdu))
    return b.pad_to(total_len, 0).array(total_len)


def make_mixed_stream(rng, n_frames, encrypted=False):
    """One carrier's FULL-protocol-mix stream: SYNC + SCH/F resources
    with LLC payloads, NDB/SCH_HD half-slot pairs, FRAG-START/MAC-END
    chains, traffic+voice slots (full-slot and NDB half-slot), fully
    stolen STCH slots, a forced mid-stream relock, frame-18 AACH
    windows, and (encrypted=True) TEA1-encrypted RESOURCEs incl. a
    216-bit-skip second half slot — the workload class of reference
    tetra_lower_mac.c:178-352 instead of a sanitized SYNC/SCH_F mix."""
    from tetra_tpu.phy.sync import compute_match_map

    def clean_noise(n):
        # noise span with NO accidental training-sequence match: a
        # false lock during (re)acquisition would emit one garbage
        # slot (CRC wrong) and break the capture's 0-error invariant
        while True:
            cand = rng.integers(0, 2, n).astype(np.uint8)
            if not compute_match_map(cand).any():
                return cand

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        aach = testpdu.make_access_assign_bits()
        aach_t = testpdu.make_access_assign_bits(hdr=3, f1=5, f2=0)
        si = (testpdu.make_sysinfo_pdu(cck_id=CCK_ID) if encrypted
              else testpdu.make_sysinfo_pdu(hyperframe=99))
        bb_t = np.asarray(tx.encode_bbk(jnp.asarray(aach_t),
                                        jnp.uint32(INIT)))
        dsetup = testpdu.make_bl_udata(testpdu.make_mle_cmce_dsetup())
        big_tl = np.concatenate(
            [testpdu.make_mle_cmce_dsetup(),
             np.tile([1, 0, 1, 1, 0, 0], 40)]).astype(np.int8)
        big_llc = testpdu.make_bl_udata(big_tl)

        def sb(fn):
            return np.asarray(tx.make_sync_burst(
                testpdu.make_sync_pdu(mcc=MCC, mnc=MNC, cc=CC, tn=1,
                                      fn=fn, mn=1),
                si, aach, jnp.uint32(INIT)), np.uint8)

        def schf(pdu, traffic=False):
            return np.asarray(tx.make_schf_burst(
                pdu, aach_t if traffic else aach,
                jnp.uint32(INIT)), np.uint8)

        def ndb(b1, b2, traffic=False):
            return np.asarray(tx.make_ndb_burst(
                b1, b2, aach_t if traffic else aach,
                jnp.uint32(INIT)), np.uint8)

        from tetra_tpu.phy.burst import build_norm_c_d_burst

        def voice():
            t5 = np.asarray(scramb_bits(
                jnp.uint32(INIT),
                jnp.asarray(rng.integers(0, 2, 432).astype(np.int8))))
            return np.asarray(build_norm_c_d_burst(
                t5[:216], bb_t, t5[216:], False), np.uint8)

        def ndb_half_voice(b1_pdu):
            # STCH signalling in block 1 (auto-stolen on a traffic
            # slot), raw half-slot voice in block 2
            b1 = np.asarray(tx.encode_block("NDB", jnp.asarray(b1_pdu),
                                            jnp.uint32(INIT)))
            t5 = np.asarray(scramb_bits(
                jnp.uint32(INIT),
                jnp.asarray(rng.integers(0, 2, 216).astype(np.int8))))
            return np.asarray(build_norm_c_d_burst(b1, bb_t, t5, True),
                              np.uint8)

        res = lambda ssi, sdu=dsetup, tl=268: testpdu.make_resource_pdu(
            ssi=ssi, sdu_bits=sdu, total_len=tl)
        frag1 = _start_frag(0x777, big_llc[: 268 - 43])
        frag2 = _mac_end(big_llc[268 - 43:])

        # double-SYNC head: alignment consumes the first burst, the
        # second decodes SB1 so the cell scrambling code is known
        # before the first pattern frame's NDB/stolen slots
        parts = [clean_noise(731), sb(1)]
        for f in range(n_frames):
            fn = f % 18 + 1
            parts.append(sb(fn))
            p = f % 4
            if p == 0:
                if encrypted:
                    e = lambda tn, tl=268, skip=0, end=None: _encrypt_pdu(
                        res(0x900 + f, tl=tl), tn, fn, 1, skip, end)
                    parts += [schf(e(2)),
                              ndb(e(3, tl=124),
                                  _encrypt_pdu(res(0x90F, tl=124), 3, fn,
                                               1, skip=216)),
                              schf(e(4))]
                else:
                    parts += [schf(res(0x400 + f)),
                              ndb(res(0x500 + f, tl=124),
                                  res(0x501 + f, tl=124)),
                              schf(res(0x402 + f))]
            elif p == 1:
                # FRAG-START at tn=2; END lands on the same TN next frame
                parts += [schf(frag1), schf(_null_schf()),
                          schf(_null_schf())]
            elif p == 2:
                parts += [schf(frag2), voice(),
                          ndb(_stolen_marker(0x600 + f, dsetup),
                              res(0x601 + f, tl=124), traffic=True)]
            else:
                parts += [schf(res(0x700 + f)),
                          ndb_half_voice(res(0x702 + f, tl=124)),
                          voice()]
            if f == n_frames // 2:
                # lock loss + re-acquisition mid-stream
                parts.append(clean_noise(443))
    return np.concatenate(parts)


def clean_bits(n_car, n_frames, seed=0):
    """[n_car, common_len(n_frames)] clean SYNC/SCH_F capture: one
    carrier stream tiled and circularly staggered per carrier (every
    start lands in screened noise — see safe_rolls)."""
    rng = np.random.default_rng(seed)
    row = make_stream(rng, n_frames)
    n_tail = common_len(n_frames) - len(row)
    row = circular_safe_pad(row, rng, n_tail)
    bits = np.tile(row, (n_car, 1))
    rolls = safe_rolls(n_car, bits.shape[1], n_tail)
    for c in range(n_car):
        bits[c] = np.roll(bits[c], rolls[c])
    return bits


def keystore_file():
    """The TEA1 keystore of the encrypted carriers, as a temp file."""
    import tempfile
    ksf = tempfile.NamedTemporaryFile("w", suffix=".keys", delete=False)
    ksf.write(KEYSTORE)
    ksf.close()
    return ksf.name


def wideband_capture(bits, snr_db=None):
    """Per-carrier bits [C, T] -> FFT-synthesized composite with carrier
    c on PFB channel c -> companded 4+4-bit capture (quantize_iq4c, ONE
    byte per complex sample). snr_db adds AWGN at that per-CHANNEL SNR
    before quantization (at full occupancy per-channel SNR equals
    composite SNR)."""
    from tetra_tpu.phy import dqpsk, channelizer
    from tetra_tpu.io import stream as stream_mod
    n_car = bits.shape[0]
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        base = np.asarray(dqpsk.modulate(bits, sps=2))
    wide = channelizer.synthesize_wideband_fft(base, np.arange(n_car),
                                               n_car)
    if snr_db is not None:
        rng = np.random.default_rng(99)
        sig = np.mean(np.abs(wide) ** 2) / n_car       # per-carrier power
        npow = sig * n_car / (10 ** (snr_db / 10))     # full-band noise
        wide = (wide + rng.normal(0, np.sqrt(npow / 2), wide.shape)
                + 1j * rng.normal(0, np.sqrt(npow / 2), wide.shape)
                ).astype(np.complex64)
    return stream_mod.quantize_iq4c(wide.real, wide.imag)


def drive_bits(bits, n_chunks, keystore=None, mesh=None):
    """One receiver pass over per-carrier bits through the native
    plane (process_bits), chunked; returns the receiver."""
    n_car, T = bits.shape
    cuts = np.linspace(0, T, n_chunks + 1).astype(int)
    mc = MultiCarrierReceiver(np.zeros(n_car), fs=25_000.0 * n_car,
                              control_plane="native",
                              keystore_path=keystore, mesh=mesh)
    for k in range(n_chunks):
        # streaming contract: mid-stream chunks keep chunks in flight
        # (fetch+walk of chunk k overlaps device compute of chunk k+1);
        # the final call drains the pipeline
        mc.process_bits(bits[:, cuts[k]:cuts[k + 1]],
                        final=k == n_chunks - 1)
    return mc


def drive_wideband(packed, n_car, n_chunks, keystore=None, demod="hard"):
    """One receiver pass over a companded wideband capture through the
    on-device PFB and the native plane (process_iq4c), chunked."""
    S = len(packed)
    cuts = np.linspace(0, S, n_chunks + 1).astype(int)
    mc = MultiCarrierReceiver([], fs=25_000.0 * n_car,
                              pfb_channels=np.arange(n_car, dtype=np.int32),
                              n_chan=n_car, control_plane="native",
                              keystore_path=keystore, demod=demod)
    for k in range(n_chunks):
        mc.process_iq4c(packed[cuts[k]:cuts[k + 1]],
                        final=k == n_chunks - 1)
    return mc


def counts(mc):
    """CRC and protocol-event counts of a drained receiver."""
    from tetra_tpu.umac.native_exec import EV
    kinds = np.concatenate([e["kind"] for e in mc.native_events])
    return {"crc_ok": int(sum(rx.stats.crc_ok for rx in mc.carriers)),
            "crc_err": int(sum(rx.stats.crc_wrong for rx in mc.carriers)),
            "traffic_slots": int((kinds == EV.TRAFFIC).sum()),
            "tl_sdus": int((kinds == EV.TLSDU).sum()),
            "frag_ends": int((kinds == EV.FRAG_END).sum())}


def _timed(drive):
    """timed_passes over a zero-argument receiver pass."""
    def one_pass():
        mc = drive()
        return mc, None
    mc, _, dt = timed_passes(one_pass)
    return mc, dt


def run(n_car=1024, n_frames=8, n_chunks=4):
    """Timed end-to-end pass over per-carrier bits (process_bits, clean
    SYNC/SCH_F mix); returns the result dict."""
    bits = clean_bits(n_car, n_frames)
    T = bits.shape[1]
    mc, dt = _timed(lambda: drive_bits(bits, n_chunks))
    c = counts(mc)
    stream_s = T / BITRATE
    res = {"n_carriers": n_car, "bits_per_carrier": T, "chunks": n_chunks,
           "wall_s": dt, "stream_s": stream_s,
           "crc_ok": c["crc_ok"], "crc_err": c["crc_err"],
           "native_events": int(sum(len(e["kind"])
                                    for e in mc.native_events)),
           "realtime_carriers_e2e": n_car * stream_s / dt,
           "mbits_per_s": n_car * T / dt / 1e6}
    assert c["crc_ok"] > 0 and c["crc_err"] == 0, c
    return res


def mixed_batch(n_car, n_frames, enc_frac=0.1, seed=0):
    """[n_car, L] mixed-protocol bits; the last ceil(enc_frac * n_car)
    carriers run the TEA1-encrypted variant. Rows are padded to
    common_len(n_frames) with junction-checked noise BEFORE the
    per-carrier circular roll, so the roll never cuts a burst."""
    rng = np.random.default_rng(seed)
    plain = make_mixed_stream(rng, n_frames, encrypted=False)
    enc = make_mixed_stream(np.random.default_rng(seed + 1), n_frames,
                            encrypted=True)
    L = common_len(n_frames)
    len_nat = len(plain)
    plain = circular_safe_pad(plain, rng, L - len(plain))
    enc = circular_safe_pad(enc, np.random.default_rng(seed + 2),
                            L - len(enc))
    n_enc = max(1, int(round(n_car * enc_frac)))
    bits = np.empty((n_car, L), np.uint8)
    bits[: n_car - n_enc] = plain
    bits[n_car - n_enc:] = enc
    # LARGE per-carrier circular stagger — varies lock offsets AND
    # decorrelates carrier content, so the wideband composite sums
    # Gaussian instead of a Dirichlet pulse train (identical
    # time-aligned content on every channel has 25-sigma peaks that no
    # fixed-point capture format survives). Starts confined to the
    # screened noise window (safe_rolls) so no carrier cold-starts
    # mid-frame.
    rolls = safe_rolls(n_car, L, L - len_nat)
    for c in range(n_car):
        bits[c] = np.roll(bits[c], rolls[c])
    return bits, n_enc


def _protocol_result(n_car, n_enc, T, n_chunks, c, dt, extra=None):
    stream_s = T / BITRATE
    res = {"n_carriers": n_car, "n_encrypted": n_enc,
           "bits_per_carrier": T, "chunks": n_chunks,
           "wall_s": dt, "stream_s": stream_s, **c,
           "realtime_carriers_e2e": n_car * stream_s / dt,
           "mbits_per_s": n_car * T / dt / 1e6, **(extra or {})}
    assert c["crc_err"] == 0 and c["crc_ok"] > 0, c
    assert c["traffic_slots"] > 0 and c["frag_ends"] > 0, c
    assert c["tl_sdus"] > 0, c
    return res


def run_mixed(n_car=1024, n_frames=16, n_chunks=4, enc_frac=0.1):
    """Timed end-to-end pass over the FULL protocol mix (NDB/SCH_HD,
    stolen/STCH, traffic+voice, FRAG/END chains, mid-stream relocks,
    >=10% TEA1-encrypted carriers) as per-carrier bits through the
    native control plane."""
    bits, n_enc = mixed_batch(n_car, n_frames, enc_frac)
    ks = keystore_file()
    mc, dt = _timed(lambda: drive_bits(bits, n_chunks, keystore=ks))
    return _protocol_result(n_car, n_enc, bits.shape[1], n_chunks,
                            counts(mc), dt)


def run_wideband(n_car=1024, n_frames=16, n_chunks=4):
    """Timed end-to-end pass ingesting ONE companded 4+4-bit WIDEBAND
    capture of the clean SYNC/SCH_F mix, channelized on device by the
    PFB (reference whole-capture front end:
    src/demod/osmosdr-tetra_demod_fft.py:64-96)."""
    bits = clean_bits(n_car, n_frames)
    packed = wideband_capture(bits)
    mc, dt = _timed(lambda: drive_wideband(packed, n_car, n_chunks))
    c = counts(mc)
    stream_s = bits.shape[1] / BITRATE
    res = {"n_carriers": n_car, "bits_per_carrier": bits.shape[1],
           "wideband_samples": len(packed), "chunks": n_chunks,
           "wall_s": dt, "stream_s": stream_s,
           "crc_ok": c["crc_ok"], "crc_err": c["crc_err"],
           "h2d_bytes_per_carrier_s": len(packed) / stream_s / n_car,
           "realtime_carriers_e2e": n_car * stream_s / dt}
    assert c["crc_ok"] > 0 and c["crc_err"] == 0, c
    return res


def run_snr8(n_car=1024, n_frames=16, n_chunks=4, snr_db=8.0):
    """The run_wideband capture with AWGN at 8 dB per-channel SNR,
    decoded by the fastpath SOFT mode (int8 soft demod + soft Viterbi +
    2-bit-tolerant sync scan). The reference's feedback demod works on
    noisy RF as its only mode (src/demod/cqpsk.py:253-270); crc_ok is
    compared with the clean wideband stage's on the same capture."""
    bits = clean_bits(n_car, n_frames)
    packed = wideband_capture(bits, snr_db=snr_db)
    mc, dt = _timed(lambda: drive_wideband(packed, n_car, n_chunks,
                                           demod="soft"))
    c = counts(mc)
    stream_s = bits.shape[1] / BITRATE
    res = {"n_carriers": n_car, "bits_per_carrier": bits.shape[1],
           "snr_db": snr_db, "wall_s": dt, "stream_s": stream_s,
           "crc_ok": c["crc_ok"], "crc_err": c["crc_err"],
           "h2d_bytes_per_carrier_s": len(packed) / stream_s / n_car,
           "realtime_carriers_e2e": n_car * stream_s / dt}
    assert c["crc_ok"] > 0, c
    return res


def run_prod(n_car=1024, n_frames=16, n_chunks=4, enc_frac=0.1):
    """THE production configuration end to end: ONE companded 4+4-bit
    wideband RF capture carrying the FULL protocol mix — NDB/SCH_HD
    half-slot pairs, fully stolen STCH, traffic+voice, FRAG-START/
    MAC-END chains, frame-18 AACH windows, a forced mid-stream relock,
    >=10% TEA1-encrypted carriers — channelized on device through the
    PFB and decoded by the native control plane with hot-path
    decryption. Zero CRC errors required (reference analogue: one
    osmosdr demod + float_to_bits + tetra-rx process chain per carrier,
    src/demod/osmosdr-tetra_demod_fft.py:64-96 +
    src/receiver1udp:71-78)."""
    bits, n_enc = mixed_batch(n_car, n_frames, enc_frac)
    packed = wideband_capture(bits)
    ks = keystore_file()
    mc, dt = _timed(lambda: drive_wideband(packed, n_car, n_chunks,
                                           keystore=ks))
    stream_s = bits.shape[1] / BITRATE
    return _protocol_result(
        n_car, n_enc, bits.shape[1], n_chunks, counts(mc), dt,
        {"wideband_samples": len(packed),
         "h2d_bytes_per_carrier_s": len(packed) / stream_s / n_car})


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench_mc_e2e: needs an NVIDIA GPU; JAX found "
                 f"{jax.devices()[0].platform}")
    from tetra_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    n_car = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    n_frames = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    n_chunks = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    if len(sys.argv) > 4 and sys.argv[4] == "mixed":
        print(json.dumps({**run_mixed(n_car, n_frames, n_chunks),
                          "card": card_info()}))
        return
    print(json.dumps({**run(n_car, n_frames, n_chunks),
                      "card": card_info()}))


if __name__ == "__main__":
    main()
