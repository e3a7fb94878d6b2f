"""Multi-carrier receiver: wideband IQ -> N decoded carrier streams.

The reference achieves multi-carrier operation with one OS process
chain per carrier glued by FIFOs/UDP (reference src/receiver1:8,
src/receiver1udp:71-78). Here the whole signal path runs as batched
device programs over the carrier axis:

  channelizer + DQPSK demod + slicer      [carriers, samples]  (device)
  lock state machines                     phy.sync_vec lax.scan (device)
  two-phase FEC decode                    ONE program per burst kind
                                          across ALL carriers  (device)
  upper MAC / LLC / MLE walk              host control plane

Two control planes:

* "python" walks each carrier's UpperMac per slot (full logging,
  decryption) — MultiSync + rx.decode_slots_multi + TetraReceiver.
* "native" routes the WHOLE chunk through tetra_tpu.fastpath: one
  fused device program (sync + FEC + packing, single fetched bundle)
  and one C++ executor call (native/umac_exec.cpp::tetra_umac_walk2)
  that owns the TDMA clock; per-chunk host work is a handful of numpy
  ops, flat in carrier count. Chunks are pipelined one deep: pass
  final=False while streaming and the fetch+walk of chunk k overlaps
  the device compute of chunk k+1.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from tetra_tpu.phy import channelizer, dqpsk
from tetra_tpu.phy.sync_vec import MultiSync
from tetra_tpu.rx import TetraReceiver, RxStats, decode_slots_multi

__all__ = ["MultiCarrierReceiver"]


@functools.lru_cache(maxsize=None)
def _pfb_demod_bits_len(n_samples: int, n_chan: int, fs: float,
                        sps: int) -> int:
    """Demod output bit count for an n_samples wideband feed through
    the PFB front end — jax.eval_shape only (no compile, no device
    work), so the fused native submit knows its static slice before
    dispatching anything."""
    import jax
    from tetra_tpu.phy import pfb as pfb_mod

    def f(re, im):
        cr, ci = pfb_mod.pfb_to_demod_rate_ri(
            re, im, jnp.zeros(1, jnp.int32), n_chan, fs)
        return dqpsk.demodulate_hard_ri(cr, ci, sps=sps, os=4)

    s = jax.ShapeDtypeStruct((n_samples,), jnp.float32)
    return int(jax.eval_shape(f, s, s).shape[-1])


@functools.lru_cache(maxsize=None)
def _mixer_demod_bits_len(n_samples: int, fs: float, sps: int) -> int:
    """Demod output bit count for an n_samples feed through the
    mixer-bank front end — jax.eval_shape only (no compile, no device
    work)."""
    import jax

    def f(re, im):
        cr, ci = channelizer.channelize_ri(
            re, im, jnp.zeros(1, jnp.float32), fs=fs)
        return dqpsk.demodulate_hard_ri(cr, ci, sps=sps, os=4)

    s = jax.ShapeDtypeStruct((n_samples,), jnp.float32)
    return int(jax.eval_shape(f, s, s).shape[-1])


class MultiCarrierReceiver:
    def __init__(self, offsets_hz, fs: float, sps: int = 2,
                 keystore_path: str | None = None,
                 dumpdir: str | None = None, log=None,
                 pfb_channels=None, n_chan: int | None = None,
                 control_plane: str = "python",
                 gsmtap_host: str | None = None,
                 decode_voice: bool = False,
                 tl_sdu_sink=None, mesh=None, demod: str = "hard"):
        self.offsets = np.asarray(offsets_hz, dtype=np.float32)
        self.fs = float(fs)
        self.sps = sps
        self.pfb_channels = (np.asarray(pfb_channels, np.int32)
                             if pfb_channels is not None else None)
        self.n_chan = n_chan if n_chan is not None else int(round(fs / 25_000.0))
        self.carriers = []
        n_carriers = (len(self.pfb_channels) if self.pfb_channels is not None
                      else len(self.offsets))
        for i in range(n_carriers):
            # `log` may be one callable shared by all carriers or a
            # per-carrier sequence of callables
            if log is None:
                carrier_log = lambda *a, **k: None
            elif isinstance(log, (list, tuple)):
                carrier_log = log[i]
            else:
                carrier_log = log
            self.carriers.append(TetraReceiver(
                keystore_path=keystore_path,
                dumpdir=f"{dumpdir}/carrier{i}" if dumpdir else None,
                # native mode exports GSMTAP from ONE shared sink fed by
                # the executor's events (below), not per-carrier sockets
                gsmtap_host=(gsmtap_host if control_plane == "python"
                             else None),
                decode_voice=decode_voice,
                log=carrier_log))
        # control plane: "python" walks each carrier's UpperMac (full
        # logging, decryption); "native" routes all carriers' decoded
        # blocks through ONE C++ executor call per chunk (structured
        # events instead of log lines; unencrypted fast path)
        assert control_plane in ("python", "native")
        assert demod == "hard" or control_plane == "native", \
            "soft demod rides the fastpath (native control plane)"
        self.control_plane = control_plane
        # generic TL-SDU egress (the SDS/data sink surface):
        # fn(carrier, pdisc, pdut, sdu_ubits) for every TL-SDU, from
        # either plane. SNDCP IP payloads additionally go to tun0 via
        # each carrier's _ip_out (reference tetra_llc.c:81-107).
        self.tl_sdu_sink = tl_sdu_sink
        if tl_sdu_sink is not None and control_plane == "python":
            from tetra_tpu.utils.bits import bits_to_uint
            for ci, rx in enumerate(self.carriers):
                # the sink is ADDITIVE: TetraReceiver wired tl_sdu_cb to
                # mle.rx_tl_sdu (MLE/CMCE/SNDCP parse + reference log
                # lines) — chain it so both planes keep full L3 parsing
                def cb(bits, n, _c=ci, _prev=rx.llc.tl_sdu_cb):
                    if _prev is not None:
                        _prev(bits, n)
                    b = np.asarray(bits)[:n]
                    pdisc = int(bits_to_uint(b[:3]))
                    w = {1: 4, 2: 5, 4: 4, 5: 3}.get(pdisc)
                    pdut = (-1 if w is None
                            else int(bits_to_uint(b[3:3 + w])))
                    self.tl_sdu_sink(_c, pdisc, pdut, b)
                rx.llc.tl_sdu_cb = cb
        self.native_cp = None
        self.gsmtap = None
        self.native_events = []   # accumulated event dicts (native mode)
        if control_plane == "native":
            from tetra_tpu.umac.native_exec import NativeControlPlane
            from tetra_tpu.fastpath import FastChunkPipeline
            self.native_cp = NativeControlPlane(n_carriers)
            if keystore_path:
                from tetra_tpu.crypto.crypto import load_keystore
                self.native_cp.set_keys(load_keystore(keystore_path))
            self.gsmtap = None
            if gsmtap_host:
                from tetra_tpu.io.gsmtap import GsmtapSink
                self.gsmtap = GsmtapSink(gsmtap_host)
                self.native_cp.set_gsmtap(True)
            # mesh: carrier-shard the fused chunk program over a device
            # mesh (fastpath._sharded_fused_chunk) — bit-identical
            # events, per-shard row budgets.
            # demod="soft": degraded-signal mode — the wideband front
            # end demodulates to int8 reliabilities, the fused chunk
            # program runs the soft Viterbi (~2 dB over hard slicing)
            # and the sync scan tolerates 2 training-sequence bit
            # errors (the reference's Costas/M&M feedback demod is its
            # only low-SNR mode, src/demod/cqpsk.py:253-270; here the
            # scale path itself degrades gracefully)
            assert demod in ("hard", "soft")
            self._fast = FastChunkPipeline(n_carriers, mesh=mesh,
                                           soft=demod == "soft")
            self._pending = []
            # chunks kept in flight while streaming (final=False):
            # depth 1 overlaps chunk k's fetch+walk with chunk k+1's
            # device compute; depth 2 also hides the host walk behind
            # the NEXT upload on transfer-bound configs (+11% on the
            # prod wideband stage, identical decode) — stats are
            # complete once a final=True call drains the queue
            self.pipeline_depth = 2
        else:
            self.sync = MultiSync(n_carriers)
            self._buf = np.zeros((n_carriers, 0), dtype=np.uint8)
            self._buf_base = 0

    def process_iq(self, wideband_iq, final: bool = True) -> list[RxStats]:
        """One chunk of wideband complex samples through the full chain.

        Uses the mixer-bank channelizer by default; constructing with
        `pfb_channels` routes through the 2x-oversampled polyphase
        filterbank instead (O(T·taps) + one DFT instead of O(C·T)).
        """
        wideband_iq = np.asarray(wideband_iq).astype(np.complex64)
        # interleaved float32 planes: the device side is planar re/im
        raw = np.ascontiguousarray(wideband_iq).view(np.float32)
        # the PFB path streams through the hop-aligned overlap-save (a
        # stateless per-chunk call would discard the filter state and
        # cost every carrier a relock per chunk boundary); the
        # mixer-bank path keeps stateless per-call behaviour
        return self._wideband_stream(raw, 2, "f32i", final)

    def process_iq8(self, iq8, final: bool = True) -> list[RxStats]:
        """One chunk of interleaved int8 wideband IQ ([I0, Q0, I1, Q1,
        ...], TWO bytes per complex sample) through the full chain.

        ~37 dB per-channel SNR at a 6-sigma backoff at any occupancy;
        use the half-the-bytes `process_iq4c` companded format when the
        h2d link, not fidelity, bounds carrier count."""
        return self._wideband_stream(np.asarray(iq8, np.int8), 2, "iq8",
                                     final)

    def process_iq4c(self, packed_u8, final: bool = True) -> list[RxStats]:
        """One chunk of COMPANDED 4+4-bit wideband IQ (io.stream
        quantize_iq4c: Lloyd-Max Gaussian levels, ONE byte per complex
        sample) through the full chain.

        The production wideband ingest format: 25 kB/s-carrier on the
        h2d link at ANY occupancy — unlike the uniform-grid iq4 format,
        whose 15 linear levels clip the Gaussian composite above ~128
        active channels, the companded grid holds ~20 dB per-channel
        SNR at full load (~10 dB over the hard-decision CRC floor)."""
        return self._wideband_stream(np.asarray(packed_u8, np.uint8), 1,
                                     "iq4c", final)

    def process_iq4(self, packed_u8, final: bool = True) -> list[RxStats]:
        """One chunk of packed 4+4-bit wideband IQ (io.stream
        quantize_iq4 format, ONE byte per complex sample) through the
        full chain: dequantize, channelize and demodulate on device.

        The h2d link carries 1 byte per wideband sample — with N
        carriers at 25 kHz spacing that is 25 kB/s per carrier, vs 72
        (planar int8 sps=2 IQ) or 36 (packed 4-bit per-carrier IQ) for
        the per-carrier ingest formats. The 15 LINEAR levels suit up to
        ~128 active channels; fully-loaded spans should use the
        companded `process_iq4c` (same byte rate) or `process_iq8`."""
        return self._wideband_stream(np.asarray(packed_u8, np.uint8), 1,
                                     "iq4", final)

    def _demod_ri(self, re, im, base: int = 0) -> np.ndarray:
        if self.pfb_channels is not None:
            from tetra_tpu.phy import pfb
            out_r, out_i = pfb.pfb_to_demod_rate_ri(
                re, im, jnp.asarray(self.pfb_channels), self.n_chan,
                self.fs)
        else:
            out_r, out_i = channelizer.channelize_ri(
                re, im, jnp.asarray(self.offsets), fs=self.fs,
                base=np.int32(base))
        # stays DEVICE-resident: the native fastpath packs on device,
        # so the demod -> decode handoff never crosses the link.
        # os=4 fractional timing: upstream resampling leaves the symbol
        # clock at an arbitrary sub-sample offset (see fastpath notes)
        return dqpsk.demodulate_hard_ri(out_r, out_i, sps=self.sps, os=4)

    def _wideband_stream(self, raw, k: int, fmt: str, final: bool):
        """Overlap-save streaming for the PFB front end: chunk
        boundaries would otherwise discard the channelizer/resampler/
        demod filter state and cost every carrier ~a slot per chunk
        (lock loss + re-acquisition).

        Each continuation call re-feeds the last W raw samples; chunks
        are consumed in BLOCK-aligned quanta (BLOCK = 25*n_chan
        samples = 50 PFB hops = exactly 36 demod bits per carrier at
        the 50k->36k resampler's 18/25 phase period), so the valid
        region of the per-call output equals the continuous stream's
        bits; bit counts come from jax.eval_shape (no device work).
        raw: 1-D array with k elements per complex sample, in wideband
        format `fmt` (fastpath._iq_to_ri).

        On the native plane the ENTIRE per-chunk pipeline — dequantize,
        PFB, resample, demod, sync, FEC, packing — dispatches as ONE
        device program (fastpath.submit_iq): one upload, one dispatch,
        one fetched bundle per chunk. The python plane demods on device
        and walks host-side. The mixer-bank path (offsets without
        pfb_channels) keeps the stateless per-call behaviour."""
        from tetra_tpu.fastpath import _iq_to_ri
        if self.pfb_channels is None:
            return self._mixer_stream(raw, k, fmt, final)
        n = self.n_chan
        BLOCK = 25 * n
        W = 2 * BLOCK
        if not hasattr(self, "_wb_rem"):
            self._wb_rem = raw[:0]
            self._wb_hist = None
        data = np.concatenate([self._wb_rem, raw])
        total = len(data) // k
        usable = (total // BLOCK) * BLOCK
        if final:
            usable = total
        if usable == 0 or (self._wb_hist is None and usable < W
                           and not final):
            # not enough for the first aligned batch yet: stash
            self._wb_rem = data
            if final:
                self._reset_wb_stream()
                return self.process_bits(
                    np.zeros((len(self.carriers), 0), np.uint8),
                    final=True)
            return [rx.stats for rx in self.carriers]
        self._wb_rem = data[usable * k:]
        chunk = data[: usable * k]
        first = self._wb_hist is None
        feed = chunk if first else np.concatenate([self._wb_hist, chunk])
        nbits = _pfb_demod_bits_len(len(feed) // k, n, self.fs, self.sps)
        keep = nbits if first else max(nbits - self._wb_g, 0)
        if first and usable % BLOCK == 0:
            # bits(L) is affine on BLOCK-aligned lengths with slope
            # 36/BLOCK, so the first call yields G(W) — the exact
            # per-carrier bit count every continuation must drop —
            # with no probe run: G(W) = L0 - 36*(usable0 - W)/BLOCK
            self._wb_g = nbits - 36 * (usable // BLOCK - 2)
        hist_src = chunk if len(chunk) >= W * k else feed
        self._wb_hist = hist_src[-W * k:]
        if final:
            # each stream restarts cleanly: a one-shot final call with a
            # non-BLOCK-aligned length would otherwise leave _wb_hist
            # set without _wb_g, and any post-final continuation would
            # splice with a misaligned hop/resampler phase
            self._reset_wb_stream()
        if self.control_plane == "native":
            self._prefetch_pending()
            if not hasattr(self, "_chan_idx_d"):
                self._chan_idx_d = jnp.asarray(self.pfb_channels)
            h = self._fast.submit_iq(feed, fmt, keep, self._chan_idx_d,
                                     n, self.fs, sps=self.sps)
            return self._native_drain(h, final)
        bits = self._demod_ri(*_iq_to_ri(fmt, jnp.asarray(feed)))
        bits = np.asarray(bits, np.uint8)[:, bits.shape[1] - keep:]
        return self.process_bits(bits, final=final)

    def _reset_wb_stream(self):
        self._wb_hist = None
        self._wb_rem = self._wb_rem[:0]
        if hasattr(self, "_wb_g"):
            del self._wb_g

    def _mixer_stream(self, raw, k: int, fmt: str, final: bool):
        """Overlap-save streaming for the MIXER-BANK fallback (carriers
        at arbitrary off-grid offsets; reference xlating FIR front end:
        src/demod/osmosdr-tetra_demod_fft.py:74-80).

        Same structure as the PFB branch: continuation calls re-feed
        the last W raw samples and drop the re-derived bits; chunks are
        consumed in BLOCK-aligned quanta (BLOCK = whole fs/36k
        resampler periods, sized to dominate the 127-tap channel FIR +
        resampler + RRC memories, with an even number of demod bits
        per block). The oscillator bank evaluates at ABSOLUTE sample
        indices (channelize_ri base=), so a chunked stream produces
        bit-identical output to a whole-capture run — previously this
        path was stateless per call and cost every carrier ~a slot of
        relock per chunk boundary. Rates whose fs/36k ratio is not
        rational with a small denominator keep the old stateless
        behaviour (none of the common SDR rates are affected)."""
        from tetra_tpu.fastpath import _iq_to_ri
        from tetra_tpu.phy.channelizer import _rational_ratio
        lm = _rational_ratio(self.fs, channelizer.DEMOD_RATE)
        if lm is None:
            if len(raw) == 0:
                return self.process_bits(
                    np.zeros((len(self.carriers), 0), np.uint8),
                    final=final)
            re, im = _iq_to_ri(fmt, jnp.asarray(raw))
            return self.process_bits(self._demod_ri(re, im), final=final)
        L_, M_ = lm
        BLOCK = L_ * max(1, -(-2048 // L_))
        if ((BLOCK // L_) * M_) % 2:
            BLOCK *= 2
        W = 2 * BLOCK
        if not hasattr(self, "_mx_rem"):
            self._mx_rem = raw[:0]
            self._mx_hist = None
            self._mx_pos = 0      # abs sample index of the consumed head
        data = np.concatenate([self._mx_rem, raw])
        total = len(data) // k
        usable = (total // BLOCK) * BLOCK
        if final:
            usable = total
        if usable == 0 or (self._mx_hist is None and usable < W
                           and not final):
            self._mx_rem = data
            if final:
                self._reset_mx_stream()
                return self.process_bits(
                    np.zeros((len(self.carriers), 0), np.uint8),
                    final=True)
            return [rx.stats for rx in self.carriers]
        self._mx_rem = data[usable * k:]
        chunk = data[: usable * k]
        first = self._mx_hist is None
        feed = chunk if first else np.concatenate([self._mx_hist, chunk])
        base = self._mx_pos - (0 if first else W)
        nbits = _mixer_demod_bits_len(len(feed) // k, self.fs, self.sps)
        keep = nbits if first else max(nbits - self._mx_g, 0)
        if first and usable % BLOCK == 0:
            # bits(L) is affine on BLOCK-aligned lengths with slope
            # bpb/BLOCK, so the first call yields G(W) — the exact
            # per-carrier bit count every continuation must drop
            bpb = (BLOCK // L_) * M_
            self._mx_g = nbits - bpb * (usable // BLOCK - 2)
        hist_src = chunk if len(chunk) >= W * k else feed
        self._mx_hist = hist_src[-W * k:]
        self._mx_pos += usable
        if final:
            self._reset_mx_stream()
        bits = self._demod_ri(*_iq_to_ri(fmt, jnp.asarray(feed)),
                              base=base)
        bits = bits[:, bits.shape[1] - keep:]
        return self.process_bits(bits, final=final)

    def _reset_mx_stream(self):
        self._mx_hist = None
        self._mx_rem = self._mx_rem[:0]
        self._mx_pos = 0
        if hasattr(self, "_mx_g"):
            del self._mx_g

    def process_bits(self, bits, final: bool = True) -> list[RxStats]:
        """Per-carrier hard bits [C, T] -> per-carrier decode stats.

        final=False keeps one chunk in flight (native plane): the
        fetch + control-plane walk of this chunk happens during the
        NEXT call's device compute. Stats are complete once a
        final=True call (the default) drains the pipeline.
        """
        import jax
        if not isinstance(bits, jax.Array):
            bits = np.asarray(bits, dtype=np.uint8)
        assert bits.ndim == 2 and bits.shape[0] == len(self.carriers)
        if self.control_plane == "native":
            self._prefetch_pending()
            return self._native_drain(self._fast.submit(bits), final)
        if isinstance(bits, jax.Array):
            bits = np.asarray(bits, np.uint8)   # host walk needs numpy
        return self._process_bits_python(bits)

    def _prefetch_pending(self):
        """Start the pending bundle's d2h copy while this chunk's
        host-side packing runs."""
        if self._pending:
            try:
                self._pending[0].bundle.copy_to_host_async()
            except Exception:
                pass

    def _native_drain(self, h, final: bool) -> list[RxStats]:
        """Queue one dispatched chunk handle and drain the pipeline to
        depth one (or fully, when final)."""
        if h is not None:
            self._pending.append(h)
        while self._pending and (final
                                 or len(self._pending) > self.pipeline_depth):
            self._collect_walk(self._pending.pop(0))
        return [rx.stats for rx in self.carriers]

    def _process_bits_python(self, bits) -> list[RxStats]:
        """Python control plane: all carriers synchronise in one device
        scan (phy.sync_vec) and FEC-decode in one device program per
        burst kind; the byte-scale upper-MAC walk runs per carrier."""
        self._buf = np.concatenate([self._buf, bits & 1], axis=1)

        slots_abs, events_abs = self.sync.scan(self._buf,
                                               base_offset=self._buf_base)
        # rebase to buffer-relative offsets for slicing/decoding
        base = self._buf_base
        slots_rel, events_rel = [], []
        for sl, ev in zip(slots_abs, events_abs):
            for s in sl:
                s.offset -= base
            for e in ev:
                e.offset -= base
            slots_rel.append(sl)
            events_rel.append(ev)

        decoded = decode_slots_multi([self._buf[c] for c in
                                      range(len(self.carriers))],
                                     slots_rel,
                                     [rx.scramb_init for rx in self.carriers])
        for c, rx in enumerate(self.carriers):
            rx._ev_ptr = 0
            for s, d in zip(slots_rel[c], decoded[c]):
                rx._flush_events(events_rel[c], s.seq)
                rx._walk_slot(d)
            rx._flush_events(events_rel[c], 1 << 62)

        keep = max(self._buf_base, self.sync.min_buf_start())
        if keep > self._buf_base:
            self._buf = self._buf[:, keep - self._buf_base:]
            self._buf_base = keep
        return [rx.stats for rx in self.carriers]

    # walk2 packed-row geometry (rx.py _PACK_* layout; see
    # native/umac_exec.cpp ROW_STRIDE constants)
    _GT_LEN_A = {0: 60, 1: 268, 2: 124}
    _GT_LEN_B = {0: 124, 1: 0, 2: 124}

    def _export_gsmtap(self, evd, d):
        """Turn EV.GSMTAP events (one per CRC-OK TMV dispatch, emitted
        by the C++ walk; reference hook tetra_upper_mac.c:483-488) into
        UDP packets: same bits, lchan, TDMA time and timeslot as the
        Python plane's per-PDU export."""
        from tetra_tpu.umac.native_exec import EV
        from tetra_tpu.tdma import TdmaTime
        gt = np.flatnonzero(evd["kind"] == EV.GSMTAP)
        for i in gt:
            row = int(evd["a"][i])
            lchan = int(evd["b"][i])
            c = int(evd["c"][i])
            off = int(evd["d"][i])
            blk = (c >> 20) & 0xF
            t = TdmaTime(tn=(c >> 16) & 0xF, fn=(c >> 8) & 0xFF,
                         mn=c & 0xFF)
            kind = int(d["kind"][row])
            # section by dispatch identity: AACH rides the BBK bits;
            # blk_num 2 is the second half-slot block; everything else
            # (SB1, SCH/F, NDB1 — blk_num 1 or 0) is block A
            if lchan == 8:                     # AACH -> BBK
                sec = d["payload"][row][392:406]
            elif blk == 2:
                sec = d["payload"][row][268: 268 + self._GT_LEN_B[kind]]
            else:
                sec = d["payload"][row][: self._GT_LEN_A[kind]]
            self.gsmtap.send(t, lchan, t.tn - 1, sec[off:])

    def _collect_walk(self, h):
        """Fetch one dispatched chunk and run the native control plane:
        numpy record assembly (no per-slot Python) + ONE C++ walk that
        advances the TDMA clocks and applies SYNC side effects.

        On a multi-process mesh each process decodes ONLY its own
        carrier shards (fastpath.collect_local) and walks those — the
        carrier axis is embarrassingly parallel, the reference's own
        scaling model (one OS process chain per carrier,
        src/receiver1:8). side_carrier maps the local per-carrier side
        rows to global carrier ids (identity when unsharded)."""
        from tetra_tpu.umac.native_exec import EV
        d = (self._fast.collect_local(h) if self._fast.multiproc
             else self._fast.collect(h))
        n = len(d["carrier"])
        recs = np.column_stack([
            d["carrier"], d["kind"], d["okA"], d["okB"], d["delta"],
            np.arange(n, dtype=np.int32), d["slot_ref"]])
        evd = self.native_cp.walk2(d["payload"].reshape(-1), recs,
                                   d["tail"])
        self.native_events.append(evd)

        B = len(self.carriers)
        side_car = np.asarray(d["side_carrier"], np.int64)
        adv_all = (np.bincount(d["carrier"], weights=d["delta"],
                               minlength=B).astype(np.int64))
        kinds = evd["kind"]
        cars = evd["carrier"]
        crc = kinds == EV.CRC
        ok_c = np.bincount(cars[crc & (evd["b"] == 1)], minlength=B)
        wr_c = np.bincount(cars[crc & (evd["b"] == 0)], minlength=B)
        states = self.native_cp.get_states()
        scr = d["scramb"]
        for i, c in enumerate(side_car):
            c = int(c)
            rx = self.carriers[c]
            adv = adv_all[c] + int(d["tail"][i])
            if adv:
                rx.stats.bursts += int(adv)
                rx.stats.slots += int(adv)
            rx.stats.crc_ok += int(ok_c[c])
            rx.stats.crc_wrong += int(wr_c[c])
            rx.time.tn, rx.time.fn, rx.time.mn = (int(states[c, 0]),
                                                  int(states[c, 1]),
                                                  int(states[c, 2]))
            rx.colour_code, rx.mcc, rx.mnc = (int(states[c, 3]),
                                              int(states[c, 4]),
                                              int(states[c, 5]))
            rx.scramb_init = int(scr[i])

        if self.gsmtap is not None:
            self._export_gsmtap(evd, d)

        # TL-SDU payload egress from the event arena: defrag-
        # reassembled SNDCP IP payloads to tun0 (matching the Python
        # plane's _defrag_out -> ip_cb path and the reference's
        # tetra_llc.c:93-101 TUN write), every TL-SDU to the generic
        # sink when one is registered
        arena = evd.get("payload")
        if arena is not None and len(arena):
            from tetra_tpu.utils.bits import pack_bits
            # without a registered sink only defrag-reassembled rows
            # (the TUN candidates) need the per-row Python walk
            dd = evd["d"]
            tl_mask = (kinds == EV.TLSDU) & (dd >= 0)
            if self.tl_sdu_sink is None:
                tl_mask &= (dd & 1) == 1
            for i in np.flatnonzero(tl_mask):
                ref = int(evd["d"][i])
                nbits = int(evd["c"][i])
                sdu = arena[ref >> 1: (ref >> 1) + nbits]
                if (ref & 1) and nbits > 19:
                    payload = sdu[19:]   # strip SNDCP header bits
                    self.carriers[cars[i]]._ip_out(
                        pack_bits(payload[: (len(payload) // 8) * 8]))
                if self.tl_sdu_sink is not None:
                    self.tl_sdu_sink(int(cars[i]), int(evd["a"][i]),
                                     int(evd["b"][i]), sdu)

        tr = np.flatnonzero(kinds == EV.TRAFFIC)
        # the traffic routing only feeds dump files / voice decode;
        # without a dump dir the gathers and the per-slot walk are
        # pure overhead (rx._dump_traffic would return immediately).
        # Multi-process meshes skip it: slot_refs index the GLOBAL t4
        # arrays, and a cross-process gather would need an allgather
        # (voice dumping is a single-host concern)
        if (len(tr) and self.carriers and self.carriers[0].dumpdir
                and not self._fast.multiproc):
            # ONE batched device gather for exactly the traffic slots'
            # t4 payloads (full slot for SCH/F, blk2 for NDB stealing)
            refs = evd["a"][tr]
            ndb = evd["b"][tr]
            rows_f = refs[ndb == 0]
            rows_2 = refs[ndb == 1]
            got_f = (np.asarray(jnp.take(h.t4_full, jnp.asarray(rows_f),
                                         axis=0)) if len(rows_f) else None)
            got_2 = (np.asarray(jnp.take(h.t4_b2, jnp.asarray(rows_2),
                                         axis=0)) if len(rows_2) else None)
            nf = n2 = 0
            for i in tr:
                rx = self.carriers[cars[i]]
                if evd["b"][i] == 0:
                    t4 = got_f[nf]
                    nf += 1
                else:
                    t4 = got_2[n2]
                    n2 += 1
                # d packs (voice keystream arena ref + 1) << 8 | tn;
                # the walk generated the 274 keystream ubits at slot
                # time when a cipher key was selected
                dd = int(evd["d"][i])
                vref = dd >> 8
                ks = (arena[vref - 1: vref - 1 + 274] if vref else None)
                rx._dump_traffic(t4, usage=int(evd["c"][i]),
                                 tsn=(dd & 0xFF) - 1, ssi=0,
                                 voice_ks=ks)
