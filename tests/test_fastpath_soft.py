"""Soft decisions through the SCALE path (fastpath soft mode).

The reference works at low SNR by design — its Costas + Mueller&Müller
feedback demodulator is its only mode (reference
src/demod/cqpsk.py:253-270). This rebuild's scale path gets there
differently: dqpsk.demodulate_soft_ri emits int8 per-bit reliabilities,
the fused chunk program gathers the soft window byte-granularly and
runs the soft Viterbi (lmac.fused decode_slots_fused soft_input), and
the sync scan tolerates 2 training-sequence bit errors
(burst.train_seq_match tol) so ~1e-2 hard BER doesn't break lock
maintenance. These tests pin: clean-capture equivalence with the hard
mode, full decode at 8 dB per-channel SNR where the hard mode loses
lock, and chunked==whole self-consistency on noisy input.
"""
import numpy as np
import pytest

from tetra_tpu.phy import channelizer, dqpsk
from tetra_tpu.rx_multi import MultiCarrierReceiver
from tests.test_rx_multi import _capture_bits

N_CHAN = 8
FS = N_CHAN * 25e3
CHANS = [1, 6]


def _wide_capture():
    bits_a = _capture_bits(262, 42, 1, 0x200, seed=1)
    bits_b = _capture_bits(901, 7, 5, 0x300, seed=2)
    n = min(len(bits_a), len(bits_b)) & ~1
    bits = np.stack([bits_a[:n], bits_b[:n]])
    base = dqpsk.modulate(bits, sps=2)
    return channelizer.synthesize_wideband_fft(base, CHANS, N_CHAN)


def _awgn_wide(wide, snr_db, n_act, seed=3):
    """AWGN at per-CHANNEL SNR snr_db: carrier power = total/active
    carriers, in-channel noise = full-band noise / N_CHAN."""
    rng = np.random.default_rng(seed)
    sig = np.mean(np.abs(wide) ** 2) / n_act
    npow = sig * N_CHAN / (10 ** (snr_db / 10))
    return (wide + rng.normal(0, np.sqrt(npow / 2), wide.shape)
            + 1j * rng.normal(0, np.sqrt(npow / 2), wide.shape)
            ).astype(np.complex64)


def _run(wide, demod, cuts=None):
    mrx = MultiCarrierReceiver([], fs=FS, pfb_channels=CHANS,
                               n_chan=N_CHAN, control_plane="native",
                               demod=demod)
    if cuts is None:
        mrx.process_iq(wide, final=True)
    else:
        edges = [0] + cuts + [len(wide)]
        for i in range(len(edges) - 1):
            mrx.process_iq(wide[edges[i]:edges[i + 1]],
                           final=i == len(edges) - 2)
    return mrx


def _ev(mrx):
    keys = ("kind", "carrier", "a", "b", "c", "d")
    return {k: np.concatenate([e[k] for e in mrx.native_events])
            for k in keys}


class TestSoftFastpath:
    def test_clean_capture_matches_hard_mode(self):
        """On a clean capture soft decisions have the same signs as
        hard slices, the tolerant scan finds the same (exact) training
        matches, and the native event stream is identical."""
        wide = _wide_capture()
        hard, soft = _run(wide, "hard"), _run(wide, "soft")
        eh, es = _ev(hard), _ev(soft)
        for k in eh:
            np.testing.assert_array_equal(eh[k], es[k], err_msg=k)
        for p, q in zip(hard.carriers, soft.carriers):
            assert (p.stats.crc_ok, p.stats.crc_wrong, p.stats.slots) \
                == (q.stats.crc_ok, q.stats.crc_wrong, q.stats.slots)
            assert p.stats.crc_ok > 0

    def test_8db_soft_full_decode_hard_loses_lock(self):
        """At 8 dB per-channel SNR the soft mode decodes the capture
        fully (soft Viterbi + tolerant sync) while the hard mode loses
        slots to training-sequence bit errors — the measured gap that
        motivates the mode (PARITY.md soft-decision floor)."""
        wide = _awgn_wide(_wide_capture(), 8.0, len(CHANS))
        clean = _run(_wide_capture(), "hard")
        soft = _run(wide, "soft")
        hard = _run(wide, "hard")
        n_soft = sum(r.stats.crc_ok for r in soft.carriers)
        n_hard = sum(r.stats.crc_ok for r in hard.carriers)
        n_clean = sum(r.stats.crc_ok for r in clean.carriers)
        assert n_soft == n_clean, (n_soft, n_clean)
        assert sum(r.stats.crc_wrong for r in soft.carriers) == 0
        assert n_soft > n_hard, (n_soft, n_hard)

    def test_soft_chunked_equals_whole(self):
        """Overlap-save streaming in soft mode: feeding the noisy
        capture in 3 arbitrary chunks produces the same native events
        as one call (the soft ring carry splices bit-exactly)."""
        wide = _awgn_wide(_wide_capture(), 9.0, len(CHANS), seed=5)
        whole = _run(wide, "soft")
        B = 25 * N_CHAN
        chunked = _run(wide, "soft", cuts=[7 * B, 13 * B + 41])
        ew, ec = _ev(whole), _ev(chunked)
        for k in ew:
            np.testing.assert_array_equal(ew[k], ec[k], err_msg=k)

    def test_hard_bits_through_soft_pipeline(self):
        """process_bits on a soft pipeline maps hard bits to
        full-confidence ±31 soft values — with the scan tolerance
        pinned to 0, decode is event-identical to the hard pipeline on
        ANY bit stream, even a deliberately corrupted one (the soft
        plumbing changes the FEC arithmetic, not the decisions). With
        the default tol=2, tolerance can only recover MORE slots on
        corrupted streams, never fewer CRC-OK blocks."""
        from tests.test_sync_vec import make_stream
        streams = [make_stream(4100 + b, n_frames=3) for b in range(4)]
        L = min(len(s) for s in streams)
        bits = np.stack([s[:L] for s in streams])

        def run_bits(demod, tol=None):
            m = MultiCarrierReceiver(np.zeros(4), fs=1e5,
                                     control_plane="native", demod=demod)
            if tol is not None:
                m._fast.tol = tol
            m.process_bits(bits, final=True)
            return m

        hard = run_bits("hard")
        soft0 = run_bits("soft", tol=0)
        eh, es = _ev(hard), _ev(soft0)
        for k in eh:
            np.testing.assert_array_equal(eh[k], es[k], err_msg=k)
        n_hard = sum(r.stats.crc_ok for r in hard.carriers)
        assert n_hard > 0
        soft2 = run_bits("soft")
        assert sum(r.stats.crc_ok for r in soft2.carriers) >= n_hard
