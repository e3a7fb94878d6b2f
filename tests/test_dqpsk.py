"""pi/4-DQPSK modem + slicer tests."""
import numpy as np
import jax.numpy as jnp

from tetra_tpu.phy import dqpsk


class TestSlicer:
    def test_float_to_bits_map(self):
        # thresholds from reference float_to_bits.c:33-72
        syms = np.array([1.0, 3.0, -1.0, -3.0, 0.5, 2.5, -0.5, -2.5])
        bits = np.asarray(dqpsk.float_to_bits(jnp.asarray(syms)))
        expect = [0, 0, 0, 1, 1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1]
        assert bits.tolist() == expect

    def test_host_slicer_matches_device(self):
        rng = np.random.default_rng(0)
        syms = rng.uniform(-4, 4, size=256).astype(np.float32)
        host = dqpsk.phase_to_bits(syms)
        dev = np.asarray(dqpsk.float_to_bits(jnp.asarray(syms)))
        np.testing.assert_array_equal(host, dev)

    def test_afc_removes_dc_offset(self):
        rng = np.random.default_rng(1)
        bits = rng.integers(0, 2, size=2 * 4000).astype(np.int8)
        syms = dqpsk.bits_to_phase(bits).astype(np.float32)
        drifted = syms + 0.4
        out = dqpsk.phase_to_bits(drifted, afc=True, filter_val=0.01)
        # after the filter settles, bits decode correctly
        assert np.array_equal(out[2000:], bits[2000:])


class TestModem:
    def test_mod_demod_roundtrip(self):
        rng = np.random.default_rng(2)
        bits = rng.integers(0, 2, size=(3, 2 * 600)).astype(np.int8)
        iq = dqpsk.modulate(bits, sps=2)
        syms = np.asarray(dqpsk.demodulate(jnp.asarray(iq), sps=2))
        out = np.asarray(dqpsk.float_to_bits(jnp.asarray(syms)))
        # ignore filter edge transients (RRC group delay ~ 11 symbols)
        margin = 2 * 16
        assert out.shape == bits.shape
        np.testing.assert_array_equal(out[:, margin:-margin], bits[:, margin:-margin])

    def test_demod_with_noise(self):
        rng = np.random.default_rng(3)
        bits = rng.integers(0, 2, size=2 * 600).astype(np.int8)
        iq = dqpsk.modulate(bits, sps=2)
        iq = iq + (rng.normal(0, 0.05, iq.shape) + 1j * rng.normal(0, 0.05, iq.shape)).astype(np.complex64)
        syms = np.asarray(dqpsk.demodulate(jnp.asarray(iq), sps=2))
        out = np.asarray(dqpsk.float_to_bits(jnp.asarray(syms)))
        margin = 2 * 16
        errs = np.sum(out[margin:-margin] != bits[margin:-margin])
        assert errs == 0

    def test_demod_with_cfo(self):
        """Small carrier-frequency offset is absorbed by the coarse CFO
        estimator (replacing the reference's Costas loop)."""
        rng = np.random.default_rng(4)
        bits = rng.integers(0, 2, size=2 * 600).astype(np.int8)
        iq = dqpsk.modulate(bits, sps=2)
        t = np.arange(iq.shape[-1])
        cfo = np.exp(1j * 2 * np.pi * 0.002 * t).astype(np.complex64)
        syms = np.asarray(dqpsk.demodulate(jnp.asarray(iq * cfo), sps=2))
        out = np.asarray(dqpsk.float_to_bits(jnp.asarray(syms)))
        margin = 2 * 16
        errs = np.sum(out[margin:-margin] != bits[margin:-margin])
        assert errs == 0


class TestHardDemod:
    def test_fast_equals_slicer_path(self):
        """Trig-free hard-decision demod must produce identical bits to
        angle + float_to_bits (except the first, zero-lag edge dibit)."""
        import jax.numpy as jnp
        rng = np.random.default_rng(10)
        bits = rng.integers(0, 2, (3, 2 * 500)).astype(np.int8)
        iq = dqpsk.modulate(bits, sps=2)
        iq = iq + (rng.normal(0, 0.08, iq.shape)
                   + 1j * rng.normal(0, 0.08, iq.shape)).astype(np.complex64)
        re = jnp.asarray(np.real(iq).astype(np.float32))
        im = jnp.asarray(np.imag(iq).astype(np.float32))
        slow = np.asarray(dqpsk.float_to_bits(
            dqpsk.demodulate_ri(re, im, est_cfo=False)))
        fast = np.asarray(dqpsk.demodulate_hard_ri(re, im))
        np.testing.assert_array_equal(fast[:, 2:], slow[:, 2:])


def _signal(rng, C, n_sym, snr_db=None, delay=0):
    bits = rng.integers(0, 2, size=(C, 2 * n_sym)).astype(np.int8)
    iq = dqpsk.modulate(bits, sps=2)
    if snr_db is not None:
        p = np.mean(np.abs(iq) ** 2)
        sigma = np.sqrt(p / (2 * 10 ** (snr_db / 10.0)))
        iq = iq + sigma * (rng.standard_normal(iq.shape)
                           + 1j * rng.standard_normal(iq.shape))
    iq = np.pad(iq, ((0, 0), (delay, 0)))[:, :iq.shape[1]]
    return (jnp.asarray(np.real(iq), jnp.float32),
            jnp.asarray(np.imag(iq), jnp.float32), bits)


class TestHardDemodCases:
    """demodulate_hard_ri (the XLA demod every device path runs) against
    the angle + slicer path, over the cases the fused demod kernel was
    once pinned on."""

    def _both(self, re, im):
        fast = np.asarray(dqpsk.demodulate_hard_ri(re, im))
        slow = np.asarray(dqpsk.float_to_bits(
            dqpsk.demodulate_ri(re, im, est_cfo=False)))
        return fast[:, 2:], slow[:, 2:]

    def test_clean(self):
        re, im, bits = _signal(np.random.default_rng(11), C=5, n_sym=700)
        fast, slow = self._both(re, im)
        np.testing.assert_array_equal(fast, slow)
        # and the decisions are the transmitted bits past the filter edge
        np.testing.assert_array_equal(fast[:, 30:-32], bits[:, 32:-32])

    def test_noisy_8db(self):
        """At 8 dB both see the same noise; decisions differ only where
        a symbol sits on a slicing boundary."""
        re, im, _ = _signal(np.random.default_rng(12), C=3, n_sym=600,
                            snr_db=8.0)
        fast, slow = self._both(re, im)
        assert np.mean(fast != slow) < 1e-3

    def test_timing_phase_offset(self):
        """A one-sample delay moves the optimum sampling instant to the
        other phase; both demods must track it identically."""
        re, im, _ = _signal(np.random.default_rng(13), C=4, n_sym=500,
                            delay=1)
        fast, slow = self._both(re, im)
        np.testing.assert_array_equal(fast, slow)

    def test_ragged_length(self):
        """Odd carrier counts and lengths off every block size."""
        re, im, _ = _signal(np.random.default_rng(14), C=7, n_sym=301)
        fast, slow = self._both(re, im)
        assert fast.shape == (7, 600)
        np.testing.assert_array_equal(fast, slow)

    def test_slot_framing(self):
        """locked_step_ri(fast=True) frames slots exactly as slicing the
        demodulated stream at phase_bit and reshaping into slots."""
        from tetra_tpu.lmac import steady
        n_slots, phase_bit = 3, 64
        re, im, _ = _signal(np.random.default_rng(16), C=5,
                            n_sym=(phase_bit + n_slots * 510) // 2 + 40)
        stream = np.asarray(dqpsk.demodulate_hard_ri(re, im))
        out = steady.locked_step_ri(re, im, jnp.zeros(5, jnp.uint32),
                                    phase_bit=phase_bit, n_slots=n_slots,
                                    decoders=("fused",))
        np.testing.assert_array_equal(np.asarray(out["bits"]),
                                      stream[:, phase_bit:])
