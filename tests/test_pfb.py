"""PFB channelizer: tone separation + full DQPSK roundtrip per channel."""
import numpy as np
import jax.numpy as jnp
import pytest

from tetra_tpu.phy import pfb, dqpsk


class TestPfb:
    def test_tone_lands_in_its_channel(self):
        n_chan = 16
        fs = n_chan * 25_000.0
        T = n_chan * 512
        t = np.arange(T) / fs
        for c in (1, 5, n_chan - 2):
            tone = np.exp(2j * np.pi * (c * fs / n_chan) * t).astype(np.complex64)
            cr, ci = pfb.pfb_channelize_ri(
                jnp.asarray(np.real(tone).astype(np.float32)),
                jnp.asarray(np.imag(tone).astype(np.float32)), n_chan)
            power = np.asarray(cr) ** 2 + np.asarray(ci) ** 2
            # steady-state region (skip filter warmup)
            p = power[:, 32:].mean(axis=1)
            assert p.argmax() == c
            # adjacent-channel rejection > 20 dB
            others = np.delete(p, c)
            assert p[c] > 100 * others.max()

    def test_dqpsk_roundtrip_through_pfb(self):
        """Modulated carriers on channel centres -> PFB -> resample ->
        demod -> exact bits."""
        n_chan = 8
        fs = n_chan * 25_000.0
        rng = np.random.default_rng(0)
        nsym = 600
        chans = [1, 3, 6]
        bits = rng.integers(0, 2, size=(len(chans), 2 * nsym)).astype(np.int8)
        base = dqpsk.modulate(bits, sps=2)          # [Csel, n*2] @36k
        # upsample each to fs and mix to its channel centre
        from tetra_tpu.phy.channelizer import synthesize_wideband
        offsets = np.array([c * fs / n_chan for c in chans], np.float32)
        # represent >Nyquist/2 channels as their aliases
        offsets = np.where(offsets > fs / 2, offsets - fs, offsets)
        wide = synthesize_wideband(base, offsets, fs=fs)

        out_r, out_i = pfb.pfb_to_demod_rate_ri(
            jnp.asarray(np.real(wide).astype(np.float32)),
            jnp.asarray(np.imag(wide).astype(np.float32)),
            jnp.asarray(np.array(chans, np.int32)), n_chan, fs)
        syms = dqpsk.demodulate_ri(out_r, out_i, sps=2, est_cfo=True)
        out = np.asarray(dqpsk.float_to_bits(syms))
        margin = 2 * 40
        n = min(out.shape[-1], bits.shape[-1]) - margin
        errs = (out[:, margin:n] != bits[:, margin:n]).mean()
        assert errs == 0.0, f"bit error rate {errs}"


def _wola_reference(x, n_chan, taps_per_branch=16):
    """float64 numpy statement of the WOLA definition in
    pfb_channelize_ri: frame m, branch k, then the DFT across k and the
    (-1)^{cm} hop rotation."""
    h = pfb.pfb_prototype(n_chan, taps_per_branch).astype(np.float64)
    hop, nfilt = n_chan // 2, n_chan * taps_per_branch
    M = (len(x) - nfilt) // hop + 1
    idx = (np.arange(M)[:, None] * hop + np.arange(nfilt)[None, :])
    w = (x[idx] * h).reshape(M, taps_per_branch, n_chan).sum(axis=1)
    y = np.fft.fft(w, axis=1)                         # [M, C]
    sign = np.where((np.arange(M)[:, None] * np.arange(n_chan)) % 2, -1, 1)
    return (y * sign).T                               # [C, M]


class TestPfbXla:
    """The XLA channel-major PFB (the one path on every device) against
    an independent float64 statement and against the mixer bank."""

    @pytest.mark.parametrize("n_chan", [64, 512])
    def test_matches_float64_wola(self, n_chan):
        rng = np.random.default_rng(n_chan)
        T = n_chan * 16 + n_chan // 2 * 60
        x = (rng.normal(0, 1, T) + 1j * rng.normal(0, 1, T))
        cr, ci = pfb.pfb_channelize_ri(
            jnp.asarray(x.real.astype(np.float32)),
            jnp.asarray(x.imag.astype(np.float32)), n_chan)
        want = _wola_reference(x, n_chan)
        got = np.asarray(cr) + 1j * np.asarray(ci)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-5 * np.sqrt(n_chan))

    @pytest.mark.parametrize("n_chan", [16, 32])
    def test_bits_match_mixer_bank(self, n_chan):
        """Carriers on channel centres: PFB + resampler + hard demod
        gives the same bits as the mixer-bank channelizer + the same
        demod, and both equal what was sent."""
        from tetra_tpu.phy.channelizer import (channelize_ri,
                                               synthesize_wideband)
        fs = n_chan * 25_000.0
        rng = np.random.default_rng(n_chan + 1)
        chans = [1, n_chan // 2 - 1, n_chan - 3]
        bits = rng.integers(0, 2, size=(len(chans), 1200)).astype(np.int8)
        offsets = np.array([c * fs / n_chan for c in chans], np.float32)
        offsets = np.where(offsets > fs / 2, offsets - fs, offsets)
        wide = synthesize_wideband(dqpsk.modulate(bits, sps=2), offsets,
                                   fs=fs)
        re = jnp.asarray(np.real(wide).astype(np.float32))
        im = jnp.asarray(np.imag(wide).astype(np.float32))
        pr, pi = pfb.pfb_to_demod_rate_ri(
            re, im, jnp.asarray(np.array(chans, np.int32)), n_chan, fs)
        mr, mi = channelize_ri(re, im, jnp.asarray(offsets), fs=fs)
        a = np.asarray(dqpsk.demodulate_hard_ri(pr, pi, os=4))
        b = np.asarray(dqpsk.demodulate_hard_ri(mr, mi, os=4))
        n = min(a.shape[1], b.shape[1], bits.shape[1]) - 80
        np.testing.assert_array_equal(a[:, 80:n], b[:, 80:n])
        np.testing.assert_array_equal(a[:, 80:n], bits[:, 80:n])
