"""Wideband channelizer: one capture -> N per-carrier baseband streams.

Reference behaviour: one GNU Radio process per carrier, each running a
frequency-translating FIR + resampler in front of the DQPSK demod
(reference src/demod/osmosdr-tetra_demod_fft.py:64-96,
telive_1ch_simple_gr310_udp.py). Multi-carrier = multi-process.

Design: all carriers are extracted from the same wideband tensor in
one batched program — mix with a bank of complex oscillators
[C, T], low-pass filter, and polyphase-resample to the demod rate
(36 kHz, sps=2) with precomputed per-output gather indices + a P-phase
fractional-delay filterbank. Every stage is a dense batched op; carriers
are the embarrassingly-parallel axis that shards across chips.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["design_lowpass", "channelize", "synthesize_wideband"]

DEMOD_RATE = 36_000.0
_N_PHASES = 32


@functools.lru_cache(maxsize=16)
def design_lowpass(fs: float, cutoff: float, ntaps: int = 127) -> np.ndarray:
    """Hamming-windowed sinc low-pass FIR (unity DC gain)."""
    t = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = np.sinc(2.0 * cutoff / fs * t) * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _resample_plan(n_in: int, fs: float, out_rate: float,
                   ntaps_per_phase: int = 8, skew: float = 0.0):
    """Precompute (gather_start [n_out], phase_indices [n_out],
    filterbank [P, ntaps]) for arbitrary-ratio polyphase resampling.

    Delay-free: output sample n interpolates the input at exactly
    n * fs/out_rate + skew input samples (skew compensates upstream
    group delay, e.g. a PFB prototype). The interpolation kernel centre
    sits ntaps//2 - 1 taps into each gathered window.
    """
    ratio = fs / out_rate
    centre = ntaps_per_phase // 2 - 1
    n_out = max(int((n_in - ntaps_per_phase - max(skew, 0.0)) / ratio), 0)
    pos = np.arange(n_out) * ratio + skew
    ipos = np.floor(pos).astype(np.int32)
    frac = pos - ipos
    start = np.maximum(ipos - centre, 0)
    phase = np.minimum((frac * _N_PHASES).astype(np.int32), _N_PHASES - 1)
    # P-phase fractional-delay interpolation bank (windowed sinc)
    k = np.arange(ntaps_per_phase) - centre
    bank = np.zeros((_N_PHASES, ntaps_per_phase), np.float32)
    for p in range(_N_PHASES):
        d = p / _N_PHASES
        h = np.sinc(k - d) * np.hamming(ntaps_per_phase)
        bank[p] = (h / h.sum()).astype(np.float32)
    return start, phase, bank


@functools.lru_cache(maxsize=32)
def _rational_ratio(fs: float, out_rate: float, max_den: int = 64):
    """(L, M) with fs/out_rate == L/M exactly, or None."""
    ratio = fs / out_rate
    for M in range(1, max_den + 1):
        L = round(ratio * M)
        if abs(ratio * M - L) < 1e-9 and L > 0:
            return L, M
    return None


@functools.lru_cache(maxsize=32)
def _resample_block_plan(n_in: int, fs: float, out_rate: float,
                         ntaps_per_phase: int = 8, skew: float = 0.0):
    """Block-matmul reorganisation of _resample_plan for rational
    fs/out_rate = L/M: the interpolation phase pattern repeats every M
    outputs, so output block q (M samples) is one [width, M] matmul
    against input window [q·L + bmin, q·L + bmin + width) — a ~1.3x
    banded gather + a dense matmul instead of the generic path's 8x
    window materialisation. Coefficients are IDENTICAL to
    _resample_plan (same 32-phase quantised bank), so results match the
    generic path. Returns (W [width, M], bmin, width, L, M, n_out,
    pad_l) or None when the ratio isn't rational with a small
    denominator."""
    lm = _rational_ratio(fs, out_rate)
    if lm is None:
        return None
    L, M = lm
    ratio = fs / out_rate
    centre = ntaps_per_phase // 2 - 1
    n_out = max(int((n_in - ntaps_per_phase - max(skew, 0.0)) / ratio), 0)
    pos = np.arange(M) * ratio + skew
    ipos = np.floor(pos).astype(np.int64)
    frac = pos - ipos
    phase = np.minimum((frac * _N_PHASES).astype(np.int32), _N_PHASES - 1)
    b = ipos - centre
    bmin = int(b.min())
    width = int(b.max()) + ntaps_per_phase - bmin
    # same bank as _resample_plan
    k = np.arange(ntaps_per_phase) - centre
    W = np.zeros((width, M), np.float32)
    for r in range(M):
        d = phase[r] / _N_PHASES
        h = np.sinc(k - d) * np.hamming(ntaps_per_phase)
        W[b[r] - bmin: b[r] - bmin + ntaps_per_phase, r] = \
            (h / h.sum()).astype(np.float32)
    pad_l = max(-bmin, 0)
    return W, bmin, width, L, M, n_out, pad_l


def _resample_ri_one(x, n_in: int, fs: float, out_rate: float,
                     skew: float = 0.0):
    """Polyphase resample one real plane [..., n_in] -> [..., n_out].

    Rational ratios take the block-matmul fast path; anything else the
    generic per-output gather (identical maths, more HBM traffic)."""
    plan = _resample_block_plan(n_in, fs, out_rate, skew=skew)
    if plan is not None:
        W, bmin, width, L, M, n_out, pad_l = plan
        if n_out == 0:
            return x[..., :0]
        nq = -(-n_out // M)
        need = pad_l + (nq - 1) * L + bmin + width
        pad_r = max(need - pad_l - n_in, 0)
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad_l, pad_r)],
                     mode="edge")
        idx = ((jnp.arange(nq) * L)[:, None] + (pad_l + bmin)
               + jnp.arange(width)[None, :])                    # [nq, width]
        blocks = xp[..., idx]                                   # [.., nq, w]
        out = jnp.einsum("...qw,wr->...qr", blocks, jnp.asarray(W),
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        return out.reshape(*x.shape[:-1], nq * M)[..., :n_out]
    base, phase, bank = _resample_plan(n_in, fs, out_rate, skew=skew)
    ntp = bank.shape[1]
    gather = jnp.asarray(base)[:, None] + jnp.arange(ntp)[None, :]
    gather = jnp.clip(gather, 0, n_in - 1)
    coefs = jnp.asarray(bank)[jnp.asarray(phase)].astype(jnp.float32)
    return jnp.einsum("...nw,nw->...n", x[..., gather], coefs,
                      precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("fs", "out_rate", "ntaps"))
def channelize_ri(re, im, offsets_hz, fs: float, out_rate: float = DEMOD_RATE,
                  ntaps: int = 127, base=0):
    """Planar wideband channelizer: float32 [T] planes -> [C, n_out] planes.

    Same math as `channelize` but with all complex arithmetic expressed
    on planar real/imag arrays: oscillator-bank mix, low-pass FIR per
    plane, polyphase resample per plane.
    Returns (out_re, out_im).

    base: absolute sample index of re[0] in a longer stream. Streaming
    callers (rx_multi overlap-save on the mixer path) pass it so the
    oscillator evaluates cos(2*pi*f*(base+i)/fs) with EXACTLY the same
    float ops as a whole-capture run at index base+i — chunked output
    is then bit-identical to unchunked (DQPSK is differential, so even
    a constant phase error would cancel; matching the floats makes the
    equality exact rather than statistical).
    """
    from tetra_tpu.phy.dqpsk import _fir_real
    re = jnp.asarray(re, dtype=jnp.float32)
    im = jnp.asarray(im, dtype=jnp.float32)
    T = re.shape[-1]
    t = ((jnp.arange(T, dtype=jnp.int32) + base).astype(jnp.float32)
         / jnp.float32(fs))
    ph = 2.0 * jnp.pi * offsets_hz[:, None] * t[None, :]
    c, s = jnp.cos(ph), jnp.sin(ph)
    # (re + j im) * e^{-j ph}
    mr = re[None, :] * c + im[None, :] * s
    mi = im[None, :] * c - re[None, :] * s

    taps = design_lowpass(fs, 12_500.0, ntaps)
    fr = _fir_real(mr, taps)
    fi = _fir_real(mi, taps)

    out_r = _resample_ri_one(fr, T, fs, out_rate)
    out_i = _resample_ri_one(fi, T, fs, out_rate)
    return out_r, out_i


@functools.partial(jax.jit, static_argnames=("fs", "out_rate", "ntaps"))
def channelize(iq, offsets_hz, fs: float, out_rate: float = DEMOD_RATE,
               ntaps: int = 127):
    """Wideband complex [T] (or [..., T]) -> per-carrier baseband [C, T_out].

    offsets_hz: [C] float32 carrier offsets relative to the capture
    centre. Output rate defaults to the reference demod's 36 kHz.
    """
    iq = jnp.asarray(iq)
    T = iq.shape[-1]
    t = jnp.arange(T, dtype=jnp.float32) / jnp.float32(fs)
    osc = jnp.exp(-2j * jnp.pi * offsets_hz[:, None] * t[None, :])
    mixed = iq[None, :] * osc.astype(jnp.complex64)            # [C, T]

    # low-pass to the channel bandwidth (half the 25 kHz spacing)
    from tetra_tpu.phy.dqpsk import _fir_complex
    taps = jnp.asarray(design_lowpass(fs, 12_500.0, ntaps))
    filt = _fir_complex(mixed, taps)                           # [C, T]

    # polyphase resample to out_rate (planar; complex64 einsum would
    # hit the slow generic path anyway)
    out_r = _resample_ri_one(jnp.real(filt), T, fs, out_rate)
    out_i = _resample_ri_one(jnp.imag(filt), T, fs, out_rate)
    return (out_r + 1j * out_i).astype(jnp.complex64)


def synthesize_wideband_fft(basebands, channels, n_chan: int,
                            in_rate: float = DEMOD_RATE,
                            spacing: float = 25_000.0) -> np.ndarray:
    """Host fixture generator, FFT form: per-carrier baseband [C, T_in]
    at in_rate -> wideband capture [T_out] at n_chan*spacing, carrier c
    centred on PFB channel channels[c].

    O(T_out log T_out) instead of synthesize_wideband's O(C*T_out*taps)
    — the only practical way to build hundreds-of-carrier captures. The
    pi/4-DQPSK RRC spectrum (alpha 0.35, 18 ksym/s) occupies +-12.15
    kHz, inside the +-spacing/2 window each channel keeps, so the
    truncation is below the filter's own stopband. Circularity matches
    a looped capture; decode parity vs the per-carrier path is pinned
    in tests/test_rx_multi.py."""
    basebands = np.asarray(basebands, np.complex64)
    C, T_in = basebands.shape
    fs = n_chan * spacing
    dur = T_in / in_rate
    T_out = int(round(dur * fs))
    half = int(spacing / 2 * dur)          # bins kept per side
    F = np.fft.fft(basebands, axis=1)      # bin b = freq b/dur
    big = np.zeros(T_out, np.complex64)
    for c in range(C):
        k = int(channels[c]) % n_chan
        centre = int(round(k * spacing * dur)) % T_out
        pos = (centre + np.arange(half)) % T_out
        neg = (centre - np.arange(1, half + 1)) % T_out
        big[pos] += F[c, :half]
        big[neg] += F[c, T_in - np.arange(1, half + 1)]
    out = np.fft.ifft(big) * (T_out / T_in)
    return out.astype(np.complex64)


def synthesize_wideband(basebands, offsets_hz, fs: float,
                        in_rate: float = DEMOD_RATE) -> np.ndarray:
    """Host fixture generator: per-carrier baseband [C, T_in] at in_rate
    -> summed wideband capture [T_out] at fs (inverse of channelize)."""
    basebands = np.asarray(basebands)
    C, T_in = basebands.shape
    ratio = fs / in_rate
    T_out = int(T_in * ratio)
    t_out = np.arange(T_out) / fs
    # upsample each carrier by windowed-sinc interpolation at the output
    # instants (32 taps, Kaiser window — a truncated bare sinc has ~-13 dB
    # interpolation error at fractional positions, enough to close the
    # DQPSK eye)
    pos = t_out * in_rate
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    half = 16
    k = np.arange(-half + 1, half + 1)
    win = np.kaiser(2 * half, 8.0)
    out = np.zeros(T_out, np.complex64)
    for c in range(C):
        sig = np.zeros(T_out, np.complex64)
        for wi, kk in enumerate(k):
            idx = np.clip(base + kk, 0, T_in - 1)
            w = np.sinc(kk - frac) * win[wi]
            sig += basebands[c, idx] * w
        out += sig * np.exp(2j * np.pi * offsets_hz[c] * t_out)
    return out.astype(np.complex64)
