"""Polyphase filterbank channelizer: wideband -> all channels at once.

The mixer-bank channelizer (phy.channelizer) costs O(C·T) multiplies;
this 2x-oversampled WOLA filterbank costs O(T·taps) for the polyphase
filter plus a DFT across branches per hop. The DFT is expressed as
real [C, C] matmuls (cos/sin) on planar re/im arrays, run at HIGHEST
precision (SURVEY.md §7.1 "polyphase filterbank channelizer").

Channel c is centred at c·fs/C (c > C/2 ≡ negative frequencies) and
emerges 2x oversampled at 2·fs/C complex samples/s (50 kHz for 25 kHz
TETRA channel spacing), comfortably above the signal bandwidth; a
per-channel polyphase resampler (shared with phy.channelizer) brings
selected channels to the 36 kHz demod rate.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tetra_tpu.phy.channelizer import DEMOD_RATE

__all__ = ["pfb_prototype", "pfb_channelize_ri", "pfb_to_demod_rate_ri"]

_HI = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=8)
def pfb_prototype(n_chan: int, taps_per_branch: int = 16,
                  cutoff_frac: float = 0.64) -> np.ndarray:
    """Prototype low-pass for the filterbank, length n_chan*taps_per_branch.

    cutoff_frac is relative to the channel spacing fs/n_chan. The default
    0.64 (16 kHz for 25 kHz TETRA spacing) keeps the passband FLAT across
    the ±12.15 kHz pi/4-DQPSK signal band — a cutoff at exactly half the
    spacing droops -6 dB right at the band edge and destroys the eye.
    The 2x-oversampled structure folds only at ±fs/n_chan, so the wider
    passband is alias-safe; the cost is some adjacent-channel rolloff
    leakage in the 12.85-16 kHz region."""
    n = n_chan * taps_per_branch
    t = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(2.0 * cutoff_frac * t / n_chan) * np.kaiser(n, 10.0)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_chan: int):
    """(cos [C, C], sin [C, C]) of 2π c k / C."""
    k = np.arange(n_chan)
    ang = 2.0 * np.pi * np.outer(k, k) / n_chan
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("n_chan", "taps_per_branch"))
def pfb_channelize_ri(re, im, n_chan: int, taps_per_branch: int = 16):
    """Planar wideband [T] -> all channels [C, M] (planar), M ≈ 2T/C.

    2x-oversampled weighted overlap-add: hop H = C/2; output frame m is
    b[m, k] = Σ_j x[mH + jC + k] · h[jC + k], followed by the analysis
    DFT across k and the (-1)^{cm} rotation that recentres channel c
    (the e^{-2πi c mH / C} WOLA phase term). Returns (chan_re, chan_im).
    """
    assert n_chan % 2 == 0
    hop = n_chan // 2
    h = pfb_prototype(n_chan, taps_per_branch)
    nfilt = n_chan * taps_per_branch
    hj = jnp.asarray(h.reshape(taps_per_branch, n_chan))        # [J, C]

    def frames(x):
        # b[m, k] = Σ_j x[mH + jC + k] h[jC + k], computed as 2J shifted
        # multiply-adds over the hop-strided view — O(T) memory instead of
        # materialising a [M, J·C] gather (2J× the input size)
        x = jnp.asarray(x, jnp.float32)
        T = x.shape[-1]
        M = max((T - nfilt) // hop + 1, 1)
        nblk = T // hop
        u = x[..., : nblk * hop].reshape(*x.shape[:-1], nblk, hop)
        acc_lo = jnp.zeros(x.shape[:-1] + (M, hop), jnp.float32)
        acc_hi = jnp.zeros(x.shape[:-1] + (M, hop), jnp.float32)
        for l in range(2 * taps_per_branch):
            # window offset l*hop covers filter taps [l*hop, (l+1)*hop)
            j, half = divmod(l, 2)
            w = hj[j, half * hop:(half + 1) * hop]               # [hop]
            seg = u[..., l: l + M, :] * w
            if half == 0:
                acc_lo = acc_lo + seg
            else:
                acc_hi = acc_hi + seg
        return jnp.concatenate([acc_lo, acc_hi], axis=-1)        # [.., M, C]

    br_r = frames(re)
    br_i = frames(im)
    M = br_r.shape[-2]

    cosm, sinm = _dft_matrices(n_chan)
    cosj = jnp.asarray(cosm)
    sinj = jnp.asarray(sinm)
    # analysis DFT: y[c] = Σ_k b[k] e^{-2πick/C}
    yr = (jnp.einsum("...mk,ck->...mc", br_r, cosj,
                     preferred_element_type=jnp.float32, precision=_HI)
          + jnp.einsum("...mk,ck->...mc", br_i, sinj,
                       preferred_element_type=jnp.float32, precision=_HI))
    yi = (jnp.einsum("...mk,ck->...mc", br_i, cosj,
                     preferred_element_type=jnp.float32, precision=_HI)
          - jnp.einsum("...mk,ck->...mc", br_r, sinj,
                       preferred_element_type=jnp.float32, precision=_HI))
    # WOLA hop rotation: multiply by e^{+2πi c mH / C} = (-1)^{cm}
    cm = (jnp.arange(M)[:, None] * jnp.arange(n_chan)[None, :]) % 2
    sign = jnp.where(cm == 1, -1.0, 1.0).astype(jnp.float32)
    yr = yr * sign
    yi = yi * sign
    return jnp.moveaxis(yr, -1, -2), jnp.moveaxis(yi, -1, -2)   # [C, M]


@functools.partial(jax.jit, static_argnames=("n_chan", "fs", "out_rate",
                                             "taps_per_branch"))
def pfb_to_demod_rate_ri(re, im, channel_idx, n_chan: int, fs: float,
                         out_rate: float = DEMOD_RATE,
                         taps_per_branch: int = 16):
    """Wideband planar [T] at `fs` -> selected channels at the demod rate.

    channel_idx: [Csel] int32 PFB channel numbers. Returns
    (out_re [Csel, T_out], out_im).
    """
    chan_rate = 2.0 * fs / n_chan
    # compensate the prototype's group delay: channel frame m holds input
    # time (mH + (JC-1)/2)/fs, so the sample for output time t sits at
    # t*chan_rate - (JC-1)/(2H). The first ~|skew|/ratio outputs fall
    # before the stream start and are garbage (inside any demod margin).
    hop = n_chan // 2
    skew = -(n_chan * taps_per_branch - 1) / (2.0 * hop)
    from tetra_tpu.phy.channelizer import _resample_ri_one
    cr, ci = pfb_channelize_ri(re, im, n_chan, taps_per_branch)
    cr = jnp.take(cr, channel_idx, axis=0)
    ci = jnp.take(ci, channel_idx, axis=0)
    m = cr.shape[-1]
    out_r = _resample_ri_one(cr, m, chan_rate, out_rate, skew=skew)
    out_i = _resample_ri_one(ci, m, chan_rate, out_rate, skew=skew)
    return out_r, out_i
