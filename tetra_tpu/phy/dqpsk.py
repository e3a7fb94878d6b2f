"""pi/4-DQPSK modem + slicer (the demod front-end, L0/L0.5).

Reference behaviour: src/demod/cqpsk.py (GNU Radio: AGC -> RRC ->
mpsk_receiver with Costas + Mueller&Müller feedback loops ->
diff_phasor -> arg -> rescale) and src/float_to_bits.c (float phase
symbols -> hard dibits, optional one-pole pseudo-AFC).

Design (SURVEY.md §7.1): feedback loops don't vectorise, so the
demodulator is feed-forward — matched RRC filter, differential phasor
over one-symbol lag, per-chunk timing-phase selection by the pi/4-DQPSK
decision metric (|sin 2θ| is maximal at the optimum sampling instant),
coarse CFO as a mean phase-drift estimate subtracted per symbol. All
stages are batched convolutions/elementwise ops over [carriers, time].
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "rrc_taps", "modulate", "demodulate", "float_to_bits", "phase_to_bits",
    "bits_to_phase", "demodulate_hard_slotwise_ri",
    "demodulate_soft_slotwise_ri",
]

# dibit -> phase step in units of pi/4 (reference float_to_bits.c:50-72,
# inverse direction; mod map [1,3,7,5] in cqpsk.py:89-104 is equivalent)
_BITS2STEP = {(0, 0): 1, (0, 1): 3, (1, 0): -1, (1, 1): -3}


@functools.lru_cache(maxsize=8)
def rrc_taps(sps: int, ntaps: int = None, alpha: float = 0.35,
             frac_shift: float = 0.0) -> np.ndarray:
    """Root-raised-cosine filter taps (gain-normalised), matching the
    GNU Radio firdes.root_raised_cosine parameterisation used at
    cqpsk.py:244-249 (11*sps taps, alpha=0.35). frac_shift (in samples)
    evaluates the taps off-grid — a bandlimited fractional-delay
    matched filter for sub-sample timing candidates."""
    if ntaps is None:
        ntaps = 11 * sps
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0 + frac_shift) / sps
    taps = np.zeros(ntaps)
    for i, x in enumerate(t):
        if abs(x) < 1e-9:
            taps[i] = 1.0 - alpha + 4 * alpha / np.pi
        elif abs(abs(4 * alpha * x) - 1.0) < 1e-9:
            taps[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
        else:
            taps[i] = ((np.sin(np.pi * x * (1 - alpha))
                        + 4 * alpha * x * np.cos(np.pi * x * (1 + alpha)))
                       / (np.pi * x * (1 - (4 * alpha * x) ** 2)))
    return (taps / np.sum(taps)).astype(np.float32)


def bits_to_phase(bits) -> np.ndarray:
    """ubits [..., 2n] -> cumulative phase steps (pi/4 units) [..., n]."""
    bits = np.asarray(bits).reshape(*np.asarray(bits).shape[:-1], -1, 2)
    steps = np.zeros(bits.shape[:-1], dtype=np.int32)
    for (b0, b1), v in _BITS2STEP.items():
        steps = np.where((bits[..., 0] == b0) & (bits[..., 1] == b1), v, steps)
    return steps


def modulate(bits, sps: int = 2, ntaps: int | None = None) -> np.ndarray:
    """ubits [..., 2n] -> complex baseband [..., n*sps] (host fixture gen).

    pi/4-DQPSK: phase accumulates by the dibit step each symbol; pulse
    shaping with the RRC filter (cqpsk.py:89-120 equivalent).
    """
    steps = bits_to_phase(bits)
    phase = np.cumsum(steps, axis=-1) * (np.pi / 4.0)
    symbols = np.exp(1j * phase).astype(np.complex64)
    up = np.zeros(symbols.shape[:-1] + (symbols.shape[-1] * sps,), np.complex64)
    up[..., ::sps] = symbols
    taps = rrc_taps(sps, ntaps)
    out = np.apply_along_axis(lambda r: np.convolve(r, taps * sps, mode="same"),
                              -1, up)
    return out.astype(np.complex64)


def _fir_complex(x, taps):
    """Batched FIR of complex [..., T] with real taps via lax.conv
    (same-length output). Real/imag filtered as separate conv batches —
    no windowed-gather blowup at large carrier counts."""
    batch = x.shape[:-1]
    T = x.shape[-1]
    ntaps = taps.shape[0]
    pad = ntaps // 2
    stacked = jnp.concatenate([jnp.real(x).reshape(-1, 1, T),
                               jnp.imag(x).reshape(-1, 1, T)], axis=0)
    kernel = taps[::-1].reshape(1, 1, ntaps).astype(jnp.float32)
    out = jax.lax.conv_general_dilated(
        stacked.astype(jnp.float32), kernel, window_strides=(1,),
        padding=[(pad, ntaps - 1 - pad)],
        precision=jax.lax.Precision.HIGHEST)
    n = int(np.prod(batch)) if batch else 1
    re, im = out[:n, 0, :], out[n:, 0, :]
    return (re + 1j * im).reshape(*batch, T)


@functools.lru_cache(maxsize=16)
def _band_matrix(ntaps: int, block: int, taps_key) -> np.ndarray:
    """Banded [block+ntaps-1, block] matrix for FIR-as-matmul:
    y[o] = sum_m x_ext[m] * band[m, o] with band[m, o] = kernel[m-o]."""
    kernel = np.asarray(taps_key, dtype=np.float32)[::-1]
    K = ntaps
    band = np.zeros((block + K - 1, block), np.float32)
    for o in range(block):
        band[o:o + K, o] = kernel
    return band


def _fir_real(x, taps, block: int = 128):
    """Batched real FIR [..., T], same-length output, as an overlap-save
    banded matmul (dense GEMMs instead of a long scalar FIR loop).

    `taps` must be a host numpy array (it parameterises the constant
    band matrix)."""
    taps = np.asarray(taps, dtype=np.float32)
    batch = x.shape[:-1]
    T = x.shape[-1]
    ntaps = taps.shape[0]
    pad = ntaps // 2
    nblk = -(-T // block)
    Tp = nblk * block
    x2 = jnp.pad(x.astype(jnp.float32),
                 [(0, 0)] * (x.ndim - 1) + [(pad, Tp - T + (ntaps - 1 - pad))])
    # frames[n] = x_ext[n*block : n*block + block+ntaps-1]
    idx = (jnp.arange(nblk) * block)[:, None] + jnp.arange(block + ntaps - 1)[None, :]
    frames = x2[..., idx]                                    # [..., nblk, blk+K-1]
    band = jnp.asarray(_band_matrix(ntaps, block, tuple(taps.tolist())))
    y = jnp.einsum("...nk,ko->...no", frames, band,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return y.reshape(*batch, Tp)[..., :T]


@functools.partial(jax.jit, static_argnames=("sps", "est_cfo"))
def demodulate_ri(re, im, sps: int = 2, est_cfo: bool = True):
    """Real/imag-plane demodulator core [..., T] f32 each -> symbols.

    Complex arithmetic expressed on planar float re/im arrays.
    """
    taps = rrc_taps(sps)
    fr = _fir_real(re, taps)
    fi = _fir_real(im, taps)

    # differential phasor z[n] * conj(z[n - sps]) on float planes
    # (zero-padded at the front so output keeps T//sps symbols)
    def lag(x):
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(sps, 0)])[..., :-sps]

    lr, li = lag(fr), lag(fi)
    dr = fr * lr + fi * li
    di = fi * lr - fr * li
    theta = jnp.arctan2(di, dr)

    # timing: per chunk, pick the sample phase maximising |sin(2θ)|
    n = (theta.shape[-1] // sps) * sps
    th = theta[..., :n].reshape(*theta.shape[:-1], n // sps, sps)
    score = jnp.mean(jnp.abs(jnp.sin(2.0 * th)), axis=-2)       # [..., sps]
    best = jnp.argmax(score, axis=-1)                           # [...]
    sym_theta = jnp.take_along_axis(
        th, best[..., None, None].astype(jnp.int32), axis=-1)[..., 0]

    if est_cfo:
        # coarse CFO: mean deviation from the nearest odd multiple of pi/4
        quant = jnp.round((sym_theta / (jnp.pi / 4.0) - 1.0) / 2.0) * 2.0 + 1.0
        err = sym_theta - quant * (jnp.pi / 4.0)
        sym_theta = sym_theta - jnp.mean(err, axis=-1, keepdims=True)

    return sym_theta / (jnp.pi / 4.0)


def demodulate(iq, sps: int = 2, est_cfo: bool = True):
    """Complex baseband [..., T] -> float phase symbols [..., T//sps].

    Output units match the reference chain's float stream (phase deltas
    in pi/4 units, ±1/±3) so it feeds float_to_bits directly. Thin
    wrapper over demodulate_ri (planar core).
    """
    iq = jnp.asarray(iq)
    return demodulate_ri(jnp.real(iq).astype(jnp.float32),
                         jnp.imag(iq).astype(jnp.float32),
                         sps=sps, est_cfo=est_cfo)


def _stream_phasors(re, im, sps: int, os: int):
    """Shared full-stream phasor core: matched filter (os-x fractional
    bank), differential phasor, per-carrier timing-phase pick. Returns
    (sel_r, sel_i) [..., T//sps] — the selected differential phasors,
    one per symbol."""
    tap_bank = [rrc_taps(sps, frac_shift=k / os) for k in range(os)]

    def mf(x):
        fs = [_fir_real(x, tp) for tp in tap_bank]
        if os == 1:
            return fs[0]
        return jnp.stack(fs, axis=-1).reshape(
            *fs[0].shape[:-1], os * fs[0].shape[-1])

    fr, fi = mf(re), mf(im)
    sps2 = os * sps

    def lag(x):
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(sps2, 0)])[..., :-sps2]

    lr, li = lag(fr), lag(fi)
    dr = fr * lr + fi * li
    di = fi * lr - fr * li

    n = (dr.shape[-1] // sps2) * sps2
    drp = dr[..., :n].reshape(*dr.shape[:-1], n // sps2, sps2)
    dip = di[..., :n].reshape(*di.shape[:-1], n // sps2, sps2)
    mag2 = drp * drp + dip * dip
    score = jnp.mean(2.0 * jnp.abs(drp * dip) / (mag2 + 1e-12), axis=-2)
    best = jnp.argmax(score, axis=-1).astype(jnp.int32)
    sel_r = jnp.take_along_axis(drp, best[..., None, None], axis=-1)[..., 0]
    sel_i = jnp.take_along_axis(dip, best[..., None, None], axis=-1)[..., 0]
    return sel_r, sel_i


@functools.partial(jax.jit, static_argnames=("sps", "os"))
def demodulate_hard_ri(re, im, sps: int = 2, os: int = 1):
    """Trig-free hard-decision demodulator: planar baseband -> dibits.

    pi/4-DQPSK hard decisions are pure sign tests on the differential
    phasor d = z[n]·conj(z[n-sps]): b0 = (Im d <= 0), b1 = (Re d < 0) —
    equivalent to the angle+slicer path (float_to_bits.c thresholds) but
    with no atan2. Timing selection uses |sin 2θ| = 2|dr·di|/|d|², also
    trig-free. Returns ubits [..., 2*(T//sps)].

    os > 1 adds fractional timing: an os-x bank of fractionally-shifted
    RRC matched filters interpolates between input samples and ONE of
    sps*os phases is picked per carrier. With sps=2 alone, a
    half-sample symbol-clock offset lands exactly between the two
    available phases and the decision margin collapses on the worst
    symbols (measured through the PFB front end: min margin 0.62 at
    the right phase vs ~0.001 at the wrong one) — os=4 bounds the
    sampling error at T/16, the same trade as _slotwise_phasors. Use
    os=4 wherever upstream resampling leaves the symbol clock at an
    arbitrary offset (the wideband paths); os=1 suits phase-aligned
    steady streams.
    """
    sel_r, sel_i = _stream_phasors(re, im, sps, os)
    b0 = (sel_i <= 0).astype(jnp.int8)
    b1 = (sel_r < 0).astype(jnp.int8)
    bits = jnp.stack([b0, b1], axis=-1)
    return bits.reshape(*bits.shape[:-2], bits.shape[-2] * 2)


@functools.partial(jax.jit, static_argnames=("sps", "os"))
def demodulate_soft_ri(re, im, sps: int = 2, os: int = 1):
    """Full-stream soft-decision demodulator: planar baseband -> int8
    per-bit reliabilities [..., 2*(T//sps)] (positive = bit 0, the
    pipeline's convention; hard decisions = (soft < 0)).

    Same front end and timing pick as demodulate_hard_ri; instead of
    sign tests, the differential phasor components are normalised by
    the per-carrier mean magnitude, clipped at 4x, and quantised to
    int8 (±124 full scale — the ~5 effective soft bits cost <0.1 dB
    against the float path). The reference chain is hard-decision by
    construction (float_to_bits.c thresholds); carrying amplitudes
    through the linear descramble/deinterleave/depuncture into the
    soft Viterbi buys ~2 dB (PARITY.md), and fastpath's soft mode
    threads this output through the fused chunk program at scale.
    """
    sel_r, sel_i = _stream_phasors(re, im, sps, os)
    nrm = jnp.mean(jnp.sqrt(sel_r * sel_r + sel_i * sel_i),
                   axis=-1, keepdims=True) + 1e-9
    s0 = jnp.clip(sel_i / nrm, -4.0, 4.0)
    s1 = jnp.clip(sel_r / nrm, -4.0, 4.0)
    soft = jnp.stack([s0, s1], axis=-1)
    q = jnp.round(soft * 31.0).astype(jnp.int8)
    return q.reshape(*q.shape[:-2], q.shape[-2] * 2)


def _slotwise_phasors(re, im, n_slots: int, phase_bit: int, sps: int):
    """Degraded-signal hard demodulator: per-SLOT timing + residual-CFO
    correction (the feed-forward substitute for the reference's
    Costas + Mueller&Müller tracking loops, cqpsk.py:254-263).

    Per slot (255 symbols):
    - timing phase re-picked by the |sin 2θ| metric, so sample-clock
      offset that drifts across a chunk is re-acquired every slot;
    - residual carrier phase/CFO estimated blind via the quadrupling
      nonlinearity: for pi/4-DQPSK every differential phasor d[n]
      satisfies angle(d^4) = pi + 4*eps, so
      eps = (angle(sum d[n]^4) - pi) / 4 needs no decisions and no
      pilots; d is de-rotated by eps before slicing. Handles CFO ramps
      (eps is per-slot) within +-pi/16 per-symbol residual.

    Returns hard bits [C, n_slots, 510] for slots whose first bit is at
    `phase_bit` (bit indexing as locked_step_ri).
    """
    # 4x timing resolution: fractionally-shifted RRC matched filters
    # provide exact bandlimited interpolation between input samples, so
    # the worst-case sampling error drops from T/4 to T/16 under
    # sample-clock drift (a ~0.2 dB ISI penalty instead of ~2 dB)
    OS = 4
    tap_bank = [rrc_taps(sps, frac_shift=k / OS) for k in range(OS)]

    def mf(x):
        fs = [_fir_real(x, tp) for tp in tap_bank]
        return jnp.stack(fs, axis=-1).reshape(
            *fs[0].shape[:-1], OS * fs[0].shape[-1])

    fr, fi = mf(re), mf(im)
    sps2 = OS * sps

    def lag(x):
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(sps2, 0)])[..., :-sps2]

    lr, li = lag(fr), lag(fi)
    dr = fr * lr + fi * li
    di = fi * lr - fr * li

    # slot grid in sample space: slot s covers symbols
    # [phase_bit/2 + 255*s, +255), each symbol spanning sps2 samples
    sym0 = phase_bit // 2
    need = (sym0 + n_slots * 255) * sps2
    dr = dr[..., :need].reshape(*dr.shape[:-1], sym0 + n_slots * 255, sps2)
    di = di[..., :need].reshape(*di.shape[:-1], sym0 + n_slots * 255, sps2)
    dr = dr[..., sym0:, :].reshape(*dr.shape[:-2], n_slots, 255, sps2)
    di = di[..., sym0:, :].reshape(*di.shape[:-2], n_slots, 255, sps2)

    # blind phase per (slot, sample-phase): z = d^4 (planar),
    # eps = wrap(angle(sum z) - pi) / 4 — estimated BEFORE the timing
    # pick because the |sin 2θ| timing metric itself decays as cos(2eps)
    # under CFO
    r2 = dr * dr - di * di
    i2 = 2.0 * dr * di
    zr = r2 * r2 - i2 * i2
    zi = 2.0 * r2 * i2
    # normalize per symbol so strong symbols don't dominate
    m4 = jnp.sqrt(zr * zr + zi * zi) + 1e-12
    ang = jnp.arctan2(jnp.sum(zi / m4, axis=-2), jnp.sum(zr / m4, axis=-2))
    e4 = ang - jnp.pi                                       # wrap to (-pi, pi]
    e4 = jnp.where(e4 <= -jnp.pi, e4 + 2.0 * jnp.pi, e4)
    eps = e4 / 4.0                                          # [C, S, sps]
    ce, se = jnp.cos(-eps)[..., None, :], jnp.sin(-eps)[..., None, :]
    cr = dr * ce - di * se                                  # de-rotated
    ci = dr * se + di * ce

    # per-slot timing phase on the corrected phasors
    mag2 = cr * cr + ci * ci
    score = jnp.mean(2.0 * jnp.abs(cr * ci) / (mag2 + 1e-12), axis=-2)
    best = jnp.argmax(score, axis=-1).astype(jnp.int32)     # [C, S]
    sel = lambda x: jnp.take_along_axis(
        x, best[..., None, None], axis=-1)[..., 0]
    return sel(cr), sel(ci)                                 # [C, S, 255] each


@functools.partial(jax.jit, static_argnames=("sps", "n_slots", "phase_bit"))
def demodulate_hard_slotwise_ri(re, im, n_slots: int, phase_bit: int = 0,
                                sps: int = 2):
    rr, ri = _slotwise_phasors(re, im, n_slots, phase_bit, sps)
    b0 = (ri <= 0).astype(jnp.int8)
    b1 = (rr < 0).astype(jnp.int8)
    bits = jnp.stack([b0, b1], axis=-1)
    return bits.reshape(*bits.shape[:-3], n_slots, 510)


@functools.partial(jax.jit, static_argnames=("sps", "n_slots", "phase_bit"))
def demodulate_soft_slotwise_ri(re, im, n_slots: int, phase_bit: int = 0,
                                sps: int = 2):
    """Soft-decision slotwise demod: per-bit reliabilities instead of
    hard slices (positive = bit 0, the pipeline's +127 convention;
    magnitude ~1 on clean symbols, clipped at 4).

    The reference chain is hard-decision by construction
    (float_to_bits.c thresholds); keeping the demodulator's amplitude
    information through the (linear) descramble + deinterleave +
    depuncture into the Viterbi buys ~2 dB — an enhancement mode, used
    by locked_step_ri(fast="soft").
    """
    rr, ri = _slotwise_phasors(re, im, n_slots, phase_bit, sps)
    # per-slot amplitude normalisation (Viterbi metrics are per-block
    # scale-invariant, but clipping must bite at a consistent level)
    nrm = jnp.mean(jnp.sqrt(rr * rr + ri * ri), axis=-1, keepdims=True) + 1e-9
    # hard rule: b0 = (ri <= 0), b1 = (rr < 0); positive soft = bit 0
    s0 = jnp.clip(ri / nrm, -4.0, 4.0)
    s1 = jnp.clip(rr / nrm, -4.0, 4.0)
    soft = jnp.stack([s0, s1], axis=-1)
    return soft.reshape(*soft.shape[:-3], n_slots, 510)


@jax.jit
def float_to_bits(symbols):
    """Float phase symbols [..., n] -> hard ubits [..., 2n].

    Thresholds and dibit map from reference src/float_to_bits.c:33-72:
    >2 -> +3 -> (0,1); >0 -> +1 -> (0,0); <-2 -> -3 -> (1,1); else -1 -> (1,0).
    """
    s = symbols
    b0 = (s <= 0).astype(jnp.int8)
    b1 = ((s > 2) | ((s < -2))).astype(jnp.int8)
    return jnp.stack([b0, b1], axis=-1).reshape(*s.shape[:-1], s.shape[-1] * 2)


def phase_to_bits(symbols, afc: bool = False, filter_val: float = 1e-4,
                  filter_goal: float = 0.0) -> np.ndarray:
    """Host slicer with the optional one-pole pseudo-AFC
    (reference float_to_bits.c:142-149). Sequential by nature; used for
    file-based parity runs.

    Arithmetic reproduces the C program's mixed float/double evaluation
    exactly (filter stored as float32; `filter * (1.0 - filter_val)`
    promotes to double, `(fl - goal) * filter_val` stays float32), so
    the output is bit-identical to the compiled reference — pinned by
    tests/test_ref_slicer.py incl. the -a mode over drift ramps.
    """
    out = np.zeros(len(symbols) * 2, dtype=np.uint8)
    fv = np.float32(filter_val)
    fg = np.float32(filter_goal)
    one_minus = np.float64(1.0) - np.float64(fv)
    filt = np.float32(0.0)
    for i, fl in enumerate(np.asarray(symbols, dtype=np.float32)):
        if afc:
            if -5.0 < fl < 5.0:
                t2 = np.float32(np.float32(fl - fg) * fv)
                filt = np.float32(np.float64(filt) * one_minus
                                  + np.float64(t2))
            fl = np.float32(fl - filt)
        if fl > 2:
            d = (0, 1)
        elif fl > 0:
            d = (0, 0)
        elif fl < -2:
            d = (1, 1)
        else:
            d = (1, 0)
        out[2 * i], out[2 * i + 1] = d
    return out
