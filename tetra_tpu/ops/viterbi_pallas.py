"""Fused Viterbi decoder for the TETRA 16-state codes as one Pallas
kernel on the Triton route (NVIDIA GPUs).

Same trellis, soft convention and tie semantics as the XLA scan in
tetra_tpu.ops.viterbi (`decode`, `decode_segmented`): strict `c1 > c0`
survivor choice and the lowest index among maximal states wherever a
best state is picked. Every metric is an integer-valued float32 sum
below 2^24, so decisions and output bits are bit-identical to the scan.

Design: each program owns a block of `block_rows` rows, with rows as the
vector axis (one row per thread). The 16 path metrics are 16 unrolled
[R] register vectors, so the trellis permutation is static Python
indexing. The branch metrics are signed sums of the step's N soft
values with signs known at trace time. The forward pass runs as an
in-kernel `fori_loop`; each step packs its 16 survivor decisions into
one int32 per row and stores it to a time-major [n_sym, B] buffer in
global memory (~1.2 KB per row, L2-resident at chunk sizes). The
traceback runs in the same kernel from those words. Trellis restarts at
static `boundaries` (per-row mask) split the loops at those steps, as
the segmented scan does.

Inputs are time-major ([n_sym*N, B]), so every per-step load and store
is one coalesced [R] vector.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tetra_tpu.ops.viterbi import trellis_signs, _NEG

__all__ = ["decode_pallas", "BLOCK_ROWS"]

BLOCK_ROWS = 64      # rows per program: ~20k rows -> ~320 programs


def _bm_plan(generators):
    """Static branch-metric plan: for every (state, input bit) the
    index of a distinct sign pattern and whether it is negated, plus
    the distinct patterns (sign vectors over the N outputs)."""
    signs = trellis_signs(generators)                  # [16, 2, N]
    pats, plan = [], {}
    for s in range(16):
        for b in (0, 1):
            v = tuple(int(x) for x in signs[s, b])
            neg = tuple(-x for x in v)
            if v in pats:
                plan[s, b] = (pats.index(v), False)
            elif neg in pats:
                plan[s, b] = (pats.index(neg), True)
            else:
                pats.append(v)
                plan[s, b] = (len(pats) - 1, False)
    return pats, plan


def _best_state(m):
    """Lowest index among the maximal metrics (jnp.argmax semantics)."""
    best = m[0]
    for s in range(1, 16):
        best = jnp.maximum(best, m[s])
    idx = jnp.full(best.shape, 15, jnp.int32)
    for s in range(14, -1, -1):
        idx = jnp.where(m[s] == best, jnp.int32(s), idx)
    return idx


def _make_kernel(n_sym: int, generators, boundaries: tuple, rows: int):
    n = len(generators)
    pats, plan = _bm_plan(generators)
    edges = (0,) + tuple(boundaries) + (n_sym,)

    def kernel(*refs):
        if boundaries:
            soft_ref, rm_ref, bits_ref, dec_ref = refs
        else:
            soft_ref, bits_ref, dec_ref = refs
        zero = jnp.zeros((rows,), jnp.float32)
        neg = jnp.full((rows,), _NEG, jnp.float32)
        init = (zero,) + (neg,) * 15

        def acs(t, m):
            x = [soft_ref[t * n + k, :] for k in range(n)]
            pm = []
            for p in pats:
                acc = None
                for k, sg in enumerate(p):
                    if acc is None:
                        acc = x[k] if sg > 0 else -x[k]
                    else:
                        acc = acc + x[k] if sg > 0 else acc - x[k]
                pm.append(acc)

            def bm(s, b):
                i, flip = plan[s, b]
                return -pm[i] if flip else pm[i]

            new, word = [], jnp.zeros((rows,), jnp.int32)
            for ns in range(16):
                p0, b = ns >> 1, ns & 1
                p1 = p0 | 8
                c0 = m[p0] + bm(p0, b)
                c1 = m[p1] + bm(p1, b)
                took = c1 > c0
                new.append(jnp.where(took, c1, c0))
                word = word | jnp.where(took, jnp.int32(1 << ns),
                                        jnp.int32(0))
            dec_ref[t, :] = word
            return tuple(new)

        m = init
        restart_best = {}
        for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
            if lo:
                r = rm_ref[i - 1, :] != 0
                restart_best[lo] = (r, _best_state(m))
                m = tuple(jnp.where(r, a, b) for a, b in zip(init, m))
            m = jax.lax.fori_loop(lo, hi, acs, m)

        def back(j, state, hi):
            t = hi - 1 - j
            bits_ref[t, :] = (state & 1).astype(jnp.int8)
            took = (dec_ref[t, :] >> state) & 1
            return (state >> 1) | (took << 3)

        state = _best_state(m)
        for lo, hi in zip(edges[-2::-1], edges[:0:-1]):
            state = jax.lax.fori_loop(0, hi - lo,
                                      functools.partial(back, hi=hi), state)
            if lo:
                r, best = restart_best[lo]
                state = jnp.where(r, best, state)

    return kernel


@functools.partial(jax.jit, static_argnames=(
    "n_sym", "generators", "boundaries", "block_rows", "interpret"))
def decode_pallas(soft, n_sym: int, generators, rmask=None,
                  boundaries: tuple = (), block_rows: int = BLOCK_ROWS,
                  interpret: bool = False):
    """Soft mother bits [B, >= n_sym*N] -> hard bits [B, n_sym] int8.

    rmask [B, len(boundaries)] (nonzero = restart the trellis at that
    boundary), required when `boundaries` is non-empty. Rows are padded
    to a multiple of `block_rows` (a power of two)."""
    generators = tuple(map(tuple, generators))
    n = len(generators)
    B = soft.shape[0]
    rows = block_rows
    Bp = -(-B // rows) * rows
    # time-major, row-padded: one coalesced [R] load per (step, output)
    soft_t = jnp.pad(soft[:, : n_sym * n].astype(jnp.float32),
                     ((0, Bp - B), (0, 0))).T
    args = [soft_t]
    in_specs = [pl.BlockSpec((n_sym * n, rows), lambda i: (0, i))]
    if boundaries:
        rm = jnp.pad(jnp.asarray(rmask).astype(jnp.int32),
                     ((0, Bp - B), (0, 0))).T
        args.append(rm)
        in_specs.append(pl.BlockSpec((len(boundaries), rows),
                                     lambda i: (0, i)))
    bits, _ = pl.pallas_call(
        _make_kernel(n_sym, generators, tuple(boundaries), rows),
        grid=(Bp // rows,),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((n_sym, rows), lambda i: (0, i)),
                   pl.BlockSpec((n_sym, rows), lambda i: (0, i))],
        out_shape=[jax.ShapeDtypeStruct((n_sym, Bp), jnp.int8),
                   jax.ShapeDtypeStruct((n_sym, Bp), jnp.int32)],
        compiler_params=plgpu.CompilerParams(num_warps=max(rows // 32, 1),
                                             num_stages=1),
        interpret=interpret,
        name="viterbi16",
    )(*args)
    return bits.T[:B]
