"""Viterbi decoder alone: the fused Pallas kernel against the XLA scan
on the same rows, at the row count of the 1024-carrier chunk program.

Both decode the unified 288-step segmented trellis of lmac.fused (the
chunk program's FEC) on random soft inputs of the hard (±127/0) and
soft (int8 reliability x 127) alphabets with random restart masks, and
must agree bit for bit. Times are medians of --reps calls, each ended
by block_until_ready, in turns (kernel, scan, scan, kernel).

Usage: python tools/bench_viterbi.py [--rows 21504] [--block-rows 32,64,128]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=21504)
    p.add_argument("--block-rows", default="32,64,128")
    p.add_argument("--reps", type=int, default=20)
    a = p.parse_args(argv)
    from tetra_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from bench_mc_e2e import card_info, median_time
    from tetra_tpu.constants import CONV_GENERATORS_CCH
    from tetra_tpu.lmac import fused
    from tetra_tpu.ops.viterbi_pallas import decode_pallas
    gens = tuple(map(tuple, CONV_GENERATORS_CCH))
    dev = jax.devices()[0]
    res = {"card": card_info(),
           "device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}, "rows": a.rows}
    rng = np.random.default_rng(0)
    rm = jnp.asarray(rng.integers(0, 2, size=(a.rows, 3)).astype(np.float32))
    scan = jax.jit(fused.decode_segmented)
    for alphabet, hi, scale in (("hard", 1, 127), ("soft", 31, 127)):
        soft = jnp.asarray((rng.integers(-hi, hi + 1,
                                         size=(a.rows, fused.N_MOTHER))
                            * scale).astype(np.float32))
        want = np.asarray(scan(soft, rm))
        out = {"scan_s": []}
        kernels = {}
        for br in map(int, a.block_rows.split(",")):
            kernels[br] = jax.jit(lambda s, r, br=br: decode_pallas(
                s, fused.N_SYM, gens, r, fused.BOUNDARIES, block_rows=br))
            same = np.array_equal(np.asarray(kernels[br](soft, rm)), want)
            out[f"kernel_equals_scan_br{br}"] = bool(same)
            out[f"kernel_s_br{br}"] = []
        for turn in ("kernel", "scan", "scan", "kernel"):
            if turn == "scan":
                out["scan_s"].append(median_time(lambda: scan(soft, rm),
                                                 a.reps))
                continue
            for br, k in kernels.items():
                out[f"kernel_s_br{br}"].append(
                    median_time(lambda: k(soft, rm), a.reps))
        res[alphabet] = out
    # the two exact GF(2) contractions the CRC can use, at its shape
    # (utils.bits.gf2_matmul keeps the s8 one)
    from tetra_tpu.ops import crc
    from tetra_tpu.utils.bits import gf2_matmul
    M = jnp.asarray(crc.crc16_matrix(284)[0])
    x = jnp.asarray(rng.integers(0, 2, size=(a.rows, 284)).astype(np.int8))
    s8 = jax.jit(gf2_matmul)
    f32 = jax.jit(lambda b, m: jnp.mod(jnp.dot(
        b.astype(jnp.float32), m.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST), 2.0).astype(jnp.int8))
    res["gf2_equal"] = bool(np.array_equal(np.asarray(f32(x, M)),
                                           np.asarray(s8(x, M))))
    res["gf2_f32_s"] = median_time(lambda: f32(x, M), a.reps)
    res["gf2_s8_s"] = median_time(lambda: s8(x, M), a.reps)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
