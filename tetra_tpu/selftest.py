"""Self-test CLI — the conv_enc_test analogue.

Reference behaviour: src/conv_enc_test.c — run the puncture/depuncture
self-test over all 9 channel configurations (tetra_conv_enc.c:250-348),
then soak the full encode->decode chain with randomized PDUs and report
the total CRC error count.
"""
from __future__ import annotations

import sys

import numpy as np
import jax.numpy as jnp

from tetra_tpu import constants as C, tx
from tetra_tpu.ops import rcpc
from tetra_tpu.lmac import pipeline
from tetra_tpu.phy import burst as burst_mod

# the reference's 9 test configurations (tetra_conv_enc.c:253-263)
PUNCT_CONFIGS = [
    ("2_3", 80, 120, 4),       # BSCH
    ("292_432", 292, 432, 4),  # TCH/4.8
    ("148_432", 148, 432, 4),  # TCH/2.4
    ("2_3", 144, 216, 4),      # SCH/HD, BNCH, STCH
    ("2_3", 112, 168, 4),      # SCH/HU
    ("2_3", 288, 432, 4),      # SCH/F
    ("112_168", 112, 168, 3),  # speech class 1
    ("72_162", 72, 162, 3),    # speech class 2
    ("38_80", 38, 80, 3),      # speech class 2 in STCH
]


def punct_test() -> int:
    """Puncture -> depuncture must reproduce exactly the punctured mother
    positions, with everything else left as erasures."""
    failures = 0
    for scheme, t2, t3, rate in PUNCT_CONFIGS:
        mlen = t2 * rate
        mother = np.arange(mlen, dtype=np.int32) % 255
        p = np.asarray(rcpc.puncture(scheme, jnp.asarray(mother), t3))
        d = np.asarray(rcpc.depuncture_hard(scheme, jnp.asarray(p), mlen))
        keep = d != 255
        ok = np.array_equal(d[keep], mother[keep]) and keep.sum() == t3
        print(f"==> Puncture/Depuncture {scheme} ({t2}/{t3}): "
              f"{'OK' if ok else 'FAIL'}")
        failures += not ok
    return failures


def loopback_soak(iterations: int = 100, seed: int = 0) -> int:
    """Randomized encode->decode soak (conv_enc_test.c:335-346), batched."""
    rng = np.random.default_rng(seed)
    from tetra_tpu.ops.scramble import scramb_get_init
    init = scramb_get_init(262, 42, 1)
    schf = rng.integers(0, 2, size=(iterations, 268)).astype(np.int8)
    aach = rng.integers(0, 2, size=(iterations, 14)).astype(np.int8)
    t5 = np.asarray(tx.encode_block("SCH_F", jnp.asarray(schf), jnp.uint32(init)))
    bb = np.asarray(tx.encode_bbk(jnp.asarray(aach), jnp.uint32(init)))
    bursts = np.stack([
        burst_mod.build_norm_c_d_burst(t5[i, :216], bb[i], t5[i, 216:], False)
        for i in range(iterations)])
    res = pipeline.decode_schf_burst(jnp.asarray(bursts), jnp.uint32(init))
    ok = np.asarray(res["SCH_F"].crc_ok)
    exact = np.asarray((np.asarray(res["SCH_F"].type1) == schf).all(axis=-1))
    errors = int((~(ok & exact)).sum())
    return errors


def main(argv=None):
    from tetra_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    rc = punct_test()
    if rc:
        print(f"puncture self-test: {rc} FAILURES")
        sys.exit(1)
    errs = loopback_soak()
    print(f"total number of CRC Errors: {errs}")
    sys.exit(1 if errs else 0)


if __name__ == "__main__":
    main()
