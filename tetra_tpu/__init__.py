"""tetra_tpu — a TETRA V+D air-interface framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
osmocom/osmo-tetra reference receiver (see SURVEY.md): pi/4-DQPSK
demodulation, burst synchronisation, the lower-MAC FEC chain
(descramble → deinterleave → depuncture → Viterbi → CRC), upper-MAC /
LLC / MLE PDU parsing, the TEA/TAA1 crypto suite, and GSMTAP export —
batched over carriers and time so that hundreds of carriers decode in
real time on a single accelerator (an NVIDIA GPU; every test runs on
the CPU).

Layering mirrors the reference's SAP boundaries (reference
src/tetra_prim.h:10-16) but the signal path is tensorised:

- ``tetra_tpu.ops``      bit-exact device kernels (type-5 ↔ type-1 bits)
- ``tetra_tpu.phy``      burst build/split, training-sequence sync
- ``tetra_tpu.lmac``     batched lower-MAC decode pipeline
- ``tetra_tpu.umac``     upper MAC PDU parsing (host control plane)
- ``tetra_tpu.llc``      LLC parsing + defragmentation
- ``tetra_tpu.mle``      MLE/CMCE/MM/SNDCP dispatch
- ``tetra_tpu.crypto``   TEA1/2/3 KSGs, TAA1 suite, HURDLE, keystore
- ``tetra_tpu.parallel`` carrier/time sharding over device meshes
- ``tetra_tpu.io``       GSMTAP/TUN/file ingest & egress
"""

__version__ = "0.1.0"

from tetra_tpu import constants  # noqa: F401
