#!/bin/sh
# CI entry point (the contrib/jenkins.sh analogue): build the golden
# oracle, run the self-tests and the full test suite.
set -ex

cd "$(dirname "$0")/.."

# rebuild golden vectors when the reference tree is available
if [ -d /root/reference/src ]; then
  gcc -O1 -o /tmp/gen_golden tools/gen_golden.c \
    /root/reference/src/lower_mac/tetra_scramb.c \
    /root/reference/src/lower_mac/tetra_interleave.c \
    /root/reference/src/lower_mac/tetra_conv_enc.c \
    /root/reference/src/lower_mac/crc_simple.c \
    /root/reference/src/lower_mac/tetra_rm3014.c \
    /root/reference/src/lower_mac/tch_reordering.c \
    /root/reference/src/phy/tetra_burst.c \
    /root/reference/src/crypto/tea1.c /root/reference/src/crypto/tea2.c \
    /root/reference/src/crypto/tea3.c /root/reference/src/crypto/taa1.c \
    /root/reference/src/crypto/hurdle.c \
    /root/reference/src/tetra_llc_pdu.c \
    -Itools/stubs -I/root/reference/src
  /tmp/gen_golden
fi

python -m tetra_tpu.selftest
JAX_PLATFORMS=cpu python -m pytest tests/ -q

# the suite above runs on the CPU (Pallas kernels in interpret mode);
# on a machine with an NVIDIA GPU, also run the receiver end to end on
# the card and the compiled kernels against their references
if nvidia-smi >/dev/null 2>&1; then
  python chip_smoke.py
fi
