/* Minimal stand-in for libosmocore's conv.h (oracle build only).
 *
 * Declares the code-description struct the reference's viterbi_cch.c /
 * viterbi_tch.c fill in, plus osmo_conv_decode.  The decoder itself is
 * implemented in tools/ref_rx.c: a plain max-correlation Viterbi with
 * start state 0, best-end-state selection and ties broken toward the
 * lower predecessor / lower state — the semantics the JAX framework's
 * tetra_tpu.ops.viterbi documents and that libosmocore's decoder
 * exhibits on the TETRA tail-terminated blocks. */
#ifndef STUB_OSMOCOM_CONV_H
#define STUB_OSMOCOM_CONV_H

#include <stdint.h>
#include <osmocom/core/bits.h>

enum osmo_conv_term {
	CONV_TERM_FLUSH = 0,
	CONV_TERM_TRUNCATION,
	CONV_TERM_TAIL_BITING,
};

struct osmo_conv_code {
	int N;
	int K;
	int len;
	enum osmo_conv_term term;
	const uint8_t (*next_output)[2];
	const uint8_t (*next_state)[2];
	const uint16_t *next_term_output;
	const uint16_t *next_term_state;
	const int *puncture;
};

int osmo_conv_decode(const struct osmo_conv_code *code,
		     const sbit_t *input, ubit_t *output);

#endif
