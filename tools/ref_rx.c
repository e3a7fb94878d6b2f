/* Differential-parity oracle receiver.
 *
 * Compiles the read-only reference's ACTUAL receive chain — burst
 * synchronizer state machine (phy/tetra_burst_sync.c), burst splitter
 * (phy/tetra_burst.c), TDMA clock (tetra_tdma.c) and the full lower MAC
 * (lower_mac/tetra_lower_mac.c and its kernels) — into a mini-receiver
 * driven by the reference's own 64-byte read loop (tetra-rx.c:82-95).
 * The upper MAC is replaced by a printer stub that emits one
 * machine-parseable "REC ..." line per TMV-SAP UNITDATA.ind, plus the
 * reference AACH traffic-detection side effects (tetra_upper_mac.c:423-455)
 * so the traffic-routing decisions in the lower MAC stay live.
 *
 * tests/test_ref_parity.py diffs this program's per-slot decisions
 * (sync events, slot alignment, TDMA time, CRC verdicts, type-1 bits)
 * against tetra_tpu.rx.TetraReceiver over the same captures.
 *
 * This file only CALLS reference code as an oracle; the JAX framework in
 * tetra_tpu/ is an independent implementation validated against it.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>
#include <fcntl.h>

#include <osmocom/core/utils.h>
#include <osmocom/core/msgb.h>
#include <osmocom/core/talloc.h>
#include <osmocom/core/conv.h>

#include <tetra_common.h>
#include <tetra_prim.h>
#include <tetra_tdma.h>
#include <tetra_mac_pdu.h>
#include <phy/tetra_burst_sync.h>
#include <crypto/tetra_crypto.h>

void *tetra_tall_ctx;

/* ---- libosmocore utility stubs (same as tools/gen_golden.c) ---- */
const char *get_value_string(const struct value_string *vs, uint32_t value)
{
	static char unk[32];
	for (; vs->str; vs++)
		if (vs->value == value)
			return vs->str;
	snprintf(unk, sizeof(unk), "unknown(%u)", value);
	return unk;
}

char *osmo_ubit_dump(const uint8_t *bits, unsigned int len)
{
	static char s[8192];
	unsigned int i;
	for (i = 0; i < len && i + 1 < sizeof(s); i++)
		s[i] = bits[i] ? '1' : '0';
	s[i] = 0;
	return s;
}

char *osmo_hexdump(const unsigned char *buf, int len)
{
	static char s[8192];
	for (int i = 0; i < len && 2 * i + 2 < (int)sizeof(s); i++)
		sprintf(s + 2 * i, "%02x", buf[i]);
	return s;
}

/* ---- osmo_conv_decode: plain max-correlation Viterbi ----
 *
 * Semantics (shared with tetra_tpu.ops.viterbi, which documents the
 * derivation): start in state 0; ACS picks the higher-metric
 * predecessor, ties toward the lower-numbered one; end state is the
 * metric argmax with ties toward the lower state.  Soft convention per
 * lower_mac/viterbi.c:6-25: +127 = bit 0, -127 = bit 1, 0 = erasure. */
int osmo_conv_decode(const struct osmo_conv_code *code,
		     const sbit_t *input, ubit_t *output)
{
	const int ns = 1 << (code->K - 1);
	const int T = code->len;
	const int N = code->N;
	int32_t *metric = malloc(sizeof(int32_t) * ns);
	int32_t *next = malloc(sizeof(int32_t) * ns);
	uint8_t *decs = malloc((size_t)T * ns);
	int s, t, j;

	for (s = 0; s < ns; s++)
		metric[s] = s == 0 ? 0 : -1000000;

	for (t = 0; t < T; t++) {
		const sbit_t *in = &input[(size_t)t * N];
		for (s = 0; s < ns; s++) {
			int b = s & 1;
			int p0 = s >> 1, p1 = (s >> 1) | (ns >> 1);
			int32_t c0 = metric[p0], c1 = metric[p1];
			uint8_t o0 = code->next_output[p0][b];
			uint8_t o1 = code->next_output[p1][b];
			for (j = 0; j < N; j++) {
				int32_t v = in[j];
				c0 += (o0 >> (N - 1 - j)) & 1 ? -v : v;
				c1 += (o1 >> (N - 1 - j)) & 1 ? -v : v;
			}
			if (c1 > c0) {
				next[s] = c1;
				decs[(size_t)t * ns + s] = 1;
			} else {
				next[s] = c0;
				decs[(size_t)t * ns + s] = 0;
			}
		}
		memcpy(metric, next, sizeof(int32_t) * ns);
	}

	int best = 0;
	for (s = 1; s < ns; s++)
		if (metric[s] > metric[best])
			best = s;
	for (t = T - 1; t >= 0; t--) {
		output[t] = best & 1;
		best = (best >> 1) | (decs[(size_t)t * ns + best] ? ns >> 1 : 0);
	}

	free(metric);
	free(next);
	free(decs);
	return 0;
}

/* ---- crypto stubs: the parity corpus is unencrypted ---- */
void update_current_network(struct tetra_crypto_state *tcs, int mcc, int mnc)
{
	(void)tcs; (void)mcc; (void)mnc;
}

/* ---- upper MAC printer stub ----
 *
 * One REC line per TMV-SAP UNITDATA.ind, then the reference AACH
 * handling (tetra_upper_mac.c:423-455 state effects) and the
 * tms->tsn side effect of tetra_gsmtap_makemsg (tetra_gsmtap.c:50),
 * which the lower MAC's traffic dump path reads. */
int upper_mac_prim_recv(struct osmo_prim_hdr *op, void *priv)
{
	struct tetra_tmvsap_prim *tmvp = (struct tetra_tmvsap_prim *)op;
	struct tmv_unitdata_param *tup = &tmvp->u.unitdata;
	struct tetra_mac_state *tms = priv;
	struct msgb *msg = op->msg;
	unsigned int len = msgb_l1len(msg);

	printf("REC t=%u/%u/%u lchan=%u crc=%u blk=%d len=%u bits=%s\n",
	       tup->tdma_time.tn, tup->tdma_time.fn, tup->tdma_time.mn,
	       tup->lchan, tup->crc_ok ? 1 : 0, tup->blk_num, len,
	       osmo_ubit_dump(msg->l1h, len));

	if (!tup->crc_ok)
		return -1;

	/* tetra_gsmtap_makemsg side effect (tetra_gsmtap.c:50) */
	tms->tsn = tup->tdma_time.tn - 1;

	if (tup->lchan == TETRA_LC_AACH) {
		struct tetra_acc_ass_decoded aad;
		memset(&aad, 0, sizeof(aad));
		macpdu_decode_access_assign(&aad, msg->l1h,
					    tup->tdma_time.fn == 18 ? 1 : 0);
		if (aad.dl_usage > 3)
			tms->cur_burst.is_traffic = aad.dl_usage;
		else
			tms->cur_burst.is_traffic = 0;
		tms->cur_burst.blk1_stolen = false;
		tms->cur_burst.blk2_stolen = false;
	}

	return -1;
}

/* ---- main: the reference receiver loop (tetra-rx.c:40-103) ---- */
int main(int argc, char **argv)
{
	int fd, opt;
	struct tetra_rx_state *trs;
	struct tetra_mac_state *tms;

	tms = talloc_zero(tetra_tall_ctx, struct tetra_mac_state);
	tetra_mac_state_init(tms);
	tms->tcs = talloc_zero(NULL, struct tetra_crypto_state);
	tms->dumpdir = strdup(".");

	trs = talloc_zero(tetra_tall_ctx, struct tetra_rx_state);
	trs->burst_cb_priv = tms;

	while ((opt = getopt(argc, argv, "d:")) != -1) {
		switch (opt) {
		case 'd':
			free(tms->dumpdir);
			tms->dumpdir = strdup(optarg);
			break;
		default:
			fprintf(stderr, "Unknown option %c\n", opt);
		}
	}

	if (argc <= optind) {
		fprintf(stderr, "Usage: %s [-d DUMPDIR] <file_with_1_byte_per_bit>\n",
			argv[0]);
		exit(1);
	}

	fd = open(argv[optind], O_RDONLY);
	if (fd < 0) {
		perror("open");
		exit(2);
	}

	while (1) {
		uint8_t buf[64];
		int len = read(fd, buf, sizeof(buf));
		if (len < 0) {
			perror("read");
			exit(1);
		} else if (len == 0) {
			printf("EOF\n");
			break;
		}
		tetra_burst_sync_in(trs, buf, len);
	}

	free(tms->dumpdir);
	talloc_free(trs);
	talloc_free(tms->tcs);
	talloc_free(tms);
	return 0;
}
