/* Full-stack differential-parity oracle receiver.
 *
 * Like tools/ref_rx.c, but the upper half is NOT stubbed: this build
 * links the reference's ACTUAL upper MAC (tetra_upper_mac.c:157-385
 * rx_resrc/rx_macfrag/rx_macend, SYSINFO/AACH handling), LLC
 * (tetra_llc.c:111-179 incl. the advanced-link defragmenter), MLE
 * dispatch (tetra_mle.c:20-53), the MAC/LLC/MLE PDU codecs and the
 * complete crypto suite (crypto/tetra_crypto.c + TEA1/2/3 + TAA1 +
 * HURDLE), on top of the same PHY + lower MAC chain.  Its stdout
 * (RESOURCE/FRAG-START/FRAG-CONT/FRAG-END/TM-SDU/TL-SDU/BNCH SYSINFO
 * lines) is the oracle for tests/test_ref_parity_upper.py, which
 * diffs field-level decisions against tetra_tpu's upper half (both
 * the Python plane and the native executor's event stream).
 *
 * Only the I/O edges are stubbed: GSMTAP export (tetra_gsmtap.c —
 * keeping its tms->tsn side effect, tetra_gsmtap.c:50) and the TUN
 * device (tuntap.c).
 *
 * This file only CALLS reference code as an oracle; the JAX framework
 * in tetra_tpu/ is an independent implementation validated against it.
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
#include <tetra_gsmtap.h>
#include <phy/tetra_burst_sync.h>
#include <crypto/tetra_crypto.h>

void *tetra_tall_ctx;

/* ---- libosmocore utility stubs (same as tools/ref_rx.c) ---- */
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

/* ---- osmo_conv_decode: plain max-correlation Viterbi (documented in
 * tools/ref_rx.c; standing in for the external libosmocore routine) */
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

/* ---- GSMTAP stub: keep the tms->tsn side effect the traffic-dump
 * path reads (tetra_gsmtap.c:50), emit nothing ---- */
struct msgb *tetra_gsmtap_makemsg(struct tetra_tdma_time *tm,
				  enum tetra_log_chan lchan, uint8_t ts,
				  uint8_t ss, int8_t signal_dbm, uint8_t snr,
				  const uint8_t *bitdata, unsigned int bitlen,
				  struct tetra_mac_state *tms)
{
	(void)tm; (void)lchan; (void)ss; (void)signal_dbm; (void)snr;
	(void)bitdata; (void)bitlen;
	tms->tsn = ts;
	return NULL;
}

int tetra_gsmtap_sendmsg(struct msgb *msg)
{
	(void)msg;
	return 0;
}

int tetra_gsmtap_init(const char *host, uint16_t port)
{
	(void)host; (void)port;
	return 0;
}

/* ---- TUN stub (tuntap.c) ---- */
int tun_alloc(char *dev)
{
	(void)dev;
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
	tetra_crypto_state_init(tms->tcs);
	tms->dumpdir = strdup(".");

	trs = talloc_zero(tetra_tall_ctx, struct tetra_rx_state);
	trs->burst_cb_priv = tms;

	while ((opt = getopt(argc, argv, "d:k:")) != -1) {
		switch (opt) {
		case 'd':
			free(tms->dumpdir);
			tms->dumpdir = strdup(optarg);
			break;
		case 'k':
			load_keystore(optarg);
			break;
		default:
			fprintf(stderr, "Unknown option %c\n", opt);
		}
	}

	if (argc <= optind) {
		fprintf(stderr,
			"Usage: %s [-d DUMPDIR] [-k KEYSTORE] <1_byte_per_bit>\n",
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
