/* Golden-vector generator.
 *
 * Compiles the self-contained kernels of the read-only reference
 * (/root/reference/src) and runs them on deterministic pseudo-random inputs,
 * dumping (input, output) pairs as JSON to tests/golden/golden.json.
 *
 * This file only CALLS reference code as an oracle; the JAX framework in
 * tetra_tpu/ is an independent implementation validated against these
 * vectors.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <osmocom/core/utils.h>

#include <lower_mac/tetra_scramb.h>
#include <lower_mac/tetra_interleave.h>
#include <lower_mac/tetra_conv_enc.h>
#include <lower_mac/crc_simple.h>
#include <lower_mac/tetra_rm3014.h>
#include <phy/tetra_burst.h>
#include <crypto/tea1.h>
#include <crypto/tea2.h>
#include <crypto/tea3.h>
#include <crypto/taa1.h>
#include <crypto/hurdle.h>

#include "tetra_llc_pdu.h"

/* ---- stubs the reference objects need ---- */
uint32_t bits_to_uint(const uint8_t *bits, unsigned int len)
{
	uint32_t ret = 0;
	while (len--)
		ret = (ret << 1) | (*bits++ & 1);
	return ret;
}

const char *get_value_string(const struct value_string *vs, uint32_t value)
{
	for (; vs->str; vs++)
		if (vs->value == value)
			return vs->str;
	return "unknown";
}

char *osmo_hexdump(const unsigned char *buf, int len)
{
	static char s[8192];
	for (int i = 0; i < len && 2 * i + 2 < (int)sizeof(s); i++)
		sprintf(s + 2 * i, "%02x", buf[i]);
	return s;
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

void tp_sap_udata_ind(enum tp_sap_data_type type, int blk_num,
		      const uint8_t *bits, unsigned int len, void *priv)
{
	(void)type; (void)blk_num; (void)bits; (void)len; (void)priv;
}

void tetra_acelp_type2_to_codec(const uint8_t *in, uint8_t *out);
void tetra_acelp_codec_to_acelp(const uint8_t *in, uint8_t *out);

/* ---- deterministic PRNG (xorshift32) ---- */
static uint32_t rng_state = 0xC0FFEE01u;
static uint32_t xr(void)
{
	uint32_t x = rng_state;
	x ^= x << 13; x ^= x >> 17; x ^= x << 5;
	rng_state = x;
	return x;
}
static void rand_bits(uint8_t *out, int n)
{
	for (int i = 0; i < n; i++)
		out[i] = xr() & 1;
}
static void rand_bytes(uint8_t *out, int n)
{
	for (int i = 0; i < n; i++)
		out[i] = xr() & 0xff;
}

/* ---- JSON emit helpers ---- */
static FILE *jf;
static int first_entry = 1;

static void emit_open(const char *name)
{
	if (!first_entry)
		fprintf(jf, ",\n");
	first_entry = 0;
	fprintf(jf, "\"%s\": {", name);
}
static void emit_close(void) { fprintf(jf, "}"); }
static int first_field;
static void field_sep(void)
{
	if (!first_field)
		fprintf(jf, ", ");
	first_field = 0;
}
static void emit_arr_u8(const char *key, const uint8_t *a, int n)
{
	field_sep();
	fprintf(jf, "\"%s\": [", key);
	for (int i = 0; i < n; i++)
		fprintf(jf, "%s%u", i ? "," : "", a[i]);
	fprintf(jf, "]");
}
static void emit_u32(const char *key, uint32_t v)
{
	field_sep();
	fprintf(jf, "\"%s\": %u", key, v);
}

int main(void)
{
	uint8_t buf[4096], out[4096], out2[4096];
	char name[128];

	jf = fopen("tests/golden/golden.json", "w");
	if (!jf) { perror("open"); return 1; }
	fprintf(jf, "{\n");

	/* ---- scrambler keystreams ---- */
	{
		uint32_t inits[6];
		inits[0] = SCRAMB_INIT;
		inits[1] = tetra_scramb_get_init(262, 42, 1);
		inits[2] = tetra_scramb_get_init(1023, 16383, 63);
		inits[3] = tetra_scramb_get_init(0, 0, 0);
		inits[4] = xr();
		inits[5] = xr();
		for (int i = 0; i < 6; i++) {
			tetra_scramb_get_bits(inits[i], out, 432);
			snprintf(name, sizeof(name), "scramb_%d", i);
			emit_open(name); first_field = 1;
			emit_u32("init", inits[i]);
			emit_arr_u8("keystream", out, 432);
			emit_close();
		}
		emit_open("scramb_get_init"); first_field = 1;
		emit_u32("mcc", 262); emit_u32("mnc", 42); emit_u32("colour", 1);
		emit_u32("init", tetra_scramb_get_init(262, 42, 1));
		emit_close();
	}

	/* ---- block interleaver permutations ---- */
	{
		const struct { uint32_t K, a; } il[] = {
			{120, 11}, {216, 101}, {432, 103}, {168, 13}, {288, 103},
		};
		for (unsigned i = 0; i < sizeof(il)/sizeof(il[0]); i++) {
			uint8_t in[432];
			rand_bits(in, il[i].K);
			block_interleave(il[i].K, il[i].a, in, out);
			block_deinterleave(il[i].K, il[i].a, in, out2);
			snprintf(name, sizeof(name), "interleave_%u_%u", il[i].K, il[i].a);
			emit_open(name); first_field = 1;
			emit_u32("K", il[i].K); emit_u32("a", il[i].a);
			emit_arr_u8("in", in, il[i].K);
			emit_arr_u8("interleaved", out, il[i].K);
			emit_arr_u8("deinterleaved", out2, il[i].K);
			emit_close();
		}
	}

	/* ---- convolutional mother encoder ---- */
	{
		const int lens[] = {80, 144, 288, 112};
		for (unsigned i = 0; i < sizeof(lens)/sizeof(lens[0]); i++) {
			struct conv_enc_state ces;
			uint8_t in[288];
			rand_bits(in, lens[i]);
			/* zero tail like the real chain (last 4 bits zero) */
			in[lens[i]-1] = in[lens[i]-2] = in[lens[i]-3] = in[lens[i]-4] = 0;
			conv_enc_init(&ces);
			conv_enc_input(&ces, in, lens[i], out);
			snprintf(name, sizeof(name), "conv_enc_%d", lens[i]);
			emit_open(name); first_field = 1;
			emit_arr_u8("in", in, lens[i]);
			emit_arr_u8("mother", out, lens[i]*4);
			emit_close();
		}
	}

	/* ---- puncture / depuncture for every scheme ---- */
	{
		const struct { int punct; int t2; int t3; int rate; } ps[] = {
			{TETRA_RCPC_PUNCT_2_3, 80, 120, 4},
			{TETRA_RCPC_PUNCT_292_432, 292, 432, 4},
			{TETRA_RCPC_PUNCT_148_432, 148, 432, 4},
			{TETRA_RCPC_PUNCT_2_3, 144, 216, 4},
			{TETRA_RCPC_PUNCT_2_3, 112, 168, 4},
			{TETRA_RCPC_PUNCT_2_3, 288, 432, 4},
			{TETRA_RCPC_PUNCT_112_168, 112, 168, 3},
			{TETRA_RCPC_PUNCT_72_162, 72, 162, 3},
			{TETRA_RCPC_PUNCT_38_80, 38, 80, 3},
			{TETRA_RCPC_PUNCT_1_3, 48, 144, 4},
		};
		for (unsigned i = 0; i < sizeof(ps)/sizeof(ps[0]); i++) {
			int mlen = ps[i].t2 * ps[i].rate;
			uint8_t mother[292*4];
			for (int j = 0; j < mlen; j++)
				mother[j] = (j * 7 + 3) & 0x7f;  /* distinct markers */
			get_punctured_rate(ps[i].punct, mother, ps[i].t3, out);
			memset(out2, 0xff, mlen);
			tetra_rcpc_depunct(ps[i].punct, out, ps[i].t3, out2);
			snprintf(name, sizeof(name), "punct_%d_%d_%d", ps[i].punct, ps[i].t2, ps[i].t3);
			emit_open(name); first_field = 1;
			emit_u32("punct", ps[i].punct);
			emit_u32("type2_len", ps[i].t2);
			emit_u32("type3_len", ps[i].t3);
			emit_u32("mother_rate", ps[i].rate);
			emit_arr_u8("punctured", out, ps[i].t3);
			emit_arr_u8("depunctured", out2, mlen);
			emit_close();
		}
	}

	/* ---- CRC16 ---- */
	{
		const int lens[] = {60, 76, 124, 140, 268, 272, 284, 288, 92, 7};
		for (unsigned i = 0; i < sizeof(lens)/sizeof(lens[0]); i++) {
			uint8_t in[512];
			rand_bits(in, lens[i]);
			uint16_t crc = crc16_ccitt_bits(in, lens[i]);
			snprintf(name, sizeof(name), "crc16_%d", lens[i]);
			emit_open(name); first_field = 1;
			emit_arr_u8("in", in, lens[i]);
			emit_u32("crc", crc);
			emit_close();
		}
	}

	/* ---- RM(30,14) ---- */
	{
		fflush(stdout);
		tetra_rm3014_init();
		uint8_t vals14[32];
		emit_open("rm3014"); first_field = 1;
		uint32_t words[16];
		uint32_t ins[16];
		for (int i = 0; i < 16; i++) {
			ins[i] = xr() & 0x3fff;
			words[i] = tetra_rm3014_compute((uint16_t)ins[i]);
		}
		ins[0] = 0; words[0] = tetra_rm3014_compute(0);
		ins[1] = 0x3fff; words[1] = tetra_rm3014_compute(0x3fff);
		field_sep(); fprintf(jf, "\"in\": [");
		for (int i = 0; i < 16; i++) fprintf(jf, "%s%u", i?",":"", ins[i]);
		fprintf(jf, "]");
		field_sep(); fprintf(jf, "\"out\": [");
		for (int i = 0; i < 16; i++) fprintf(jf, "%s%u", i?",":"", words[i]);
		fprintf(jf, "]");
		emit_close();
		(void)vals14;
	}

	/* ---- burst builders ---- */
	{
		uint8_t sb[120], bb[30], bkn[216], bkn1[216], bkn2[216], burst[510];
		rand_bits(sb, 120); rand_bits(bb, 30); rand_bits(bkn, 216);
		build_sync_c_d_burst(burst, sb, bb, bkn);
		emit_open("burst_sync"); first_field = 1;
		emit_arr_u8("sb", sb, 120);
		emit_arr_u8("bb", bb, 30);
		emit_arr_u8("bkn", bkn, 216);
		emit_arr_u8("burst", burst, 510);
		emit_close();

		rand_bits(bkn1, 216); rand_bits(bkn2, 216); rand_bits(bb, 30);
		build_norm_c_d_burst(burst, bkn1, bb, bkn2, 0);
		emit_open("burst_norm0"); first_field = 1;
		emit_arr_u8("bkn1", bkn1, 216);
		emit_arr_u8("bb", bb, 30);
		emit_arr_u8("bkn2", bkn2, 216);
		emit_arr_u8("burst", burst, 510);
		emit_close();

		build_norm_c_d_burst(burst, bkn1, bb, bkn2, 1);
		emit_open("burst_norm1"); first_field = 1;
		emit_arr_u8("bkn1", bkn1, 216);
		emit_arr_u8("bb", bb, 30);
		emit_arr_u8("bkn2", bkn2, 216);
		emit_arr_u8("burst", burst, 510);
		emit_close();
	}

	/* ---- training sequence finder ---- */
	{
		/* embed the SYNC training sequence at a known offset inside noise */
		uint8_t stream[1024];
		unsigned int offs = 0;
		int rc;
		rand_bits(stream, 1024);
		/* plant y_bits at 300 by building a sync burst there */
		uint8_t sb[120], bb[30], bkn[216], burst[510];
		rand_bits(sb, 120); rand_bits(bb, 30); rand_bits(bkn, 216);
		build_sync_c_d_burst(burst, sb, bb, bkn);
		memcpy(stream + 86, burst, 510);  /* y_bits land at 86+214=300 */
		rc = tetra_find_train_seq(stream, 900, (1 << TETRA_TRAIN_SYNC), &offs);
		emit_open("train_seq_sync"); first_field = 1;
		emit_arr_u8("stream", stream, 1024);
		emit_u32("rc", (uint32_t)rc);
		emit_u32("offset", offs);
		emit_close();
	}

	/* ---- TEA keystream generators ---- */
	{
		uint8_t key[10], ks[64];
		uint32_t ivs[3] = {0x00000000u, 0x12345678u, 0x0FFFFFFFu};
		for (int v = 0; v < 3; v++) {
			rand_bytes(key, 10);
			tea1(ivs[v], key, 64, ks);
			snprintf(name, sizeof(name), "tea1_%d", v);
			emit_open(name); first_field = 1;
			emit_u32("iv", ivs[v]);
			emit_arr_u8("key", key, 10);
			emit_arr_u8("ks", ks, 64);
			emit_close();

			tea2(ivs[v], key, 64, ks);
			snprintf(name, sizeof(name), "tea2_%d", v);
			emit_open(name); first_field = 1;
			emit_u32("iv", ivs[v]);
			emit_arr_u8("key", key, 10);
			emit_arr_u8("ks", ks, 64);
			emit_close();

			tea3(ivs[v], key, 64, ks);
			snprintf(name, sizeof(name), "tea3_%d", v);
			emit_open(name); first_field = 1;
			emit_u32("iv", ivs[v]);
			emit_arr_u8("key", key, 10);
			emit_arr_u8("ks", ks, 64);
			emit_close();
		}
	}

	/* ---- HURDLE block cipher ---- */
	{
		uint8_t k16[16], pt[16], ct[16], rec[15];
		rand_bytes(k16, 16); rand_bytes(pt, 16);
		pt[15] = 0;
		HURDLE_enc_cbc(ct, pt, k16);
		emit_open("hurdle_cbc"); first_field = 1;
		emit_arr_u8("key", k16, 16);
		emit_arr_u8("pt", pt, 16);
		emit_arr_u8("ct", ct, 16);
		emit_close();

		/* CTS decrypt of a 15-byte sealed blob (7 + 8 stolen layout) */
		uint8_t sealed[15];
		memcpy(sealed, ct, 7);
		memcpy(sealed + 7, ct + 8, 8);
		HURDLE_dec_cts(rec, sealed, k16);
		emit_open("hurdle_cts"); first_field = 1;
		emit_arr_u8("key", k16, 16);
		emit_arr_u8("sealed", sealed, 15);
		emit_arr_u8("pt", rec, 15);
		emit_close();
	}

	/* ---- TAA1 primitives ---- */
	{
		uint8_t k[10], rs[10], ksout[16], cn[2], la[2], cc[1], eck[10];
		uint8_t kk16[16], rand10[10], res[4], dck[10];
		rand_bytes(kk16, 16); rand_bytes(rs, 10);
		ta11_ta41(kk16, rs, ksout);
		emit_open("ta11"); first_field = 1;
		emit_arr_u8("k", kk16, 16);
		emit_arr_u8("rs", rs, 10);
		emit_arr_u8("ks", ksout, 16);
		emit_close();

		rand_bytes(kk16, 16); rand_bytes(rand10, 10);
		ta12_ta22(kk16, rand10, res, dck);
		emit_open("ta12"); first_field = 1;
		emit_arr_u8("ks", kk16, 16);
		emit_arr_u8("rand", rand10, 10);
		emit_arr_u8("res", res, 4);
		emit_arr_u8("dck", dck, 10);
		emit_close();

		rand_bytes(kk16, 16); rand_bytes(rs, 10);
		ta21(kk16, rs, ksout);
		emit_open("ta21"); first_field = 1;
		emit_arr_u8("k", kk16, 16);
		emit_arr_u8("rs", rs, 10);
		emit_arr_u8("ksp", ksout, 16);
		emit_close();

		/* ta31 seal + ta32 unseal */
		uint8_t cck[10], cckid[2], sealed15[15], rec10[10], mf;
		rand_bytes(cck, 10); rand_bytes(cckid, 2); rand_bytes(dck, 10);
		ta31(cck, cckid, dck, sealed15);
		ta32(sealed15, cckid, dck, rec10, &mf);
		emit_open("ta31_32"); first_field = 1;
		emit_arr_u8("cck", cck, 10);
		emit_arr_u8("cckid", cckid, 2);
		emit_arr_u8("dck", dck, 10);
		emit_arr_u8("sealed", sealed15, 15);
		emit_arr_u8("unsealed", rec10, 10);
		emit_u32("mf", mf);
		emit_close();

		/* ta51 seal + ta52 unseal */
		uint8_t sck[10], vn[2], keyn = 0x15, keyn_out;
		rand_bytes(sck, 10); rand_bytes(vn, 2); rand_bytes(kk16, 16);
		ta51(sck, vn, kk16, &keyn, sealed15);
		ta52(sealed15, kk16, vn, rec10, &mf, &keyn_out);
		emit_open("ta51_52"); first_field = 1;
		emit_arr_u8("sck", sck, 10);
		emit_arr_u8("vn", vn, 2);
		emit_arr_u8("key", kk16, 16);
		emit_u32("keyn", keyn);
		emit_arr_u8("sealed", sealed15, 15);
		emit_arr_u8("unsealed", rec10, 10);
		emit_u32("mf", mf);
		emit_u32("keyn_out", keyn_out);
		emit_close();

		/* ta71 */
		uint8_t gck[10], mgck[10];
		rand_bytes(gck, 10); rand_bytes(cck, 10);
		ta71(gck, cck, mgck);
		emit_open("ta71"); first_field = 1;
		emit_arr_u8("gck", gck, 10);
		emit_arr_u8("cck", cck, 10);
		emit_arr_u8("mgck", mgck, 10);
		emit_close();

		/* ta81/82 */
		uint8_t gckn[2], gckvn[2];
		rand_bytes(gck, 10); rand_bytes(gckn, 2); rand_bytes(gckvn, 2); rand_bytes(kk16, 16);
		ta81(gck, gckvn, gckn, kk16, sealed15);
		uint8_t gckn_out[2];
		ta82(sealed15, gckvn, kk16, rec10, &mf, gckn_out);
		emit_open("ta81_82"); first_field = 1;
		emit_arr_u8("gck", gck, 10);
		emit_arr_u8("gckvn", gckvn, 2);
		emit_arr_u8("gckn", gckn, 2);
		emit_arr_u8("key", kk16, 16);
		emit_arr_u8("sealed", sealed15, 15);
		emit_arr_u8("unsealed", rec10, 10);
		emit_arr_u8("gckn_out", gckn_out, 2);
		emit_u32("mf", mf);
		emit_close();

		/* ta91/92 (gsko is 12 bytes: 10 + 2 vn slot per ta81 aliasing) */
		uint8_t gsko[12], gsko_out[12];
		rand_bytes(gsko, 12); rand_bytes(gckvn, 2); rand_bytes(kk16, 16);
		ta91(gsko, gckvn, kk16, sealed15);
		ta92(sealed15, gckvn, kk16, gsko_out, &mf);
		emit_open("ta91_92"); first_field = 1;
		emit_arr_u8("gsko", gsko, 12);
		emit_arr_u8("vn", gckvn, 2);
		emit_arr_u8("key", kk16, 16);
		emit_arr_u8("sealed", sealed15, 15);
		emit_arr_u8("unsealed", gsko_out, 12);
		emit_u32("mf", mf);
		emit_close();

		/* tb4 / tb5 / tb6 / tb7 */
		uint8_t d1[10], d2[10], d3[10];
		rand_bytes(d1, 10); rand_bytes(d2, 10);
		tb4(d1, d2, d3);
		emit_open("tb4"); first_field = 1;
		emit_arr_u8("dck1", d1, 10);
		emit_arr_u8("dck2", d2, 10);
		emit_arr_u8("dck", d3, 10);
		emit_close();

		rand_bytes(k, 10);
		cn[0] = 0x03; cn[1] = 0xA5;   /* 12-bit carrier */
		la[0] = 0x21; la[1] = 0x7B;   /* 14-bit LA */
		cc[0] = 0x2A;                 /* 6-bit colour code */
		tb5(cn, la, cc, k, eck);
		emit_open("tb5"); first_field = 1;
		emit_arr_u8("cn", cn, 2);
		emit_arr_u8("la", la, 2);
		emit_arr_u8("cc", cc, 1);
		emit_arr_u8("ck", k, 10);
		emit_arr_u8("eck", eck, 10);
		emit_close();

		uint8_t ssi[3];
		rand_bytes(k, 10); rand_bytes(ssi, 3);
		cn[0] = 0x0F; cn[1] = 0xFF;
		tb6(k, cn, ssi, eck);
		emit_open("tb6"); first_field = 1;
		emit_arr_u8("sck", k, 10);
		emit_arr_u8("cn", cn, 2);
		emit_arr_u8("ssi", ssi, 3);
		emit_arr_u8("eck", eck, 10);
		emit_close();

		uint8_t gsko12[12], egsko[16];
		rand_bytes(gsko12, 12);
		tb7(gsko12, egsko);
		emit_open("tb7"); first_field = 1;
		emit_arr_u8("gsko", gsko12, 12);
		emit_arr_u8("egsko", egsko, 16);
		emit_close();
	}

	/* ---- ACELP speech bit reordering ---- */
	{
		uint8_t in[432], codec[432], back[432];
		rand_bits(in, 432);
		memset(codec, 0, sizeof(codec));
		tetra_acelp_type2_to_codec(in, codec);
		tetra_acelp_codec_to_acelp(codec, back);
		emit_open("acelp_reorder"); first_field = 1;
		emit_arr_u8("type2", in, 432);
		emit_arr_u8("codec", codec, 432);
		emit_arr_u8("back", back, 432);
		emit_close();
	}

	/* ---- LLC PDU parse + FCS ---- */
	{
		/* BL-UDATA-FCS: 4-bit type (6) + payload + 32-bit FCS */
		struct tetra_llc_pdu lpp;
		uint8_t pdu[200];
		int plen = 96;
		rand_bits(pdu, plen);
		pdu[0] = 0; pdu[1] = 1; pdu[2] = 1; pdu[3] = 0; /* type 6 */
		memset(&lpp, 0, sizeof(lpp));
		tetra_llc_pdu_parse(&lpp, pdu, plen);
		emit_open("llc_bl_udata_fcs"); first_field = 1;
		emit_arr_u8("pdu", pdu, plen);
		emit_u32("pdu_type", lpp.pdu_type);
		emit_u32("tl_sdu_len", lpp.tl_sdu_len);
		emit_u32("fcs", lpp.fcs);
		emit_u32("fcs_invalid", lpp.fcs_invalid);
		emit_close();
	}

	fprintf(jf, "\n}\n");
	fclose(jf);
	printf("golden vectors written\n");
	return 0;
}
