"""Bit-exactness of the core ops against reference-generated golden vectors."""
import numpy as np
import jax.numpy as jnp
import pytest

from tetra_tpu.ops import scramble, interleave, rcpc, crc, rm3014
from tetra_tpu.ops import viterbi
from tetra_tpu.utils import bits as bitutils
from tests.conftest import arr


class TestScrambler:
    @pytest.mark.parametrize("i", range(6))
    def test_keystream(self, golden, i):
        e = golden[f"scramb_{i}"]
        ks = scramble.keystream_np(int(e["init"]), 432)
        np.testing.assert_array_equal(ks, arr(e, "keystream"))

    def test_keystream_device(self, golden):
        e = golden["scramb_1"]
        init = jnp.uint32(int(e["init"]))
        ks = np.asarray(scramble.keystream(init, 432))
        np.testing.assert_array_equal(ks, arr(e, "keystream"))

    def test_get_init(self, golden):
        e = golden["scramb_get_init"]
        assert scramble.scramb_get_init(e["mcc"], e["mnc"], e["colour"]) == e["init"]

    def test_scramb_roundtrip(self, golden):
        rng = np.random.default_rng(0)
        x = rng.integers(0, 2, size=(3, 432)).astype(np.int8)
        init = jnp.uint32(scramble.scramb_get_init(262, 42, 1))
        y = scramble.scramb_bits(init, jnp.asarray(x))
        z = scramble.scramb_bits(init, y)
        np.testing.assert_array_equal(np.asarray(z), x)

    def test_batched_inits(self):
        inits = np.array([3, scramble.scramb_get_init(262, 42, 1)], dtype=np.uint32)
        ks = np.asarray(scramble.keystream(jnp.asarray(inits), 64))
        for i, init in enumerate(inits):
            np.testing.assert_array_equal(ks[i], scramble.keystream_np(int(init), 64))


class TestInterleave:
    @pytest.mark.parametrize("K,a", [(120, 11), (216, 101), (432, 103), (168, 13), (288, 103)])
    def test_golden(self, golden, K, a):
        e = golden[f"interleave_{K}_{a}"]
        x = jnp.asarray(arr(e, "in"))
        np.testing.assert_array_equal(
            np.asarray(interleave.block_interleave(K, a, x)), arr(e, "interleaved"))
        np.testing.assert_array_equal(
            np.asarray(interleave.block_deinterleave(K, a, x)), arr(e, "deinterleaved"))

    def test_roundtrip_batched(self):
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.integers(0, 2, size=(4, 432)).astype(np.int8))
        y = interleave.block_interleave(432, 103, x)
        z = interleave.block_deinterleave(432, 103, y)
        np.testing.assert_array_equal(np.asarray(z), np.asarray(x))


class TestConvEnc:
    @pytest.mark.parametrize("L", [80, 144, 288, 112])
    def test_golden(self, golden, L):
        e = golden[f"conv_enc_{L}"]
        out = rcpc.conv_encode(jnp.asarray(arr(e, "in")))
        np.testing.assert_array_equal(np.asarray(out), arr(e, "mother"))


class TestPuncture:
    CASES = [
        ("2_3", 0, 80, 120), ("292_432", 2, 292, 432), ("148_432", 3, 148, 432),
        ("2_3", 0, 144, 216), ("2_3", 0, 112, 168), ("2_3", 0, 288, 432),
        ("112_168", 4, 112, 168), ("72_162", 5, 72, 162), ("38_80", 6, 38, 80),
        ("1_3", 1, 48, 144),
    ]

    @pytest.mark.parametrize("scheme,pid,t2,t3", CASES)
    def test_golden(self, golden, scheme, pid, t2, t3):
        e = golden[f"punct_{pid}_{t2}_{t3}"]
        rate = int(e["mother_rate"])
        mother = np.array([(j * 7 + 3) & 0x7F for j in range(t2 * rate)], dtype=np.int32)
        out = rcpc.puncture(scheme, jnp.asarray(mother), t3)
        np.testing.assert_array_equal(np.asarray(out), arr(e, "punctured"))
        dep = rcpc.depuncture_hard(scheme, out, t2 * rate)
        np.testing.assert_array_equal(np.asarray(dep), np.asarray(e["depunctured"]))


class TestCRC16:
    @pytest.mark.parametrize("L", [60, 76, 124, 140, 268, 272, 284, 288, 92, 7])
    def test_golden(self, golden, L):
        e = golden[f"crc16_{L}"]
        x = arr(e, "in")
        assert crc.crc16_bits_np(x) == e["crc"]
        val = int(np.asarray(crc.crc16_value(jnp.asarray(x))))
        assert val == e["crc"]

    def test_gf2_paths_identical(self):
        """gf2_matmul's s8 contraction must agree bit-for-bit with a
        numpy integer GF(2) product on every block length the pipeline
        uses."""
        from tetra_tpu.utils.bits import gf2_matmul
        rng = np.random.default_rng(5)
        for L in (60, 284, 288, 510):
            M, _ = crc.crc16_matrix(min(L, 288))
            Mx = np.zeros((L, 16), np.uint8)
            Mx[: M.shape[0]] = M
            x = jnp.asarray(rng.integers(0, 2, size=(33, L)).astype(np.int8))
            np.testing.assert_array_equal(
                np.asarray(gf2_matmul(x, jnp.asarray(Mx))),
                (np.asarray(x, np.int64) @ Mx.astype(np.int64)) % 2)

    def test_check_constant(self):
        # encode-style: appended complemented+byteswapped CRC verifies to 0x1D0F
        rng = np.random.default_rng(2)
        data = rng.integers(0, 2, size=60).astype(np.uint8)
        # the reference's swap16 + little-endian pbit2ubit round-trip is an
        # identity: the appended bits are just ~crc MSB-first
        # (conv_enc_test.c:224-231)
        c = crc.crc16_bits_np(data) ^ 0xFFFF
        full = np.concatenate([data, bitutils.uint_to_bits(c, 16)])
        assert crc.crc16_bits_np(full) == crc.TETRA_CRC_OK
        assert bool(np.asarray(crc.crc16_check(jnp.asarray(full))))


class TestRM3014:
    def test_golden(self, golden):
        e = golden["rm3014"]
        for inp, out in zip(e["in"], e["out"]):
            assert rm3014.encode_uint(int(inp)) == int(out)

    def test_device_encode_decode(self, golden):
        e = golden["rm3014"]
        vals = np.asarray(e["in"], dtype=np.int64)
        bits14 = np.stack([bitutils.uint_to_bits(int(v), 14) for v in vals])
        cw = rm3014.encode(jnp.asarray(bits14))
        info, ok = rm3014.decode(cw)
        np.testing.assert_array_equal(np.asarray(info), bits14)
        assert bool(np.asarray(ok).all())

    def test_single_bit_correction(self):
        bits14 = bitutils.uint_to_bits(0x2A5A, 14)
        cw = np.asarray(rm3014.encode(jnp.asarray(bits14)))
        for pos in [0, 13, 17, 29]:
            bad = cw.copy()
            bad[pos] ^= 1
            info, ok = rm3014.decode(jnp.asarray(bad), correct=True)
            np.testing.assert_array_equal(np.asarray(info), bits14)
            assert bool(np.asarray(ok))
        info, ok = rm3014.decode(jnp.asarray(bad), correct=False)
        assert not bool(np.asarray(ok))


class TestFCS32:
    def test_llc_parse_golden(self, golden):
        e = golden["llc_bl_udata_fcs"]
        pdu = arr(e, "pdu")
        # BL-UDATA-FCS: payload bits 4..len-32, FCS = last 32 bits
        payload = pdu[4:-32]
        computed = crc.fcs32_np(payload)
        extracted = bitutils.bits_to_uint(pdu[-32:])
        assert extracted == e["fcs"]
        # reference reported invalid iff computed != extracted
        assert (computed != extracted) == bool(e["fcs_invalid"])

    def test_affine_matches_serial(self):
        rng = np.random.default_rng(3)
        for L in (8, 31, 32, 33, 96):
            x = rng.integers(0, 2, size=L).astype(np.uint8)
            bits = np.asarray(crc.fcs32(jnp.asarray(x)))
            assert bitutils.bits_to_uint(bits) == crc.fcs32_np(x)


class TestViterbi:
    def test_clean_roundtrip_cch(self):
        rng = np.random.default_rng(4)
        for L in (80, 144, 288):
            data = rng.integers(0, 2, size=(5, L)).astype(np.int8)
            data[:, -4:] = 0  # tail bits
            mother = rcpc.conv_encode(jnp.asarray(data))
            soft = (1.0 - 2.0 * np.asarray(mother)) * 127.0
            dec = viterbi.decode(jnp.asarray(soft), L)
            np.testing.assert_array_equal(np.asarray(dec), data)

    def test_punctured_roundtrip(self):
        # full SB1 FEC slice: encode -> puncture -> depuncture(soft) -> viterbi
        rng = np.random.default_rng(5)
        data = rng.integers(0, 2, size=(8, 80)).astype(np.int8)
        data[:, -4:] = 0
        mother = rcpc.conv_encode(jnp.asarray(data))
        t3 = rcpc.puncture("2_3", mother, 120)
        soft = rcpc.depuncture_soft("2_3", (1.0 - 2.0 * np.asarray(t3)) * 127.0, 320)
        dec = viterbi.decode(jnp.asarray(soft), 80)
        np.testing.assert_array_equal(np.asarray(dec), data)

    def test_erasure_tolerance(self):
        rng = np.random.default_rng(6)
        data = rng.integers(0, 2, size=(1, 80)).astype(np.int8)
        data[:, -4:] = 0
        mother = np.asarray(rcpc.conv_encode(jnp.asarray(data)))
        soft = (1.0 - 2.0 * mother) * 127.0
        soft[:, 40:44] = 0.0  # erase one symbol's outputs
        dec = viterbi.decode(jnp.asarray(soft), 80)
        np.testing.assert_array_equal(np.asarray(dec), data)

    def test_tch_code_roundtrip(self):
        from tetra_tpu.constants import CONV_GENERATORS_TCH
        rng = np.random.default_rng(7)
        data = rng.integers(0, 2, size=(3, 112)).astype(np.int8)
        data[:, -4:] = 0
        mother = rcpc.conv_encode(jnp.asarray(data), CONV_GENERATORS_TCH)
        soft = (1.0 - 2.0 * np.asarray(mother)) * 127.0
        dec = viterbi.decode(jnp.asarray(soft), 112, CONV_GENERATORS_TCH)
        np.testing.assert_array_equal(np.asarray(dec), data)
