"""Steady-state locked pipeline: IQ in, decoded blocks out, one program."""
import numpy as np
import jax.numpy as jnp

from tetra_tpu import tx, testpdu, constants as C
from tetra_tpu.ops.scramble import scramb_get_init
from tetra_tpu.phy import dqpsk
from tetra_tpu.lmac import steady

INIT = scramb_get_init(262, 42, 1)


def _mixed_slots(n_carriers=2, n_slots=4, seed=0):
    rng = np.random.default_rng(seed)
    slots = np.zeros((n_carriers, n_slots, 510), np.int8)
    kinds = np.zeros((n_carriers, n_slots), np.int32)
    payloads = {}
    for c in range(n_carriers):
        for s in range(n_slots):
            k = (c + s) % 3
            kinds[c, s] = k
            if k == 0:
                b = tx.make_sync_burst(
                    testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
                    testpdu.make_sysinfo_pdu(),
                    testpdu.make_access_assign_bits(), jnp.uint32(INIT))
            elif k == 1:
                pdu = testpdu.make_resource_pdu(ssi=0x400 + 10 * c + s)
                payloads[(c, s)] = pdu
                b = tx.make_schf_burst(pdu, testpdu.make_access_assign_bits(),
                                       jnp.uint32(INIT))
            else:
                b1 = rng.integers(0, 2, 124).astype(np.int8)
                b2 = rng.integers(0, 2, 124).astype(np.int8)
                payloads[(c, s)] = (b1, b2)
                b = tx.make_ndb_burst(b1, b2, testpdu.make_access_assign_bits(),
                                      jnp.uint32(INIT))
            slots[c, s] = b
    return slots, kinds, payloads


class TestSteady:
    def test_classify_and_decode(self):
        slots, kinds, payloads = _mixed_slots()
        inits = jnp.asarray(np.full(2, INIT, np.uint32))
        out = steady.locked_step_bits(jnp.asarray(slots), inits)
        np.testing.assert_array_equal(np.asarray(out["kinds"]), kinds)
        assert np.asarray(out["crc_ok"]).all()
        for (c, s), payload in payloads.items():
            if kinds[c, s] == 1:
                np.testing.assert_array_equal(
                    np.asarray(out["schf"].type1[c, s]), payload)
            else:
                np.testing.assert_array_equal(
                    np.asarray(out["ndb1"].type1[c, s]), payload[0])
                np.testing.assert_array_equal(
                    np.asarray(out["ndb2"].type1[c, s]), payload[1])

    def test_lock_lost_detection(self):
        slots, kinds, _ = _mixed_slots(seed=1)
        slots[0, 1, C.NORM_TRAIN_OFFSET:C.NORM_TRAIN_OFFSET + 22] ^= 1
        slots[0, 1, C.SYNC_TRAIN_OFFSET:C.SYNC_TRAIN_OFFSET + 5] ^= 1
        out = steady.locked_step_bits(jnp.asarray(slots),
                                      jnp.asarray(np.full(2, INIT, np.uint32)))
        assert int(np.asarray(out["kinds"])[0, 1]) == -1
        assert not bool(np.asarray(out["crc_ok"])[0, 1])

    def test_full_chain_from_iq(self):
        slots, kinds, payloads = _mixed_slots(seed=2)
        Cc, S = slots.shape[:2]
        bitstream = slots.reshape(Cc, -1)
        # pad both ends so RRC transients fall outside the slots
        pad = np.zeros((Cc, 64), np.int8)
        bits = np.concatenate([pad, bitstream, pad], axis=1)
        iq = dqpsk.modulate(bits, sps=2)
        out = steady.locked_step_iq(jnp.asarray(iq),
                                    jnp.asarray(np.full(Cc, INIT, np.uint32)),
                                    phase_bit=64, n_slots=S)
        np.testing.assert_array_equal(np.asarray(out["kinds"]), kinds)
        assert np.asarray(out["crc_ok"]).all()


class TestGroupedDecode:
    def test_matches_full_decode(self):
        slots, kinds, payloads = _mixed_slots(n_carriers=3, n_slots=5, seed=9)
        flat = slots.reshape(-1, 510)
        flat_kinds = np.asarray(steady.verify_train_seq(jnp.asarray(flat)))
        inits = np.full(len(flat), INIT, np.uint32)
        groups = steady.grouped_decode(flat, inits, flat_kinds)
        # every slot accounted for exactly once
        seen = np.concatenate([idx for idx, _ in groups.values()])
        assert sorted(seen.tolist()) == list(range(len(flat)))
        # payload spot-checks against the flat index space
        n_slots = slots.shape[1]
        for (c, s), payload in payloads.items():
            fi = c * n_slots + s
            if kinds[c, s] == 1:
                idx, res = groups["schf"]
                row = int(np.nonzero(idx == fi)[0][0])
                np.testing.assert_array_equal(res["SCH_F"].type1[row], payload)
                assert res["SCH_F"].crc_ok[row]
            elif kinds[c, s] == 2:
                idx, res = groups["ndb"]
                row = int(np.nonzero(idx == fi)[0][0])
                np.testing.assert_array_equal(res["NDB1"].type1[row], payload[0])
                np.testing.assert_array_equal(res["NDB2"].type1[row], payload[1])
        idx, res = groups["sync"]
        assert res["SB1"].crc_ok.all() and res["SB2"].crc_ok.all()
