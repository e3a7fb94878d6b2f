"""Kind-compacted fused decode vs the per-interpretation reference path.

The fused path (lmac.fused) must be bit-identical, per slot, to what
steady.locked_step_bits computes for that slot's classified kind — on
clean bursts AND under random corruption (where Viterbi/traceback tie
behaviour matters).
"""
import numpy as np
import jax.numpy as jnp

from tetra_tpu import tx, testpdu, constants as C
from tetra_tpu.ops import rcpc, viterbi
from tetra_tpu.ops.scramble import scramb_get_init
from tetra_tpu.ops.viterbi_pallas import decode_pallas
from tetra_tpu.lmac import steady, fused, pipeline

INIT = scramb_get_init(262, 42, 1)


def _mixed_slots(n=24, seed=0, corrupt=0):
    rng = np.random.default_rng(seed)
    slots = np.zeros((n, 510), np.int8)
    kinds = np.zeros(n, np.int32)
    for i in range(n):
        k = i % 3
        kinds[i] = k
        if k == 0:
            b = tx.make_sync_burst(
                testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
                testpdu.make_sysinfo_pdu(),
                testpdu.make_access_assign_bits(), jnp.uint32(INIT))
        elif k == 1:
            b = tx.make_schf_burst(testpdu.make_resource_pdu(ssi=0x400 + i),
                                   testpdu.make_access_assign_bits(),
                                   jnp.uint32(INIT))
        else:
            b = tx.make_ndb_burst(rng.integers(0, 2, 124).astype(np.int8),
                                  rng.integers(0, 2, 124).astype(np.int8),
                                  testpdu.make_access_assign_bits(),
                                  jnp.uint32(INIT))
        slots[i] = b
        if corrupt:
            flips = rng.choice(510, size=corrupt, replace=False)
            slots[i, flips] ^= 1
    return slots, kinds


class TestSegmentedViterbi:
    """Segmented decode == independent per-segment decodes."""

    def _check(self, rng, layouts):
        B = len(layouts)
        soft = (rng.integers(-1, 2, size=(B, fused.N_MOTHER)) * 127).astype(
            np.float32)
        rmask = np.zeros((B, len(fused.BOUNDARIES)), np.float32)
        expect = np.zeros((B, fused.N_SYM), np.int8)
        for i, segs in enumerate(layouts):
            t = 0
            for seg_len in segs:
                if t:
                    rmask[i, fused.BOUNDARIES.index(t)] = 1.0
                piece = viterbi.decode(
                    jnp.asarray(soft[i:i + 1, t * 4:(t + seg_len) * 4]),
                    seg_len)
                expect[i, t:t + seg_len] = np.asarray(piece)[0]
                t += seg_len
        got = np.asarray(fused.decode_segmented(jnp.asarray(soft),
                                                jnp.asarray(rmask)))
        np.testing.assert_array_equal(got, expect)
        got_k = np.asarray(decode_pallas(
            jnp.asarray(soft), fused.N_SYM, C.CONV_GENERATORS_CCH,
            jnp.asarray(rmask), fused.BOUNDARIES, block_rows=8,
            interpret=True))
        np.testing.assert_array_equal(got_k, expect)

    def test_all_kind_layouts_random_soft(self):
        rng = np.random.default_rng(7)
        # SYNC 80+144+64pad, SCH/F 288, NDB 144+144, and full-split
        self._check(rng, [(80, 144, 64), (288,), (144, 144),
                          (80, 64, 80, 64), (288,), (80, 144, 64)])

    def test_clean_roundtrip_segments(self):
        rng = np.random.default_rng(8)
        data = rng.integers(0, 2, size=(4, 288)).astype(np.int8)
        # terminate each segment of an NDB-style layout
        data[:, 140:144] = 0
        data[:, 284:288] = 0
        soft = np.zeros((4, fused.N_MOTHER), np.float32)
        for i in range(4):
            for t0, t1 in ((0, 144), (144, 288)):
                mother = rcpc.conv_encode(jnp.asarray(data[i:i + 1, t0:t1]))
                soft[i, t0 * 4:t1 * 4] = (1 - 2 * np.asarray(mother)[0]) * 127
        rmask = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
        got = np.asarray(fused.decode_segmented(jnp.asarray(soft),
                                                jnp.asarray(rmask)))
        np.testing.assert_array_equal(got, data)


class TestFusedVsReference:
    def _compare(self, slots, kinds_built):
        ref = steady.locked_step_bits(jnp.asarray(slots)[None],
                                      jnp.asarray([INIT], jnp.uint32))
        # feed the fused path the CLASSIFIED kinds, as the receiver does
        # (corruption may destroy the training sequence -> kind -1)
        kinds = np.asarray(ref["kinds"])[0]
        got = fused.decode_slots_fused(jnp.asarray(slots),
                                       jnp.uint32(INIT),
                                       jnp.asarray(kinds))
        np.testing.assert_array_equal(np.asarray(ref["crc_ok"])[0],
                                      np.asarray(got["crc_ok"]))
        pairs = {0: [("sb1", "sb1"), ("sb2", "sb2")],
                 1: [("schf", "schf")], 2: [("ndb1", "ndb1"),
                                            ("ndb2", "ndb2")]}
        for i, k in enumerate(kinds):
            if k < 0:
                continue
            for rname, gname in pairs[int(k)]:
                np.testing.assert_array_equal(
                    np.asarray(ref[rname].type1)[0, i],
                    np.asarray(got[gname].type1)[i], err_msg=f"{rname}[{i}]")
                assert bool(np.asarray(ref[rname].crc_ok)[0, i]) == \
                    bool(np.asarray(got[gname].crc_ok)[i])
            # BBK position is kind-dependent (tetra_burst.c:346-372);
            # check both paths kind-select it identically, and against
            # the per-kind pipeline decode as an independent oracle
            np.testing.assert_array_equal(
                np.asarray(ref["bbk"].type1)[0, i],
                np.asarray(got["bbk"].type1)[i], err_msg=f"ref bbk[{i}]")
            kind_fn = {0: pipeline.decode_sync_burst,
                       1: pipeline.decode_schf_burst,
                       2: pipeline.decode_ndb_burst}[int(k)]
            bbk_ref = kind_fn(jnp.asarray(slots[i:i + 1]), jnp.uint32(INIT))
            np.testing.assert_array_equal(
                np.asarray(bbk_ref["BBK"].type1)[0],
                np.asarray(got["bbk"].type1)[i], err_msg=f"bbk[{i}]")

    def test_clean_mixed(self):
        self._compare(*_mixed_slots(n=24, seed=0))

    def test_corrupted_mixed(self):
        for nflip in (3, 20, 120):
            self._compare(*_mixed_slots(n=12, seed=nflip, corrupt=nflip))

    def test_batched_shape(self):
        slots, kinds = _mixed_slots(n=12, seed=1)
        out = fused.decode_slots_fused(
            jnp.asarray(slots.reshape(3, 4, 510)),
            jnp.full((3, 4), INIT, jnp.uint32),
            jnp.asarray(kinds.reshape(3, 4)))
        assert out["schf"].type1.shape == (3, 4, 268)
        assert out["crc_ok"].shape == (3, 4)
