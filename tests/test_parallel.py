"""Sharded multi-carrier decode + halo-exchanged correlation on the
8-device virtual CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tetra_tpu import constants as C, tx, testpdu
from tetra_tpu.ops.scramble import scramb_get_init
from tetra_tpu.parallel.mesh import (make_mesh, sharded_burst_decode,
                                     sharded_match_map, MAX_TRAIN_LEN)
from tetra_tpu.phy import burst as burst_mod
from tetra_tpu.lmac import pipeline


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


class TestShardedDecode:
    def test_matches_unsharded(self, devices):
        mesh = make_mesh(devices)
        init = scramb_get_init(262, 42, 1)
        rng = np.random.default_rng(0)
        Cc, S = 16, 2
        bursts = np.zeros((Cc, S, 510), np.int8)
        kinds = np.zeros((Cc, S), np.int32)
        for c in range(Cc):
            for s in range(S):
                if (c + s) % 2 == 0:
                    b = tx.make_sync_burst(
                        testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
                        testpdu.make_sysinfo_pdu(),
                        testpdu.make_access_assign_bits(), jnp.uint32(init))
                    kinds[c, s] = 0
                else:
                    schf = testpdu.make_resource_pdu(ssi=c * 10 + s)
                    b = tx.make_schf_burst(
                        schf, testpdu.make_access_assign_bits(), jnp.uint32(init))
                    kinds[c, s] = 1
                bursts[c, s] = b
        inits = np.full(Cc, init, np.uint32)

        fn = sharded_burst_decode(mesh)
        out = fn(jnp.asarray(bursts), jnp.asarray(inits), jnp.asarray(kinds))

        # unsharded reference: per-interpretation decode on each slot's
        # kind (the fused path's fields are meaningful on matching
        # kinds only, so compare kind-masked)
        ref_schf = pipeline.decode_schf_burst(
            jnp.asarray(bursts), jnp.asarray(inits)[:, None])
        ref_sync = pipeline.decode_sync_burst(
            jnp.asarray(bursts), jnp.asarray(inits)[:, None])
        m1 = kinds == 1
        m0 = kinds == 0
        np.testing.assert_array_equal(np.asarray(out["schf_type1"])[m1],
                                      np.asarray(ref_schf["SCH_F"].type1)[m1])
        np.testing.assert_array_equal(np.asarray(out["sb1_type1"])[m0],
                                      np.asarray(ref_sync["SB1"].type1)[m0])
        # correct blocks decode with CRC OK according to their kind
        schf_ok = np.asarray(out["schf_ok"])
        sb_ok = np.asarray(out["sb1_ok"]) & np.asarray(out["sb2_ok"])
        ok = np.where(kinds == 1, schf_ok, sb_ok)
        assert ok.all()
        assert np.asarray(out["crc_ok"]).all()
        assert int(np.asarray(out["crc_ok_total"])) == Cc * S

    def test_halo_exchange_matches_unsharded(self, devices):
        mesh = jax.sharding.Mesh(np.asarray(devices), ("time",))
        rng = np.random.default_rng(1)
        T = 8 * 256
        bits = rng.integers(0, 2, size=(2, T)).astype(np.int8)
        # plant a training sequence straddling a shard boundary (shard = 256)
        start = 256 * 3 - 10
        bits[0, start:start + len(C.TRAIN_Y)] = C.TRAIN_Y
        sharded = sharded_match_map(mesh)(jnp.asarray(bits))
        ref = burst_mod.train_seq_match(jnp.asarray(bits))
        # positions within MAX_TRAIN_LEN of the global end differ (ring halo
        # wraps); mask them
        valid = T - (MAX_TRAIN_LEN - 1)
        np.testing.assert_array_equal(np.asarray(sharded)[:, :valid],
                                      np.asarray(ref)[:, :valid])
        assert bool(np.asarray(sharded)[0, start, 0])


class TestShardedFullChain:
    def test_matches_unsharded(self, devices):
        from tetra_tpu.parallel.mesh import sharded_locked_step
        from tetra_tpu.lmac import steady
        from tetra_tpu.phy import dqpsk
        init = scramb_get_init(262, 42, 1)
        Cc, S = 8, 2
        slots = []
        for c in range(Cc):
            row = []
            for s in range(S):
                pdu = testpdu.make_resource_pdu(ssi=c * 10 + s)
                row.append(tx.make_schf_burst(
                    pdu, testpdu.make_access_assign_bits(), jnp.uint32(init)))
            slots.append(np.concatenate(row))
        pad = np.zeros((Cc, 64), np.int8)
        bits = np.concatenate([pad, np.stack(slots).astype(np.int8), pad], axis=1)
        iq = dqpsk.modulate(bits, sps=2)
        re = jnp.asarray(np.real(iq).astype(np.float32))
        im = jnp.asarray(np.imag(iq).astype(np.float32))
        inits = jnp.asarray(np.full(Cc, init, np.uint32))

        mesh = make_mesh(devices)
        fn = sharded_locked_step(mesh, phase_bit=64, n_slots=S,
                                 decoders=("schf",))
        out = fn(re, im, inits)
        ref = steady.locked_step_ri(re, im, inits, phase_bit=64, n_slots=S,
                                    decoders=("schf",))
        np.testing.assert_array_equal(np.asarray(out["kinds"]),
                                      np.asarray(ref["kinds"]))
        np.testing.assert_array_equal(np.asarray(out["schf_type1"]),
                                      np.asarray(ref["schf"].type1))
        assert int(np.asarray(out["crc_ok_total"])) == Cc * S


class TestShardedPfb:
    def test_matches_unsharded(self, devices):
        from tetra_tpu.parallel.mesh import sharded_pfb_channelize
        from tetra_tpu.phy import pfb
        mesh = jax.sharding.Mesh(np.asarray(devices), ("time",))
        n_chan, J = 16, 16
        hop = n_chan // 2
        T = 8 * 64 * hop  # 8 shards x 64 hops
        rng = np.random.default_rng(5)
        re = jnp.asarray(rng.normal(0, 1, T).astype(np.float32))
        im = jnp.asarray(rng.normal(0, 1, T).astype(np.float32))

        fn = sharded_pfb_channelize(mesh, n_chan, J)
        cr_s, ci_s = fn(re, im)
        cr_u, ci_u = pfb.pfb_channelize_ri(re, im, n_chan, J)

        # sharded yields T/hop frames; unsharded (T - nfilt)/hop + 1 —
        # compare the common prefix excluding the last shard's wrap region
        m_common = np.asarray(cr_u).shape[-1]
        wrap = (n_chan * J) // hop + 1
        np.testing.assert_allclose(np.asarray(cr_s)[:, :m_common - wrap],
                                   np.asarray(cr_u)[:, :m_common - wrap],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(ci_s)[:, :m_common - wrap],
                                   np.asarray(ci_u)[:, :m_common - wrap],
                                   rtol=0, atol=1e-4)


class TestLockedStep2D:
    """2-D (host, chip) mesh: time over hosts (halo exchange), carriers
    over chips — outputs must match the unsharded steady chain."""

    def test_matches_unsharded(self, devices):
        from tetra_tpu.parallel.mesh import make_mesh_2d, sharded_locked_step_2d
        from tetra_tpu.lmac import steady
        from tetra_tpu.phy import dqpsk

        mesh = make_mesh_2d(devices, hosts=2)   # 2 hosts x 4 chips
        init = scramb_get_init(262, 42, 1)
        rng = np.random.default_rng(3)
        Cc, S_total = 8, 8                      # 4 slots per host shard
        slots = np.zeros((Cc, S_total, 510), np.int8)
        for c in range(Cc):
            for s in range(S_total):
                k = (c + s) % 3
                if k == 0:
                    b = tx.make_sync_burst(
                        testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
                        testpdu.make_sysinfo_pdu(),
                        testpdu.make_access_assign_bits(), jnp.uint32(init))
                elif k == 1:
                    b = tx.make_schf_burst(
                        testpdu.make_resource_pdu(ssi=c * 16 + s),
                        testpdu.make_access_assign_bits(), jnp.uint32(init))
                else:
                    b = tx.make_ndb_burst(
                        rng.integers(0, 2, 124).astype(np.int8),
                        rng.integers(0, 2, 124).astype(np.int8),
                        testpdu.make_access_assign_bits(), jnp.uint32(init))
                slots[c, s] = b
        bits = slots.reshape(Cc, -1)
        iq = dqpsk.modulate(bits.astype(np.int8), sps=2)
        re = np.real(iq).astype(np.float32)
        im = np.imag(iq).astype(np.float32)
        inits = np.full(Cc, init, np.uint32)

        ref = steady.locked_step_ri(jnp.asarray(re), jnp.asarray(im),
                                    jnp.asarray(inits), phase_bit=0,
                                    n_slots=S_total, decoders=("fused",))

        fn = sharded_locked_step_2d(mesh)
        out = fn(jnp.asarray(re), jnp.asarray(im), jnp.asarray(inits))

        np.testing.assert_array_equal(np.asarray(out["kinds"]),
                                      np.asarray(ref["kinds"]))
        np.testing.assert_array_equal(np.asarray(out["crc_ok"]),
                                      np.asarray(ref["crc_ok"]))
        np.testing.assert_array_equal(np.asarray(out["schf_type1"]),
                                      np.asarray(ref["schf"].type1))
        assert int(out["crc_ok_total"]) == int(
            np.asarray(ref["crc_ok"]).sum())
        # every slot of a clean capture must decode
        assert int(out["crc_ok_total"]) == Cc * S_total

    def test_sharding_layout(self, devices):
        """Inputs/outputs carry the declared 2-D shardings."""
        from tetra_tpu.parallel.mesh import make_mesh_2d, sharded_locked_step_2d
        mesh = make_mesh_2d(devices, hosts=2)
        rng = np.random.default_rng(0)
        Cc, S_total = 4, 4
        T = S_total * 255 * 2
        re = jnp.asarray(rng.normal(0, 1, (Cc, T)).astype(np.float32))
        im = jnp.asarray(rng.normal(0, 1, (Cc, T)).astype(np.float32))
        inits = jnp.asarray(np.full(Cc, 3, np.uint32))
        out = sharded_locked_step_2d(mesh)(re, im, inits)
        assert out["kinds"].shape == (Cc, S_total)
        shard_shapes = {s.data.shape for s in out["kinds"].addressable_shards}
        assert shard_shapes == {(Cc // 4, S_total // 2)}
