"""Device-mesh sharding for multi-carrier / multi-chip operation.

The reference scales by running one OS process per carrier glued with
FIFOs/UDP (reference src/receiver1:8, src/receiver1udp:71-78). Here the
same scaling is a sharded tensor program (SURVEY.md §2.9/§7.1):

- carriers   -> data-parallel axis, sharded over chips ("carrier")
- time       -> sequence axis; the training-sequence correlator needs a
  (seq_len-1)-bit halo at shard boundaries, exchanged with a ppermute
  collective under shard_map — the direct analogue of ring/blockwise
  context parallelism
- bookkeeping (CRC counters) -> psum over the mesh
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
from jax.experimental.shard_map import shard_map

from tetra_tpu import constants as C
from tetra_tpu.lmac import pipeline as lmac
from tetra_tpu.phy import burst as burst_mod

__all__ = ["make_mesh", "make_mesh_2d", "sharded_burst_decode",
           "sharded_match_map", "sharded_locked_step_2d", "MAX_TRAIN_LEN"]

MAX_TRAIN_LEN = 38  # longest training sequence (y, 38 bits)


def make_mesh(devices=None, axis_name: str = "carrier") -> Mesh:
    """1-D mesh over all (or given) devices, carriers sharded across it."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(devices=None, hosts: int = 2,
                 axis_names: tuple = ("host", "chip")) -> Mesh:
    """2-D (host, chip) mesh: the ingest/time axis shards over hosts
    (halos cross the inter-host network), carriers shard over each
    host's devices (SURVEY.md §7.2 step 6)."""
    devices = devices if devices is not None else jax.devices()
    d = np.asarray(devices)
    assert len(d) % hosts == 0, (len(d), hosts)
    return Mesh(d.reshape(hosts, -1), axis_names)


def sharded_burst_decode(mesh: Mesh, axis: str = "carrier"):
    """Jitted multi-carrier slot decoder.

    fn(bursts [C, S, 510] int8, inits [C] uint32, kinds [C, S] int32)
    -> dict of decoded blocks + global CRC-OK count (psum over chips).

    kinds: 0 = SYNC / 1 = SCH/F / 2 = NDB / -1 = none (from
    steady.verify_train_seq). Routes through the kind-compacted fused
    decode (lmac.fused): ONE segmented-Viterbi pass per chip decodes
    every slot under its own interpretation, so each kind's fields are
    only meaningful on slots OF that kind.
    """
    spec_b = P(axis, None, None)
    spec_i = P(axis)
    spec_k = P(axis, None)

    def step(bursts, inits, kinds):
        from tetra_tpu.lmac import fused as fused_mod
        res = fused_mod.decode_slots_fused(bursts,
                                           inits[:, None].astype(jnp.uint32),
                                           kinds)
        total_ok = jax.lax.psum(jnp.sum(res["crc_ok"].astype(jnp.int32)),
                                axis)
        out = {"crc_ok": res["crc_ok"], "crc_ok_total": total_ok,
               "bbk_type1": res["bbk"].type1}
        for k in ("sb1", "sb2", "schf", "ndb1", "ndb2"):
            out[k + "_type1"] = res[k].type1
            out[k + "_ok"] = res[k].crc_ok
        return out

    out_specs = {"crc_ok": spec_k, "crc_ok_total": P(),
                 "bbk_type1": spec_b}
    for k in ("sb1", "sb2", "schf", "ndb1", "ndb2"):
        out_specs[k + "_type1"] = spec_b
        out_specs[k + "_ok"] = spec_k
    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(spec_b, spec_i, spec_k),
        out_specs=out_specs,
        check_rep=False)
    return jax.jit(sharded)


def sharded_locked_step(mesh: Mesh, axis: str = "carrier",
                        phase_bit: int = 0, sps: int = 2,
                        n_slots: int | None = None,
                        decoders: tuple = ("sync", "schf", "ndb")):
    """Jitted steady-state full chain over a carrier-sharded mesh.

    fn(re [C, T], im [C, T], inits [C]) -> locked_step outputs with the
    carrier axis sharded across chips plus a psum'd global CRC-OK count.
    The per-carrier chain has no cross-carrier dependence, so the only
    collective is the bookkeeping psum — linear scaling by construction.
    """
    from tetra_tpu.lmac import steady

    def step(re, im, inits):
        out = steady.locked_step_ri(re, im, inits, phase_bit=phase_bit,
                                    sps=sps, n_slots=n_slots,
                                    decoders=decoders)
        total_ok = jax.lax.psum(out["crc_ok"].astype(jnp.int32).sum(), axis)
        return {"kinds": out["kinds"], "crc_ok": out["crc_ok"],
                "schf_type1": out["schf"].type1 if "schf" in decoders else None,
                "crc_ok_total": total_ok}

    spec2 = P(axis, None)
    out_specs = {"kinds": spec2, "crc_ok": spec2,
                 "schf_type1": P(axis, None, None) if "schf" in decoders else None,
                 "crc_ok_total": P()}
    sharded = shard_map(step, mesh=mesh,
                        in_specs=(spec2, spec2, P(axis)),
                        out_specs=out_specs, check_rep=False)
    return jax.jit(sharded)


def sharded_locked_step_2d(mesh: Mesh, sps: int = 2,
                           decoders: tuple = ("fused",),
                           host_axis: str = "host",
                           chip_axis: str = "chip"):
    """Steady-state full chain over a 2-D (host, chip) mesh.

    fn(re [C, T], im [C, T], inits [C]) with carriers sharded over
    `chip_axis` and TIME sharded over `host_axis` (each host ingests
    only its own time window — T must be a host-multiple of whole slots,
    and slot boundaries assumed at bit 0 as in locked_step_ri with
    phase_bit=0).

    Exactness vs the unsharded chain: the RRC FIR and the differential
    lag need (ntaps//2 + sps) left / (ntaps-1-ntaps//2) right context,
    fetched from time-neighbours via ppermute over the host axis;
    stream-edge shards substitute the zero context the unsharded demod
    uses. The per-chunk timing metric becomes a psum over the host axis
    (an f32 reduction reorder — argmax ties could in principle flip on
    pathological inputs; decode outputs are bit-identical on anything
    non-degenerate, property-tested in tests/test_parallel.py).
    """
    from tetra_tpu.lmac import steady
    from tetra_tpu.phy.dqpsk import rrc_taps, _fir_real

    taps = rrc_taps(sps)
    ntaps = len(taps)
    pad_l = ntaps // 2
    h_left = pad_l + sps
    h_right = ntaps - 1 - pad_l
    H = mesh.shape[host_axis]

    def step(re, im, inits):
        T_loc = re.shape[-1]
        idx = jax.lax.axis_index(host_axis)

        def ext(x):
            left = jax.lax.ppermute(x[:, -h_left:], host_axis,
                                    [(i, (i + 1) % H) for i in range(H)])
            right = jax.lax.ppermute(x[:, :h_right], host_axis,
                                     [(i, (i - 1) % H) for i in range(H)])
            left = jnp.where(idx == 0, 0.0, left)       # stream start
            right = jnp.where(idx == H - 1, 0.0, right)  # stream end
            return jnp.concatenate([left, x, right], axis=-1)

        fr = _fir_real(ext(re), taps)
        fi = _fir_real(ext(im), taps)
        # differential phasor z[n]*conj(z[n-sps]); the unsharded demod
        # zero-pads the lag at the stream start
        cur = lambda f: f[:, h_left: h_left + T_loc]
        lagv = lambda f: f[:, h_left - sps: h_left - sps + T_loc]
        edge = (jnp.arange(T_loc) < sps)[None, :] & (idx == 0)
        lr = jnp.where(edge, 0.0, lagv(fr))
        li = jnp.where(edge, 0.0, lagv(fi))
        frc, fic = cur(fr), cur(fi)
        dr = frc * lr + fic * li
        di = fic * lr - frc * li

        # timing phase: per-shard partial sums -> global argmax
        n = (T_loc // sps) * sps
        drp = dr[..., :n].reshape(*dr.shape[:-1], n // sps, sps)
        dip = di[..., :n].reshape(*di.shape[:-1], n // sps, sps)
        mag2 = drp * drp + dip * dip
        score = jnp.sum(2.0 * jnp.abs(drp * dip) / (mag2 + 1e-12), axis=-2)
        score = jax.lax.psum(score, host_axis)
        best = jnp.argmax(score, axis=-1).astype(jnp.int32)
        sel_r = jnp.take_along_axis(drp, best[..., None, None], axis=-1)[..., 0]
        sel_i = jnp.take_along_axis(dip, best[..., None, None], axis=-1)[..., 0]
        b0 = (sel_i <= 0).astype(jnp.int8)
        b1 = (sel_r < 0).astype(jnp.int8)
        bits = jnp.stack([b0, b1], axis=-1).reshape(b0.shape[0], -1)

        S = bits.shape[-1] // C.BITS_PER_TS
        slots = bits[..., : S * C.BITS_PER_TS].reshape(
            bits.shape[0], S, C.BITS_PER_TS)
        out = steady.locked_step_bits(slots, inits, decoders=decoders)
        total = jax.lax.psum(out["crc_ok"].astype(jnp.int32).sum(),
                             (host_axis, chip_axis))
        return {"kinds": out["kinds"], "crc_ok": out["crc_ok"],
                "schf_type1": out["schf"].type1, "crc_ok_total": total}

    spec_t = P(chip_axis, host_axis)
    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(spec_t, spec_t, P(chip_axis)),
        out_specs={"kinds": spec_t, "crc_ok": spec_t,
                   "schf_type1": P(chip_axis, host_axis, None),
                   "crc_ok_total": P()},
        check_rep=False)
    return jax.jit(sharded)


def sharded_pfb_channelize(mesh: Mesh, n_chan: int,
                           taps_per_branch: int = 16, axis: str = "time"):
    """Jitted time-sharded wideband channelizer with halo exchange.

    fn(re [T], im [T]) -> (chan_re [C, M], chan_im [C, M]) with the
    wideband time axis sharded over `axis` and the channel outputs
    time-sharded the same way. Each shard fetches nfilt - hop wideband
    samples from its right neighbour via ppermute so WOLA windows
    spanning the boundary are exact — the multi-host ingest pattern of
    SURVEY.md §7.2 step 6 (the last shard's windows that would wrap are
    garbage; mask by absolute position).
    """
    from tetra_tpu.phy import pfb as pfb_mod
    n = mesh.shape[axis]
    hop = n_chan // 2
    nfilt = n_chan * taps_per_branch
    halo = nfilt - hop

    def step(re, im):
        perm = [(i, (i - 1) % n) for i in range(n)]

        def extend(x):
            h = jax.lax.ppermute(x[: halo], axis, perm)
            return jnp.concatenate([x, h], axis=-1)

        return pfb_mod.pfb_channelize_ri(extend(re), extend(im), n_chan,
                                         taps_per_branch)

    sharded = shard_map(step, mesh=mesh,
                        in_specs=(P(axis), P(axis)),
                        out_specs=(P(None, axis), P(None, axis)),
                        check_rep=False)
    return jax.jit(sharded)


def sharded_match_map(mesh: Mesh, axis: str = "time"):
    """Jitted training-sequence correlation with halo exchange.

    fn(bits [C, T] int8) -> match [C, T, 5] bool, with T sharded over
    `axis`. Each shard fetches MAX_TRAIN_LEN-1 bits from its right
    neighbour via ppermute so windows spanning the boundary are exact —
    overlap-save, the sequence-parallel halo pattern (SURVEY.md §5).
    """
    n = mesh.shape[axis]

    def step(bits):
        # bits: local shard [C, T/n]
        halo_src = bits[:, : MAX_TRAIN_LEN - 1]
        # receive the *next* shard's head: shift left around the ring
        perm = [(i, (i - 1) % n) for i in range(n)]
        halo = jax.lax.ppermute(halo_src, axis, perm)
        ext = jnp.concatenate([bits, halo], axis=-1)
        m = burst_mod.train_seq_match(ext)
        # windows that would use wrapped halo on the last shard are
        # masked by the caller via absolute position; keep local T size
        return m[:, : bits.shape[-1], :]

    sharded = shard_map(step, mesh=mesh,
                        in_specs=P(None, axis),
                        out_specs=P(None, axis, None),
                        check_rep=False)
    return jax.jit(sharded)
