"""On-card smoke test: the multi-carrier receiver end to end on an
NVIDIA GPU, through the entry points a user calls.

    python chip_smoke.py              # one card: phases a-e + gpu tests
    python chip_smoke.py --chips 4    # four cards: the sharded phase only

One card, in one process:
  a. wideband hard: MultiCarrierReceiver.process_iq4c over the
     production capture (1024 carriers on the 25 kHz raster, fs = 25.6
     Msps, companded 4+4-bit IQ, full protocol mix, 10% TEA1-encrypted
     carriers, 16 multiframes in 4 chunks) — zero CRC errors;
  b. wideband soft: the clean SYNC/SCH_F capture decoded hard, and at
     8 dB per-channel SNR decoded with demod="soft";
  c. per-carrier bits: process_bits at 1024 carriers — zero CRC errors;
  d. single carrier: the `tetra_tpu.rx` CLI, in process — one
     "CRC COMP: 0x1d0f OK" line per burst written;
  e. GPU against CPU: a 64-carrier capture (fs = 1.6 Msps) through the
     same receiver on the card and on the host CPU; every collected
     field and every native event must be identical;
  then the tests marked `gpu`.

--chips 4: process_bits at 1024 carriers on a 1-D carrier mesh over 4
cards, compared bit for bit with the same run on one card.

Exits non-zero, printing no result, unless JAX's first device is a GPU.
The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import io
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tools"))

N_CAR, N_FRAMES, N_CHUNKS = 1024, 16, 4
N_SMALL = 64
COLLECT_KEYS = ("carrier", "kind", "okA", "okB", "delta", "payload",
                "n_slots", "tail", "scramb")
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class CompileClock:
    """Seconds of XLA backend compilation (JAX's own monitoring event;
    tracing and lowering are not counted), so each phase's compile time
    shows apart."""

    def __init__(self):
        import jax
        self.secs = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == COMPILE_EVENT:
            self.secs += duration


def check(ok, what):
    """A phase check that holds under `python -O` too."""
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def run_phase(clock, name, fn):
    c0, t0 = clock.secs, time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    comp = clock.secs - c0
    print(f"[{name}] wall {wall:.3f} s  compile {comp:.3f} s  "
          f"other {wall - comp:.3f} s", flush=True)
    return out


def diff_runs(a, b):
    """Names of the fields in which two receiver runs differ: the
    collected chunk dicts (COLLECT_KEYS) and the native events."""
    import numpy as np
    (mc_a, col_a), (mc_b, col_b) = a, b
    bad = []
    if len(col_a) != len(col_b):
        bad.append("chunks")
    for da, db in zip(col_a, col_b):
        bad += [k for k in COLLECT_KEYS
                if not np.array_equal(da[k], db[k])]
    ev_a, ev_b = mc_a.native_events, mc_b.native_events
    if len(ev_a) != len(ev_b):
        bad.append("events")
    for ea, eb in zip(ev_a, ev_b):
        bad += ["event." + k for k in ea
                if not np.array_equal(ea[k], eb[k])]
    return sorted(set(bad))


def drive_recorded(B, drive, *args, **kwargs):
    """Run a bench_mc_e2e drive_* pass, keeping each collected chunk."""
    from tetra_tpu import fastpath
    with B.recorded(fastpath.FastChunkPipeline, "collect") as calls:
        mc = drive(*args, **kwargs)
    return mc, [out for _, _, out in calls]


def phase_a(B, ks):
    """Wideband hard over the production capture."""
    import jax
    from tetra_tpu import fastpath
    bits, n_enc = B.mixed_batch(N_CAR, N_FRAMES, enc_frac=0.1)
    packed = B.wideband_capture(bits)
    with B.recorded(fastpath, "fused_chunk_iq") as calls:
        mc = B.drive_wideband(packed, N_CAR, N_CHUNKS, keystore=ks)
    c = B.counts(mc)
    print(f"  a: {N_CAR} carriers ({n_enc} encrypted), "
          f"{len(packed)} wideband samples: {c}", flush=True)
    check(c["crc_err"] == 0 and c["crc_ok"] > 0, c)
    check(min(c["traffic_slots"], c["tl_sdus"], c["frag_ends"]) > 0, c)
    args, kwargs, _ = calls[0]
    g_rows = inspect.signature(fastpath.fused_chunk_iq).bind(
        *args, **kwargs).arguments["g_rows"]
    mem = fastpath.fused_chunk_iq.lower(*args, **kwargs).compile() \
        .memory_analysis()
    fields = ("argument", "output", "temp", "alias", "generated_code")
    print(f"  a: chunk program G={g_rows} rows, memory_analysis "
          + ", ".join(f"{f} {getattr(mem, f + '_size_in_bytes')} B"
                      for f in fields), flush=True)
    jax.block_until_ready(calls[-1][2])
    return c


def phase_b(B):
    """The clean SYNC/SCH_F capture hard, and at 8 dB soft."""
    bits = B.clean_bits(N_CAR, N_FRAMES)
    clean = B.counts(B.drive_wideband(B.wideband_capture(bits), N_CAR,
                                      N_CHUNKS))
    check(clean["crc_err"] == 0 and clean["crc_ok"] > 0, clean)
    soft = B.counts(B.drive_wideband(B.wideband_capture(bits, snr_db=8.0),
                                     N_CAR, N_CHUNKS, demod="soft"))
    print(f"  b: clean hard crc_ok {clean['crc_ok']} crc_err "
          f"{clean['crc_err']}; 8 dB soft crc_ok {soft['crc_ok']} crc_err "
          f"{soft['crc_err']}; soft/clean "
          f"{soft['crc_ok'] / clean['crc_ok']:.4f}", flush=True)
    check(soft["crc_ok"] > 0, soft)
    return clean, soft


def phase_c(B):
    """process_bits at 1024 carriers over the clean bits capture."""
    c = B.counts(B.drive_bits(B.clean_bits(N_CAR, N_FRAMES), N_CHUNKS))
    print(f"  c: {c}", flush=True)
    check(c["crc_err"] == 0 and c["crc_ok"] > 0, c)
    return c


def phase_d():
    """The single-carrier CLI on a double-SYNC head + SCH/F capture:
    acquisition consumes the first SYNC, the second decodes SB1 + SB2
    (two CRC lines), every SCH/F one line — one line per burst."""
    import numpy as np
    import jax.numpy as jnp
    from tetra_tpu import rx, testpdu, tx
    from tetra_tpu.ops.scramble import scramb_get_init
    init = jnp.uint32(scramb_get_init(262, 42, 1))
    aach = testpdu.make_access_assign_bits()
    sync = np.asarray(tx.make_sync_burst(
        testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
        testpdu.make_sysinfo_pdu(), aach, init), np.uint8)
    bursts = [sync, sync] + [np.asarray(tx.make_schf_burst(
        testpdu.make_resource_pdu(ssi=0x400 + i), aach, init), np.uint8)
        for i in range(14)]
    garbage = np.random.default_rng(0).integers(0, 2, 777).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "cap.bits"
        np.concatenate([garbage] + bursts).tofile(path)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rx.main(["-f", "bits", str(path)])
    n_ok = log.getvalue().count("CRC COMP: 0x1d0f OK")
    print(f"  d: {len(bursts)} bursts written, {n_ok} 'CRC COMP: 0x1d0f OK'"
          f" lines; {log.getvalue().strip().splitlines()[-1]}", flush=True)
    check(n_ok == len(bursts), (n_ok, len(bursts)))
    return n_ok


def phase_e(B, ks):
    """The same 64-carrier captures on the card and on the host CPU."""
    import jax
    bits, _ = B.mixed_batch(N_SMALL, N_FRAMES, enc_frac=0.1)
    cpu = jax.devices("cpu")[0]
    out = {}
    for mode, snr in (("hard", None), ("soft", 8.0)):
        packed = B.wideband_capture(bits, snr_db=snr)

        def run():
            return drive_recorded(B, B.drive_wideband, packed, N_SMALL,
                                  N_CHUNKS, keystore=ks, demod=mode)
        gpu_run = run()
        with jax.default_device(cpu):
            cpu_run = run()
        bad = diff_runs(gpu_run, cpu_run)
        c = B.counts(gpu_run[0])
        print(f"  e: {mode} ({'clean' if snr is None else f'{snr} dB'}): "
              f"GPU crc_ok {c['crc_ok']} crc_err {c['crc_err']}, "
              f"CPU crc_ok {B.counts(cpu_run[0])['crc_ok']}; fields that "
              f"differ: {bad or 'none'}", flush=True)
        check(not bad, (mode, bad))
        out[mode] = c
    return out


class _Passes:
    """pytest plugin: counts tests whose call phase passed."""

    def __init__(self):
        self.n = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.n += 1


def phase_gpu_tests():
    """The `gpu`-marked tests, in this process (JAX already holds the
    card, so they run on it); every selected test must pass."""
    import pytest
    files = sorted(str(f) for f in (ROOT / "tests").glob("test_*.py")
                   if "pytest.mark.gpu" in f.read_text())
    passes = _Passes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", str(ROOT), *files], plugins=[passes])
    print(f"  gpu-marked tests: {passes.n} passed", flush=True)
    check(rc == 0 and passes.n > 0, f"gpu-marked tests: pytest exit {rc}, "
          f"{passes.n} passed")


def phase_sharded(B):
    """process_bits over a 1-D carrier mesh of every card == one card."""
    from tetra_tpu.parallel.mesh import make_mesh
    bits = B.clean_bits(N_CAR, N_FRAMES)
    one = drive_recorded(B, B.drive_bits, bits, N_CHUNKS)
    mesh = make_mesh()
    many = drive_recorded(B, B.drive_bits, bits, N_CHUNKS, mesh=mesh)
    bad = diff_runs(one, many)
    c = B.counts(many[0])
    print(f"  sharded over {mesh.devices.size} cards ({mesh.axis_names}): "
          f"{c}; fields that differ from one card: {bad or 'none'}",
          flush=True)
    check(not bad, bad)
    check(c["crc_err"] == 0 and c["crc_ok"] > 0, c)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU; JAX found "
                 f"{devs[0].platform}")
    if len(devs) < args.chips:
        sys.exit(f"chip_smoke: --chips {args.chips} but {len(devs)} cards")
    from tetra_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import bench_mc_e2e as B

    print(B.card_info(), flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)
    clock = CompileClock()
    if args.chips == 4:
        run_phase(clock, "sharded process_bits", lambda: phase_sharded(B))
    else:
        ks = B.keystore_file()
        run_phase(clock, "a wideband hard", lambda: phase_a(B, ks))
        run_phase(clock, "b wideband soft", lambda: phase_b(B))
        run_phase(clock, "c per-carrier bits", lambda: phase_c(B))
        run_phase(clock, "d single-carrier CLI", phase_d)
        run_phase(clock, "e GPU vs CPU", lambda: phase_e(B, ks))
        run_phase(clock, "gpu-marked tests", phase_gpu_tests)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
