"""Where one chunk of the production wideband configuration spends its
time, on the device and on the host.

Drives bench_mc_e2e's production capture (run_prod: 1024 carriers,
companded 4+4-bit IQ, full protocol mix, 10% TEA1) through
MultiCarrierReceiver.process_iq4c, keeps the arguments of one
mid-stream call of the fused chunk program (fastpath.fused_chunk_iq),
and then:

  1. times the host side of a warm receiver pass: the bundle fetch +
     row decode (FastChunkPipeline.collect) and the C++ walk
     (NativeControlPlane.walk2);
  2. times that chunk program on the device with the fused Viterbi
     kernel and with the XLA scan in its place (turns: kernel, scan,
     scan, kernel; median of --reps calls each, ended by
     block_until_ready).

With --layers it instead traces --trace-calls calls of the chunk
program with jax.profiler and splits the device time by the program's
named scopes (dequant, pfb, demod, sync_scan, compaction, fec, bundle);
the kernels of each scope are found through the op_name metadata of the
compiled HLO. XLA's command buffers (CUDA graphs) hide the kernels they
hold from the trace, so --layers turns them off for the whole process
(--xla_gpu_enable_command_buffer=); its times are for attribution, not
the production figure.

Prints one JSON object (last line) and, with --layers, writes the trace
and a per-kernel table under --out.

Usage: python tools/profile_chunk.py [--layers] [--carriers 1024]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import pathlib
import re
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

if "--layers" in sys.argv:       # before JAX starts its GPU backend
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=")
import jax  # noqa: E402

SCOPES = ("fec", "dequant", "pfb", "demod", "sync_scan", "compaction",
          "bundle")


def scope_of(op_name: str) -> str:
    parts = op_name.split("/")
    for s in SCOPES:          # "fec" first: SB1 pre-decode sits in
        if s in parts:        # compaction/fec
            return s
    return "other"


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> named scope, from op_name metadata."""
    out = {}
    for m in re.finditer(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?"
                         r'op_name="([^"]*)"', hlo_text, re.M):
        out[m.group(1)] = scope_of(m.group(2))
    return out


def device_events(trace_dir: pathlib.Path):
    """(name, stats, start_ns, dur_ns) of every event on a GPU plane."""
    from jax.profiler import ProfileData
    path = next(trace_dir.rglob("*.xplane.pb"))
    pd = ProfileData.from_file(str(path))
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                yield (ev.name, dict(ev.stats), ev.start_ns, ev.duration_ns)


def split_by_scope(events, names_to_scope):
    """Device busy time per scope, the busy union and the window."""
    per = collections.Counter()
    kern = collections.Counter()
    spans = []
    for name, stats, t0, dur in events:
        hlo = str(stats.get("hlo_op", name))
        scope = names_to_scope.get(hlo, names_to_scope.get(name, "other"))
        per[scope] += dur
        kern[(scope, hlo)] += dur
        spans.append((t0, t0 + dur))
    spans.sort()
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    return per, kern, busy, window


@contextlib.contextmanager
def timed_method(obj, name, acc):
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        acc.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, wrapper)
    try:
        yield
    finally:
        setattr(obj, name, fn)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", action="store_true")
    p.add_argument("--carriers", type=int, default=1024)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--chunks", type=int, default=4)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--trace-calls", type=int, default=3)
    p.add_argument("--out", default="chiprun_out/profile_chunk")
    a = p.parse_args(argv)
    from tetra_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import bench_mc_e2e as B
    from tetra_tpu import fastpath
    from tetra_tpu.ops import viterbi
    from tetra_tpu.umac.native_exec import NativeControlPlane
    out_dir = pathlib.Path(a.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = jax.devices()[0]
    res = {"card": B.card_info(), "device": {"platform": dev.platform,
                                      "kind": dev.device_kind,
                                      "count": len(jax.devices())},
           "carriers": a.carriers}

    bits, _ = B.mixed_batch(a.carriers, a.frames, enc_frac=0.1)
    packed = B.wideband_capture(bits)
    ks = B.keystore_file()
    real = fastpath.fused_chunk_iq
    with B.recorded(fastpath, "fused_chunk_iq") as calls:
        B.drive_wideband(packed, a.carriers, a.chunks, keystore=ks)
    args, kw, _ = calls[len(calls) // 2]
    g_rows = args[18]
    res["g_rows"] = int(g_rows)

    if a.layers:
        res["layers"] = layers(real.lower(*args, **kw).compile(), args[:11],
                               out_dir, a.trace_calls)
        print(json.dumps(res))
        return

    # 1. host side of a warm pass: fetch + row decode, and the C++ walk
    collect_s, walk_s = [], []
    t0 = time.perf_counter()
    with timed_method(fastpath.FastChunkPipeline, "collect", collect_s), \
            timed_method(NativeControlPlane, "walk2", walk_s):
        mc = B.drive_wideband(packed, a.carriers, a.chunks, keystore=ks)
    res["warm_pass_s"] = time.perf_counter() - t0
    res["collect_s"] = collect_s
    res["walk2_s"] = walk_s
    res["counts"] = B.counts(mc)

    # 2. the chunk program with the kernel, then with the XLA scan
    kernel_prog = real.lower(*args, **kw).compile()
    dyn = args[:11]                 # the non-static arguments

    def scan_only(soft, n_sym, generators=viterbi.CONV_GENERATORS_CCH,
                  rmask=None, boundaries=()):
        flat = soft.reshape((-1, soft.shape[-1]))
        if boundaries:
            out = viterbi.decode_segmented(
                flat, rmask.reshape((-1, len(boundaries))), n_sym,
                tuple(boundaries), generators)
        else:
            out = viterbi.decode(flat, n_sym, generators)
        return out.reshape(*soft.shape[:-1], n_sym)
    fast = viterbi.decode_fast
    viterbi.decode_fast = scan_only
    jax.clear_caches()
    try:
        scan_prog = real.lower(*args, **kw).compile()
    finally:
        viterbi.decode_fast = fast
        jax.clear_caches()
    t = {"kernel": [], "scan": []}
    for which in ("kernel", "scan", "scan", "kernel"):
        prog = kernel_prog if which == "kernel" else scan_prog
        t[which].append(B.median_time(lambda: prog(*dyn), a.reps))
    res["chunk_device_s"] = t
    res["chunk_kernel_equals_scan"] = all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in
        zip(jax.tree.leaves(kernel_prog(*dyn)),
            jax.tree.leaves(scan_prog(*dyn))))
    print(json.dumps(res))


def layers(prog, dyn, out_dir, calls):
    """Device time per named scope over `calls` traced calls, the busy
    union and the window; writes the per-kernel table."""
    trace_dir = out_dir / "trace"
    jax.block_until_ready(prog(*dyn))
    with jax.profiler.trace(str(trace_dir)):
        for _ in range(calls):
            jax.block_until_ready(prog(*dyn))
    per, kern, busy, window = split_by_scope(device_events(trace_dir),
                                             hlo_scopes(prog.as_text()))
    total = sum(per.values())
    with open(out_dir / "kernels.txt", "w") as f:
        for (scope, hlo), ns in kern.most_common():
            f.write(f"{ns / calls / 1e3:12.1f} us  {scope:11s} {hlo}\n")
    return {"trace_calls": calls,
            "device_ns_by_scope": dict(per),
            "device_share_by_scope": {k: v / max(total, 1)
                                      for k, v in per.items()},
            "device_busy_ns": busy, "device_window_ns": window}


if __name__ == "__main__":
    main()
