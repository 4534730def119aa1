#!/usr/bin/env python
"""Bring-up check of the profiler on a GPU, through the user's entry points.

    python chip_smoke.py          # one card: phases 1-6
    python chip_smoke.py --four   # four cards: the sharded paths (phase 7)

One process holds the card(s).  Phases (each fails the run on any
mismatch; every compared number is an integer, so tolerance is 0):

  1. device     JAX version, devices, compile-cache directory, and the
                card's name and power limit (nvidia-smi, in a child process
                that stays off JAX).  No GPU: exit 1, no result line.
  2. native     build native/slimm_native.cpp; the engine must decode with
                it, not with the pure-Python decoder.
  3. kernels    _hist2/_hist1 at 10M records x 12.6M bins against
                np.bincount (one input with a >= 2^16-deep bin, so the
                packed scatter's fallback runs), and pass-A binning plus
                the lineage/table gathers at 10M records x 1000 contigs
                with lengths, bin offsets and taxids past 2^24, against
                numpy indexing.
  4. main path  BASELINE.json configs[2]: a 1000-contig DB (contigs of
                0.5-2 Mbp) and a 10M-record grouped SAM made from a fixed
                seed; `profile -o` on the card.  Its 8 counters must equal
                the single-core C++ baseline (native.baseline_profile) on
                the generated records and on the natively decoded arrays.
  5. streaming  the same file with `--stream 4000000`: TSVs byte-identical.
  6. directory  three 200k-record files, `profile -d -ro -co` on the card
                against the scalar oracle (`--no-device`): byte-identical.
  7. --four     phase 4's file with --shards 4, --shards 2 --model-shards 2
                and --stream 4000000 --shards 4, each byte-identical to a
                one-card run in the same process, plus
                __graft_entry__.dryrun_multichip(4).

The last stdout line is {"ok": true, "device": {...}} and is printed only
when every phase passed.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20260
MAIN_RECORDS = 10_000_000
MAIN_CONTIGS = 1000
STREAM_CHUNK = 4_000_000
DIR_FILES, DIR_RECORDS, DIR_CONTIGS = 3, 200_000, 50
# phase 3 geometry: the 1000-contig file's record count and bin domain
KERNEL_RECORDS, KERNEL_BINS, KERNEL_CONTIGS = 10_000_000, 12_600_000, 1000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_power() -> str:
    """`name, power.limit` of every card, from nvidia-smi (a child process
    that never touches JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in r.stdout.splitlines() if ln.strip())


# ---------------------------------------------------------------------------
# phases (sizes are arguments so the tests can run them tiny on the CPU)
# ---------------------------------------------------------------------------


def phase_device() -> str:
    import jax

    from slimm_jax.utils.compile_cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    devs = jax.devices()
    card = card_name_power()
    log(f"[1 device] jax {jax.__version__}; devices {devs}; "
        f"kind {devs[0].device_kind!r}; compile cache {cache_dir}")
    log(f"[1 device] card: {card}")
    return card


def phase_native() -> None:
    from slimm_jax.config import EngineOptions
    from slimm_jax.io import native

    t0 = time.perf_counter()
    path = native.build_library(force=True)
    if not (native.available() and EngineOptions().use_native):
        raise RuntimeError("engine would use the pure-Python decoder")
    log(f"[2 native] built {path} in {time.perf_counter() - t0:.3f} s")


def _assert_equal(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (int(np.sum(got != want)) if got.shape == want.shape
               else f"shape {got.shape} vs {want.shape}")
        raise AssertionError(f"{name}: device != numpy ({bad} differ)")


def phase_kernels(n_records: int = KERNEL_RECORDS,
                  n_bins: int = KERNEL_BINS,
                  n_contigs: int = KERNEL_CONTIGS) -> None:
    import jax
    import jax.numpy as jnp

    from slimm_jax.engine.pipeline import (_hist1, _hist2, _lineage_rows,
                                           _pass_a_local, _table_col)

    rng = np.random.default_rng(SEED)
    bp = -(-n_bins // 1024) * 1024
    hist2 = jax.jit(_hist2, static_argnums=3)
    hist1 = jax.jit(_hist1, static_argnums=2)

    def bincount(idx, w):
        return np.bincount(idx[w], minlength=bp)

    for case in ("uniform", "deep_bin"):
        idx = rng.integers(0, n_bins, n_records).astype(np.int32)
        w1 = rng.random(n_records) < 0.95
        w2 = rng.random(n_records) < 0.8
        if case == "deep_bin":   # > 2^16 hits in one bin: fallback branch
            deep = (1 << 16) + 7
            idx[:deep] = n_bins // 3
            w1[:deep] = w2[:deep] = True
        d = [jnp.asarray(a) for a in (idx, w1, w2)]
        h1, h2 = hist2(d[0], d[1], d[2], bp)
        want1 = bincount(idx, w1)
        _assert_equal(f"_hist2[{case}] cov", h1, want1)
        _assert_equal(f"_hist2[{case}] uniq_cov", h2, bincount(idx, w2))
        _assert_equal(f"_hist1[{case}]", hist1(d[0], d[1], bp), want1)
        log(f"[3 kernels] _hist2/_hist1 {case}: {n_records} records x "
            f"{bp} bins, deepest bin {int(want1.max())}: exact")

    # per-contig lookups with every table value past 2^24
    lengths = rng.integers((1 << 24) + 1, 1 << 25, n_contigs).astype(
        np.uint32)
    bw = np.int32(1000)
    nbins = lengths // np.uint32(bw) + 1
    boff = ((1 << 24) + np.concatenate([[0], np.cumsum(nbins)[:-1]])).astype(
        np.int32)
    tbp = -(-int(boff[-1] + nbins[-1]) // 1024) * 1024
    rid = rng.integers(0, n_contigs, n_records).astype(np.int32)
    pos = (rng.random(n_records) * (lengths[rid] - 150)).astype(np.int32)
    read_id = np.arange(n_records, dtype=np.int32)
    out = jax.jit(lambda a, b, c: _pass_a_local(
        a, b, c, jnp.asarray(lengths), jnp.asarray(boff), np.int32(75), bw,
        n_contigs=n_contigs, total_bins_pad=tbp, dedup_window=0, k_steps=1,
        window=1))(read_id, rid, pos)
    center = np.minimum(pos.astype(np.uint32) + np.uint32(75), lengths[rid])
    gbin = boff[rid] + (center // np.uint32(bw)).astype(np.int32)
    _assert_equal("pass-A t_gbin", out["t_gbin"], gbin)
    _assert_equal("pass-A cov", out["cov"], np.bincount(gbin, minlength=tbp))

    lineage = rng.integers((1 << 24) + 1, 1 << 30, (n_contigs, 8)).astype(
        np.int32)
    col = rng.integers((1 << 24) + 1, 1 << 30, n_contigs).astype(np.int32)
    ridx = rng.integers(-1, n_contigs + 1, n_records).astype(np.int32)
    rc = np.clip(ridx, 0, n_contigs - 1)
    d_ridx = jnp.asarray(ridx)
    _assert_equal("_lineage_rows", jax.jit(
        _lineage_rows, static_argnums=2)(jnp.asarray(lineage), d_ridx,
                                         n_contigs), lineage[rc])
    _assert_equal("_table_col", jax.jit(
        _table_col, static_argnums=2)(jnp.asarray(col), d_ridx, n_contigs),
        col[rc])
    log(f"[3 kernels] pass-A binning + lineage/table gathers: {n_records} "
        f"records x {n_contigs} contigs, max length {int(lengths.max())}, "
        f"max offset {int(boff.max())}, max taxid {int(lineage.max())}: "
        "exact")


def make_main_inputs(tmp: str, n_records: int = MAIN_RECORDS,
                     n_contigs: int = MAIN_CONTIGS) -> dict:
    """DB (.sldb) + grouped SAM from bench.py's generators (fixed seed)."""
    import bench

    t0 = time.perf_counter()
    w = bench.make_workload(n_records, n_contigs, seed=SEED)
    sam = os.path.join(tmp, "main.sam")
    mb = bench.write_bench_sam(sam, w, n_contigs)
    db = os.path.join(tmp, f"db{n_contigs}.sldb")
    bench.make_bench_db(w, n_contigs).save_sldb(db)
    log(f"[4 main path] generated {len(w['read_id'])} records over "
        f"{n_contigs} contigs ({mb:.1f} MiB SAM) in "
        f"{time.perf_counter() - t0:.3f} s")
    return dict(w=w, sam=sam, db=db)


def run_cli(args: list) -> float:
    from slimm_jax.cli import main

    t0 = time.perf_counter()
    rc = main(args)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"profile {' '.join(args)} exited {rc}")
    return secs


def read_stats(path: str) -> list:
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        r.pop("file")
    return rows


def same_tsvs(a: str, b: str, what: str) -> int:
    names = sorted(os.listdir(a))
    if not names or names != sorted(os.listdir(b)):
        raise AssertionError(f"{what}: outputs differ: {names} vs "
                             f"{sorted(os.listdir(b))}")
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    if mismatch or errors:
        raise AssertionError(f"{what}: TSVs differ: {mismatch + errors}")
    return len(names)


def phase_main_path(tmp: str, inputs: dict, card: str) -> dict:
    import jax

    from slimm_jax.config import EngineOptions
    from slimm_jax.engine.pipeline import open_alignment_file
    from slimm_jax.io import native

    sam, db, w = inputs["sam"], inputs["db"], inputs["w"]
    out = os.path.join(tmp, "out_main") + "/"
    stats = os.path.join(tmp, "main.jsonl")
    secs = run_cli(["profile", "--json-stats", stats, "-o", out, db, sam])
    (eng,) = read_stats(stats)
    # the same run again with every program compiled: splits compile from
    # run time, and must give the same bytes
    warm_out = os.path.join(tmp, "out_main_warm") + "/"
    warm = run_cli(["profile", "-o", warm_out, db, sam])
    same_tsvs(out, warm_out, "warm rerun")
    mem = jax.devices()[0].memory_stats() or {}
    log(f"[4 main path] profile wall {secs:.6f} s cold (compile included), "
        f"{warm:.6f} s warm; peak_bytes_in_use "
        f"{mem.get('peak_bytes_in_use', 'n/a')} (process high-water mark); "
        f"card: {card}")

    af = open_alignment_file(sam, EngineOptions())
    if not isinstance(af, native.NativeAlignmentFile):
        raise RuntimeError("engine decoded with the pure-Python decoder")
    batch = af.load()
    avg = batch.avg_read_length
    got = {"hits": eng["hits_count"], "matches": eng["matches_count"],
           "uniq_matches": eng["uniq_matches_count"],
           "uniq_matches2": eng["uniq_matches_count2"],
           "n_valid_refs": eng["valid_refs"], "lca_total": eng["lca_reads"],
           "cov_mass": eng["cov_mass"],
           "uniq_cov2_mass": eng["uniq_cov2_mass"]}
    # the generated records are exactly the SAM's records; the decoded
    # arrays are the same records after the decoder's first-hit dedup,
    # so all counters but `hits` (the record count) must agree there too
    _, raw = native.baseline_profile(
        w["read_id"], w["rid"], w["pos"], w["n_reads"], w["lengths"],
        w["lineage"], avg, avg)
    _, dec = native.baseline_profile(
        batch.read_id.astype(np.int32), batch.rid, batch.pos,
        batch.n_reads, w["lengths"], w["lineage"], avg, avg)
    if raw != got:
        raise AssertionError(f"engine {got} != C++ baseline {raw}")
    if {k: v for k, v in dec.items() if k != "hits"} != {
            k: v for k, v in raw.items() if k != "hits"}:
        raise AssertionError(f"decoded-array baseline {dec} != {raw}")
    log(f"[4 main path] 8 counters equal the C++ baseline: {got}")
    return dict(out=out, counters=got)


def phase_stream(tmp: str, inputs: dict, main_out: str,
                 chunk: int = STREAM_CHUNK) -> None:
    out = os.path.join(tmp, "out_stream") + "/"
    secs = run_cli(["profile", "--stream", str(chunk), "-o", out,
                    inputs["db"], inputs["sam"]])
    n = same_tsvs(main_out, out, "--stream")
    log(f"[5 streaming] --stream {chunk}: {n} TSV byte-identical "
        f"(wall {secs:.6f} s)")


def phase_directory(tmp: str, n_files: int = DIR_FILES,
                    n_records: int = DIR_RECORDS,
                    n_contigs: int = DIR_CONTIGS) -> None:
    """Directory mode (batched dispatch, -ro/-co bin-level outputs) against
    the scalar oracle.  The files share one header, so they batch."""
    import bench

    indir = os.path.join(tmp, "dir_in")
    os.makedirs(indir)
    w0 = None
    for k in range(n_files):
        w = bench.make_workload(n_records, n_contigs, seed=SEED + 1 + k)
        if w0 is None:
            w0 = w
        else:   # one reference for every file: re-place reads on it
            rng = np.random.default_rng(SEED + 100 + k)
            w["lengths"] = w0["lengths"]
            w["pos"] = (rng.random(len(w["rid"]))
                        * (w0["lengths"][w["rid"]] - w["avg_read_len"])
                        ).astype(np.int32)
        bench.write_bench_sam(os.path.join(indir, f"s{k}.sam"), w, n_contigs)
    db = os.path.join(tmp, "dir_db.sldb")
    bench.make_bench_db(w0, n_contigs).save_sldb(db)
    dev = os.path.join(tmp, "dir_dev") + "/"
    orc = os.path.join(tmp, "dir_oracle") + "/"
    secs = run_cli(["profile", "-d", "-ro", "-co", "-o", dev, db, indir])
    osecs = run_cli(["profile", "--no-device", "-d", "-ro", "-co", "-o", orc,
                     db, indir])
    n = same_tsvs(dev, orc, "directory mode vs oracle")
    log(f"[6 directory] {n_files} files x {n_records} records: {n} TSVs "
        f"byte-identical to the oracle (device {secs:.6f} s, oracle "
        f"{osecs:.6f} s)")


def phase_four(tmp: str, inputs: dict, chunk: int = STREAM_CHUNK) -> None:
    import __graft_entry__

    db, sam = inputs["db"], inputs["sam"]

    def run(tag, extra):
        out = os.path.join(tmp, f"out_{tag}") + "/"
        stats = os.path.join(tmp, f"{tag}.jsonl")
        secs = run_cli(["profile", *extra, "--json-stats", stats, "-o", out,
                        db, sam])
        return out, read_stats(stats), secs

    one, one_stats, secs = run("one", [])
    log(f"[7 four] one card: wall {secs:.6f} s")
    for tag, extra in (("shards4", ["--shards", "4"]),
                       ("shards2x2", ["--shards", "2", "--model-shards",
                                      "2"]),
                       ("stream_shards4", ["--stream", str(chunk),
                                           "--shards", "4"])):
        out, st, secs = run(tag, extra)
        n = same_tsvs(one, out, " ".join(extra))
        if st != one_stats:
            raise AssertionError(f"{' '.join(extra)}: counters {st} != "
                                 f"{one_stats}")
        log(f"[7 four] {' '.join(extra)}: {n} TSV byte-identical, counters "
            f"equal (wall {secs:.6f} s)")
    __graft_entry__.dryrun_multichip(4)
    log("[7 four] dryrun_multichip(4): ok")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded phase")
    args = p.parse_args(argv)
    try:
        import bench  # noqa: F401
        import slimm_jax  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it inside the repository ({e})",
              file=sys.stderr)
        return 2
    import jax

    devs = jax.devices()
    want = 4 if args.four else 1
    if devs[0].platform != "gpu" or len(devs) < want:
        print(f"chip_smoke: needs {want} GPU(s); JAX sees {devs}",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    card = phase_device()
    phase_native()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four:
            phase_four(tmp, make_main_inputs(tmp))
        else:
            phase_kernels()
            inputs = make_main_inputs(tmp)
            res = phase_main_path(tmp, inputs, card)
            phase_stream(tmp, inputs, res["out"])
            phase_directory(tmp)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.3f} s; "
        f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
