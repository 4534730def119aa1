"""Command-line front-ends.

  slimm-jax profile  — the profiler (reference `slimm`, src/slimm.cpp:60-180)
  slimm-jax build    — the DB builder (reference `slimm_build`,
                       src/slimm_build.cpp:76-145)
  slimm-jax collect  — multi-sample profile merge (collect_profiles.py)

Option names, defaults, and ranges mirror the reference CLIs exactly.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .config import BuildOptions, EngineOptions, ProfileOptions
from .taxonomy import RANK_LIST


def _range_float(lo, hi):
    def parse(s):
        v = float(s)
        if not (lo <= v <= hi):
            raise argparse.ArgumentTypeError(
                f"value {v} not in range [{lo}, {hi}]")
        return v
    return parse


def build_profile_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser(
        "profile",
        help="Species Level Identification of Microbes from Metagenomes",
        description="Taxonomic profiling of SAM/BAM alignments against a "
                    ".sldb database (JAX device engine).")
    p.add_argument("DB", help="taxonomy database (.sldb or .sldb.npz)")
    p.add_argument("IN", help="SAM/BAM file (or directory with -d)")
    p.add_argument("-o", "--output-prefix", default=None,
                   help="output path prefix.")
    p.add_argument("-w", "--bin-width", type=int, default=0,
                   help="Set the width of a single bin in neuclotides.")
    p.add_argument("-mr", "--min-reads", type=int, default=0,
                   help="Minimum number of matching reads to consider a "
                        "reference present.")
    p.add_argument("-r", "--rank", default="species", choices=RANK_LIST,
                   help="The taxonomic rank of identification")
    p.add_argument("-cc", "--cov-cut-off", type=_range_float(0.0, 1.0),
                   default=0.95,
                   help="the quantile of coverages to use as a cutoff "
                        "smaller value means bigger threshold.")
    p.add_argument("-ac", "--abundance-cut-off", type=_range_float(0.0, 10.0),
                   default=0.01, help="do not report abundances below this value")
    p.add_argument("-d", "--directory", action="store_true",
                   help="Input is a directory.")
    p.add_argument("-ro", "--raw-output", action="store_true",
                   help="Output raw reference statstics")
    p.add_argument("-co", "--coverage-output", action="store_true",
                   help="Output raw coverage statstics")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Enable verbose output.")
    # device execution knobs (no reference analogue; results are invariant)
    p.add_argument("--shards", type=int, default=None,
                   help="data-parallel device shards (default: all devices)")
    p.add_argument("--hash-read-names", action="store_true",
                   help="intern read names as 64-bit hashes (billion-read "
                        "scale mode: ~1/4 the dictionary memory; colliding "
                        "names merge, ~3%% chance of one merged pair at "
                        "1e9 reads)")
    p.add_argument("--stream", type=int, default=0, metavar="TARGETS",
                   help="chunk-streaming decode+profile with this many "
                        "alignment targets per device chunk (bounds device "
                        "memory for huge files; 0 = whole-file dispatch)")
    p.add_argument("--model-shards", type=int, default=1,
                   help="shard the coverage-state bin axis over this many "
                        "devices (for databases whose bin tables exceed "
                        "one device; results are bit-identical)")
    p.add_argument("--no-device", action="store_true",
                   help="run the scalar oracle instead of the device engine")
    p.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler trace here")
    p.add_argument("--json-stats", default=None,
                   help="append one JSON line of counters per input file "
                        "(structured observability alongside the reference's "
                        "stderr phase log)")
    return p


def build_build_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser(
        "build",
        help="gets a reduced taxonomic information given a multi-fasta file "
             "using accession numbers")
    p.add_argument("FASTA", help="A multi-fasta file used as a reference "
                                 "for mapping")
    p.add_argument("ACC2TAXID", nargs="+",
                   help="one or more accession to taxa id mapping files "
                        "downloaded from ncbi (separated by space.)")
    p.add_argument("-o", "--output-file", default="slimm_db.sldb",
                   help="The path to the output file (default slimm_db.sldb)")
    p.add_argument("-nm", "--names", required=True,
                   help="NCBI's names.dmp file which contains the mapping "
                        "of taxaid to name")
    p.add_argument("-nd", "--nodes", required=True,
                   help="NCBI's nodes.dmp file which contains the taxonomic "
                        "tree.")
    p.add_argument("-b", "--batch", type=int, default=1000000,
                   help="maximum number of mapping to load to memory. "
                        "(default=1000000)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Enable verbose output.")
    return p


def build_collect_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("collect",
                       help="merge multiple _profile.tsv files into "
                            "merged_profile.tsv")
    p.add_argument("PROFILES", nargs="+", help="per-sample _profile.tsv files")
    p.add_argument("-o", "--output", default="merged_profile.tsv")
    return p


def cmd_profile(args) -> int:
    # imports deferred so `build`/`collect` don't touch jax
    from .utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    from .database import SlimmDatabase
    from .engine import profile_file
    from .engine.reports import write_abundance, write_coverage, write_raw_stat
    from .io import collect_bam_files
    from .oracle import OracleProfiler
    from .utils.timer import Timer

    options = ProfileOptions(
        database_path=args.DB, input_path=args.IN,
        output_prefix=args.output_prefix if args.output_prefix is not None
        else args.IN,
        bin_width=args.bin_width, min_reads=args.min_reads, rank=args.rank,
        cov_cut_off=args.cov_cut_off, abundance_cut_off=args.abundance_cut_off,
        is_directory=args.directory, raw_output=args.raw_output,
        coverage_output=args.coverage_output, verbose=args.verbose)
    # the full bin-resolution histograms are only needed for -ro/-co output;
    # the abundance path uses per-contig integers (skipping them removes the
    # largest device op at full-RefSeq bin counts)
    engine = EngineOptions(num_shards=args.shards, trace_dir=args.trace_dir,
                           fetch_coverage=args.raw_output
                           or args.coverage_output,
                           stream_chunk=args.stream,
                           hash_read_names=args.hash_read_names)

    stop_watch = Timer()
    paths = collect_bam_files(options.input_path, options.is_directory,
                              options.verbose)
    db = SlimmDatabase.load(options.database_path)

    runner = None
    if not args.no_device and (
            (args.shards is not None and args.shards > 1)
            or args.model_shards > 1):
        from .parallel import ShardedRunner
        runner = ShardedRunner(num_shards=args.shards,
                               model_shards=args.model_shards)

    total_hits = 0
    import copy

    # directory mode on a single device: stack files into grouped device
    # dispatches (one jit'ed lax.scan per group): one dispatch and one
    # fetch per group instead of per file
    batched_states = None
    if (not args.no_device and runner is None and len(paths) > 1
            and args.trace_dir is None and not engine.stream_chunk):
        import os as _os

        from .engine.pipeline import profile_files_batched
        batched_states = {}
        group = max(1, engine.files_per_dispatch)
        # group by file size, not path order: batched dispatch pads every
        # file in a group to the group maximum, so one big file among
        # small ones makes the whole group pay its padded cost
        by_size = sorted(paths, key=lambda p: _os.path.getsize(p))
        for i in range(0, len(by_size), group):
            per_group_options = copy.deepcopy(options)
            for path, st in profile_files_batched(
                    per_group_options, db, by_size[i:i + group],
                    engine=engine):
                batched_states[path] = st

    for n, path in enumerate(paths):
        print(f"\nReading {n + 1} of {len(paths)} files ... "
              f"({path.rsplit('/', 1)[-1]})\n"
              "=================================================================",
              file=sys.stderr)
        per_file_options = copy.deepcopy(options)
        if args.trace_dir:
            import jax
            jax.profiler.start_trace(args.trace_dir)
        if batched_states is not None:
            state = batched_states[path]
        elif not args.no_device and engine.stream_chunk:
            from .engine.pipeline import profile_file_streaming
            state = profile_file_streaming(per_file_options, db, path,
                                           engine=engine,
                                           sharded_runner=runner)
        elif args.no_device:
            from .io import AlignmentFile
            af = AlignmentFile(path)
            prof = OracleProfiler(per_file_options, db.ac__taxid,
                                  db.taxid__name,
                                  list(zip(af.contig_names,
                                           af.contig_lengths.tolist())))
            state = prof.run(af.raw_records())
        else:
            state = profile_file(per_file_options, db, path, engine=engine,
                                 sharded_runner=runner)
        if args.trace_dir:
            import jax
            jax.profiler.stop_trace()
        total_hits += state.hits_count
        if state.hits_count == 0:
            continue
        if options.verbose:
            _print_matches_stat(state)
        if options.raw_output:
            write_raw_stat(state, options.output_prefix, path)
        if options.coverage_output:
            write_coverage(state, options.output_prefix, path)
        write_abundance(state, options.output_prefix, path)
        if options.verbose:
            _print_filter_stat(state)
        if args.json_stats:
            import json
            with open(args.json_stats, "a") as jf:
                jf.write(json.dumps({
                    "file": path,
                    "hits_count": state.hits_count,
                    "matches_count": state.matches_count,
                    "uniq_matches_count": state.uniq_matches_count,
                    "uniq_matches_count2": state.uniq_matches_count2,
                    "reference_count": state.reference_count,
                    "valid_refs": len(state.valid_ref_ids),
                    "lca_reads": state.lca_reads,
                    "cov_mass": int(state.reads_count.sum()),
                    "uniq_cov2_mass": int(state.uniq_reads_count2.sum()),
                    "failed_by_cov": state.failed_byCov,
                    "failed_by_uniq_cov": state.failed_byUniqCov,
                    "failed_by_min_read": state.failed_by_min_read,
                    "avg_read_length": state.avg_read_length,
                    "coverage_cut_off": float(state.coverage_cut_off()),
                    "uniq_coverage_cut_off":
                        float(state.uniq_coverage_cut_off()),
                }) + "\n")

    from .io.files import get_directory
    print("\n*****************************************************************",
          file=sys.stderr)
    print(f"{total_hits} SAM/BAM alignment records are proccessed.",
          file=sys.stderr)
    print("Taxonomic profiles are written to: \n   "
          f"{get_directory(options.output_prefix)}", file=sys.stderr)
    print(f"Total time elapsed: {stop_watch.elapsed():.6g} secs",
          file=sys.stderr)
    return 0


def _print_matches_stat(state) -> None:
    # (slimm.hpp:621-630)
    print(f"  {state.hits_count} records processed.", file=sys.stderr)
    print(f"    {state.matches_count} matching reads", file=sys.stderr)
    print(f"    {state.uniq_matches_count} uniquily matching reads",
          file=sys.stderr)
    print(f"  references with reads = {state.reference_count}", file=sys.stderr)
    print(f"  expected bins coverage = {state.expected_coverage():.6g}",
          file=sys.stderr)
    print(f"  bins coverage cut-off = {state.coverage_cut_off():.6g} "
          f"({state.options.cov_cut_off} quantile)", file=sys.stderr)
    print(f"  uniq bins coverage cut-off = {state.uniq_coverage_cut_off():.6g}"
          f" ({state.options.cov_cut_off} quantile)\n", file=sys.stderr)


def _print_filter_stat(state) -> None:
    # (slimm.hpp:613-619)
    print(f"  {len(state.valid_ref_ids)} passed the threshould coverage.",
          file=sys.stderr)
    print(f"  {state.failed_byCov} ref's couldn't pass the coverage "
          "threshould.", file=sys.stderr)
    print(f"  {state.failed_byUniqCov} ref's couldn't pass the uniq coverage "
          "threshould.", file=sys.stderr)
    print(f"  uniquily matching reads increased from "
          f"{state.uniq_matches_count} to {state.uniq_matches_count2}\n",
          file=sys.stderr)


def cmd_build(args) -> int:
    from .database import build_database

    options = BuildOptions(
        fasta_path=args.FASTA, ac__taxid_paths=args.ACC2TAXID,
        names_path=args.names, nodes_path=args.nodes,
        output_path=args.output_file, batch=args.batch, verbose=args.verbose)
    db = build_database(options)
    db.save_sldb(options.output_path)
    db.save_npz(options.output_path + ".npz")
    print(f"[MSG] database written to {options.output_path} "
          f"(+ .npz cache)", file=sys.stderr)
    return 0


def cmd_collect(args) -> int:
    from .tools.collect import collect_profiles

    collect_profiles(args.PROFILES, args.output)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="slimm-jax",
        description="SLIMM on JAX — Species Level Identification of "
                    "Microbes from Metagenomes")
    parser.add_argument("--version", action="version",
                        version=f"slimm-jax {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)
    build_profile_parser(sub)
    build_build_parser(sub)
    build_collect_parser(sub)
    args = parser.parse_args(argv)
    try:
        if args.command == "profile":
            return cmd_profile(args)
        if args.command == "build":
            return cmd_build(args)
        return cmd_collect(args)
    except (ValueError, OSError, ZeroDivisionError) as e:
        # decode/DB errors surface as a message + exit 1, mirroring SeqAn's
        # global exception handler (reference src/CMakeLists.txt:150)
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
