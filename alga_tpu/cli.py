"""CLI mirroring the reference's live flags (ref: src/Params.cpp:237-506;
live set per SURVEY.md §2.2: --file1 --file2 --threads --output
--error-rate --retl --retr --remove_reads_with_n --rna --scale -l).

Usage:
    python -m alga_tpu.cli --file1 reads_1.fastq --file2 reads_2.fastq \
        --output contigs.fasta [--error-rate 0.02] [--scale 0.55]
"""

from __future__ import annotations

import argparse

from alga_tpu.config import AssemblyConfig
from alga_tpu.pipeline import assemble_to_file


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="alga-tpu",
        description="overlap-graph de-novo genome assembler on an accelerator",
    )
    p.add_argument("--file1", required=True, help="reads (FASTA/FASTQ), first mates")
    p.add_argument("--file2", default="", help="second mates (optional)")
    p.add_argument("--output", default="contigs.fasta")
    p.add_argument("--threads", type=int, default=6, help="host worker threads")
    p.add_argument("--error-rate", type=float, default=0.0, dest="error_rate",
                   help="expected sequencing error rate; >0.01 enables the "
                        "error-tolerant supplement")
    p.add_argument("--scale", type=float, default=0.55,
                   help="the single tuning knob (default 0.55)")
    p.add_argument("-l", "--min-overlap", type=int, default=-1,
                   dest="min_overlap",
                   help="minimum exact overlap (default: auto from read length)")
    p.add_argument("--retl", type=int, default=3, help="read end trim left")
    p.add_argument("--retr", type=int, default=3, help="read end trim right")
    p.add_argument("--remove_reads_with_n", type=int, default=1)
    p.add_argument("--rna", action="store_true")
    p.add_argument("--correct_reads", type=int, default=0, choices=[0, 1, 2],
                   help="k-mer spectrum read correction (2 = correct only)")
    p.add_argument("--no-native", action="store_true",
                   help="disable the C++ host engine (use Python twin)")
    p.add_argument("--serialize", type=int, default=0,
                   help="write graph checkpoints (reference-compatible binary)")
    p.add_argument("--deserialize_graph", type=int, default=0,
                   help="resume from graph checkpoints when present")
    p.add_argument("--redirect_cerr", type=int, default=0,
                   help="redirect stderr logs to <output>.log "
                        "(ref Params.cpp:578-594)")
    p.add_argument("--profile_dir", default="",
                   help="write a jax.profiler trace of the assembly to this "
                        "directory")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.redirect_cerr:
        import sys
        logpath = args.output.rsplit(".", 1)[0] + ".log"
        sys.stderr = open(logpath, "w")
    cfg = AssemblyConfig(
        file1=args.file1,
        file2=args.file2,
        output=args.output,
        threads=args.threads,
        error_rate=args.error_rate,
        scale=args.scale,
        min_overlap_pref_suf=args.min_overlap,
        read_end_trim_left=args.retl,
        read_end_trim_right=args.retr,
        remove_reads_with_n=bool(args.remove_reads_with_n),
        rna=args.rna,
        correct_reads=args.correct_reads,
        use_native=not args.no_native,
        serialize_graph=bool(args.serialize),
        deserialize_graph=bool(args.deserialize_graph),
    )
    from alga_tpu.pipeline import DataQualityError
    try:
        if args.profile_dir:
            import jax
            jax.profiler.start_trace(args.profile_dir)
            try:
                assemble_to_file(cfg)
            finally:
                jax.profiler.stop_trace()
        else:
            assemble_to_file(cfg)
    except DataQualityError as e:
        # ref main.cpp:429-435: stderr message + exit(1)
        import sys
        print(str(e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
