"""Assembly configuration + the reference's auto-tuning contract.

The reference drives ~70 mutable static fields on `Params`
(ref: include/Params.h:44-307, src/Params.cpp:677-778 for defaults).  Here
the live subset becomes one immutable dataclass; the auto-tuning formulas
(ref: src/main.cpp:93-115 and the supplement-phase retune at
src/main.cpp:332-340) are pure functions producing a derived config.

Only parameters that are live in the reference's default path are kept;
dead/disabled reference fields (SURVEY.md §7.4) are intentionally absent.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class AssemblyConfig:
    # --- user-facing knobs (ref: README.md usage, src/Params.cpp:237-506) ---
    file1: str = ""
    file2: str = ""            # paired-end mate file ("" = unpaired)
    output: str = "contigs.fasta"
    threads: int = 6           # host-side worker count (ref default: Params.cpp:763)
    error_rate: float = 0.0    # --error-rate; >0.01 enables the LI supplement
                               # (ref: src/Params.cpp:346-360)
    scale: float = 0.55        # the single tuning knob (ref: Params.cpp:678)
    rna: bool = False
    remove_reads_with_n: bool = True   # ref: Params.cpp:741
    add_paired_reads: bool = True      # ref: Params.cpp:693 (live default 1;
                                       # only settable in code — the getopt
                                       # entry is commented out).  Controls
                                       # PFASTA record framing: 2-line
                                       # interleaved-mate records when on,
                                       # 4-line records with the mate lines
                                       # discarded when off
                                       # (ref: InputReader.cpp:156-165)

    # --- preprocessing (ref: src/IO/InputReader.cpp) ---
    read_end_trim_left: int = 3        # ref: Params.cpp:729
    read_end_trim_right: int = 3       # ref: Params.cpp:730
    str_period_threshold: int = 20     # drop reads with MinPeriod <= 20
                                       # (ref: InputReader.cpp:341-353)

    # --- derived / tunable thresholds (defaults = reference defaults) ---
    min_overlap_pref_suf: int = -1     # -1 → auto (ref: Params.cpp:708)
    rsoe_min_overlap: int = -1         # REMOVE_SMALL_OVERLAP_EDGES_MIN_OVERLAP
    rsoe_number_to_retain: int = 3     # ref: Params.cpp:733
    soes: int = 3                      # short-overlap edges retained per node
                                       # during regime-1 of the sweep
                                       # (ref: GraphCreatorPrefSuf.h:62)
    contig_min_output_length: int = 200    # ref: Params.cpp:736
    max_offset_parallel_paths: int = 250   # % of avg read len (ref: Params.cpp:687)
    max_offset_dangling_branches: int = 250
    min_offset_for_alignment: int = 0      # ref: Params.cpp:709
    new_reads_per_contig_percentage: int = 95  # ref: Params.cpp:755
    min_overlap_area: int = -1
    max_offset_considered_for_alignment: int = 70  # ref: Params.cpp:684

    # --- alignment-kernel thresholds (error path) ---
    min_overlap_rate: int = 95             # ref: Params.cpp:696
    minimal_overlap_rate_for_lcs: int = 95
    max_error_rate_for_lcs: int = 2        # band half-width (ref: Params.cpp:699)
    minimal_overlap_for_lcs_low_error: int = 97  # (100+95)>>1, ref: Params.cpp:701
    use_acler_instead_of_aclcs: bool = True      # ref: Params.cpp:703
    alignment_controller_same_ends_length: int = 3  # ref: Params.cpp:756

    # --- LI minimizer supplement (error path) ---
    li_kmer_length: int = -1       # -1 → auto
    li_kmer_intervals: int = 3     # ref: Params.cpp:706
    use_supplement: bool = False   # USE_GRAPH_CREATOR_SUPPLEMENT
                                   # (set when error_rate > 0.01)

    # --- read correction (ref: src/Corrector/ReadCorrector.cpp; flag
    #     CORRECT_READS, 0=off, 1=correct+assemble, 2=correct only) ---
    correct_reads: int = 0

    # --- checkpoint / resume (ref --serialize/--deserialize_graph,
    #     src/Params.cpp:392-395, main.cpp:242,293,385-403) ---
    serialize_graph: bool = False
    deserialize_graph: bool = False
    checkpoint_prefix: str = ""     # defaults to <output> without extension

    # --- host engine ---
    use_native: bool = True    # use the C++ host graph engine when built
                               # (native/alga_host.cpp; Python twin otherwise)

    # --- multi-device execution (no reference counterpart: the reference is
    #     single-process shared-memory; SURVEY.md §2.10) ---
    sharded_gcps: str = "auto"  # "auto" = de-replicated all_to_all GCPS
                                # (parallel/sharded_gcps.py) when >1 device
                                # is visible; "on" forces it (1-device mesh
                                # works too); "off" forces single-device

    # --- sweep mechanics ---
    read_length_cap: int = 500     # overlap sweep cap (ref: GCPS.cpp:92)

    # --- contig post-processing ---
    trim_threshold: int = 25       # contig end-trim overlap graph threshold
                                   # (ref: main.cpp:651)
    max_length_of_insert_size: int = 1000   # ref: ContigCreatorSinglePath.h:129
    min_paired_connections: int = 5         # ref: ContigCreatorSinglePath.h:127

    @property
    def paired(self) -> bool:
        return bool(self.file2)

    @property
    def error_rate_percent(self) -> int:
        """ERROR_RATE in the reference is 100*r (ref: Params.cpp:346-360)."""
        return int(100 * self.error_rate)


@dataclass(frozen=True)
class TunedConfig(AssemblyConfig):
    """Config after read-length-driven auto-tuning (all -1 fields resolved)."""
    avg_read_length: int = 0       # LEN (pre-trim average; see autotune())
    kmer_length_bucket: int = 0


def autotune(cfg: AssemblyConfig, avg_read_length_post_trim: float) -> TunedConfig:
    """Resolve -1 thresholds from the average read length.

    Reproduces ref src/main.cpp:93-115 exactly:
      LEN = avg(post-trim read length) + trim_left + trim_right
      L   = LEN * SCALE
      MIN_OVERLAP_PREF_SUF = L;  RSOE = LEN*(SCALE+1)/2;  MIN_OVERLAP_AREA = L
      LI_KMER_LENGTH = KMER_LENGTH_BUCKET = min(2L/3, 60)
      CONTIG_MIN_OUTPUT_LENGTH / MAX_OFFSET_{PARALLEL_PATHS,DANGLING_BRANCHES}
        floored at 1.75*LEN
    """
    LEN = int(avg_read_length_post_trim) + cfg.read_end_trim_left + cfg.read_end_trim_right
    floor_175 = int(1.75 * LEN)

    L = int(LEN * cfg.scale)
    rsoemo = int(LEN * (cfg.scale + 1) / 2)

    updates = dict(
        avg_read_length=LEN,
        contig_min_output_length=max(cfg.contig_min_output_length, floor_175),
        max_offset_parallel_paths=max(cfg.max_offset_parallel_paths, floor_175),
        max_offset_dangling_branches=max(cfg.max_offset_dangling_branches, floor_175),
    )

    if cfg.min_overlap_pref_suf == -1:
        updates.update(
            li_kmer_length=min(2 * L // 3, 60),
            kmer_length_bucket=min(2 * L // 3, 60),
            min_overlap_pref_suf=L,
            min_overlap_area=L,
        )
        if cfg.rsoe_min_overlap == -1:
            updates["rsoe_min_overlap"] = rsoemo
    elif cfg.rsoe_min_overlap == -1:
        updates["rsoe_min_overlap"] = (cfg.min_overlap_pref_suf + LEN) // 2

    if cfg.li_kmer_length == -1 and "li_kmer_length" not in updates:
        updates["li_kmer_length"] = min(2 * L // 3, 60)

    if cfg.error_rate > 0.01 and not cfg.use_supplement:
        updates["use_supplement"] = True

    return TunedConfig(**{**dataclasses.asdict(cfg), **updates})


def supplement_retune(cfg: TunedConfig, avg_read_length_now: float) -> TunedConfig:
    """Parameter re-tune for the LI/PKB supplement phase.

    Reproduces ref src/main.cpp:332-340:
      MIN_OVERLAP_AREA = (1+SCALE)*avg/2
      MAX_OFFSET_CONSIDERED_FOR_ALIGNMENT = (1-SCALE)*avg/2
      MINIMAL_OVERLAP_FOR_LCS_LOW_ERROR = 99 - ERROR_RATE
      LI_KMER_INTERVALS = 6;  LI_KMER_LENGTH = 35
    """
    return dataclasses.replace(
        cfg,
        min_overlap_area=int((1.0 + cfg.scale) * avg_read_length_now / 2),
        max_offset_considered_for_alignment=int((1.0 - cfg.scale) * avg_read_length_now / 2),
        minimal_overlap_for_lcs_low_error=99 - cfg.error_rate_percent,
        li_kmer_intervals=6,
        li_kmer_length=35,
    )
