# Copy of metaeuk_tpu/params.py; only the imports differ.
"""Parameter system.

Dataclass equivalent of the reference's LocalParameters
(src/commons/LocalParameters.h:137-158) + the mmseqs Parameters defaults
that matter to the pipeline (lib/mmseqs/src/commons/Parameters.cpp:2354-2560)
with the predict-exons workflow overrides applied
(src/workflow/PredictExons.cpp:8-16, :44).
"""

import dataclasses


@dataclasses.dataclass
class Params:
    # --- MetaEuk-specific (LocalParameters.h:137-158) ---
    metaeuk_evalue_thr: float = 0.001     # --metaeuk-eval
    metaeuk_tcov_thr: float = 0.5         # --metaeuk-tcov
    min_intron_length: int = 15           # --min-intron
    max_intron_length: int = 10000        # --max-intron
    min_exon_aa_length: int = 11          # --min-exon-aa
    max_aa_overlap: int = 10              # --max-overlap
    max_exon_sets: int = 1                # --max-exon-sets
    set_gap_open_penalty: int = -1        # --set-gap-open
    set_gap_extend_penalty: int = -1      # --set-gap-extend
    reverse_fragments: bool = False       # --reverse-fragments
    overlap_allowed: int = 0              # --overlap
    write_target_key: bool = False        # --target-key
    write_frag_coords: bool = False       # --write-frag-coords
    len_scan_for_start: int = 0           # --len-scan-for-start

    # --- ORF extraction (PredictExons.cpp:9-10 overrides) ---
    orf_start_mode: int = 1               # ANY_TO_STOP
    orf_min_length: int = 15              # codons
    orf_max_length: int = 32734
    orf_max_gaps: int = 2**31 - 1
    contig_start_mode: int = 2            # keep both complete & incomplete
    contig_end_mode: int = 2
    forward_frames: tuple = (1, 2, 3)
    reverse_frames: tuple = (1, 2, 3)
    use_all_table_starts: bool = False
    translation_table: int = 1

    # --- search / alignment (Parameters.cpp defaults + workflow overrides) ---
    search_evalue_thr: float = 100.0      # -e (PredictExons.cpp:15)
    sensitivity: float = 4.0              # -s (metaeuk predictexons default)
    max_res_list_len: int = 300           # --max-seqs
    gap_open: int = 11
    gap_extend: int = 1
    comp_bias_correction: bool = True
    comp_bias_correction_scale: float = 1.0
    kmer_size: int = 0                    # -k (0 = auto by target DB size,
    #   IndexTable::computeKmerSize: 6 below 3.35G residues, else 7)
    split: int = 0                        # --split (0 = auto by memory)
    split_mode: int = 2                   # --split-mode (0 target, 1 query,
    #   2 auto: query split when the whole target index fits the memory
    #   budget, else target split — Prefiltering.cpp:662-770)
    split_memory_limit: int = 0           # --split-memory-limit (0 = free RAM)
    disk_space_limit: int = 0             # --disk-space-limit (0 = default;
    #   bounds staged profile slices in the sliced profile search,
    #   searchslicedtargetprofile.sh:46-120 role)
    cov_thr: float = 0.0
    cov_mode: int = 0
    seq_id_thr: float = 0.0
    # alnLenThr = minExonAaLength (PredictExons.cpp:44)
    aln_len_thr: int = 11
    max_accept: int = 2**31 - 1
    max_rejected: int = 2**31 - 1
    max_seq_len: int = 65535

    # --- taxonomy ---
    majority_thr: float = 0.5             # TaxToContig.cpp:9
    tax_lineage: int = 0
    vote_mode: int = 1                    # aggregatetax default (weighted)

    # --- prefilter ---
    # "kmer" (default, matching the reference): sensitivity-calibrated
    #   spaced-6-mer prefilter (search/prefilter_kmer.py, byte-parity
    #   candidate sets vs prefiltering/QueryMatcher.cpp)
    # "exhaustive": align every fragment x target (reference
    #   --prefilter-mode 2 / exhaustive-search fake_pref)
    # "ungapped": brute-force gapless diagonal filter (reference
    #   --prefilter-mode 1 / GPU mode, prefiltering/ungappedprefilter.cpp)
    prefilter_mode: str = "kmer"
    min_diag_score: int = 15              # --min-ungapped-score

    # --- execution ---
    threads: int = 0                      # 0 = auto
    batch_pairs: int = 16384              # device batch of SW pairs

    def __post_init__(self):
        if self.min_exon_aa_length < self.max_aa_overlap:
            raise ValueError(
                "minExonAaLength < maxAaOverlap (collectoptimalset.cpp:228-231)")
