#!/usr/bin/env python3
"""Smoke run of metaeuk_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        (from the root of a checkout; needs one card)

Phases, each fatal on failure:
  1. require a CUDA device; print the card's name and power limit
  2. build the CUDA kernels from metaeuk_tpu_torch/csrc with nvcc (one
     process per source, all started together; qm_variants.cu, about 100
     s, joined before phase 3b) and the host library from native/ with
     g++; ptxas's registers and spill bytes of K5/K6 and of each length
     class of K1/K2 and of K3/K4 (and, at 3b, of T4's instances)
  3. each kernel against its plain PyTorch version on the card, compared
     with torch.equal (all outputs are integers: the tolerance is zero): the
     pair kernels on seeded ragged batches at the driver's bucket shapes (Lq
     up to 4608) and on planted ties (pair_edge_batch, Lq and Lt 1152: on
     either side of their lane, group and 511/512 row-stripe edges, at the
     first and last columns and one row or column past the true lengths,
     and runs ending at q_len - 1 or t_len - 1; the reverse pass from the
     forward ends, over the whole matrix and from random ends), the
     query-major kernels on seeded tiles at Lq 64..4096
     with Lt across 512, on the same planted ties as tiles (qm_edge_tiles,
     each pair's own target in a varying lane of its query's tile among
     other targets and padding lanes, a tile of padding lanes only and a
     padding tile; K4 as K2) and on a 3,500-aa self-match at Lq 4096 whose
     H passes the cap 32767, the long-query kernels K5/K6 on Lq 256..1024 and
     on the 16384 and 65536 tiers (true lengths up to 32,734, Lt up to 4096;
     the plain versions at a row tile of 64, then at the real one), with
     equal scores planted in different row tiles at different columns and
     on either side of the kernels' column boundaries (15/16, a thread's
     edge; 511/512, a stripe's) in a long query's first and last rows, the
     reverse pass also over every lane's whole matrix; and the gapless
     kernels on seeded pairs, all with padding lanes and tiles, repeated
     targets (ties), implanted shared segments and zero-length sequences;
     gapless_long at the 1024, 8192 and 32768 buckets (true lengths up to
     32,700, Lt across its column tiles of 512) on planted runs: the first
     and last diagonals' single cells, runs at its 256-diagonal chunk edge
     and across its tile edges, and runs over 128 that end at q_len - 1 or
     t_len - 1 with padding that would extend them; gapless_rows through
     the cross entry at the short-row buckets (Lq 32, 128, 512, 64), with
     20 targets (under a block's 32 columns) and the shape's 100-3000, on
     planted pairs: the first and last diagonals' single cells and runs
     that end at q_len - 1 or t_len - 1 with padding that would extend them;
     gapless_pair at the short-row widths 32, 64, 128 and 512 on the same
     plants plus runs on each lane of a band of four diagonals, through
     pair lists in order, shuffled with repeats, with indices of -1 and past
     nq and nt, and with a query of one pair beside one of more pairs than
     a block's 128 threads, at the wrapper's layout and a thread a pair;
     K1/K2's PSSM entries (sw_pair_ends_prof, sw_pair_starts_prof) on
     seeded staged PSSMs in [-32, 31] at the pair kernels' shapes (profiles
     up to 4,608 rows, one over 4096) read in a shuffled order, and on
     pair_edge_batch's planted ties with the PSSM built as submat[q] + bias,
     where they also equal sw_pair_ends / sw_pair_starts bit for bit;
     K1/K2's uncapped instances (sw_pair_ends_nocap, sw_pair_starts_nocap,
     the realign pass) under the realign matrix scores_with_bias(2.0,
     -0.2) at the pair kernels' shapes, on pair_edge_batch's planted ties
     (under BLOSUM62 with the planted cells checked, and under the realign
     matrix) and on self-matches at Lq 4096 whose H passes 32767 in the
     seventh row stripe (the capped entry stops at 32767 there); K1/K2's
     uncapped PSSM instances (sw_pair_ends_prof_nocap,
     sw_pair_starts_prof_nocap, the profile-query aligner) on the PSSM
     entries' seeded staged PSSMs and planted ties (bit-equal there to the
     uncapped sequence instances), and on self-matches of a profile scoring
     31 on its own residue and -32 elsewhere: 1,100 rows in the aligner's
     1152 bucket (34,100 at (1099, 1099)) and 3,500 rows at Lq 4096, where
     the capped entry stops at 32767
  3b. the microbenchmark kernels against their plain versions, bit for bit
     (floats compared as their bits): every case of tools/kbench.py (T1-T3)
     at its TPU shape (256, 512) and REPS 512 on seeded non-zero inputs,
     T1 also at n_ops 2 and on one warp, every shift amount kb_shift is
     built for with both fills, a scan with values below NEG; T2 at every
     amount and fill and T3 at the edge reps (KBENCH_EDGE_REPS: no rep,
     one, a remainder loop alone, one unrolled block, both; scans of 0, 1,
     5, 7, 31, 33 and 64 passes, across and past the wavefront's ramp) on
     a width that is not a multiple of a block's four columns, with int32
     extremes in the scan; every T4
     variant and the uN / tjN sweeps at tools/kernel_variants.py's default
     shape (32 tiles, Lq 256, Lt 2048), a small ragged shape with lanes
     that never score and repeated lanes, a shape where H passes 32767,
     Lq 1,100 (STRIPE_SHAPE: T4's three row stripes, equal runs in the
     first and third going to the third's earlier column), and nocap and
     fold_nocap where their packed words wrap (fold_nocap on H' = H + i ge,
     below and past 65,536 where H is below it)
  4. easy-predict through the metaeuk-tpu-torch CLI on tests/data: the four
     outputs byte-identical to tests/golden/easypredict.*
  4b. easy-predict --prefilter-mode ungapped on tests/data and on the
     0.01 Mbp / 500-target metagenome: sha256 digests equal to
     tests/golden/ungapped_slice.json (the JAX package's outputs); the
     metagenome run goes through the query-major kernels under the default
     routing
  4c. easy-predict in k-mer and in ungapped mode on the long-frame golden
     input (make_long_slice.GOLDEN_INPUT: fragments in the 16384 and 65536
     tiers): sha256 digests equal to tests/golden/long_slice.json (the JAX
     package's outputs), the row-tiled kernels launched, and gapless_long
     in ungapped mode (gapless_rows takes the short rows of every ungapped
     run)
  4d. easy-predict against tests/golden/profile/profileDB through the CLI:
     the four outputs byte-identical to tests/golden/profile/pp.*; and
     slice_search_db with backtraces on the enrich fixture: the result DB's
     sha256 digests equal tests/golden/profile_slice.json's (the JAX
     package's, equal to tests/golden/enrich/search_slice); the PSSM entries
     launched and no plain version called in either; ProfileQueryAligner
     on the enrich profiles against the fixture proteins, hits and
     backtraces equal to its plain run
  4e. the search workflows on tests/data through the CLI: easy-search
     (plain and --greedy-best-hits), easy-rbh, rbh (with its seven
     intermediates), map and search --sens-steps 3 (with its per-step
     intermediates) and 2, byte-identical to the MMseqs2 goldens in
     tests/golden/searchwf and senssteps; SearchDriver.search + backtraces
     equal to tests/golden/aln/search_a; K1/K2 launched, no plain version
     called
  4g. the iterative search and the profile tools on the fixtures through
     the CLI, each output byte-identical to the reference's golden: search
     --num-iterations 2|3 -a (tests/golden/pref/iter*), result2profile
     (r2p, 13 flag sets), msa2profile (msa), sequence2profile (util9),
     profile2pssm and convertprofiledb (util), expandaln and expand2profile
     (util7), the dbtools6 commands with alignall (util6), enrich
     (enrich/enriched); K1 and the uncapped PSSM instances launched, no
     plain version called (ProfileQueryAligner in 4d needs the uncapped
     PSSM instances and no capped PSSM entry)
  4f. MetaEuk's modular commands and the taxonomy workflows on tests/data
     through the CLI: predictexons -> reduceredundancy -> unitesetstofasta
     byte-identical to tests/golden/easypredict.* with the intermediates
     equal to tests/golden/dbs; extractorfs, resultspercontig and
     collectoptimalset equal to tests/golden/percontig; taxtocontig
     byte-identical to the MetaEuk binary's tests/golden/tax/reftax_*;
     taxonomy (with its pref and first DBs), taxonomy --lca-mode 4
     --tax-output-mode 2 and easy-taxonomy equal to tests/golden/tax2;
     K1/K2 launched, no plain version called
  4h. the clustering and linear-search family on the fixtures through the
     CLI, each output byte-identical to the MMseqs2 binary's golden: cluster
     at its defaults (the linclust pre-step and every cascade step's
     pref_step, aln_step and clu_step, tests/golden/clusterwf) and at
     --min-seq-id 0.9, easy-cluster and easy-linclust (three files each),
     kmermatcher (4 flag sets) and linclust (tests/golden/kmermatcher),
     createlinindex, kmersearch, linsearch (tests/golden/linsearch) and
     easy-linsearch (its m8 and result DB against the JAX package's digests
     in tests/golden/cluster_slice.json), convertca3m (ca3m), result2msa and
     result2repseq (utils), pickconsensusrep and clusterupdate (util8); the
     native host library loaded; K1/K2 launched, the uncapped PSSM
     instances in pickconsensusrep (and no capped PSSM entry), no plain
     version called
  4i. the multihit family, the DB utilities over modules the port carries
     and the resident server on the fixtures through the CLI: every case of
     DB_CLI_CASES (multihitdb on tests/golden/util7's two set files and
     multihitsearch: all ten DBs of tests/test_util7.py; besthitperset in
     both modes and combinepvalperset in its four aggregation modes
     (tests/golden/multihit); the dbtools, dbtools2 and dbtools5 commands,
     filterdb, rescorediagonal, createindex, prefilter with and without the
     persisted index, indexdb, kmerindexdb, nrtotaxmapping, filterresult,
     version), each output byte-identical to its MMseqs2 golden where one
     exists; then gpuserver (`python -m metaeuk_tpu_torch.cli gpuserver`,
     --warmup 1) on tests/data/proteins.faa in a process of its own:
     serverclient ping, prefilter and search -a 1 and client_request,
     byte-equal to the direct prefilter_db and search_db, an unknown op
     refused, shutdown with exit 0 and the socket gone; K1/K2 launched in
     multihitsearch, no plain version called
  4j. the M11b commands on the fixtures through the CLI: every case of
     UTIL_CLI_CASES (the dbtools4 commands on tests/golden/util4 and utils,
     the dbtools7 and dbtools8 commands on util9 and util10, pairaln's
     pairing modes and fwbw on util11, alignbykmer, ungappedprefilter and
     gappedprefilter on the util5 fixture, databases --tsv 1 and its
     --local-file chains (dbcatalog, databases), offsetalignment in both
     search types and proteinaln2nucl on utils, and search --search-type 3
     on tests/data's contigs against utils/nucl_search_out), each output
     byte-identical to its MMseqs2 golden where one exists; no plain version
     called
  5. the k-mer main path at a real size: easy-predict on the 1.6 Mbp /
     3000-target synthetic metagenome of tests/golden/multichip_slice.json;
     the four sha256 digests equal the file's, the pair kernels launched and
     no plain version called in that run; wall, stage and align-phase
     seconds, cells and aligned cells/s, K1/K2's launches and summed ms
     (CUDA events around each launch, as in 5b and 5c)
  5b. the ungapped path at a size its users meet: easy-predict
     --prefilter-mode ungapped on the 0.4 Mbp / 3000-target slice; the
     gapless and query-major kernels launched and no plain version called;
     the same candidate pairs aligned again through the driver with
     METAEUK_QM=off (the pair kernels) give a hit array equal field by
     field; the SW kernels' launches and summed ms in both runs; K7's
     launches, ms, cells, cells/s and bound at each staged query width
  5c. the row-tiled path at full width: easy-predict --prefilter-mode
     ungapped on the 0.4 Mbp slice plus 48 contigs with frames of 4,200 to
     32,700 aa (make_long_slice.CHIP_SLICE); both gapless kernels, the
     query-major and the row-tiled kernels launched and no plain version
     called; the same pairs through the pair kernels give an equal hit
     array; then the
     long-frame contigs alone in k-mer mode under the default routing and
     under METAEUK_QM=off, hits and outputs equal; wall, stage and
     align-phase seconds, cells and launches of each run, and each
     kernel's summed time in the first run (the SW kernels' in every run),
     the gapless kernels' also by staged query width with their cells,
     cells/s and bound (CUDA events around each launch, put there by a hook
     of this script)
  5d. the profile path at full width: the k-mer slice's contigs against
     3,000 HMM profiles of its targets (make_profile_slice.PROFILE_SLICE);
     the four sha256 digests equal tests/golden/profile_slice.json's (the
     JAX package's outputs), the PSSM entries launched and no plain version
     called; wall, stage and profile-search phase seconds (the profile
     prefilter, the alignment, the filter and swap), pairs, cells and each
     PSSM entry's launches and summed ms (CUDA events) beside its bound
  5e. the search workflows at full width: 4,000 queries against the k-mer
     slice's 3,000 targets (make_search_slice.SEARCH_SLICE): easy_search at
     its defaults, then align_db over its prefilter DB with backtraces and
     the realign pass; the m8, result DB and realign DB sha256 digests
     equal tests/golden/search_slice.json's (the JAX package's outputs);
     the native host library loaded; K1/K2 launched in both runs, K3/K4
     wherever the routing sent pairs, the uncapped instances in the
     realign run, no plain version called; each run's wall, stage seconds
     (prefilter, align, write_blast_tab), the driver's phase seconds
     (align phases, backtraces, realign SW, realign tracebacks), pairs and
     cells by route, and each SW kernel's launches and summed ms (CUDA
     events) beside its bound
  5f. the modular commands and taxtocontig at full width: predictexons ->
     reduceredundancy -> unitesetstofasta on phase 5's slice, the four
     digests equal to multichip_slice.json, each command's seconds and the
     DP-format round trip's beside phase 5's wall; taxtocontig (an
     exhaustive search: every prediction against the 3,000 targets) on
     those predictions under tests/golden/make_tax_slice.py's synthetic
     taxonomy, at the default routing and under METAEUK_QM=off, hit arrays
     equal field by field and both TSVs byte-identical; wall, stage
     seconds (load, search, per-query LCA loop, io), the driver's phase
     seconds, pairs and cells by route, each SW kernel's launches and
     summed ms (CUDA events) beside its bound and the kernels' busy and idle
     shares of the wall; then easy-predict and taxtocontig on the slice's
     first 10 contigs, digests equal tests/golden/tax_slice.json's (the JAX
     package's outputs); K1/K2 launched in predictexons, K3 (every forward
     pair: each prediction has over 1,000 candidates in each target tier)
     at the default routing,
     K1/K2 and no K3 under METAEUK_QM=off, no plain version called
  5g. the iterative search at full width: (a) search --num-iterations
     ITER_FULL_ITERATIONS -a on every ITER_FULL_EVERY-th of the search
     slice's 4,000 queries (2,000: a depth cut that keeps the slice's widths
     and its mix of 90/60/40% copies and decoys) against its 3,000 targets
     (tests/golden/make_iter_slice.py); (a), (b) and (c) one after the
     other in a process of its own started after the build and joined
     after phase 6b (their host stages take minutes); wall, stage seconds
     by step (k-mer prefilter, align,
     realign, result2profile, profile prefilter, subtractdbs,
     ProfileQueryAligner.search, backtraces, mergedbs and the prefilter
     and alignment DB io), the driver's phase seconds, pairs and cells by
     route and by profile step, each SW kernel's launches and summed ms
     (CUDA events) beside its bound and the idle share; (b) a seeded
     sample of 20,000 pairs of its last profile step aligned again through
     the kernels and through the plain versions on the card: raw outputs
     and hits equal, and equal to the step's hits; (c) three iterations on
     the slice's cut (every 10th query): the counts and every digest equal
     tests/golden/iter_slice.json (the JAX package's); K1/K2, their
     uncapped and uncapped PSSM instances and K3/K4 where routed launched
     in (a) and (c), no capped PSSM entry, no plain version called outside
     (b)
  5h. the clustering and linear-search family at full width: the search
     slice's 3,000 targets and 4,000 queries in one DB of 7,000 proteins
     (tests/golden/make_cluster_slice.py); first its cut (200 families
     whole, 200 other targets, 200 decoys) through easy-cluster,
     easy-linclust and easy-linsearch at their defaults, the counts and
     digests (the cascade's DBs too) equal tests/golden/cluster_slice.json
     (the JAX package's); then the three on the whole slice, each at the
     default routing and under METAEUK_QM=off: every SearchDriver.search
     hit array equal field by field, every output byte-identical, and
     equal to cluster_slice.json's runs of the whole slice; K1/K2 launched
     in every run, K3/K4 wherever the routing sent pairs, no plain version
     called; each run's wall, seconds by step in call order (createdb,
     linclust, kmermatcher, each rescorediagonal, createsubdb, each
     prefilter, each align with its SearchDriver.search and backtraces,
     clust, mergeclusters, createlinindex, kmersearch, filterdb,
     swapresults and the writers), the driver's phase seconds, pairs and
     cells by route, each SW kernel's launches and summed ms (CUDA events)
     beside its bound, and the kernels' busy and idle shares of the wall
  5i. the multihit family at full width: the k-mer slice's 245 contigs in
     35 set files of 7 (tests/golden/make_multihit_slice.py); multihitdb
     over them, then multihitsearch of the set DB against itself at the
     default routing and under METAEUK_QM=off: the hit arrays and outputs
     equal, and the counts and digests of the seven multihitdb DBs, result,
     aggregate and the output DB equal tests/golden/multihit_slice.json
     (the JAX package's); wall, seconds by step in call order (createdb,
     tsv2db, extractorfs, translatenucs, orftocontig, filterdb, swapdb,
     result2stats, prefilter, align with its SearchDriver.search,
     besthitperset, mergeresultsbyset), pairs and cells by route, K1/K2's
     launches and summed ms beside their bounds, the idle share; K1/K2
     launched, K3/K4 wherever routed, no plain version called
  5j. the resident server at full width: gpuserver on the search slice's
     3,000 targets in a process of its own (this script's --serve mode:
     the port's CLI, each request's kernel launches counted and timed in
     that process), its startup seconds with --warmup 1 and with --warmup
     0; ping, then a prefilter and a search (alignment mode 3, -e 1e-3) of
     the 4,000 queries: the search's result equal to search_slice.json's
     easy_search result, the prefilter equal to the search's own; the same
     search again, then two at once to other DBs, both equal to the first;
     each request's seconds, the first search's K1-K4 launches and summed
     ms beside their bounds, no plain version called; shutdown, exit 0, the
     socket gone
  5k. the runtime Gumbel fit at full size, in a process of its own started
     after the build and joined after phase 5j: the four scoring systems of
     tests/golden/gumbel_slice.json (BLOSUM62 at 8/2, VTML80 at 10/1, the
     +2/-3 nucleotide matrix at 4/2 through proteinaln2nucl on the
     offsetaln fixture, VTML80's ungapped fit at 32000/0), each fit at
     fit_gapped's defaults (262,144 pairs of 384 letters, 64 chunks; islands
     over 4,096 pairs of 1,024) with a fresh cache: the sha256 of
     _simulate's arrays, the island count and proteinaln2nucl's output
     equal the golden (the JAX package's) bit for bit, the 12 parameters
     within GUMBEL_PARAM_RTOL (numpy's float sums differ across hosts in
     their last bits) with their distance in ulps printed; K1/K2's
     uncapped instances launched and no plain version called; the first
     GUMBEL_PLAIN_CHUNKS chunks of each fit equal to the plain versions on
     the card (torch.equal); each fit's seconds split into sampling,
     _simulate's alignment, islands and regression, its cells, and K1/K2's
     launches and summed ms (CUDA events) beside their bounds
  5l. the multi-process easy-predict at the size of
     tests/golden/dist_bench_slice.json (4.0 Mbp, 8,000 targets,
     --split 2), in a process of its own started after phase 5j and
     joined after phase 6b: metaeuk_tpu_torch/tools/dist_worker.py in one
     process, then in two on the one card (a gloo group; each on its
     contig half, the target splits fanned round-robin over them through
     the shared scratch); both runs' four sha256 digests equal the file's
     (the JAX package's single-process split-2 run), each process of the
     second built exactly its split, every (split, query block) hit file
     exists, every process launched K1/K2 and called no plain version;
     each run's wall, each process's wall, stage seconds, cells, K1-K4
     launches and summed ms (CUDA events) beside their bounds, and its
     idle share
  5m. the driver's device fan-out and the sharded steps: (a) the k-mer
     slice of phase 5 through easy-predict with the driver's launches
     fanned over ["cuda:0", "cuda:0"] (each launch chunk split into a
     sub-chunk per entry): the four digests equal multichip_slice.json,
     K1/K2 launched and no plain version called; wall, launches and
     summed ms beside phase 5's; (b) parallel/dist.py's dense and top-300
     sharded steps on a one-rank NCCL mesh at 512 x 1024 pairs of 64 x 64
     (tools/dryrun.py SLICE_STEP): every output equal to the plain dense
     cross product on the card (the top-k in jax.lax.top_k's tie order),
     K1's uncapped instance launched once a step and no plain version
     called; its ms beside its bound, the collective bytes per rank; the
     2 x 2 mesh is checked only by tests/test_torch_dist.py on the CPU
  5n. the k-mer-index prefilter at full width, in a process of its own
     started before phase 5h and joined after 5m: (a) the k-mer slice's
     61,457 fragments against its 3,000 targets through
     search/kmer_prefilter.py's KmerPrefilter.candidate_pairs on the card:
     the counts and the sha256 of the candidates, their scores and the kept
     pairs equal tests/golden/kmerpf_slice.json's (the JAX package's),
     gapless_pair launched for each short bucket (no candidate of the
     slice lies in a long one), no plain version called; every candidate
     scored again through gapless_long and the plain version on the card,
     equal to the path's scores; (b) make_kmerpf_slice.PLANTED_CUT (a
     1,024-aa fragment among the 0.01 Mbp cut's) on the card, gapless_pair
     and gapless_long launched, equal to the plain version's run on the
     CPU; wall, stage seconds (index, screen, rescore, select), pairs,
     cells and each kernel's launches and summed ms (CUDA events) by staged
     width beside its bound
  5o. the bench after phase 6b: `python -m metaeuk_tpu_torch bench` (this
     script's --bench mode, runpy) at its configuration, make_metagenome(4,
     8000), 572 contigs, with one timed run, and `bench --selftest`, each in
     a process of its own, started together: the selftest lines (0 fails of 140 light, 253
     full checks), the configuration, every kernel rate present, K1-K6
     launched across the two runs and no plain version called, and the
     unsplit run's four sha256 digests equal to
     tests/golden/dist_bench_slice.json's (the JAX package's --split 2
     run); the bench's JSON lines printed
  6. kernel and plain-version times at main-path shapes, with CUDA events,
     each kernel's output there equal to its plain version's, beside each
     kernel's bound (the larger of its operations over the card's int32
     rate and its bytes over its memory rate); K1/K2's PSSM entries at
     TIME_SHAPE on the same pairs as K1/K2 (rows submat[q] + bias), their
     outputs equal to K1/K2's, and their uncapped instances there, equal
     to K1/K2's uncapped instances; K1/K2's uncapped instances at
     TIME_SHAPE under the realign matrix; K1/K2 also at the k-mer
     slice's largest bucket (16,384 pairs, Lq 256 x Lt 1024, lengths drawn
     from its percentiles); K3/K4 (with K1/K2 on the same pairs) also at
     one launch of the ungapped slices' largest query-major bucket (1,008
     tiles, Lq 256 x Lt 1024, live lanes and lengths drawn from its
     percentiles); K5/K6 also against the Lt
     1024 tier (targets of 513-600 aa); gapless_pair at GAPLESS_TIME_SHAPE
     in pair-list order and shuffled (the wrapper's time and the kernel's
     alone, beside the thread-per-pair design's); gapless_long at one
     launch of the long-frame slice (2 query rows of Lq 32768 x 1,687
     targets of Lt 512); gapless_rows, gapless_pair and gapless_long on
     the same cross launches at Lq 128 x Lt 512 and at Lq 32 x Lt 64 (the
     prefilter's launch of 349,525 rows x 12 targets)
  6b. the microbenchmark entry points (python -m metaeuk_tpu_torch.tools.
     kbench, .kernel_variants) over all their cases, the kernels launched
     and no plain version called; each new kernel's time beside its bound
     (T1 at the rate of each dtype's pipe) and its plain version's; T1 on
     one warp in cycles per dependent step at the SM clock nvidia-smi reads
     during the run; T2's and T3's floors (tools/torch_kbench_floors.py:
     each case at REPS and 2 x REPS, at reps 0, one column alone, 4,096
     columns; the operations bound, the shuffle bound, the latency floor
     at the measured shuffle and max latencies); T2's one-call yardstick
     (tools/kbench.py shift_yardstick, strided torch.cummax clamped at 0)
     and 64 x torch.cummax as T3's library yardstick, each equal to its
     kernel's output; the SASS
     opcodes of each T1 chain (cuobjdump); T4 base against K3 (sw_qm_ends)
     on the same 4,096 pairs (T4_K3_SHAPE), equal outputs, both times
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before either.
"""

import contextlib
import hashlib
import json
import os
import pathlib
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
DB_SUFFIXES = ("", ".index", ".dbtype")
CSRC = "metaeuk_tpu_torch/csrc"
KERNELS = {
    # name: (source, TPU kernel it replaces)
    "sw_pair_ends": ("sw_pair.cu", "metaeuk_tpu/ops/sw_pallas.py:86"),
    "sw_pair_starts": ("sw_pair.cu", "metaeuk_tpu/ops/sw_pallas.py:220"),
    # K1/K2's uncapped instances: the realign pass, which the JAX package
    # runs on sw_jax.sw_align_batch (:176, XLA, no Pallas kernel)
    "sw_pair_ends_nocap": ("sw_pair.cu", "metaeuk_tpu/ops/sw_jax.py:83"),
    "sw_pair_starts_nocap": ("sw_pair.cu", "metaeuk_tpu/ops/sw_jax.py:111"),
    "sw_pair_ends_prof": ("sw_pair.cu", "metaeuk_tpu/ops/sw_pallas.py:86"),
    "sw_pair_starts_prof": ("sw_pair.cu",
                            "metaeuk_tpu/ops/sw_pallas.py:220"),
    # K1/K2's uncapped PSSM instances: the profile-query aligner, which the
    # JAX package runs on sw_jax.sw_align_batch_prof (:149, XLA, no Pallas
    # kernel)
    "sw_pair_ends_prof_nocap": ("sw_pair.cu",
                                "metaeuk_tpu/ops/sw_jax.py:135"),
    "sw_pair_starts_prof_nocap": ("sw_pair.cu",
                                  "metaeuk_tpu/ops/sw_jax.py:149"),
    "sw_qm_ends": ("sw_qm.cu", "metaeuk_tpu/ops/sw_pallas.py:405"),
    "sw_qm_starts": ("sw_qm.cu", "metaeuk_tpu/ops/sw_pallas.py:462"),
    "sw_qm_rt_ends": ("sw_qm_rt.cu", "metaeuk_tpu/ops/sw_pallas.py:539"),
    "sw_qm_rt_starts": ("sw_qm_rt.cu", "metaeuk_tpu/ops/sw_pallas.py:627"),
    "gapless_pair": ("gapless.cu", "metaeuk_tpu/ops/ungapped.py:44"),
    "gapless_long": ("gapless.cu", "metaeuk_tpu/ops/ungapped.py:44"),
    "gapless_rows": ("gapless.cu", "metaeuk_tpu/ops/ungapped.py:44"),
    "kb_alu": ("kbench.cu", "tools/kbench.py:50"),
    "kb_shift": ("kbench.cu", "tools/kbench.py:79"),
    "kb_scan": ("kbench.cu", "tools/kbench.py:111"),
    "qm_variant_ends": ("qm_variants.cu", "tools/kernel_variants.py:48"),
}
PAIR_KERNELS = ("sw_pair_ends", "sw_pair_starts")
NOCAP_KERNELS = ("sw_pair_ends_nocap", "sw_pair_starts_nocap")
# the PSSM entries of K1/K2 (the profile path: sw_pallas.py
# _align_full_prof :369 over _build_S_prof :346)
PROF_KERNELS = ("sw_pair_ends_prof", "sw_pair_starts_prof")
# their uncapped instances (the profile-query aligner: sw_jax.py
# sw_align_batch_prof :149 over sw_batch_ends_prof :135)
PROF_NOCAP_KERNELS = ("sw_pair_ends_prof_nocap", "sw_pair_starts_prof_nocap")
UNGAPPED_KERNELS = ("gapless_rows", "sw_qm_ends", "sw_qm_starts")
RT_KERNELS = ("sw_qm_rt_ends", "sw_qm_rt_starts")
# K5/K6's __global__ function in ptxas's report (the instance of its
# template for the forward and the reverse pass)
RT_KERNEL_SYMBOLS = {"sw_qm_rt_ends": "sw_qm_rt_kernelILb0E",
                     "sw_qm_rt_starts": "sw_qm_rt_kernelILb1E"}
# K1/K2's __global__ template in ptxas's report, one instance per length
# class (G, R), pass and row source (PairRows: sequence queries, ProfRows:
# the PSSM entries); K3's and K4's, one instance per class
PAIR_KERNEL_SYMBOL = "sw_pair_kernel"
QM_KERNEL_SYMBOLS = {"sw_qm_ends": "sw_qm_ends_kernel",
                     "sw_qm_starts": "sw_qm_starts_kernel"}
# (Lq, Lt, pairs): the driver's length tiers, plus one tier above the TPU
# kernels' 4096-row bound
CHECK_SHAPES = ((64, 64, 1024), (128, 256, 1024), (256, 512, 2048),
                (1024, 1024, 256), (4096, 1024, 64), (4608, 512, 64))
# (Lq, Lt, query rows, target rows, tiles): query-major tiers up to 4096
# rows, Lt across one 512-column chunk
QM_SHAPES = ((64, 512, 64, 300, 96), (128, 1024, 64, 300, 64),
             (256, 256, 32, 300, 48), (1024, 1024, 8, 200, 12),
             (4096, 1024, 4, 100, 4))
# (Lq, Lt, query rows, target rows, tiles, row tile, query lengths): K5/K6
# with the plain versions at a shrunk row tile of 64 (many tile
# boundaries), then at the real one (None: sw_torch.TQ_RT) on the 16384 and
# 65536 tiers with true lengths up to 32,734 and Lt up to 4096 (eight
# stripes of 512)
QM_RT_SHAPES = ((256, 512, 8, 300, 24, 64, (1, 256)),
                (1024, 1024, 4, 200, 12, 64, (1, 1024)),
                (16384, 512, 4, 300, 8, None, (4097, 16384)),
                (16384, 4096, 2, 64, 4, None, (4097, 6200)),
                (65536, 512, 3, 200, 6, None, (16385, 32734)))
# (Lq, Lt, query rows, target rows): gapless prefilter buckets, the last
# as large as one of the ungapped slice's launches (4.2M pairs)
GAPLESS_SHAPES = ((32, 64, 64, 300), (128, 512, 64, 300),
                  (512, 1024, 16, 100), (4096, 1024, 4, 50),
                  (64, 512, 1400, 3000))
# (Lq, Lt, query lengths, query rows, target rows): the prefilter's buckets
# of long rows (gapless_long: LONG_ROWS, fragments over 4096 aa, and the
# longest), with true lengths up to 32,700 and Lt across gapless_long's
# column tiles of 512
GAPLESS_LONG_SHAPES = ((1024, 1100, (513, 1024), 16, 300),
                       (8192, 1100, (4097, 8192), 3, 300),
                       (32768, 512, (16385, 32700), 2, 300),
                       (32768, 1100, (16385, 32700), 2, 100))
# the ungapped slice of phase 5b: the 1.6 Mbp slice's generator and targets
UNGAPPED_SLICE = dict(mbp=0.4, targets=3000, seed=20260820)
# pair-launch cell budget of phase 5c's METAEUK_QM=off runs: every pair of
# a long-frame tier in one launch (the driver's default is 1 << 32)
OFF_CELL_BUDGET = 1 << 39
# timing shapes: pair kernels (Lq, Lt, pairs); query-major (Lq, Lt, tiles),
# timed with the pair kernels on the same pairs; gapless (Lq, Lt, pairs)
TIME_SHAPE = (256, 512, 4096)
# the pair kernels' second timing shape: the k-mer slice's largest bucket
# at the driver's pair cap there (2^32 / (256 * 1024)), with fragment and
# target lengths drawn from the bucket's percentiles (tools/
# torch_pair_shapes.py: the 19,823 pairs of Lq 256 x Lt 1024)
KMER_PAIR_SHAPE = (256, 1024, 16384)
KMER_PAIR_LENGTHS = ((0, 10, 25, 50, 75, 90, 100),
                     (15, 24, 37, 66, 122, 180, 256),
                     (257, 298, 344, 412, 477, 535, 599))
QM_TIME_SHAPE = (128, 512, 512)
# K3/K4's second timing shape: one launch of the ungapped slices' largest
# query-major bucket (Lq 256 x Lt 1024: 31,234 tiles in 31 launches on the
# 0.4 Mbp slice), with live lanes a tile, query and target lengths drawn
# from its percentiles (tools/torch_long_frame_ab.py --qm-shapes):
# (Lq, Lt, tiles), then (percentiles, live lanes, query lengths, target
# lengths)
QM_BUCKET_SHAPE = (256, 1024, 1008)
QM_BUCKET_LENGTHS = ((0, 10, 50, 90, 100), (48, 108, 128, 128, 128),
                     (15, 16, 28, 73, 256), (257, 299, 424, 544, 600))
# K3/K4's planted edges: pair_edge_batch's pairs as tiles at this width
# (qm_edge_tiles); then a cap run at (Lq, Lt, run length): a self-match of
# W and C (11 and 9 a cell) whose H passes 32767
QM_EDGE_WIDTH = 1152
QM_CAP_SHAPE = (4096, 4096, 3500)
# K1/K2's uncapped instances past the cap: (Lq, Lt, residues cycled, run
# length) self-matches under the realign matrix (W:W 10, C:C 9 there)
# whose H passes 32767 in the seventh row stripe of 512
NOCAP_RUNS = ((4096, 4096, b"W", 3500), (4096, 4096, b"WWC", 3600))
# K1/K2's uncapped PSSM instances past the cap: (Lq, Lt, run length)
# self-matches of a profile that scores 31 on its own residue and -32 on
# every other (31 * 1057 = 32767 at row and column 1056): the 1,100-row
# profile of tests/test_torch_profile.py's cap test in the aligner's bucket
# of 1152 (34,100 at (1099, 1099)), and a 3,500-row one at Lq 4096
PROF_CAP_RUNS = ((1152, 1152, 1100), (4096, 4096, 3500))
# phase 5g: the iterations of the full search slice's run (the cut runs
# make_iter_slice.ITER_SLICE's three; result2profile, a per-query numpy
# loop, takes minutes a round at 4,000 queries), and the seeded sample of
# its last profile step's pairs that the plain versions realign on the card
ITER_FULL_ITERATIONS = 2
# the full run's depth cut: every ITER_FULL_EVERY-th query of the slice (its
# widths and its mix of 90/60/40% copies and decoys kept)
ITER_FULL_EVERY = 2
ITER_SAMPLE = 20000
ITER_SAMPLE_SEED = 20261017
# K5/K6 (Lq tier, Lt, tiles), query lengths 8192..16384, timed with the
# pair kernels on the same pairs (targets of 256-512 aa); then the Lt 1024
# tier, targets of 513-600 aa (two stripes)
QM_RT_TIME_SHAPE = (16384, 512, 64)
QM_RT_WIDE_SHAPE = (16384, 1024, 64, 513, 600)
GAPLESS_TIME_SHAPE = (128, 512, 1 << 18)
# gapless_pair's time at GAPLESS_TIME_SHAPE in its first design, a thread
# per pair walking its cells one diagonal at a time (PERF.md §6)
GAPLESS_PAIR_THREAD_MS = 16.38
# gapless_pair's planted pair lists (check_gapless_pairs): (Lq, Lt, query
# rows, targets) at the short-row widths, each with more targets than a
# block's 128 threads
GAPLESS_PAIR_SHAPES = ((32, 64, 16, 300), (64, 128, 16, 300),
                       (128, 512, 16, 300), (512, 1024, 16, 300))
# gapless_rows, gapless_pair and gapless_long on one cross launch each: the
# query rows of GAPLESS_TIME_SHAPE against its 3,000 targets, then the
# prefilter's launch at Lq 32 x Lt 64 (12 targets of 60-64 aa, as in the
# slices' Lt 64 bucket, and as many query rows of 17-32 aa as its pair cap
# of 2^22 allows): (Lq, Lt, query rows, query lengths, targets, target
# lengths)
GAPLESS_ROWS_TIME_SHAPES = ((128, 512, 88, (64, 128), 3000, (256, 512)),
                            (32, 64, (1 << 22) // 12, (17, 32), 12, (60, 64)))
# gapless_long at one launch of the long-frame slice's prefilter: (Lq, Lt,
# query rows, query lengths, targets, target lengths)
GAPLESS_LONG_TIME_SHAPE = (32768, 512, 2, (16400, 32700), 1687, (257, 512))
# H100 SXM peaks: int32 operations (64 INT32 lanes per SM, half the 128 FP32
# lanes behind the data sheet's 67 TFLOP/s, which counts an FMA as two) and
# device memory bytes per second
INT32_OPS_PER_S = 67e12 / 4
BYTES_PER_S = 3.35e12
# warp shuffles: 32 results a clock an SM at compute capability 9.0 (the
# CUDA C++ Programming Guide's table of arithmetic instruction throughput),
# half the int32 lanes' rate; in lanes moved a second
SHFL_PER_S = INT32_OPS_PER_S / 2
# the least integer instructions per DP cell, with the bias folded into a
# per-query profile and each of sm_90's DPX functions (__viaddmax_s32,
# __viaddmax_s32_relu) counted as one instruction at the int32 rate.
# Smith-Waterman: G = max(Hdiag + s, E, 0) 1, H = min(max(G, F), cap) 2,
# E' = max(E - ge, H - go) 2, F' = max(G - go, F - ge) 1 (F carried as
# F + go: F' + go = max(F + go - ge, G), one add-max), best = max 1; the
# end positions' bookkeeping is not counted. Gapless: run = max(run + s, 0)
# 1, best = max 1.
SW_OPS, GAPLESS_OPS = 7, 2
# K1/K2's uncapped instances (the realign pass): H = max(G, F) 1, the rest
# as SW_OPS
NOCAP_SW_OPS = 6
# K1/K2's planted ties (pair_edge_batch): {fragment rows n: rows e whose
# pair e - 1 / e gets equal scores}: a lane's edge (R - 1 / R) and a
# group's last rows at the largest n of each length class of
# ops/sw_cuda.py PAIR_CLASSES; past 512 rows the 511/512 row-stripe edge,
# then the last stripe's lane edge and last rows (R 8 at n 700, R 4 at n
# 1100)
PAIR_EDGES = {32: (8, 16, 24, 31), 64: (8, 32, 56, 63),
              128: (8, 64, 120, 127), 256: (16, 128, 240, 255),
              512: (16, 256, 496, 511), 700: (512, 520, 699),
              1100: (512, 1024, 1028, 1099)}


def phase(name):
    print(f"== {name}", flush=True)


def ragged_batch(torch, rng, Lq, Lt, B, device):
    """Seeded pairs with ragged lengths, zero-length pairs, repeated pairs
    (ties) and pairs that share a segment (real hits)."""
    import numpy as np
    q = rng.integers(0, 21, (B, Lq))
    t = rng.integers(0, 21, (B, Lt))
    qb = rng.integers(-3, 4, (B, Lq))
    ql = rng.integers(1, Lq + 1, B)
    tl = rng.integers(1, Lt + 1, B)
    ql[::17] = 0
    tl[5::19] = 0
    for b in range(3, B, 7):   # implant a shared segment
        n = int(min(ql[b], tl[b], 40))
        t[b, :n] = q[b, :n]
    q[1::11], qb[1::11], ql[1::11] = q[0], qb[0], ql[0]
    t[1::11], tl[1::11] = t[0], tl[0]
    mk = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dt)
    return (mk(q, torch.uint8), mk(qb, torch.int8), mk(ql, torch.int32),
            mk(t, torch.uint8), mk(tl, torch.int32))


def staged_batch(torch, rng, Lq, Lt, nq, nt, device, lo=1):
    """Seeded staged matrices as the driver holds them: (nq, Lq) query codes
    and biases, (nt, Lt) target codes, lengths between lo and the tier
    width, zero-length rows, targets that repeat others (ties) and targets
    that share a segment with a query (real hits)."""
    import numpy as np
    q = rng.integers(0, 21, (nq, Lq))
    qb = rng.integers(-3, 4, (nq, Lq))
    ql = rng.integers(lo, Lq + 1, nq)
    t = rng.integers(0, 21, (nt, Lt))
    tl = rng.integers(lo, Lt + 1, nt)
    ql[5::13] = 0
    tl[7::23] = 0
    for k in range(2, nt, 5):
        qi = k % nq
        n = int(min(ql[qi], tl[k], 60))
        t[k, 3:3 + n] = q[qi, :n]
    t[1::9], tl[1::9] = t[0], tl[0]
    mk = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dt)
    return (mk(q, torch.uint8), mk(qb, torch.int8), mk(ql, torch.int32),
            mk(t, torch.uint8), mk(tl, torch.int32))


@contextlib.contextmanager
def pair_kernels_only(driver):
    """METAEUK_QM=off, with pair launches of up to OFF_CELL_BUDGET cells: a
    launch takes at least as long as its longest pair (a warp per pair
    there, row stripe by row stripe), and the default budget cuts the 65536
    tier into launches of 64 pairs."""
    budget = driver.CELL_BUDGET["cuda"]
    os.environ["METAEUK_QM"] = "off"
    driver.CELL_BUDGET["cuda"] = OFF_CELL_BUDGET
    try:
        yield
    finally:
        del os.environ["METAEUK_QM"]
        driver.CELL_BUDGET["cuda"] = budget


@contextlib.contextmanager
def launch_events(torch, module, by_lq=False):
    """Brackets each launch through module._kernel (the ctypes entry points
    of ops/sw_cuda.py and ops/ungapped_cuda.py) with CUDA events on the
    current stream, for this script's measurement only; yields {kernel:
    [(start, stop)]}, read after a synchronise. With by_lq the key is
    "kernel Lq N", N the staged query width (the 7th argument of the
    gapless entry points)."""
    kernel, events = module._kernel, {}

    def timed_kernel(*key):
        fn = kernel(*key)

        def launch(*args):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            rc = fn(*args)
            stop.record()
            name = f"{fn.__name__} Lq {args[6]}" if by_lq else fn.__name__
            events.setdefault(name, []).append((start, stop))
            return rc
        return launch
    module._kernel = timed_kernel
    try:
        yield events
    finally:
        module._kernel = kernel


def event_ms(events):
    """{key: [launches, summed ms]} of launch_events' events, with one more
    entry per kernel that a by_lq key splits ("kernel": the sum over its
    Lq buckets), in key order."""
    out = {}
    for k, evs in events.items():
        out[k] = [len(evs), sum(a.elapsed_time(b) for a, b in evs)]
        if " Lq " in k:
            total = out.setdefault(k.split(" Lq ")[0], [0, 0.0])
            total[0] += out[k][0]
            total[1] += out[k][1]
    return dict(sorted(out.items()))


def print_k7_by_lq(events, cells_by_lq):
    """Each gapless kernel's launches, summed ms, cells, cells/s and bound
    at each staged query width, from launch_events(by_lq=True)'s events and
    the prefilter's CELLS_BY_LQ (a width takes one kernel)."""
    for k, (n, ms) in event_ms(events).items():
        if " Lq " not in k:
            continue
        cells = cells_by_lq.get(int(k.split(" Lq ")[1]), 0)
        bound_ms = cells * GAPLESS_OPS / INT32_OPS_PER_S * 1e3
        print(f"K7 {k}: {n} launches, {ms:.3f} ms, {cells} cells, "
              f"{cells / ms * 1e3:.4e} cells/s, bound {bound_ms:.3f} ms "
              f"(operations; {bound_ms / ms:.1%} of it)", flush=True)


def print_sw_ms(events, what):
    """Each SW kernel's launches and summed ms in one run, from
    launch_events' events."""
    for k, (n, ms) in event_ms(events).items():
        print(f"{what}: {k} {n} launches, {ms:.3f} ms of kernel time (CUDA "
              "events around each launch)", flush=True)


def ptxas_usage(text):
    """{function: [registers, spill store bytes, spill load bytes]} from
    nvcc's -Xptxas -v report."""
    import re
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, [0, 0, 0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


def report_t4_build(_build, sw_cuda, t_start):
    """qm_variants.cu's nvcc seconds and, of its 125 instances <variant,
    unroll, G, R>, the most registers, those that spill, and each class of
    base at unroll 8 (the tool's default)."""
    b = _build.BUILT.get("qm_variants", {})
    print(f"qm_variants.cu {b.get('seconds', 0.0):.2f} s of nvcc, joined at "
          f"{time.perf_counter() - t_start:.1f} s of the script", flush=True)
    usage = {n: v for n, v in ptxas_usage(b.get("ptxas", "")).items()
             if "qm_variant_kernel" in n}
    spilled = sorted(n for n, v in usage.items() if v[1] or v[2])
    print(f"qm_variant_ends: {len(usage)} instances, at most "
          f"{max((v[0] for v in usage.values()), default=0)} registers, "
          f"{len(spilled)} with spills {spilled[:4]}", flush=True)
    for g, r in sw_cuda.PAIR_CLASSES:
        found = [v for n, v in usage.items()
                 if f"qm_variant_kernelILi0ELi8ELi{g}ELi{r}E" in n]
        print(f"qm_variant_ends base u8 (G {g}, R {r}): " + (
            f"{found[0][0]} registers, {found[0][1]} bytes spill stores, "
            f"{found[0][2]} bytes spill loads" if found
            else "no ptxas report (a cached build)"), flush=True)


def same_hits(np, ref, got, what):
    if len(ref) != len(got) or any(not np.array_equal(ref[f], got[f])
                                   for f in ref.dtype.names):
        raise AssertionError(f"{what}: query-major and pair-kernel hit "
                             "arrays differ")
    print(f"{what}: query-major and pair-kernel hit arrays equal "
          f"({len(ref)} hits)", flush=True)


def max_err(torch, got, ref):
    err = 0
    for g, r in zip(got, ref):
        err = max(err, int((g.long() - r.long()).abs().max().item())
                  if g.numel() else 0)
        if not torch.equal(g, r):
            raise AssertionError("kernel disagrees with its plain version")
    return err


def check_pair_kernels(torch, sw_cuda, sw_torch, errs):
    import numpy as np
    rng = np.random.default_rng(20260820)
    for Lq, Lt, B in CHECK_SHAPES:
        args = ragged_batch(torch, rng, Lq, Lt, B, "cuda")
        got = sw_cuda.sw_ends(*args)
        torch.cuda.synchronize()
        ref = sw_torch.sw_ends(*args)
        errs["sw_pair_ends"] = max(errs["sw_pair_ends"],
                                   max_err(torch, got, ref))
        qe = torch.clamp_min(ref[1], 0)
        te = torch.clamp_min(ref[2], 0)
        # random ends too: rows/columns past the true lengths, and -1
        qe_r = torch.from_numpy(rng.integers(-1, Lq + 2, B)).to("cuda")
        te_r = torch.from_numpy(rng.integers(-1, Lt + 2, B)).to("cuda")
        for ends in ((qe, te), (qe_r.int(), te_r.int())):
            got = sw_cuda.sw_starts(*args, *ends)
            torch.cuda.synchronize()
            ref2 = sw_torch.sw_starts(*args, *ends)
            errs["sw_pair_starts"] = max(errs["sw_pair_starts"],
                                         max_err(torch, got, ref2))
        if not torch.equal(ref[0], sw_torch.sw_starts(*args, qe, te)[0]):
            raise AssertionError("reverse score differs from forward best")
        got = sw_cuda.align_full(*args)
        torch.cuda.synchronize()
        max_err(torch, got, sw_torch.align_full(*args))
        n_hit = int((ref[0] > 0).sum())
        print(f"pair Lq={Lq} Lt={Lt} B={B}: ends and starts equal "
              f"({n_hit} pairs with a hit)", flush=True)


def check_qm_kernels(torch, sw_cuda, sw_torch, errs):
    import numpy as np
    rng = np.random.default_rng(20260821)
    TB = sw_torch.TB
    for Lq, Lt, nq, nt, nT in QM_SHAPES:
        staged = staged_batch(torch, rng, Lq, Lt, nq, nt, "cuda")
        qidx = rng.integers(0, nq, nT)
        qidx[-1] = -1                       # a padding tile
        lj = rng.integers(0, nt, (nT, TB))
        lj[:, 100:] = -1                    # padding lanes
        lj[1, :] = np.arange(TB) % nt       # every target, repeats included
        lj[2, 5:40] = 1                     # one target many times (ties)
        args = (*staged, torch.from_numpy(qidx).int().cuda(),
                torch.from_numpy(lj.reshape(-1)).int().cuda())
        got = sw_cuda.qm_ends(*args)
        torch.cuda.synchronize()
        ref = sw_torch.qm_ends(*args)
        errs["sw_qm_ends"] = max(errs["sw_qm_ends"], max_err(torch, got, ref))
        qe = torch.clamp_min(ref[1], 0)
        te = torch.clamp_min(ref[2], 0)
        B = nT * TB
        qe_r = torch.from_numpy(rng.integers(-1, Lq + 2, B)).int().cuda()
        te_r = torch.from_numpy(rng.integers(-1, Lt + 2, B)).int().cuda()
        for ends in ((qe, te), (qe_r, te_r)):
            got = sw_cuda.qm_starts(*args, *ends)
            torch.cuda.synchronize()
            ref2 = sw_torch.qm_starts(*args, *ends)
            errs["sw_qm_starts"] = max(errs["sw_qm_starts"],
                                       max_err(torch, got, ref2))
        if not torch.equal(ref[0], sw_torch.qm_starts(*args, qe, te)[0]):
            raise AssertionError("reverse score differs from forward best")
        print(f"query-major Lq={Lq} Lt={Lt} tiles={nT}: ends and starts "
              f"equal ({int((ref[0] > 0).sum())} lanes with a hit)",
              flush=True)


def plant_row_tile_ties(q, qb, ql, t, tl, tq, rng, n=24):
    """Query 0 gets a segment A in its first row tile and a permutation B of
    A (the same self-score) two row tiles down, and a bias of -4 on its
    other rows; target 0 (and its repeat, target 1) holds B early and A
    late, target 2 the other way round: equal scores in different row tiles
    at different columns, forward and reverse."""
    rA, rB, cE, cL = 5, 2 * tq + 5, 3, 200
    A = rng.integers(0, 20, n)
    B = rng.permutation(A)
    ql[0] = max(ql[0], rB + n + 1)
    q[0, rA:rA + n], q[0, rB:rB + n] = A, B
    qb[0] = -4
    qb[0, rA:rA + n] = qb[0, rB:rB + n] = 0
    for k, (early, late) in ((0, (B, A)), (2, (A, B))):
        t[k, cE:cE + n], t[k, cL:cL + n] = early, late
        tl[k] = max(tl[k], cL + n + 1)
    t[1], tl[1] = t[0], tl[0]


def plant_column_ties(q, qb, ql, t, tl, rng):
    """Query 1 gets W (bias -2) in its first row and C (bias 0) in its last,
    each scoring 9 against its own residue, and other residues with a bias
    of -9 elsewhere, so no other cell scores above 0; targets 3 and 4 (and 5
    and 6 where the tier is wider than 512) hold a W and a C on either side
    of a K5/K6 column boundary, 15/16 (a thread's edge) and 511/512 (a
    stripe's edge), at full length (16 columns a thread). Returns {target:
    (forward end, reverse start over the whole matrix)} as (row, column):
    the first column wins forward, the last one in reverse."""
    from metaeuk_tpu_torch.data.submat import encode_aa
    W, C = (int(encode_aa(r)[0]) for r in (b"W", b"C"))
    other = [a for a in range(20) if a not in (W, C)]
    ql[1] = max(ql[1], 2)
    Lt, last = t.shape[1], int(ql[1]) - 1
    q[1], qb[1] = rng.choice(other, q.shape[1]), -9
    (q[1, 0], qb[1, 0]), (q[1, last], qb[1, last]) = (W, -2), (C, 0)
    cases = [(3, 16, 15), (4, 15, 16)]
    if Lt > 512:
        cases += [(5, 512, 511), (6, 511, 512)]
    expect = {}
    for k, w, c in cases:
        t[k], tl[k] = rng.choice(other, Lt), Lt
        t[k, w], t[k, c] = W, C
        expect[k] = ((last, c), (0, w)) if c < w else ((0, w), (last, c))
    return expect


def pair_edge_batch(np, rng, Lq, Lt):
    """A (Lq, Lt) batch of K1/K2's planted edges, for every n of PAIR_EDGES
    below Lq. Each tie pair holds two cells of score 9 (a W or C row of bias
    -2 or 0 against its own residue) and nothing else that reaches 9 (every
    other cell scores at most -1): in rows e - 1 and e of each edge e, in
    one column, in two columns (the later row first), and in the first and
    last columns; then with one of the two cells one row past q_len or one
    column past t_len. Then runs that end at q_len - 1 or t_len - 1 with
    padding that would extend them: the fragment equals the target over
    the whole width, bias 0. Returns (q, qb, ql, t, tl) numpy arrays and,
    per pair, the expected forward end and reverse start over the whole
    matrix as (score, row, column), or None for a run."""
    from metaeuk_tpu_torch.data.submat import encode_aa
    W, C, Y, A = (int(encode_aa(r)[0]) for r in (b"W", b"C", b"Y", b"A"))
    other = [a for a in range(20) if a not in (W, C, Y, A)]
    ties = []
    for k, (n, edges) in enumerate(PAIR_EDGES.items()):
        if n >= Lq:
            continue
        m = min(Lt - 1, 40 + 7 * k)
        c = m // 2
        for e in edges:
            ties += [(n, m, (e - 1, c), (e, c)),
                     (n, m, (e - 1, c + 3), (e, c)),
                     (n, m, (e - 1, 0), (e, m - 1)),
                     (n, m, (e, 0), (e - 1, m - 1))]
        ties += [(n, m, (n - 1, c + 2), (n, c)),
                 (n, m, (edges[0], m - 1), (edges[0] - 1, m))]
    runs = [(n, n + d) for n in PAIR_EDGES for d in (-1, 0, 1)
            if n + 1 < Lq and n + d + 1 < Lt]
    B = len(ties) + len(runs)
    q = rng.choice(other, (B, Lq))
    qb = np.full((B, Lq), -9)
    t = rng.choice(other, (B, Lt))
    ql, tl = np.zeros(B, np.int64), np.zeros(B, np.int64)
    expect = []
    for b, (n, m, x, y) in enumerate(ties):
        ql[b], tl[b] = n, m
        ry = W if x[1] == y[1] else C   # one column: two W rows
        q[b, x[0]], qb[b, x[0]], t[b, x[1]] = W, -2, W
        q[b, y[0]], qb[b, y[0]], t[b, y[1]] = ry, -2 if ry == W else 0, ry
        real = [(r, col) for r, col in (x, y) if r < n and col < m]
        fwd = min(real, key=lambda rc: (rc[1], rc[0]))
        rev = max(real, key=lambda rc: (rc[1], rc[0]))
        expect.append(((9, *fwd), (9, *rev)))
    w = min(Lq, Lt)
    for b, (n, m) in enumerate(runs, len(ties)):
        ql[b], tl[b] = n, m
        q[b, :w] = t[b, :w] = rng.integers(0, 20, w)
        qb[b] = 0
        expect.append(None)
    return (q, qb, ql, t, tl), expect


def check_pair_edges(torch, sw_cuda, sw_torch, errs):
    """K1/K2 on pair_edge_batch at Lq 1152 x Lt 1152, against the plain
    versions and against the planted cells; K2 from the forward ends, over
    the whole matrix, and from random ends (-1 and past the lengths)."""
    import numpy as np
    rng = np.random.default_rng(20260825)
    Lq = Lt = 1152
    arrays, expect = pair_edge_batch(np, rng, Lq, Lt)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
        device="cuda", dtype=dt) for a, dt in zip(arrays, (
            torch.uint8, torch.int8, torch.int32, torch.uint8, torch.int32)))
    B = args[0].shape[0]
    got = sw_cuda.sw_ends(*args)
    torch.cuda.synchronize()
    ref = sw_torch.sw_ends(*args)
    errs["sw_pair_ends"] = max(errs["sw_pair_ends"], max_err(torch, got, ref))
    whole = tuple((a - 1).int() for a in (args[2], args[4]))
    ends = [(torch.clamp_min(ref[1], 0), torch.clamp_min(ref[2], 0)), whole,
            tuple(torch.from_numpy(rng.integers(-1, n + 2, B)).int().cuda()
                  for n in (Lq, Lt))]
    starts = []
    for k, (qe, te) in enumerate(ends):
        got = sw_cuda.sw_starts(*args, qe, te)
        torch.cuda.synchronize()
        starts.append(sw_torch.sw_starts(*args, qe, te))
        errs["sw_pair_starts"] = max(errs["sw_pair_starts"],
                                     max_err(torch, got, starts[-1]))
    if not torch.equal(ref[0], starts[0][0]):
        raise AssertionError("reverse score differs from forward best")
    for b, ex in enumerate(expect):
        have = (tuple(int(ref[k][b]) for k in range(3)),
                tuple(int(starts[1][k][b]) for k in range(3)))
        if ex is not None and have != ex:
            raise AssertionError(f"planted pair {b}: {have}, expected {ex}")
    n_ties = sum(e is not None for e in expect)
    print(f"pair edges Lq={Lq} Lt={Lt}: ends and starts equal on {n_ties} "
          f"planted ties (as expected) and {B - n_ties} runs ending at "
          f"q_len - 1 or t_len - 1 (scores up to {int(ref[0].max())})",
          flush=True)


def realign_scoring(device):
    """The realign pass's scoring: scores_with_bias(2.0, -0.2), gaps 11/1."""
    from metaeuk_tpu_torch import state
    from metaeuk_tpu_torch.data.submat import scores_with_bias
    return state.scoring_from_numpy(scores_with_bias(2.0, -0.2), 11, 1,
                                    device)


def check_nocap_pair(torch, sw_cuda, sw_torch, args, scoring, errs, rng):
    """K1/K2's uncapped instances on one batch against their plain versions
    (cap=None): forward ends, then starts from those ends and from random
    ones; returns the plain (ends, starts from the ends)."""
    ref = sw_torch.sw_ends(*args, scoring=scoring, cap=None)
    errs["sw_pair_ends_nocap"] = max(errs["sw_pair_ends_nocap"], max_err(
        torch, sw_cuda.sw_ends(*args, scoring=scoring, cap=None), ref))
    (B, Lq), Lt = args[0].shape, args[3].shape[1]
    fwd_ends = (torch.clamp_min(ref[1], 0), torch.clamp_min(ref[2], 0))
    starts = []
    for ends in (fwd_ends, tuple(
            torch.from_numpy(rng.integers(-1, n + 2, B)).int().cuda()
            for n in (Lq, Lt))):
        starts.append(sw_torch.sw_starts(*args, *ends, scoring=scoring,
                                         cap=None))
        errs["sw_pair_starts_nocap"] = max(
            errs["sw_pair_starts_nocap"], max_err(torch, sw_cuda.sw_starts(
                *args, *ends, scoring=scoring, cap=None), starts[-1]))
    if not torch.equal(ref[0], starts[0][0]):
        raise AssertionError("uncapped reverse score differs from the "
                             "forward best")
    return ref, starts[0]


def check_nocap_kernels(torch, sw_cuda, sw_torch, errs):
    """K1/K2's uncapped instances (the realign pass) against their plain
    versions: the realign matrix at the pair kernels' shapes; pair_edge_
    batch's planted ties under BLOSUM62 (the planted cells checked too) and
    under the realign matrix; self-matches at Lq 4096 whose H passes 32767
    in a later row stripe (the 8-byte hand-off), where the capped entry
    stops at 32767."""
    import numpy as np
    from metaeuk_tpu_torch import state
    from metaeuk_tpu_torch.data.submat import encode_aa
    rng = np.random.default_rng(20260827)
    realign = realign_scoring("cuda")
    for Lq, Lt, B in CHECK_SHAPES:
        args = ragged_batch(torch, rng, Lq, Lt, B, "cuda")
        ref, _ = check_nocap_pair(torch, sw_cuda, sw_torch, args, realign,
                                  errs, rng)
        max_err(torch, sw_cuda.align_full(*args, scoring=realign, cap=None),
                sw_torch.align_full(*args, scoring=realign, cap=None))
        print(f"uncapped pair Lq={Lq} Lt={Lt} B={B}, realign matrix: ends "
              f"and starts equal ({int((ref[0] > 0).sum())} pairs with a "
              "hit)", flush=True)
    arrays, expect = pair_edge_batch(np, rng, 1152, 1152)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
        device="cuda", dtype=dt) for a, dt in zip(arrays, (
            torch.uint8, torch.int8, torch.int32, torch.uint8, torch.int32)))
    for name, scoring in (("BLOSUM62", state.default_scoring(
            torch.device("cuda"))), ("realign", realign)):
        ref, _ = check_nocap_pair(torch, sw_cuda, sw_torch, args, scoring,
                                  errs, rng)
        whole = tuple((a - 1).int() for a in (args[2], args[4]))
        rev = sw_torch.sw_starts(*args, *whole, scoring=scoring, cap=None)
        errs["sw_pair_starts_nocap"] = max(
            errs["sw_pair_starts_nocap"], max_err(torch, sw_cuda.sw_starts(
                *args, *whole, scoring=scoring, cap=None), rev))
        if name == "BLOSUM62":
            for b, ex in enumerate(expect):
                have = (tuple(int(ref[k][b]) for k in range(3)),
                        tuple(int(rev[k][b]) for k in range(3)))
                if ex is not None and have != ex:
                    raise AssertionError(f"uncapped planted pair {b}: "
                                         f"{have}, expected {ex}")
        print(f"uncapped pair edges Lq=Lt=1152, {name}: ends and starts "
              "equal on the planted ties", flush=True)
    for Lq, Lt, residues, n in NOCAP_RUNS:
        run = np.resize(encode_aa(residues), n)
        q = np.zeros((2, Lq), np.int64)
        q[:, :n] = run
        args = (torch.from_numpy(q).to("cuda", torch.uint8),
                torch.zeros((2, Lq), dtype=torch.int8, device="cuda"),
                torch.tensor([n, n // 2], dtype=torch.int32, device="cuda"),
                torch.from_numpy(q[:, :Lt]).to("cuda", torch.uint8),
                torch.tensor([n, n], dtype=torch.int32, device="cuda"))
        ref, starts = check_nocap_pair(torch, sw_cuda, sw_torch, args,
                                       realign, errs, rng)
        capped = sw_cuda.sw_ends(*args, scoring=realign)
        if int(ref[0][0]) <= state.SCORE_CAP or \
                int(capped[0][0]) != state.SCORE_CAP or \
                (int(ref[1][0]), int(starts[1][0])) != (n - 1, 0):
            raise AssertionError("uncapped self-match did not pass the cap "
                                 "from row 0 to row n - 1")
        print(f"uncapped self-match of {n} x {residues.decode()} at Lq {Lq}:"
              f" score {int(ref[0][0])} (capped entry {int(capped[0][0])}),"
              " ends and starts equal", flush=True)


def prof_batch(torch, rng, Lq, Lt, B, device):
    """Seeded staged PSSM matrices as the profile search holds them: (B, Lq,
    21) int32 PSSM rows in [-32, 31] (X column 0) of lengths 1..Lq (one of
    Lq), (B, Lt)
    fragment codes of lengths 1..Lt, zero-length rows, fragments that share
    a stretch of a profile's best residues (real hits); pairs (li, lj) in a
    shuffled order, with repeated pairs (ties)."""
    import numpy as np
    prof = rng.integers(-32, 32, (B, Lq, 21))
    prof[:, :, 20] = 0
    pl = rng.integers(1, Lq + 1, B)
    t = rng.integers(0, 21, (B, Lt))
    tl = rng.integers(1, Lt + 1, B)
    pl[::17] = 0
    pl[2] = Lq      # a profile of the tier's full width
    tl[5::19] = 0
    for b in range(3, B, 7):
        n = int(min(pl[b], tl[b], 60))
        t[b, :n] = prof[b, :n, :20].argmax(1)
    li = rng.permutation(B)
    lj = rng.permutation(B)
    li[1::11], lj[1::11] = li[0], lj[0]
    mk = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dt)
    return (mk(prof, torch.int32), mk(pl, torch.int32), mk(t, torch.uint8),
            mk(tl, torch.int32), mk(li, torch.int32), mk(lj, torch.int32))


def check_prof_ends_starts(torch, sw_cuda, sw_torch, args, ends, errs,
                           nocap=False):
    """The PSSM entries (nocap: their uncapped instances, cap=None) on
    staged args against their plain versions: K1's ends, then K2's starts
    from the forward ends and from each pair of `ends`; returns (K1's
    outputs, [K2's outputs from the forward ends, then from each of
    `ends`])."""
    fwd, rev = PROF_NOCAP_KERNELS if nocap else PROF_KERNELS
    kw = {"cap": None} if nocap else {}
    got = sw_cuda.sw_ends_prof(*args, **kw)
    torch.cuda.synchronize()
    ref = sw_torch.sw_ends_prof(*sw_cuda._gathered(*args), **kw)
    errs[fwd] = max(errs[fwd], max_err(torch, got, ref))
    starts = []
    for qe, te in [(torch.clamp_min(ref[1], 0), torch.clamp_min(ref[2], 0)),
                   *ends]:
        got = sw_cuda.sw_starts_prof(*args, qe, te, **kw)
        torch.cuda.synchronize()
        starts.append(sw_torch.sw_starts_prof(*sw_cuda._gathered(*args),
                                              qe, te, **kw))
        errs[rev] = max(errs[rev], max_err(torch, got, starts[-1]))
    if not torch.equal(ref[0], starts[0][0]):
        raise AssertionError("PSSM reverse score differs from forward best")
    return ref, starts


def check_prof_kernels(torch, sw_cuda, sw_torch, errs, nocap=False):
    """K1/K2's PSSM entries (nocap: their uncapped instances) on prof_batch
    at CHECK_SHAPES (Lq up to 4608, profiles over 4096 rows): ends, starts
    from the forward ends and from random ends (-1, past the lengths), and
    align_full_prof."""
    import numpy as np
    rng = np.random.default_rng(20260826)
    kw = {"cap": None} if nocap else {}
    what = "uncapped PSSM" if nocap else "PSSM"
    for Lq, Lt, B in CHECK_SHAPES:
        args = prof_batch(torch, rng, Lq, Lt, B, "cuda")
        rand = tuple(torch.from_numpy(rng.integers(-1, n + 2, B)).int()
                     .cuda() for n in (Lq, Lt))
        ref, _ = check_prof_ends_starts(torch, sw_cuda, sw_torch, args,
                                        [rand], errs, nocap)
        got = sw_cuda.align_full_prof(*args, **kw)
        torch.cuda.synchronize()
        max_err(torch, got,
                sw_torch.align_full_prof(*sw_cuda._gathered(*args), **kw))
        print(f"{what} pairs Lq={Lq} Lt={Lt} B={B}: ends and starts equal "
              f"({int((ref[0] > 0).sum())} pairs with a hit, longest "
              f"profile {int(args[1].max())} rows)", flush=True)


def check_prof_edges(torch, sw_cuda, sw_torch, errs, nocap=False):
    """K1/K2's PSSM entries (nocap: their uncapped instances) on
    pair_edge_batch at Lq 1152 x Lt 1152, the PSSM built as submat[q] +
    bias, staged and read in a shuffled order: equal to their plain versions
    and, bit for bit, to sw_pair_ends / sw_pair_starts (nocap: their
    uncapped instances) on the same pairs (from the forward ends, over the
    whole matrix and from random ends)."""
    import numpy as np
    from metaeuk_tpu_torch import state
    rng = np.random.default_rng(20260827)
    Lq = Lt = 1152
    arrays, _ = pair_edge_batch(np, rng, Lq, Lt)
    seq = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
        device="cuda", dtype=dt) for a, dt in zip(arrays, (
            torch.uint8, torch.int8, torch.int32, torch.uint8, torch.int32)))
    q, qb, ql, t, tl = seq
    B = q.shape[0]
    perm = torch.from_numpy(rng.permutation(B)).cuda()
    inv = torch.argsort(perm)
    sub = state.default_scoring(q.device).submat
    prof = sub[q.long()] + qb.int()[:, :, None]
    # staged in the order perm, read back by li = lj = inv
    staged = (prof[perm], ql[perm], t[perm], tl[perm], inv.int(), inv.int())
    whole = tuple((a - 1).int() for a in (ql, tl))
    rand = tuple(torch.from_numpy(rng.integers(-1, n + 2, B)).int().cuda()
                 for n in (Lq, Lt))
    ref, starts = check_prof_ends_starts(torch, sw_cuda, sw_torch, staged,
                                         [whole, rand], errs, nocap)
    kw = {"cap": None} if nocap else {}
    seq_ends = sw_cuda.sw_ends(*seq, **kw)
    max_err(torch, sw_cuda.sw_ends_prof(*staged, **kw), seq_ends)
    for (qe, te), want in zip(
            [(torch.clamp_min(ref[1], 0), torch.clamp_min(ref[2], 0)),
             whole, rand], starts):
        max_err(torch, sw_cuda.sw_starts(*seq, qe, te, **kw), want)
        max_err(torch, sw_cuda.sw_starts_prof(*staged, qe, te, **kw), want)
    torch.cuda.synchronize()
    what = "uncapped PSSM" if nocap else "PSSM"
    seq_names = "sw_pair_ends_nocap / sw_pair_starts_nocap" if nocap else \
        "sw_pair_ends / sw_pair_starts"
    print(f"{what} pair edges Lq={Lq} Lt={Lt}: {B} pairs equal to the plain "
          f"versions and bit-equal to {seq_names}", flush=True)


def check_prof_cap_runs(torch, sw_cuda, sw_torch, errs):
    """K1/K2's uncapped PSSM instances on PROF_CAP_RUNS against their plain
    versions: pair 0 the whole self-match (31 * n, ending at (n - 1, n - 1)
    and starting at (0, 0)), pair 1 its profile's first half against the
    same fragment; the capped entry stops at 32767."""
    import numpy as np
    rng = np.random.default_rng(34100)
    for Lq, Lt, n in PROF_CAP_RUNS:
        t = np.zeros((2, Lt), np.int64)
        t[:, :n] = rng.integers(0, 20, n)
        prof = np.full((2, Lq, 21), -32, np.int64)
        prof[:, np.arange(n), t[0, :n]] = 31
        prof[:, :, 20] = 0
        mk = lambda a, dt: torch.from_numpy(a).to(device="cuda", dtype=dt)
        staged = (mk(prof, torch.int32), mk(np.array([n, n // 2]),
                                              torch.int32),
                  mk(t, torch.uint8), mk(np.array([n, n]), torch.int32),
                  mk(np.array([0, 1]), torch.int32),
                  mk(np.array([0, 0]), torch.int32))
        ref, starts = check_prof_ends_starts(torch, sw_cuda, sw_torch,
                                             staged, [], errs, nocap=True)
        capped = sw_cuda.sw_ends_prof(*staged)
        have = [int(ref[k][0]) for k in range(3)] + \
            [int(starts[0][k][0]) for k in (1, 2)]
        if have != [31 * n, n - 1, n - 1, 0, 0] or \
                int(ref[0][1]) != 31 * (n // 2) or \
                int(capped[0][0]) != 32767:
            raise AssertionError(f"uncapped PSSM self-match of {n} rows: "
                                 f"{have}, capped {int(capped[0][0])}")
        print(f"uncapped PSSM self-match of {n} rows at Lq {Lq}: score "
              f"{31 * n}, end ({n - 1}, {n - 1}), start (0, 0) (capped entry"
              f" {int(capped[0][0])}); equal to the plain versions",
              flush=True)


def check_profile_aligner(np, torch, counters, driver, prefilter):
    """ProfileQueryAligner (iterative search steps >= 1, enrich) on the
    enrich fixture's 24 profiles against the 6 fixture proteins, every pair,
    E-value 100: on the card through the uncapped PSSM instances (never the
    capped entries), equal field by field and in backtraces and sequence
    identities to the plain versions' run (tests/test_torch_profile.py
    holds that run to the JAX package's)."""
    import make_profile_slice as mps
    from metaeuk_tpu_torch.io.profiledb import ProfileDB
    from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, SeqDB
    from metaeuk_tpu_torch.ops import sw_cuda
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.search.profile_align import ProfileQueryAligner
    profs = ProfileDB.from_db(str(mps.SEARCH_PROFILES))
    prots = SeqDB.from_fasta(str(ROOT / "tests" / "data" / "proteins.faa"),
                             DBTYPE_AA)
    pairs = [(a, b) for a in range(len(profs)) for b in range(len(prots))]
    p = Params(search_evalue_thr=100.0)
    res = {}
    for dev in ("cuda", "cpu"):
        reset(torch, counters, driver, prefilter)
        al = ProfileQueryAligner(p, profs, prots, dev)
        hits = al.search(pairs)
        res[dev] = (hits, *al.backtraces(hits))
        if dev == "cuda":
            run_l, run_p = counts(counters)
            if min(run_l[k] for k in PROF_NOCAP_KERNELS) == 0 or \
                    any(run_l[k] for k in PROF_KERNELS) or \
                    any(run_p.values()):
                raise AssertionError("ProfileQueryAligner did not go "
                                     "through the uncapped PSSM instances")
    (ref, ref_bt, ref_id), (got, got_bt, got_id) = res["cpu"], res["cuda"]
    if len(ref) == 0 or len(ref) != len(got) or any(
            not np.array_equal(ref[f], got[f]) for f in ref.dtype.names) \
            or ref_bt != got_bt or not np.array_equal(ref_id, got_id):
        raise AssertionError("ProfileQueryAligner on the card differs from "
                             "its plain run")
    sw_cuda.reset_counts()
    print(f"ProfileQueryAligner: {len(got)} hits and their backtraces equal "
          "to the plain versions' run", flush=True)


def same_bytes(mine, golden):
    if pathlib.Path(mine).read_bytes() != pathlib.Path(golden).read_bytes():
        raise AssertionError(f"{mine} differs from {golden}")


def same_db(mine, golden):
    for s in DB_SUFFIXES:
        same_bytes(f"{mine}{s}", f"{golden}{s}")


def check_search_workflows(cli, device, td):
    """Phase 4e: the port's CLI easy-search (plain and --greedy-best-hits),
    easy-rbh, rbh (with its seven intermediates), map and search
    --sens-steps 3 (with its per-step intermediates) and 2 on tests/data,
    each output byte-identical to the MMseqs2 binary's goldens
    (tests/golden/searchwf, tests/golden/senssteps); then SearchDriver.search
    + backtraces on the fixture proteins, equal to tests/golden/aln/search_a.
    Runs on `device` (tests/test_torch_search.py rehearses it on the CPU)."""
    from metaeuk_tpu_torch import native
    from metaeuk_tpu_torch.io.mmseqsdb import read_db
    from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, SeqDB
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.pipeline.alnformat import hits_to_aln_db_entries
    from metaeuk_tpu_torch.search.driver import SearchDriver
    data = ROOT / "tests" / "data"
    wf, steps = GOLDEN / "searchwf", GOLDEN / "senssteps"
    q, t = str(data / "queries_lin.faa"), str(data / "proteins.faa")
    dev = ["--device", str(device)]
    for fasta, db in ((q, "qdb"), (t, "tdb"),
                      (str(data / "queries_steps.faa"), "sdb")):
        cli.main(["createdb", fasta, str(td / db)])
    for cmd, golden, extra in (("easy-search", "easysearch.m8", []),
                               ("easy-search", "easysearch_greedy.m8",
                                ["--greedy-best-hits"]),
                               ("easy-rbh", "easyrbh.m8", [])):
        out = td / golden
        cli.main([cmd, q, t, str(out), str(td / f"{golden}_tmp"), *dev,
                  *extra])
        same_bytes(out, wf / golden)
    cli.main(["rbh", str(td / "qdb"), str(td / "tdb"), str(td / "rbh"),
              str(td / "rbh_tmp"), *dev])
    for f in ("resAB", "resBA", "resA_best_B", "resB_best_A",
              "resB_best_A_swap", "res_best_merged",
              "res_best_merged_sorted"):
        same_db(td / "rbh_tmp" / f, wf / f"rbh_{f}")
    same_db(td / "rbh", wf / "rbh")
    cli.main(["map", str(td / "qdb"), str(td / "tdb"), str(td / "map"),
              str(td / "map_tmp")])
    same_db(td / "map", wf / "map")
    for n, sens, start in ((3, "7.5", "1.0"), (2, "7.0", "2.0")):
        cli.main(["search", str(td / "sdb"), str(td / "tdb"),
                  str(td / f"steps{n}"), str(td / f"steps{n}_tmp"),
                  "--sens-steps", str(n), "-s", sens, "--start-sens", start,
                  *dev])
        same_db(td / f"steps{n}", steps / f"steps{n}")
    for f in ("pref_0", "aln_0", "pref_1", "aln_1"):
        same_db(td / "steps3_tmp" / f, steps / f"steps3_{f}")
    if native.get_lib() is None:
        raise AssertionError("the native host library did not load: "
                             "backtraces would be empty")
    targets = SeqDB.from_fasta(t, DBTYPE_AA)
    seqs = [targets.seq_bytes(i) for i in range(len(targets))]
    drv = SearchDriver(Params(aln_len_thr=0), targets, device)
    hits = drv.search(seqs)
    bts, sids = drv.backtraces(hits, seqs)
    if dict(hits_to_aln_db_entries(hits, len(targets), bts, sids)) != \
            dict(read_db(GOLDEN / "aln" / "search_a")):
        raise AssertionError("search + backtraces differ from aln/search_a")
    print(f"search workflows on {device}: easy-search (2 modes), easy-rbh, "
          "rbh (and 7 intermediates), map, search --sens-steps 3 (and 4 "
          "intermediates) and 2 byte-identical to the MMseqs2 goldens; "
          f"search + backtraces ({len(hits)} hits) equal aln/search_a",
          flush=True)


# phase 4g: result2profile's flags for each of tests/golden/r2p's goldens
# (the reference's result2profile on the fixture proteins' self-search,
# tests/test_result2profile.py), and msa2profile's (source MSA DB, flags)
# for each of tests/golden/msa's
CRF = str(ROOT / "tests" / "data" / "tiny.crf")
R2P_EP = ["-e", "10", "--e-profile", "10"]
R2P_CASES = {
    "refr2p": ["--filter-msa", "0"],
    "refr2p_nm": ["--filter-msa", "0", "--mask-profile", "0"],
    "refr2p_nb": ["--filter-msa", "0", "--comp-bias-corr", "0"],
    "refr2p_ep": ["--filter-msa", "0", *R2P_EP],
    "refr2p_ep_nb2": ["--filter-msa", "0", "--comp-bias-corr", "0",
                      *R2P_EP],
    "refr2p_f1": [],
    "refr2p_f1_ep": R2P_EP,
    "refr2p_f1s": [*R2P_EP, "--max-seq-id", "0.3", "--diff", "2", "--qsc",
                   "0.5"],
    "refr2p_f1q": [*R2P_EP, "--qid", "0.25", "--cov", "0.3"],
    "refr2p_f1b": [*R2P_EP, "--qid", "0.1,0.3,0.9"],
    "refr2p_wg": ["--filter-msa", "0", "--wg", "1"],
    "refr2p_pc1": ["--filter-msa", "0", "--pseudo-cnt-mode", "1",
                   "--context-lib", CRF],
    "refr2p_pc1_ep": ["--filter-msa", "0", *R2P_EP, "--pseudo-cnt-mode", "1",
                      "--context-lib", CRF],
}
MSA_CASES = {
    "refprof1": ("msadb", ["--filter-msa", "0"]),
    "refprof2": ("msadb2", ["--filter-msa", "0"]),
    "refprof2_f1": ("msadb2", ["--filter-msa", "1"]),
    "refprof2_pc1": ("msadb2", ["--filter-msa", "0", "--pseudo-cnt-mode",
                                "1", "--context-lib", CRF]),
}
# search --num-iterations's goldens (the reference's blastpgp.sh chain,
# tests/test_iterative.py): (tag, iterations, the fixture proteins against
# themselves (None) or tests/golden/pref's family DBs)
ITER_GOLDENS = (("iter2", 2, None), ("iter3", 3, None),
                ("iterfam2", 2, ("pfQ", "pfT")),
                ("iterfam3", 3, ("pfQ", "pfT")))


def run_cli(cli, argv):
    if cli.main([str(a) for a in argv]) != 0:
        raise AssertionError(f"metaeuk-tpu-torch {argv[0]} failed")


def copy_db(src, dst):
    import shutil
    for s in DB_SUFFIXES:
        shutil.copyfile(f"{src}{s}", f"{dst}{s}")


def check_profile_workflows(cli, device, td):
    """Phase 4g: the iterative search and the profile tools on the fixtures
    through the port's CLI, on `device`, each output byte-identical to the
    reference's golden: search --num-iterations 2|3 -a
    (tests/golden/pref/iter*), result2profile (r2p, every case of
    R2P_CASES), msa2profile (msa), sequence2profile (util9/s2p*),
    profile2pssm and convertprofiledb (util), expandaln and expand2profile
    (util7; over the port's search of queries_lin against the fixture
    proteins), the dbtools6 commands with alignall (util6) and enrich
    (enrich/enriched). The options the CLI has no flag for (msa2profile's
    filter, expand2profile's context pseudocounts) go through the port's
    functions. tests/test_torch_profilewf.py rehearses it on the CPU.
    Returns the number of outputs compared."""
    import shutil
    from metaeuk_tpu_torch.io.mmseqsdb import read_db, write_seqdb
    from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, SeqDB
    from metaeuk_tpu_torch.pipeline.expand import expandaln_db
    from metaeuk_tpu_torch.pipeline.msa2profile import msa_db_to_profile_db
    from metaeuk_tpu_torch.search.align_module import align_db
    from metaeuk_tpu_torch.search.searchdb import prefilter_db
    data, dev, n = ROOT / "tests" / "data", ["--device", str(device)], 0
    run_cli(cli, ["createdb", data / "proteins.faa", td / "pdb"])
    for tag, its, dbs in ITER_GOLDENS:
        q, t = (td / "pdb",) * 2 if dbs is None else \
            (GOLDEN / "pref" / dbs[0], GOLDEN / "pref" / dbs[1])
        run_cli(cli, ["search", q, t, td / tag, td / f"{tag}_tmp",
                      "--num-iterations", its, "-a", *dev])
        same_db(td / tag, GOLDEN / "pref" / tag)
        n += 1
    write_seqdb(str(td / "targetsDB"),
                SeqDB.from_fasta(data / "proteins.faa", DBTYPE_AA),
                DBTYPE_AA)
    copy_db(GOLDEN / "aln" / "search_a", td / "self_aln")
    for tag, extra in R2P_CASES.items():
        run_cli(cli, ["result2profile", td / "targetsDB",
                      td / "targetsDB", td / "self_aln", td / tag,
                      *extra])
        same_db(td / tag, GOLDEN / "r2p" / tag)
        n += 1
    for tag, (src, extra) in MSA_CASES.items():
        run_cli(cli, ["msa2profile", GOLDEN / "msa" / src, td / tag,
                      "--match-mode", "1", *extra])
        same_db(td / tag, GOLDEN / "msa" / tag)
        n += 1
    entries = [(k, v.decode())
               for k, v in read_db(GOLDEN / "msa" / "msadb2")]
    msa_db_to_profile_db(entries, str(td / "refprof2_f1s"),
                         match_mode=1, filter_msa=True,
                         filter_max_seq_id=0.5, ndiff=2)
    if read_db(td / "refprof2_f1s") != \
            read_db(GOLDEN / "msa" / "refprof2_f1s"):
        raise AssertionError("msa2profile refprof2_f1s differs")
    n += 1
    for tag, extra in (("s2p", []), ("s2p_tau", ["--tau", "0.35"])):
        run_cli(cli, ["sequence2profile", td / "pdb", td / tag,
                      "--context-lib", CRF, *extra])
        same_db(td / tag, GOLDEN / "util9" / tag)
        n += 1
    util = GOLDEN / "util"
    run_cli(cli, ["profile2pssm", GOLDEN / "r2p" / "refr2p",
                  td / "pssm"])
    same_bytes(td / "pssm", util / "refpssm")
    run_cli(cli, ["profile2pssm", GOLDEN / "r2p" / "refr2p",
                  td / "pssmdb", "--db-output", "1"])
    for s in ("", ".index"):
        same_bytes(f"{td / 'pssmdb'}{s}", f"{util / 'refpssm_db'}{s}")
    run_cli(cli, ["convertprofiledb", data / "hhmdb", td / "cvt"])
    for s in (*DB_SUFFIXES, "_h", "_h.index"):
        same_bytes(f"{td / 'cvt'}{s}", f"{util / 'refcvt'}{s}")
    n += 3

    # queries_lin against the fixture proteins (util6's and util7's
    # inputs), the alignment on `device`
    u6, u7 = GOLDEN / "util6", GOLDEN / "util7"
    run_cli(cli, ["createdb", data / "queries_lin.faa", td / "qdb"])
    prefilter_db(str(td / "qdb"), str(td / "pdb"), str(td / "pref"),
                 sensitivity=4.0)
    align_db(str(td / "qdb"), str(td / "pdb"), str(td / "pref"),
             str(td / "aln"), evalue=1e-3, add_backtrace=True,
             device=device)
    copy_db(u7 / "selfaln", td / "selfaln")
    for tool, tag in (("expandaln", "expaln"),
                      ("expand2profile", "expprof")):
        run_cli(cli, [tool, td / "qdb", td / "pdb", td / "aln",
                      td / "selfaln", td / tag])
        same_db(td / tag, u7 / tag)
    expandaln_db(str(td / "qdb"), str(td / "pdb"), str(td / "aln"),
                 str(td / "selfaln"), str(td / "expprof_pc1"),
                 return_aln=False, pcmode=1, context_lib=CRF)
    same_db(td / "expprof_pc1", u7 / "expprof_pc1")
    run_cli(cli, ["result2profile", td / "qdb", td / "pdb", td / "aln",
                  td / "prof"])
    for tool, tag in (("profile2consensus", "p2c"),
                      ("profile2repseq", "p2r")):
        run_cli(cli, [tool, td / "prof", td / tag])
        same_db(td / tag, u6 / tag)
    run_cli(cli, ["profile2neff", td / "prof", td / "p2n.txt"])
    same_bytes(td / "p2n.txt", u6 / "p2n.txt")
    for out, extra in (("msadb", []),
                       ("msadb_ac", ["--identifier-field", "1"])):
        run_cli(cli, ["convertmsa", u6 / "test.sto", td / out, *extra])
        same_db(td / out, u6 / out)
    for out, extra in (("filtered.a3m", ["--max-seq-id", "0.99"]),
                       ("filtered_diff1.a3m",
                        ["--diff", "1", "--max-seq-id", "0.95"])):
        run_cli(cli, ["filtera3m", u6 / "test.a3m", td / out, *extra])
        same_bytes(td / out, u6 / out)
    copy_db(u6 / "m8db", td / "m8db")
    run_cli(cli, ["summarizetabs", td / "m8db", u6 / "lengths.tsv",
                  td / "sumtabs"])
    same_db(td / "sumtabs", u6 / "sumtabs")
    run_cli(cli, ["createdb", data / "contigs.fna", td / "ndb"])
    copy_db(u6 / "nres", td / "nres")
    run_cli(cli, ["result2dnamsa", td / "ndb", td / "ndb", td / "nres",
                  td / "dnamsa"])
    same_db(td / "dnamsa", u6 / "dnamsa")
    (td / "all.faa").write_bytes((data / "queries_lin.faa").read_bytes()
                                 + (data / "proteins.faa").read_bytes())
    run_cli(cli, ["createdb", td / "all.faa", td / "alldb"])
    copy_db(u6 / "sets", td / "sets")
    run_cli(cli, ["alignall", td / "alldb", td / "sets", td / "allaln",
                  *dev])
    same_db(td / "allaln", u6 / "allaln")
    n += 13

    # enrich's target profiles (with their consensus and headers) and
    # member result DB, as tests/test_enrich.py copies them
    en = td / "enrich"
    shutil.copytree(GOLDEN / "enrich", en)
    run_cli(cli, ["enrich", td / "qdb", td / "alldb", en / "profdb",
                  en / "saln", td / "enriched", td / "enrich_tmp", *dev])
    same_db(td / "enriched", GOLDEN / "enrich" / "enriched")
    n += 1
    return n


# phase 4h: kmermatcher's flags for each of tests/golden/kmermatcher's
# goldens (the reference's kmermatcher, tests/test_kmermatcher.py): (input
# DB, flags)
KMER_CASES = {"refkm": (GOLDEN / "pref" / "pfT", []),
              "refkm2": (GOLDEN / "kmermatcher" / "kmF", []),
              "refkm3": (GOLDEN / "kmermatcher" / "kmF",
                         ["--kmer-per-seq", "40"]),
              "refkm4": (GOLDEN / "kmermatcher" / "kmF", ["-k", "10"])}
# result2msa's flags for each of tests/golden/utils' MSA goldens
# (tests/test_dbtools3.py), over the fixture proteins' self-search
# utils/selfres
RESULT2MSA_CASES = {"msa_fasta": [], "msa_sto": ["--msa-format-mode", "4"],
                    "msa_filt": ["--filter-msa", "1"]}
CASCADE = ("clu_redundancy", *(f"{n}{s}" for s in range(3)
                               for n in ("pref_step", "aln_step", "clu_step")))
EASY_CLUSTER_FILES = ("_cluster.tsv", "_rep_seq.fasta", "_all_seqs.fasta")


@contextlib.contextmanager
def prof_cells(torch, sw_cuda, tally):
    """For this script's measurement only: tally(pairs, forward cells,
    reverse cells) for each sw_cuda.align_full_prof call (K1/K2's PSSM
    entries: forward over every pair, reverse up to each pair's clamped end
    cell, as the kernels sweep them)."""
    full = sw_cuda.align_full_prof

    def counted(prof_mat, p_lens, t_mat, t_lens, li, lj, **kw):
        out = full(prof_mat, p_lens, t_mat, t_lens, li, lj, **kw)
        ql = p_lens[li.long()].long()
        tl = t_lens[lj.long()].long()
        qe = torch.minimum(out[2].long().clamp_min(0), ql - 1) + 1
        te = torch.minimum(out[4].long().clamp_min(0), tl - 1) + 1
        tally(len(li), int((ql * tl).sum()),
              int((qe.clamp_min(0) * te.clamp_min(0)).sum()))
        return out
    sw_cuda.align_full_prof = counted
    try:
        yield
    finally:
        sw_cuda.align_full_prof = full


@contextlib.contextmanager
def prof_probe(torch, sw_cuda):
    """For this script's measurement only: brackets one run that aligns
    profile queries (pickconsensusrep's ProfileQueryAligner): CUDA events
    around each SW launch (launch_events), the pairs and DP cells of
    prof_cells and the change in sw_cuda's LAUNCHES and PLAIN_CALLS over
    the run; yields the record {"events", "cells": [pairs, fwd cells, rev
    cells], "launches", "plain"}, filled at exit."""
    before = (dict(sw_cuda.LAUNCHES), dict(sw_cuda.PLAIN_CALLS))
    cells, rec = [0, 0, 0], {}

    def tally(*got):
        for i, v in enumerate(got):
            cells[i] += v
    with prof_cells(torch, sw_cuda, tally), \
            launch_events(torch, sw_cuda) as events:
        yield rec
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    rec["events"], rec["cells"] = events, cells
    rec["launches"] = {k: v - before[0][k]
                       for k, v in sw_cuda.LAUNCHES.items()}
    rec["plain"] = {k: v - before[1][k]
                    for k, v in sw_cuda.PLAIN_CALLS.items()}


def check_cluster_workflows(cli, device, td):
    """Phase 4h: the clustering and linear-search family on the fixtures
    through the port's CLI, on `device`, each output byte-identical to the
    MMseqs2 binary's golden: cluster at its defaults with the linclust
    pre-step and every step's pref_step, aln_step and clu_step
    (tests/golden/clusterwf) and at --min-seq-id 0.9 (clu90); easy-cluster
    and easy-linclust (their three files); kmermatcher (kmermatcher/refkm*,
    every case of KMER_CASES) and linclust with three intermediates
    (reflc); createlinindex, kmersearch, linsearch with its two
    intermediates, easy-linsearch's prefilter and ungapped DBs (linsearch)
    and its m8 and result DB (the JAX package's digests in
    cluster_slice.json's easy_linsearch_fixture); convertca3m
    (ca3m/convout), result2msa (every case of RESULT2MSA_CASES) and
    result2repseq (utils); pickconsensusrep (util8/consrep) and
    clusterupdate (util8/newmapdb, newclu). tests/test_torch_cluster.py
    rehearses it on the CPU. Returns (the number of outputs compared,
    pickconsensusrep's prof_probe record)."""
    import shutil

    import torch
    from metaeuk_tpu_torch import native
    from metaeuk_tpu_torch.ops import sw_cuda
    if native.get_lib() is None:
        raise AssertionError("the native host library did not load: "
                             "backtraces would be empty")
    data, dev, n = ROOT / "tests" / "data", ["--device", str(device)], 0
    cw, km, ls = (GOLDEN / "clusterwf", GOLDEN / "kmermatcher",
                  GOLDEN / "linsearch")
    run_cli(cli, ["cluster", cw / "clusterwf_input.faa", td / "clu",
                  td / "clu_tmp", *dev])
    for f in CASCADE:
        same_db(td / "clu_tmp" / f, cw / f)
    same_db(td / "clu", cw / "clu")
    run_cli(cli, ["cluster", cw / "clusterwf_input.faa", td / "clu90",
                  td / "clu90_tmp", "--min-seq-id", "0.9", *dev])
    same_db(td / "clu90", cw / "clu90")
    n += len(CASCADE) + 2
    for tool, tag in (("easy-cluster", "easycluster"),
                      ("easy-linclust", "easylinclust")):
        run_cli(cli, [tool, cw / "clusterwf_input.faa", td / tag,
                      td / f"{tag}_tmp", *dev])
        for f in EASY_CLUSTER_FILES:
            same_bytes(f"{td / tag}{f}", cw / f"{tag}{f}")
        n += len(EASY_CLUSTER_FILES)
    for tag, (src, extra) in KMER_CASES.items():
        run_cli(cli, ["kmermatcher", src, td / tag, *extra])
        for s in ("", ".index"):
            same_bytes(f"{td / tag}{s}", f"{km / tag}{s}")
        n += 1
    run_cli(cli, ["linclust", km / "kmF", td / "reflc", td / "lc_tmp",
                  *dev])
    for s in ("", ".index"):
        same_bytes(f"{td / 'reflc'}{s}", f"{km / 'reflc'}{s}")
    for f in ("pref_rescore1", "pre_clust", "clust"):
        same_bytes(td / "lc_tmp" / f, km / f)
    n += 4

    for fasta, db in (("queries_lin.faa", "qdb"), ("proteins.faa", "tdb")):
        run_cli(cli, ["createdb", data / fasta, td / db])
    run_cli(cli, ["createlinindex", td / "tdb"])
    run_cli(cli, ["kmersearch", td / "qdb", f"{td / 'tdb'}.linidx.npz",
                  td / "kpref"])
    same_db(td / "kpref", ls / "pref")
    run_cli(cli, ["linsearch", td / "qdb", td / "tdb", td / "lout",
                  td / "ls_tmp", *dev])
    for f in ("reverse_ungapaln", "reverse_aln"):
        same_db(td / "ls_tmp" / f, ls / f)
    same_db(td / "lout", ls / "lout")
    run_cli(cli, ["easy-linsearch", data / "queries_lin.faa",
                  data / "proteins.faa", td / "els.m8", td / "els_tmp",
                  *dev])
    for f in ("pref", "reverse_ungapaln"):
        same_db(td / "els_tmp" / "search_tmp" / f, ls / f)
    # easy-linsearch aligns in mode 3 (linsearch in 2): its m8 and result
    # DB against the JAX package's (make_cluster_slice.py)
    want = json.loads((GOLDEN / "cluster_slice.json").read_text())[
        "sha256"]["easy_linsearch_fixture"]
    if sha256(td / "els.m8") != want["m8"] or \
            {s: sha256(f"{td / 'els_tmp' / 'result'}{s}")
             for s in DB_SUFFIXES} != want["result"]:
        raise AssertionError("easy-linsearch on the fixture differs from "
                             "cluster_slice.json")
    n += 8

    (td / "ca3m").mkdir()
    for f in (GOLDEN / "ca3m").iterdir():
        shutil.copyfile(f, td / "ca3m" / f.name)
    run_cli(cli, ["convertca3m", td / "ca3m" / "ca3mdb", td / "conv"])
    same_db(td / "conv", GOLDEN / "ca3m" / "convout")
    utils = GOLDEN / "utils"
    for tag, extra in RESULT2MSA_CASES.items():
        run_cli(cli, ["result2msa", td / "tdb", td / "tdb",
                      utils / "selfres", td / tag, *extra])
        # the Stockholm output is a flat file
        (same_bytes if tag == "msa_sto" else same_db)(td / tag, utils / tag)
    run_cli(cli, ["result2repseq", td / "tdb", utils / "selfres",
                  td / "repseq"])
    same_db(td / "repseq", utils / "repseq")
    n += len(RESULT2MSA_CASES) + 2

    u8 = GOLDEN / "util8"
    (td / "all.faa").write_bytes((data / "queries_lin.faa").read_bytes()
                                 + (data / "proteins.faa").read_bytes())
    run_cli(cli, ["createdb", td / "all.faa", td / "alldb"])
    copy_db(u8 / "clu", td / "u8clu")
    with prof_probe(torch, sw_cuda) as pcr:
        run_cli(cli, ["pickconsensusrep", td / "alldb", td / "u8clu",
                      td / "consrep", td / "pcr_tmp", *dev])
    same_db(td / "consrep", u8 / "consrep")
    copy_db(u8 / "oldclu", td / "oldclu")
    run_cli(cli, ["clusterupdate", td / "qdb", td / "alldb", td / "oldclu",
                  td / "newmapdb", td / "newclu", td / "cu_tmp", *dev])
    same_db(td / "newmapdb", u8 / "newmapdb")
    same_db(td / "newclu", u8 / "newclu")
    n += 3
    print(f"clustering and linear search on {device}: {n} outputs equal to "
          "the MMseqs2 goldens (cluster and its cascade, easy-cluster, "
          "easy-linclust, kmermatcher, linclust, the linsearch family, "
          "convertca3m, result2msa, result2repseq, pickconsensusrep, "
          "clusterupdate)", flush=True)
    return n, pcr


# phase 4i: the cases of the commands the port wires over modules it
# carries, on tests/golden's fixtures (tests/test_torch_dbcli.py runs each
# through the JAX CLI too): case -> dict(argv, goldens, and optionally copy,
# pre, device). In argv, {fx} is db_cli_fixture's directory, {out} the
# case's own and {G} tests/golden. "copy" DBs (every file of the prefix)
# are copied into {out} and the "pre" commands run through the same CLI
# first; the port gets --device where "device" is set. goldens: [(output
# under {out}, golden under {G})], "stdout" for the printed text.
def _goldens(out, golden, sufs=DB_SUFFIXES):
    return [(f"{out}{s}", f"{golden}{s}") for s in sufs]


RES = "{G}/utils/selfres"
# unpackdb's files of the six fixture proteins (tests/golden/util5/unpacked)
UNPACKED = [f"{k}.seq" for k in range(6)]
MULTIHITDB = ("", "_member_to_set", "_set_to_member", "_set_size",
              "_nucl_contig_to_set", "_nucl_set_to_contig",
              "_nucl_orf_to_contig")
DB_CLI_CASES = {
    "reverseseq": dict(argv=["reverseseq", "{fx}/tdb", "{out}/rev"],
                       goldens=_goldens("rev", "dbtools/refrev_seq",
                                        ("", ".index"))),
    "sortresult": dict(argv=["sortresult", "{G}/aln/search_a", "{out}/s"],
                       goldens=_goldens("s", "dbtools/refsorted",
                                        ("", ".index"))),
    "tsv2db": dict(argv=["tsv2db", "{G}/dbtools/input.tsv", "{out}/t"],
                   goldens=_goldens("t", "dbtools/reftsvdb")),
    "mergedbs": dict(argv=["mergedbs", "{G}/pref/pfQ", "{out}/m",
                           "{G}/pref/pfres_s4", "{G}/pref/pfres_s5.7",
                           "--prefixes", "A,B"],
                     goldens=_goldens("m", "dbtools/refmerged",
                                      ("", ".index"))),
    "createsubdb": dict(argv=["createsubdb", "{fx}/keys.txt", "{fx}/tdb",
                              "{out}/sub"],
                        goldens=_goldens("sub", "dbtools/refsubdb",
                                         ("", ".index"))),
    "extractframes": dict(argv=["extractframes", "{fx}/cdb", "{out}/ef"],
                          goldens=_goldens("ef", "dbtools/refef", (
                              "", ".index", "_h", "_h.index"))),
    "extractframes --translate": dict(
        argv=["extractframes", "{fx}/cdb", "{out}/eft", "--translate", "1"],
        goldens=_goldens("eft", "dbtools/refeft",
                         ("", ".index", "_h", "_h.index"))),
    "splitsequence": dict(argv=["splitsequence", "{fx}/cdb", "{out}/sp",
                                "--max-seq-len", "500"],
                          goldens=_goldens("sp", "dbtools/refsplit", (
                              "", ".index", "_h", "_h.index"))),
    "convert2fasta": dict(argv=["convert2fasta", "{fx}/tdb", "{out}/o.faa"],
                          goldens=[("o.faa", "dbtools/reffasta.faa")]),
    "swapdb": dict(argv=["swapdb", RES, "{out}/o"],
                   goldens=_goldens("o", "utils/swapdb_res")),
    "swapresults": dict(argv=["swapresults", "{fx}/tdb", "{fx}/tdb", RES,
                              "{out}/o"],
                        goldens=_goldens("o", "utils/swapres")),
    "prefixid": dict(argv=["prefixid", RES, "{out}/o"],
                     goldens=_goldens("o", "utils/prefid")),
    "suffixid": dict(argv=["suffixid", RES, "{out}/o", "--prefix", "XX"],
                     goldens=_goldens("o", "utils/sufid")),
    "subtractdbs": dict(argv=["subtractdbs", RES, RES, "{out}/o", "-e",
                              "1e-5"],
                        goldens=_goldens("o", "utils/sub_self")),
    "summarizeresult": dict(argv=["summarizeresult", RES, "{out}/o"],
                            goldens=_goldens("o", "utils/summ")),
    "result2flat": dict(argv=["result2flat", "{fx}/tdb", "{fx}/tdb", RES,
                              "{out}/o"],
                        goldens=[("o", "utils/flat")]),
    "createseqfiledb": dict(argv=["createseqfiledb", "{fx}/tdb", RES,
                                  "{out}/o"],
                            goldens=_goldens("o", "utils/seqfile")),
    "splitdb": dict(argv=["splitdb", RES, "{out}/o", "--split", "3"],
                    goldens=[g for i in range(3) for g in _goldens(
                        f"o_{i}_3", f"utils/spl_{i}_3")]),
    "orftocontig": dict(argv=["orftocontig", "{fx}/cdb", "{G}/utils/orfs",
                              "{out}/o"],
                        goldens=_goldens("o", "utils/orfaln")),
    "renamedbkeys": dict(argv=["renamedbkeys", "{G}/utils/rename.tsv",
                               "{fx}/tdb", "{out}/o"],
                         goldens=_goldens("o", "utils/renamed") + _goldens(
                             "o_h", "utils/renamed_h", ("", ".index"))),
    "concatdbs": dict(argv=["concatdbs", "{fx}/tdb", "{fx}/tdb", "{out}/o"],
                      goldens=_goldens("o", "utils/concat")),
    "rmdb": dict(copy=[("{fx}/tdb", "x")], argv=["rmdb", "{out}/x"],
                 goldens=[]),
    "mvdb": dict(copy=[("{fx}/tdb", "x")], argv=["mvdb", "{out}/x",
                                                 "{out}/m"], goldens=[]),
    "cpdb": dict(argv=["cpdb", "{fx}/tdb", "{out}/c"], goldens=[]),
    "lndb": dict(copy=[("{fx}/tdb", "x")], argv=["lndb", "{out}/x",
                                                 "{out}/l"], goldens=[]),
    "touchdb": dict(copy=[("{fx}/tdb", "x")], argv=["touchdb", "{out}/x"],
                    goldens=[]),
    "extractalignedregion": dict(
        argv=["extractalignedregion", "{fx}/qdb", "{fx}/tdb", "{fx}/aln",
              "{out}/extq", "--extract-mode", "1"],
        goldens=_goldens("extq", "util5/extq")),
    "extractalignedregion --extract-mode 2": dict(
        argv=["extractalignedregion", "{fx}/qdb", "{fx}/tdb", "{fx}/aln",
              "{out}/extt"],
        goldens=_goldens("extt", "util5/extt")),
    "summarizeheaders": dict(
        copy=[("{G}/util5/hdrdb", "hdrdb"), ("{G}/util5/clu2", "clu2")],
        argv=["summarizeheaders", "{out}/hdrdb", "{out}/hdrdb", "{out}/clu2",
              "{out}/sum"],
        goldens=_goldens("sum", "util5/sumhdr")),
    "summarizeheaders --header-type 2": dict(
        copy=[("{G}/util5/hdrdb", "hdrdb"), ("{G}/util5/clu2", "clu2")],
        argv=["summarizeheaders", "{out}/hdrdb", "{out}/hdrdb", "{out}/clu2",
              "{out}/summc", "--header-type", "2"],
        goldens=_goldens("summc", "util5/sumhdr_mc")),
    "clusthash": dict(argv=["clusthash", "{fx}/alldb", "{out}/chash"],
                      goldens=_goldens("chash", "util5/chash")),
    "clusthash --min-seq-id 0.9": dict(
        argv=["clusthash", "{fx}/alldb", "{out}/chash90", "--min-seq-id",
              "0.9"],
        goldens=_goldens("chash90", "util5/chash90")),
    "mergeresultsbyset": dict(argv=["mergeresultsbyset", "{fx}/sets",
                                    "{fx}/aln", "{out}/mrbs"],
                              goldens=_goldens("mrbs", "util5/mrbs")),
    "makepaddedseqdb": dict(
        argv=["makepaddedseqdb", "{fx}/tdb", "{out}/padded"],
        goldens=_goldens("padded", "util5/padded", (
            "", ".index", ".dbtype", "_h", "_h.index", "_h.dbtype"))),
    "unpackdb": dict(argv=["unpackdb", "{fx}/tdb", "{out}/unpacked",
                           "--unpack-name-mode", "0", "--unpack-suffix",
                           ".seq"],
                     goldens=[(f"unpacked/{n}", f"util5/unpacked/{n}")
                              for n in UNPACKED]),
    "countkmer": dict(argv=["countkmer", "{fx}/tdb", "-k", "2"],
                      goldens=[("stdout", "util5/countkmer_k2.tsv")]),
    "recoverlongestorf": dict(
        copy=[("{G}/util5/orfres", "orfres")],
        argv=["recoverlongestorf", "{fx}/orfs10", "{out}/orfres",
              "{out}/lo"],
        goldens=[("lo", "util5/longestorf")]),
    "tar2db": dict(argv=["tar2db", "{G}/util5/src.tar", "{out}/tardb"],
                   goldens=_goldens("tardb", "util5/tardb", (
                       *DB_SUFFIXES, ".lookup", ".source"))),
    "db2tar": dict(argv=["db2tar", "{G}/util5/tardb", "{out}/rt.tar"],
                   goldens=[]),
    "besthitperset": dict(
        argv=["besthitperset", "{G}/multihit/mh_qsize", "{G}/multihit/mh_tmap",
              "{G}/multihit/mh_res", "{out}/bh"],
        goldens=[("bh", "multihit/refbh"),
                 ("bh.index", "multihit/refbh.index")]),
    "besthitperset --simple-best-hit 0": dict(
        argv=["besthitperset", "{G}/multihit/mh_qsize", "{G}/multihit/mh_tmap",
              "{G}/multihit/mh_res", "{out}/bhns", "--simple-best-hit", "0"],
        goldens=[("bhns", "multihit/refbh_ns"),
                 ("bhns.index", "multihit/refbh_ns.index")]),
    **{f"combinepvalperset --aggregation-mode {m}": dict(
        argv=["combinepvalperset", "{G}/multihit/mh_qsize",
              "{G}/multihit/mh_tmap", "{G}/multihit/mh_logp", f"{{out}}/cp{m}",
              "--aggregation-mode", str(m)],
        goldens=[(f"cp{m}", f"multihit/refcp_m{m}"),
                 (f"cp{m}.index", f"multihit/refcp_m{m}.index")])
       for m in range(4)},
    "filterdb --extract-lines": dict(
        argv=["filterdb", RES, "{out}/o", "--extract-lines", "2"],
        goldens=_goldens("o", "utils/f_lines")),
    "filterdb --comparison-operator ge": dict(
        argv=["filterdb", RES, "{out}/o", "--filter-column", "2",
              "--comparison-operator", "ge", "--comparison-value", "100"],
        goldens=_goldens("o", "utils/f_ge")),
    "filterdb --mapping-file": dict(
        argv=["filterdb", RES, "{out}/o", "--mapping-file",
              "{G}/utils/f_map.tsv"],
        goldens=_goldens("o", "utils/f_map")),
    **{f"rescorediagonal {tag}": dict(
        argv=["rescorediagonal", "{G}/pref/pfQ", "{G}/pref/pfT",
              "{G}/pref/pfres_s4", "{out}/rd", *flags],
        goldens=_goldens("rd", f"pref/refrd_{tag}", ("", ".index")))
       for tag, flags in (("m0", []), ("m1", ["--rescore-mode", "1"]),
                          ("m2a", ["--rescore-mode", "2", "-a", "1"]))},
    "createindex": dict(copy=[("{G}/pref/pfT", "pfT")],
                        argv=["createindex", "{out}/pfT"], goldens=[]),
    "prefilter": dict(argv=["prefilter", "{G}/pref/pfQ", "{G}/pref/pfT",
                            "{out}/pf"],
                      goldens=_goldens("pf", "pref/pfres_s4",
                                       ("", ".index"))),
    "prefilter (persisted index)": dict(
        copy=[("{G}/pref/pfT", "pfT")],
        pre=[["createindex", "{out}/pfT"]],
        argv=["prefilter", "{G}/pref/pfQ", "{out}/pfT", "{out}/pfi"],
        goldens=_goldens("pfi", "pref/pfres_s4", ("", ".index"))),
    "indexdb": dict(argv=["indexdb", "{G}/pref/pfT", "{out}/pfT.kidx"],
                    goldens=[]),
    "kmerindexdb": dict(argv=["kmerindexdb", "{fx}/tdb", "{out}/lin"],
                        goldens=[]),
    "nrtotaxmapping": dict(
        copy=[("{G}/util8/nrdb_h", "nrdb_h")],
        pre=[["createbintaxonomy", "{G}/util8/taxdump8/names.dmp",
              "{G}/util8/taxdump8/nodes.dmp",
              "{G}/util8/taxdump8/merged.dmp", "{out}/nrdb_taxonomy"]],
        argv=["nrtotaxmapping", "{G}/util8/acc2taxid.tsv", "{out}/nrdb",
              "{out}/nrmap"],
        goldens=[("nrmap", "util8/nrmap")]),
    "filterresult": dict(argv=["filterresult", "{fx}/qdb", "{fx}/tdb",
                               "{fx}/aln", "{out}/fres"],
                         goldens=_goldens("fres", "util5/fres")),
    "filterresult --diff 1": dict(
        argv=["filterresult", "{fx}/qdb", "{fx}/tdb", "{fx}/aln",
              "{out}/fres2", "--diff", "1", "--max-seq-id", "0.95"],
        goldens=_goldens("fres2", "util5/fres2")),
    "multihitdb": dict(
        argv=["multihitdb", "{G}/util7/set0.fna", "{G}/util7/set1.fna",
              "{out}/mhdb", "{out}/mhtmp"],
        goldens=[g for f in MULTIHITDB
                 for g in _goldens(f"mhdb{f}", f"util7/mhdb{f}")]),
    "multihitsearch": dict(
        pre=[["multihitdb", "{G}/util7/set0.fna", "{G}/util7/set1.fna",
              "{out}/mhdb", "{out}/mhtmp"]],
        argv=["multihitsearch", "{out}/mhdb", "{out}/mhdb", "{out}/mhres",
              "{out}/mhstmp"], device=True,
        goldens=_goldens("mhstmp/result", "util7/mh_result")
        + _goldens("mhstmp/aggregate", "util7/mh_aggregate")
        + _goldens("mhres", "util7/mhres")),
    "version": dict(argv=["version"], goldens=[]),
}


# phase 4j: the cases of the 24 commands of dbtools4, dbtools7, dbtools8,
# pairaln, alignbykmer, fwbw, the exhaustive prefilters, databases,
# offsetalignment and proteinaln2nucl, and of search's nucleotide branch, in
# DB_CLI_CASES's form (util_cli_fixture's directory as {fx}). A golden may
# also be the expected bytes themselves; "text_varies" marks a command whose
# printed text depends on the machine (diskspaceavail prints the free bytes:
# a number is required, the JAX CLI's text is not compared).
SELFRES_DBTYPE_EXT = struct.pack("<I", 5 | (2 << 16))
PAIRALN = {"paired": [], "paired_dummy": ["--pairing-dummy-mode", "1"],
           "paired_cover": ["--pairing-mode", "1"],
           "paired_prox": ["--pairing-filter", "1"],
           "paired_prox_dummy": ["--pairing-filter", "1",
                                 "--pairing-dummy-mode", "1"]}
PAIRALN_INPUTS = [("{G}/util11/aln", "aln"), ("{G}/util11/alnnb", "alnnb"),
                  ("{G}/util11/tdb_h", "tdb_h"),
                  ("{G}/util11/qdb.lookup", "qdb.lookup"),
                  ("{G}/util11/tdb_mapping", "tdb_mapping")]
KB_COLUMNS = ("ID", "AC", "OS", "OX", "PE", "SEQ")
UTIL_CLI_CASES = {
    "translateaa": dict(argv=["translateaa", "{fx}/tdb", "{out}/nucl"],
                        goldens=_goldens("nucl", "util4/aa2nucl")),
    "dbtype": dict(argv=["dbtype", "{fx}/tdb"],
                   goldens=[("stdout", b"Aminoacid\n")]),
    "dbtype (alignment)": dict(argv=["dbtype", RES],
                               goldens=[("stdout", b"Alignment\n")]),
    "setextendeddbtype": dict(
        copy=[(RES, "x")],
        argv=["setextendeddbtype", "{out}/x", "--extended-dbtype", "2"],
        goldens=[("x.dbtype", SELFRES_DBTYPE_EXT)]),
    "view": dict(argv=["view", "{fx}/tdb", "--id-list", "1,3"], goldens=[]),
    "aliasdb": dict(copy=[("{fx}/tdb", "db")],
                    argv=["aliasdb", "{out}/db", "{out}/alias"], goldens=[]),
    "compress": dict(argv=["compress", RES, "{out}/c"],
                     goldens=_goldens("c", "util4/res_c",
                                      (".index", ".dbtype"))),
    "decompress": dict(argv=["decompress", "{G}/util4/res_c", "{out}/d"],
                       goldens=_goldens("d", "utils/selfres")),
    "diskspaceavail": dict(argv=["diskspaceavail", "{out}"], goldens=[],
                           text_varies=True),
    "tsv2exprofiledb": dict(
        copy=[(f"{{G}}/util9/{f}", f) for f in (
            "ex.tsv", "ex_h.tsv", "ex_seq.tsv", "ex_aln.tsv")],
        argv=["tsv2exprofiledb", "{out}/ex", "{out}/exdb"],
        goldens=[(f"{f}.dbtype", f"util9/{f}.dbtype")
                 for f in ("exdb", "exdb_seq", "exdb_aln")]
        + _goldens("exdb_seq_h", "util9/exdb_seq_h")),
    "createclusearchdb": dict(
        copy=[("{G}/util9/clu", "clu")],
        argv=["createclusearchdb", "{fx}/alldb", "{out}/clu",
              "{out}/cludb"],
        goldens=_goldens("cludb", "util9/cludb")
        + _goldens("cludb_clu", "util9/cludb_clu")
        + [(f, f"util9/{f}") for f in (
            "cludb_seq.1", "cludb_seq.index", "cludb_seq.dbtype",
            "cludb_seq_h.1", "cludb_seq_h.index")]),
    "transitivealign": dict(
        copy=[("{G}/util9/selfaln_all", "selfaln_all")],
        argv=["transitivealign", "{fx}/alldb", "{out}/selfaln_all",
              "{out}/transaln"],
        goldens=_goldens("transaln", "util9/transaln")),
    "msa2result": dict(
        pre=[["convertmsa", "{G}/util6/test.sto", "{out}/msadb"]],
        argv=["msa2result", "{out}/msadb", "{out}/m2r_seq",
              "{out}/m2r_prof"],
        goldens=_goldens("m2r_seq", "util9/m2r_seq", (
            *DB_SUFFIXES, "_h", "_h.index", "_h.dbtype"))
        + _goldens("m2r_prof", "util9/m2r_prof")),
    "convertkb": dict(
        argv=["convertkb", "{G}/util10/test.dat", "{out}/kb",
              "--kb-columns", ",".join(KB_COLUMNS)],
        goldens=[g for c in KB_COLUMNS
                 for g in _goldens(f"kb_{c}", f"util10/kb_{c}")]
        + [("kb.lookup", "util10/kb.lookup")]),
    "extractdomains": dict(
        copy=[("{G}/util6/m8db", "m8db")],
        pre=[["summarizetabs", "{out}/m8db", "{G}/util6/lengths.tsv",
              "{out}/sumtabs"]],
        argv=["extractdomains", "{out}/sumtabs", "{G}/util10/msa",
              "{out}/domains"],
        goldens=_goldens("domains", "util10/domains")),
    "calculatelambda": dict(
        argv=["calculatelambda", "{fx}/vtml80_body.out"],
        goldens=[("stdout", "util9/lambda_vtml80.txt")]),
    "appenddbtoindex": dict(
        argv=["appenddbtoindex", "{fx}/extra", "{out}/idx", "--id-list",
              "5"], goldens=[]),
    **{f"pairaln {name}": dict(
        copy=PAIRALN_INPUTS,
        argv=["pairaln", "{out}/qdb", "{out}/tdb", "{out}/aln",
              f"{{out}}/{name}", *flags],
        goldens=_goldens(name, f"util11/{name}"))
       for name, flags in PAIRALN.items()},
    "pairaln (no backtrace)": dict(
        copy=PAIRALN_INPUTS,
        argv=["pairaln", "{out}/qdb", "{out}/tdb", "{out}/alnnb",
              "{out}/paired_nb"],
        goldens=_goldens("paired_nb", "util11/paired_nb")),
    "fwbw": dict(copy=[("{G}/util11/aln", "aln")],
                 argv=["fwbw", "{fx}/fwqdb", "{fx}/tdb", "{out}/aln",
                       "{out}/fwbwout"],
                 goldens=_goldens("fwbwout", "util11/fwbwout")),
    "alignbykmer": dict(argv=["alignbykmer", "{fx}/qdb", "{fx}/tdb",
                              "{fx}/pref", "{out}/abk"],
                        goldens=_goldens("abk", "util10/abk")),
    "ungappedprefilter": dict(
        argv=["ungappedprefilter", "{fx}/qdb", "{fx}/tdb", "{out}/upref"],
        goldens=_goldens("upref", "util5/upref")),
    "gappedprefilter": dict(
        argv=["gappedprefilter", "{fx}/qdb", "{fx}/tdb", "{out}/gpref"],
        goldens=_goldens("gpref", "util5/gpref")),
    "databases --tsv 1": dict(argv=["databases", "--tsv", "1"],
                              goldens=[("stdout", "databases.tsv")]),
    "databases PDB --local-file": dict(
        argv=["databases", "PDB", "{out}/db", "{out}/tmp", "--local-file",
              "{fx}/proteins.faa"], goldens=[]),
    "databases Pfam-A.seed --local-file": dict(
        argv=["databases", "Pfam-A.seed", "{out}/prof", "{out}/t",
              "--local-file", "{G}/dbcatalog/mini.msa.gz"],
        goldens=_goldens("prof", "dbcatalog/refprof")),
    "databases PDB70 --local-file": dict(
        argv=["databases", "PDB70", "{out}/prof", "{out}/t",
              "--local-file", "{fx}/pdb70_fixture.tar.gz"],
        goldens=_goldens("prof", "databases/pdb70_prof")),
    "databases CDD --local-file": dict(
        argv=["databases", "CDD", "{out}/prof", "{out}/t", "--local-file",
              "{fx}/cdd_fixture.tar.gz"],
        goldens=_goldens("prof", "databases/cdd_prof")
        + [("t/msa.lookup", "databases/cdd_msa.lookup")]),
    "offsetalignment": dict(
        argv=["offsetalignment", "{fx}/cdb", "{G}/utils/orfs", "{fx}/tdb",
              "{fx}/tdb", "{G}/utils/orfaa_aln", "{out}/o"],
        goldens=_goldens("o", "utils/offaln")),
    "offsetalignment --search-type 3": dict(
        argv=["offsetalignment", "{fx}/cdb", "{G}/utils/nucl_qs",
              "{fx}/cdb", "{G}/utils/nucl_ts", "{G}/utils/nucl_aln",
              "{out}/o", "--search-type", "3"],
        goldens=_goldens("o", "utils/nucl_offaln")),
    "proteinaln2nucl": dict(
        pre=[["translatenucs", "{G}/utils/orfs", "{out}/orfsaa"]],
        argv=["proteinaln2nucl", "{G}/utils/orfs", "{G}/utils/orfs",
              "{out}/orfsaa", "{out}/orfsaa", "{G}/utils/orfself_aln",
              "{out}/o"],
        goldens=_goldens("o", "utils/p2n")),
    "search --search-type 3": dict(
        argv=["search", "{fx}/cdb", "{fx}/cdb", "{out}/o", "{out}/tmp",
              "--search-type", "3", "--max-seq-len", "700", "-a"],
        device=True, goldens=_goldens("o", "utils/nucl_search_out")),
}


def db_cli_fixture(cli, device, fx):
    """The inputs of DB_CLI_CASES under fx, made by the port on `device`:
    createdb of tests/data's queries_lin.faa (qdb), proteins.faa (tdb),
    contigs.fna (cdb) and of the first two together (alldb); cdb's ORFs of
    10 codons or more (orfs10); qdb against tdb prefiltered at -s 4 and
    aligned with backtraces (aln, tests/test_util5.py's); keys.txt (3 1 5)
    and a two-set DB over aln's queries (sets)."""
    from metaeuk_tpu_torch.io import mmseqsdb
    from metaeuk_tpu_torch.search.align_module import align_db
    from metaeuk_tpu_torch.search.searchdb import prefilter_db
    data = ROOT / "tests" / "data"
    fx.mkdir(parents=True, exist_ok=True)
    (fx / "all.faa").write_bytes((data / "queries_lin.faa").read_bytes()
                                 + (data / "proteins.faa").read_bytes())
    for fasta, db in ((data / "queries_lin.faa", "qdb"),
                      (data / "proteins.faa", "tdb"),
                      (data / "contigs.fna", "cdb"), (fx / "all.faa",
                                                      "alldb")):
        run_cli(cli, ["createdb", fasta, fx / db])
    run_cli(cli, ["extractorfs", fx / "cdb", fx / "orfs10", "--min-length",
                  "10"])
    prefilter_db(str(fx / "qdb"), str(fx / "tdb"), str(fx / "pref"),
                 sensitivity=4.0)
    align_db(str(fx / "qdb"), str(fx / "tdb"), str(fx / "pref"),
             str(fx / "aln"), evalue=1e-3, add_backtrace=True, device=device)
    (fx / "keys.txt").write_text("3 1 5\n")
    mmseqsdb.write_db(str(fx / "sets"), [(100, b"0\n2\n"), (101, b"1\n")],
                      5)
    return fx


def util_cli_fixture(cli, device, fx):
    """The inputs of UTIL_CLI_CASES under fx: db_cli_fixture's, and the
    JAX tests' own: queries_lin.faa's first 10 proteins and the rest as two
    source files of one DB (fwqdb, tests/test_util11.py's fwbw query), a
    one-entry DB (extra), the comment-stripped VTML80 body of
    util9/lambda_vtml80.txt (tests/test_util10.py) and tests/data's
    proteins.faa and two databases archives."""
    import shutil
    from metaeuk_tpu_torch.io import mmseqsdb
    data = ROOT / "tests" / "data"
    db_cli_fixture(cli, device, fx)
    qlin = (data / "queries_lin.faa").read_bytes().split(b"\n")
    (fx / "q1.faa").write_bytes(b"\n".join(qlin[:20]) + b"\n")
    (fx / "q2.faa").write_bytes(b"\n".join(qlin[20:]))
    run_cli(cli, ["createdb", fx / "q1.faa", fx / "q2.faa", fx / "fwqdb"])
    mmseqsdb.write_db(str(fx / "extra"), [(0, b"payload\n")],
                      mmseqsdb.DBTYPE_GENERIC)
    golden = (GOLDEN / "util9" / "lambda_vtml80.txt").read_text()
    (fx / "vtml80_body.out").write_text("\n".join(
        ln for ln in golden.splitlines() if not ln.startswith("#")) + "\n")
    for f in ("proteins.faa", "pdb70_fixture.tar.gz", "cdd_fixture.tar.gz"):
        shutil.copyfile(data / f, fx / f)
    return fx


def run_db_cli_case(main, case, fx, out, device=None):
    """Runs one case of DB_CLI_CASES or UTIL_CLI_CASES through `main` (a
    CLI's entry point) under out, with --device `device` where the case has
    it; returns (exit code, printed text; what the command wrote to the
    binary stdout, as view does, included)."""
    import io
    import shutil

    def fmt(a):
        return a.format(fx=fx, out=out, G=GOLDEN)
    out.mkdir(parents=True, exist_ok=True)
    for src, dst in case.get("copy", ()):
        src = pathlib.Path(fmt(src))
        for f in src.parent.iterdir():
            if f.name == src.name or f.name.startswith(
                    (f"{src.name}.", f"{src.name}_h")):
                shutil.copyfile(f, out / (dst + f.name[len(src.name):]))
    for argv in case.get("pre", ()):
        with contextlib.redirect_stdout(io.StringIO()):
            if main([fmt(a) for a in argv]) != 0:
                raise AssertionError(f"{argv[0]} failed")
    argv = [fmt(a) for a in case["argv"]]
    if case.get("device") and device is not None:
        argv += ["--device", str(device)]
    raw = io.BytesIO()
    text = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(text):
        rc = main(argv)
    return rc, raw.getvalue().decode("utf-8")


def check_golden(name, case, text, out):
    """Compares a case's outputs under out (and its printed text) with its
    goldens: a path under tests/golden, or the expected bytes; returns how
    many were compared."""
    for mine, golden in case["goldens"]:
        want = golden if isinstance(golden, bytes) else \
            (GOLDEN / golden).read_bytes()
        got = text.encode() if mine == "stdout" else \
            (out / mine).read_bytes()
        if got != want:
            raise AssertionError(f"{name}: {mine} differs from its golden")
    if case.get("text_varies") and not text.strip().isdigit():
        raise AssertionError(f"{name} printed {text!r}, not a number")
    return len(case["goldens"])


def check_db_cli(cli, device, td, probe=contextlib.nullcontext,
                 cases=None, fixture=db_cli_fixture):
    """Phase 4i's first part (and 4j's, with cases=UTIL_CLI_CASES and
    fixture=util_cli_fixture): every case of DB_CLI_CASES through the
    port's CLI on `device` (multihitsearch's alignment), each output equal
    to its golden; `version` prints the port's line. probe() brackets the
    cases that take --device. Returns (the outputs compared, what probe
    yielded)."""
    cases = DB_CLI_CASES if cases is None else cases
    fx = fixture(cli, device, td / "fx")
    n, rec = 0, None
    for name, case in cases.items():
        out = td / name.replace(" ", "_")
        aligns = case.get("device", False)
        with probe() if aligns else contextlib.nullcontext() as got:
            rc, text = run_db_cli_case(cli.main, case, fx, out, device)
        if aligns:
            rec = got
        if rc != 0:
            raise AssertionError(f"{name}: exit {rc}")
        if name == "version" and text != cli.VERSION + "\n":
            raise AssertionError(f"version printed {text!r}")
        n += check_golden(name, case, text, out)
    commands = {c["argv"][0] for c in cases.values()}
    print(f"{len(cases)} cases of {len(commands)} commands on "
          f"{device}: {n} outputs equal to their goldens", flush=True)
    return n, rec


# chunks of _simulate a fit also aligns through the plain versions on the
# card (sw_torch called directly, outside the wrappers and their counts)
GUMBEL_PLAIN_CHUNKS = 2
# The 12 parameters are float64 regressions and island counts over
# _simulate's integer arrays, in numpy. numpy's float sums are not
# bit-reproducible across hosts (its build and the CPU's vector units set
# their order), so on another host a parameter may differ from the
# golden's in its last bits while the arrays, the islands and the outputs
# are bit-equal: each parameter is held to the golden's within this
# relative tolerance, and its distance printed in units in the last place
# (on the golden's own host tests/test_torch_gumbel.py holds them equal).
GUMBEL_PARAM_RTOL = 1e-12


def gumbel_fit(np, torch, cli, system, kw, device, td, plain_chunks=0):
    """One runtime Gumbel fit of the port on `device`, by the path
    tests/golden/make_gumbel_slice.py's golden took: fitted_params for the
    two gapped protein systems, proteinaln2nucl at 4/2 on
    tests/test_offsetaln.py's fixture for the nucleotide one,
    EvalueComputation.for_scoring(..., gapped=False) for the ungapped one;
    fit_gapped's keywords kw, the fit cache a fresh file under td. The
    first plain_chunks chunks of _simulate are aligned by the plain versions
    on the same card too (sw_torch, outside the wrappers and their counts)
    and compared with torch.equal. Returns the fit's record: the golden's
    fields (params as repr, simulate_sha256, islands, proteinaln2nucl's
    digests), seconds (fit, simulate and its sampling and alignment,
    islands and their sampling), forward and reverse cells, sw_cuda's
    launches and plain calls over the fit (reset before it), the kernels'
    CUDA events on a card and the chunks compared with the plain versions."""
    import make_gumbel_slice as mgs
    from metaeuk_tpu_torch.data import submat, vtml80
    from metaeuk_tpu_torch.ops import sw_cuda, sw_torch
    from metaeuk_tpu_torch.pipeline.offsetaln import proteinaln2nucl
    from metaeuk_tpu_torch.search import evalue, gumbel
    scores, pback, go, ge = mgs.scoring_system(system, submat, vtml80)
    saved = gumbel._FIT_CACHE_PATH, gumbel._mem_cache
    gumbel._FIT_CACHE_PATH = str(td / f"{system}_gumbel_cache.json")
    gumbel._mem_cache = {}
    rec = dict(seconds=dict.fromkeys((
        "fit", "simulate", "simulate_sampling", "simulate_align", "islands",
        "islands_sampling"), 0.0), cells={"fwd": 0, "rev": 0},
        plain_chunks=0)
    orig = {n: getattr(gumbel, n) for n in (
        "fit_gapped", "_simulate", "_simulate_islands", "_sample_codes")}
    align = sw_cuda.sw_align_batch
    where = ["simulate"]

    def timed(name, key, keep=None):
        def run(*a, **k):
            prev, where[0] = where[0], key
            t0 = time.perf_counter()
            try:
                out = orig[name](*a, **(dict(k, **kw) if key == "fit"
                                         else k))
            finally:
                rec["seconds"][key] += time.perf_counter() - t0
                where[0] = prev
            if keep:
                keep(out)
            return out
        return run

    def sample(*a, **k):
        t0 = time.perf_counter()
        out = orig["_sample_codes"](*a, **k)
        rec["seconds"][f"{where[0]}_sampling"] += time.perf_counter() - t0
        return out

    def aligned(q, qb, ql, t, tl, **k):
        t0 = time.perf_counter()
        out = align(q, qb, ql, t, tl, **k)
        rec["seconds"]["simulate_align"] += time.perf_counter() - t0
        qe, te = (np.maximum(o.astype(np.int64), 0) for o in out[2::2])
        rec["cells"]["fwd"] += int((ql.astype(np.int64) * tl).sum())
        rec["cells"]["rev"] += int(((qe + 1) * (te + 1)).sum())
        if rec["plain_chunks"] < plain_chunks:
            dev = torch.device(k["device"])
            put = lambda a, dt: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a)).to(device=dev, dtype=dt)
            sub = np.ascontiguousarray(k["submat"], np.int32)
            plain = sw_torch.align_full(
                put(q, torch.uint8), put(qb, torch.int8),
                put(ql, torch.int32), put(t, torch.uint8),
                put(tl, torch.int32), scoring=sw_cuda._batch_scoring(
                    sub.tobytes(), sub.shape[0], int(k["go"]), int(k["ge"]),
                    dev), cap=None)
            if not all(torch.equal(put(o, torch.int32), p)
                       for o, p in zip(out, plain)):
                raise AssertionError(f"{system}: chunk {rec['plain_chunks']}"
                                     " of _simulate differs from the plain "
                                     "versions")
            rec["plain_chunks"] += 1
        return out

    def keep_sim(out):
        rec["simulate_sha256"] = mgs.simulate_sha256(*out)

    def keep_isl(out):
        rec["islands"] = int(len(out))
    gumbel.fit_gapped = timed("fit_gapped", "fit")
    gumbel._simulate = timed("_simulate", "simulate", keep_sim)
    gumbel._simulate_islands = timed("_simulate_islands", "islands",
                                     keep_isl)
    gumbel._sample_codes = sample
    sw_cuda.sw_align_batch = aligned
    sw_cuda.reset_counts()
    on_card = torch.device(device).type == "cuda"
    events = contextlib.nullcontext({}) if not on_card else \
        launch_events(torch, sw_cuda)
    try:
        with events as ev:
            if system == "nucl_4_2":
                u = GOLDEN / "utils"
                run_cli(cli, ["translatenucs", u / "orfs", td / "orfsaa"])
                proteinaln2nucl(str(u / "orfs"), str(u / "orfs"),
                                str(td / "orfsaa"), str(td / "orfsaa"),
                                str(u / "orfself_aln"), str(td / "p2n"),
                                *mgs.P2N_GAPS, device=device)
                params = next(iter(gumbel._mem_cache.values()))
                rec["proteinaln2nucl"] = mgs.db_sha256(td / "p2n")
            elif system == "vtml80_ungapped":
                params = evalue.EvalueComputation.for_scoring(
                    1, scores, pback, 10, 1, gapped=False, device=device).p
            else:
                params = gumbel.fitted_params(scores, pback, go, ge,
                                              device=device)
            if on_card:
                torch.cuda.synchronize()
    finally:
        for n, fn in orig.items():
            setattr(gumbel, n, fn)
        sw_cuda.sw_align_batch = align
        gumbel._FIT_CACHE_PATH, gumbel._mem_cache = saved
    rec["params"] = {k: repr(params[k]) for k in mgs.PARAM_KEYS}
    rec["launches"] = dict(sw_cuda.LAUNCHES)
    rec["plain"] = dict(sw_cuda.PLAIN_CALLS)
    rec["events"] = ev
    return rec


def report_gumbel_fit(system, rec, kw):
    """Prints a fit's seconds split into sampling, _simulate's alignment,
    islands and regression, its cells, and each SW kernel's launches and
    CUDA-event ms beside its bound (operations)."""
    sec = rec["seconds"]
    regression = sec["fit"] - sec["simulate"] - sec["islands"]
    rest = sec["simulate"] - sec["simulate_sampling"] - sec["simulate_align"]
    print(f"5k {system} ({kw['n_pairs']} pairs of {kw['length']}): fit "
          f"{sec['fit']:.3f} s = sampling {sec['simulate_sampling']:.3f} s + "
          f"_simulate's alignment {sec['simulate_align']:.3f} s (rest of "
          f"_simulate {rest:.3f} s) + "
          f"islands {sec['islands']:.3f} s (their sampling "
          f"{sec['islands_sampling']:.3f} s) + regression and the rest "
          f"{regression:.3f} s; {rec['islands']} islands; cells "
          f"{json.dumps(rec['cells'])}", flush=True)
    for k, (n, ms) in event_ms(rec["events"]).items():
        cells = rec["cells"]["fwd" if "ends" in k else "rev"]
        ops = NOCAP_SW_OPS if k.endswith("_nocap") else SW_OPS
        bound_ms = cells * ops / INT32_OPS_PER_S * 1e3
        print(f"5k {system}: {k} {n} launches, {ms:.3f} ms of kernel time "
              f"(CUDA events around each launch), {cells} cells, bound "
              f"{bound_ms:.3f} ms (operations; {bound_ms / ms:.1%} of it)",
              flush=True)


def check_gumbel_slice(np, torch, cli, td, device, golden, kw,
                       plain_chunks=0):
    """Phase 5k: the fit of each system of golden (make_gumbel_slice's
    entries, {system: entry}) at fit_gapped's keywords kw on `device`, each
    equal to its entry (_simulate's sha256, the island count and
    proteinaln2nucl's output bit for bit, the 12 parameters within
    GUMBEL_PARAM_RTOL); on a card K1/K2
    launched and no plain version called, and the first plain_chunks
    chunks equal to the plain versions on the card. Returns {system:
    record}."""
    records = {}
    for system, want in golden.items():
        rec = records[system] = gumbel_fit(np, torch, cli, system, kw,
                                           device, td, plain_chunks)
        report_gumbel_fit(system, rec, kw)
        for key in ("simulate_sha256", "islands", "proteinaln2nucl"):
            if rec.get(key) != want.get(key):
                raise AssertionError(f"5k {system}: {key} {rec.get(key)} "
                                     f"differs from the golden's "
                                     f"{want.get(key)}")
        got, ref = ({k: float(v) for k, v in p.items()}
                    for p in (rec["params"], want["params"]))
        ulps = {k: round(abs(got[k] - ref[k]) / np.spacing(abs(ref[k])))
                for k in ref}
        print(f"5k {system}: each parameter's distance from the golden's, "
              f"in ulps: {json.dumps(ulps)}", flush=True)
        if got.keys() != ref.keys() or any(
                abs(got[k] - ref[k]) > GUMBEL_PARAM_RTOL * abs(ref[k])
                for k in ref):
            raise AssertionError(f"5k {system}: params {rec['params']} "
                                 f"differ from the golden's {want['params']}")
        kernels = [k for k in (*PAIR_KERNELS, *NOCAP_KERNELS)
                   if rec["launches"][k]]
        if torch.device(device).type == "cuda" and (
                not kernels or any(rec["plain"].values())
                or rec["plain_chunks"] != plain_chunks):
            raise AssertionError(f"5k {system}: launches {rec['launches']}, "
                                 f"plain calls {rec['plain']}, "
                                 f"{rec['plain_chunks']} chunks checked")
        p2n = " and proteinaln2nucl" if "proteinaln2nucl" in want else ""
        print(f"5k {system}: _simulate's arrays and the islands{p2n} equal "
              f"the golden's, the 12 parameters within {GUMBEL_PARAM_RTOL} "
              f"of them; kernels {kernels}, "
              f"{rec['plain_chunks']} chunks equal to the plain versions",
              flush=True)
    return records


def wait_for_socket(proc, sock, log, timeout=300.0):
    """Seconds until a server process's socket exists; raises if the
    process exits first (with its log) or the time runs out."""
    t0 = time.perf_counter()
    while not os.path.exists(sock):
        if proc.poll() is not None:
            raise AssertionError(f"the server exited with {proc.returncode} "
                                 "before it listened:\n"
                                 + pathlib.Path(log).read_text()[-3000:])
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"no socket {sock} after {timeout} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


@contextlib.contextmanager
def server_process(argv, sock, log):
    """Starts a server process (argv) with its output to log; yields (the
    process, seconds until its socket existed); at exit kills it if it
    still runs."""
    with open(log, "w") as f:
        proc = subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT,
                                cwd=ROOT)
    try:
        yield proc, wait_for_socket(proc, sock, log)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def stop_server(proc, sock, request):
    """Sends shutdown through request(op) and checks that the process exits
    0 and removes its socket."""
    request("shutdown")
    rc = proc.wait(timeout=120)
    if rc != 0 or os.path.exists(sock):
        raise AssertionError(f"the server exited with {rc}, socket left: "
                             f"{os.path.exists(sock)}")


def check_server_fixture(cli, device, td):
    """Phase 4i's second part: `python -m metaeuk_tpu_torch.cli gpuserver`
    (--warmup 1, on `device`) over tests/data/proteins.faa in a process of
    its own; serverclient (the port's CLI) ping, prefilter and search -a 1,
    their DBs byte-equal to the direct prefilter_db and search_db; the same
    search through client_request; an unknown op refused; shutdown: exit 0,
    the socket gone. Returns the server's startup seconds."""
    import io
    from metaeuk_tpu_torch.search import searchdb
    from metaeuk_tpu_torch.server import client_request
    data = ROOT / "tests" / "data"
    td.mkdir(parents=True, exist_ok=True)
    q, t, sock = td / "qdb", td / "tdb", str(td / "srv.sock")
    run_cli(cli, ["createdb", data / "queries_lin.faa", q])
    run_cli(cli, ["createdb", data / "proteins.faa", t])
    searchdb.prefilter_db(str(q), str(t), str(td / "dir_pref"))
    searchdb.search_db(str(q), str(t), str(td / "dir_aln"),
                       str(td / "dir_tmp"), evalue=1e-3, add_backtrace=True,
                       device=device)

    def client(*argv):
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["serverclient", sock, *map(str, argv)])
        if rc != 0:
            raise AssertionError(f"serverclient {argv[0]} failed")
    with server_process(
            [sys.executable, "-m", "metaeuk_tpu_torch.cli", "gpuserver",
             str(t), "--socket", sock, "--warmup", "1", "--device",
             str(device)], sock, td / "server.log") as (proc, startup):
        client("ping")
        client("prefilter", q, td / "srv_pref")
        same_db(td / "srv_pref", td / "dir_pref")
        client("search", q, td / "srv_aln", td / "srv_tmp", "-a", "1")
        same_db(td / "srv_aln", td / "dir_aln")
        resp = client_request(sock, dict(
            op="search", query_db=str(q), out_db=str(td / "srv_aln2"),
            tmp=str(td / "srv_tmp2"), evalue=1e-3, add_backtrace=True))
        if not resp["ok"]:
            raise AssertionError(f"search through client_request: {resp}")
        same_db(td / "srv_aln2", td / "dir_aln")
        if client_request(sock, {"op": "nope"})["ok"]:
            raise AssertionError("the server took an unknown op")
        stop_server(proc, sock, client)
    print(f"gpuserver on {device}: started in {startup:.2f} s (--warmup 1); "
          "ping, prefilter and search -a 1 through serverclient and "
          "client_request byte-equal to the direct commands, an unknown op "
          "refused, shutdown with exit 0 and its socket gone", flush=True)
    return startup


@contextlib.contextmanager
def timed_steps(specs):
    """For this script's measurement only: every call of specs' functions
    (each wrapped), in the order the calls start, with its nesting depth,
    and the hit arrays of the SearchDriver.search calls among them; yields
    ([[stage, depth, seconds]], [hit arrays]), filled as the calls
    return."""
    steps, hits, depth, saved = [], [], [0], []
    for obj, name, stage in specs:
        fn = getattr(obj, name)

        def timed(*a, _fn=fn, _stage=stage, **kw):
            row = [_stage, depth[0], 0.0]
            steps.append(row)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                out = _fn(*a, **kw)
            finally:
                depth[0] -= 1
                row[2] = time.perf_counter() - t0
            if _stage == "SearchDriver.search":
                hits.append(out)
            return out
        saved.append((obj, name, fn))
        setattr(obj, name, timed)
    try:
        yield steps, hits
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


def stage_seconds(steps):
    """{stage: seconds} summed over timed_steps' record."""
    seconds = {}
    for stage, _, s in steps:
        seconds[stage] = seconds.get(stage, 0.0) + s
    return seconds


@contextlib.contextmanager
def timed_calls(specs):
    """Host seconds of the functions in specs, (module, name, stage) each,
    summed by stage over calls (timed_steps), for this script's measurement
    only; yields {stage: seconds}, filled at exit. Phase 5e times the search
    workflows' stages with it (searchdb.prefilter_db, align_module.align_db:
    the driver's search, backtraces, realign and the DB write,
    alnformat.write_blast_tab), 5f the DP-format round trip."""
    seconds = {}
    with timed_steps(specs) as (steps, _):
        yield seconds
    seconds.update(stage_seconds(steps))


@contextlib.contextmanager
def pair_routes(driver, sw_cuda):
    """Pairs and true-length DP cells by route, for this script's
    measurement only: SearchDriver's pair launches (K1/K2) and query-major
    tiles (K3/K4) in the forward pass and the reverse pass (from the gate's
    survivors' ends), and realign's batches (K1/K2's uncapped instances);
    yields {route: {pass: [pairs, cells]}}."""
    import numpy as np
    routes = {}

    def tally(route, pas, pairs, cells):
        got = routes.setdefault(route, {}).setdefault(pas, [0, 0])
        got[0] += int(pairs)
        got[1] += int(cells)

    def cells_of(ql, tl, ends):
        if ends is None:
            return (ql * tl).sum()
        qe, te = (np.maximum(e, 0).astype(np.int64) for e in ends)
        return ((np.minimum(qe, ql - 1) + 1) * (np.minimum(te, tl - 1) + 1)
                ).sum()

    def wrap(name, route):
        fn = getattr(driver.SearchDriver, name)

        def counted(self, ctx, rows, oi, ti, ends):
            ql = self._q_cache[2][oi[rows]].astype(np.int64)
            tl = self.target_lens[ti[rows]].astype(np.int64)
            tally(route, "fwd" if ends is None else "rev", len(rows),
                  cells_of(ql, tl, None if ends is None else
                           (ends[0][rows], ends[1][rows])))
            return fn(self, ctx, rows, oi, ti, ends)
        return fn, counted

    batch = sw_cuda.sw_align_batch

    def counted_batch(q, qb, ql, t, tl, **kw):
        out = batch(q, qb, ql, t, tl, **kw)
        ql, tl = np.asarray(ql, np.int64), np.asarray(tl, np.int64)
        tally("realign", "fwd", len(ql), cells_of(ql, tl, None))
        tally("realign", "rev", len(ql), cells_of(ql, tl, (out[2], out[4])))
        return out
    saved = {n: wrap(n, r) for n, r in (("_launch_chunks", "pair"),
                                        ("_qm_chunks", "query-major"))}
    for n, (_, counted) in saved.items():
        setattr(driver.SearchDriver, n, counted)
    sw_cuda.sw_align_batch = counted_batch
    try:
        yield routes
    finally:
        for n, (fn, _) in saved.items():
            setattr(driver.SearchDriver, n, fn)
        sw_cuda.sw_align_batch = batch


def run_search_slice(cfg, td, device, probe=contextlib.nullcontext):
    """Phase 5e's two runs on the search slice cfg (make_search_slice.py),
    written under td, on `device`: the port's easy_search at its defaults,
    then align_db over its pref_0 with add_backtrace=True, realign=True.
    probe() brackets each run (chip_smoke's: reset the counts, CUDA events
    around each launch, read the counts after). Returns ({"easy_search":
    ..., "align_realign": ...} with each run's wall, stage seconds, the
    driver's phase seconds and cells, its routes and what probe yielded;
    the digests, keyed as in tests/golden/search_slice.json)."""
    import make_search_slice as mss
    from metaeuk_tpu_torch.ops import sw_cuda
    from metaeuk_tpu_torch.pipeline import alnformat
    from metaeuk_tpu_torch.search import align_module, driver, searchdb
    q, t = mss.search_slice(cfg, td)
    es = td / "es"
    runs = {}
    for run in ("easy_search", "align_realign"):
        for k in driver.CELLS:
            driver.CELLS[k] = 0
        driver.PHASE_SECONDS.clear()
        with probe() as rec, \
                timed_calls(((searchdb, "prefilter_db", "prefilter"),
                             (align_module, "align_db", "align"),
                             (alnformat, "write_blast_tab",
                              "write_blast_tab"))) as st, \
                pair_routes(driver, sw_cuda) as routes:
            t0 = time.perf_counter()
            if run == "easy_search":
                searchdb.easy_search(str(q), str(t), str(td / "es.m8"),
                                     str(es), device=device)
            else:
                align_module.align_db(
                    str(es / "query"), str(es / "target"),
                    str(es / "search_tmp" / "pref_0"), str(td / "realign"),
                    add_backtrace=True, realign=True, device=device)
            wall = time.perf_counter() - t0
        runs[run] = dict(wall=wall, stages=st, routes=routes, probe=rec,
                         phases=dict(driver.PHASE_SECONDS),
                         cells=dict(driver.CELLS))
    return runs, {"easy_search": {"m8": sha256(td / "es.m8"), "result": {
        s: sha256(f"{es / 'result'}{s}") for s in DB_SUFFIXES}},
        "align_realign": {s: sha256(f"{td / 'realign'}{s}")
                          for s in DB_SUFFIXES}}


# the host stages of the iterative search that phase 5g times, by step:
# (module of the port, attribute, stage); a class's method is wrapped on the
# class
def iter_stage_specs():
    from metaeuk_tpu_torch.search import (driver, iterative, prefilter_kmer,
                                          profile_align)
    kp, pqa = prefilter_kmer.KmerPrefilter, profile_align.ProfileQueryAligner
    return ((kp, "match", "k-mer prefilter"),
            (driver.SearchDriver, "search", "align"),
            (driver.SearchDriver, "realign", "realign"),
            (iterative, "result2profile_db", "result2profile"),
            (kp, "match_profile", "profile prefilter"),
            (iterative, "subtractdbs", "subtractdbs"),
            (pqa, "search", "ProfileQueryAligner.search"),
            (pqa, "backtraces", "backtraces"),
            (iterative, "mergedbs", "mergedbs"),
            (iterative, "_write_pref", "write prefilter DB"),
            (iterative, "_pref_pairs", "read prefilter pairs"),
            (iterative, "_write_aln", "write alignment DB"))


@contextlib.contextmanager
def iter_stages(torch, sw_cuda):
    """For this script's measurement only: the host seconds of
    iter_stage_specs' stages and the profile steps' pairs and DP cells
    (K1/K2's uncapped PSSM instances, prof_cells), both by step, and the
    last
    ProfileQueryAligner.search call (its aligner, pairs, eval_thr and hits).
    A step ends when its result2profile returns (the last stage of every
    step but the last). Yields (seconds, cells, last): {"step N": {stage:
    s}}, {"step N": [pairs, fwd cells, rev cells]} and a dict."""
    from metaeuk_tpu_torch.search import profile_align
    seconds, cells, last, step, saved = {}, {}, {}, [0], []
    pqa = profile_align.ProfileQueryAligner
    search = pqa.search

    def keep_last(self, pairs, eval_thr=None):
        hits = search(self, pairs, eval_thr=eval_thr)
        last.update(aligner=self, pairs=pairs, eval_thr=eval_thr, hits=hits)
        return hits
    pqa.search = keep_last

    def tally(*got):
        per = cells.setdefault(f"step {step[0]}", [0, 0, 0])
        for i, v in enumerate(got):
            per[i] += v
    for obj, name, stage in iter_stage_specs():
        fn = getattr(obj, name)

        def timed(*a, _fn=fn, _stage=stage, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                per = seconds.setdefault(f"step {step[0]}", {})
                per[_stage] = per.get(_stage, 0.0) \
                    + time.perf_counter() - t0
                if _stage == "result2profile":
                    step[0] += 1
        saved.append((obj, name, fn))
        setattr(obj, name, timed)
    try:
        with prof_cells(torch, sw_cuda, tally):
            yield seconds, cells, last
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)
        pqa.search = search


def run_iter_slice(torch, cli, argv, probe=contextlib.nullcontext):
    """One iterative search (phase 5g): the port's CLI on argv (search
    --num-iterations ...), bracketed by probe() (chip_smoke's: reset the
    counts, CUDA events around each launch, read the counts after), its
    stages timed by step (iter_stages) and step 0's pairs and cells counted
    by route (pair_routes). Returns (the run: wall, stage seconds, profile
    cells, routes, the driver's phase seconds and cells, what probe
    yielded; the last ProfileQueryAligner call)."""
    from metaeuk_tpu_torch.ops import sw_cuda
    from metaeuk_tpu_torch.search import driver
    for k in driver.CELLS:
        driver.CELLS[k] = 0
    driver.PHASE_SECONDS.clear()
    with probe() as rec, iter_stages(torch, sw_cuda) as (st, cells, last), \
            pair_routes(driver, sw_cuda) as routes:
        t0 = time.perf_counter()
        run_cli(cli, argv)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(wall=wall, stages=st, prof_cells=cells, routes=routes,
                probe=rec, phases=dict(driver.PHASE_SECONDS),
                cells=dict(driver.CELLS)), last


# each SW kernel of the iterative search's profile steps: (pass) in
# iter_stages' cells
PROF_NOCAP_PASS = {"sw_pair_ends_prof_nocap": 1,
                   "sw_pair_starts_prof_nocap": 2}


def report_iter_run(run, r, counts):
    """Prints one iterative search of phase 5g: wall, stage seconds by step,
    the driver's phase seconds, step 0's pairs and cells by route, the
    profile steps' pairs and cells, the prefilter DBs' pairs and the
    alignment DBs' hits by step (counts: make_iter_slice.summary's), each
    SW kernel's launches and summed ms beside its bound, and the kernels'
    busy and idle shares of the wall; raises unless the run went through
    K1/K2, their uncapped instances (step 0's realign) and uncapped PSSM
    instances, and K3/K4 wherever the routing sent pairs, with no capped
    PSSM entry launched and no plain version called. Returns {kernel:
    [launches, ms]}."""
    rec, routes = r["probe"], r["routes"]
    print(f"{run}: wall {r['wall']:.3f} s")
    for step, st in r["stages"].items():
        print(f"{run}: {step} stage seconds " + json.dumps(st))
    print(f"{run}: step 0 driver phase seconds " + json.dumps(r["phases"]))
    print(f"{run}: step 0 cells {json.dumps(r['cells'])}; pairs and cells "
          "by route and pass " + json.dumps(routes))
    print(f"{run}: profile steps' [pairs, forward cells, reverse cells] "
          + json.dumps(r["prof_cells"]))
    print(f"{run}: prefilter pairs and alignment hits by step, profiles "
          + json.dumps(counts))
    ms_by = event_ms(rec["events"])
    prof = [sum(c[i] for c in r["prof_cells"].values()) for i in range(3)]
    busy = 0.0
    for k, (n, ms) in ms_by.items():
        busy += ms
        if k in PROF_NOCAP_PASS:
            cells, ops = prof[PROF_NOCAP_PASS[k]], NOCAP_SW_OPS
        else:
            route, pas = KERNEL_ROUTES.get(k, (None, None))
            cells = routes.get(route, {}).get(pas, [0, 0])[1]
            ops = NOCAP_SW_OPS if k in NOCAP_KERNELS else SW_OPS
        bound_ms = cells * ops / INT32_OPS_PER_S * 1e3
        print(f"{run}: {k} {n} launches, {ms:.3f} ms of kernel time (CUDA "
              f"events around each launch), {cells} cells, bound "
              f"{bound_ms:.3f} ms (operations; "
              f"{bound_ms / max(ms, 1e-9):.1%} of it)", flush=True)
    print(f"{run}: kernels busy {busy / 1e3:.3f} s of the wall, idle share "
          f"{1 - busy / 1e3 / r['wall']:.2%}", flush=True)
    print(f"{run}: launches {rec['launches']} plain {rec['plain']}",
          flush=True)
    need = [*PAIR_KERNELS, *NOCAP_KERNELS, *PROF_NOCAP_KERNELS]
    for k, (route, pas) in KERNEL_ROUTES.items():
        if routes.get(route, {}).get(pas, [0, 0])[0] > 0:
            need.append(k)
        elif rec["launches"][k]:
            raise AssertionError(f"{run}: {k} launched with no pair routed "
                                 "to it")
    if min(rec["launches"][k] for k in need) == 0 or \
            any(rec["launches"][k] for k in PROF_KERNELS) or \
            any(rec["plain"].values()):
        raise AssertionError(f"{run} did not go through {sorted(set(need))}"
                             " alone")
    return ms_by


def check_iter_sample(np, torch, sw_cuda, sw_torch, last, n, seed):
    """Phase 5g (b): a seeded sample of n pairs of the last profile step
    (last: iter_stages' record of its ProfileQueryAligner.search) aligned
    again by the same aligner, once through the kernels and once through
    their plain versions on the same device (sw_torch.align_full_prof on
    the gathered rows, cap=None), each launch's raw outputs recorded: the
    raw outputs equal, both runs' hits equal field by field, and equal to
    the step's own hits on the sampled pairs. Returns (sampled pairs,
    aligned pairs, hits)."""
    al, thr, hits = last["aligner"], last["eval_thr"], last["hits"]
    pairs = np.asarray(last["pairs"], np.int64).reshape(-1, 2)
    rng = np.random.default_rng(seed)
    sample = pairs[np.sort(rng.choice(len(pairs), min(n, len(pairs)),
                                      replace=False))]
    full = sw_cuda.align_full_prof

    def plain(prof_mat, p_lens, t_mat, t_lens, li, lj, cap=32767):
        return sw_torch.align_full_prof(
            *sw_cuda._gathered(prof_mat, p_lens, t_mat, t_lens, li, lj),
            cap=cap)
    raw, got = {}, {}
    for name, fn in (("kernels", full), ("plain", plain)):
        outs = raw[name] = []

        def recording(*a, _fn=fn, _outs=outs, **kw):
            o = _fn(*a, **kw)
            _outs.append([x.cpu() for x in o])
            return o
        sw_cuda.align_full_prof = recording
        try:
            got[name] = al.search(sample.tolist(), eval_thr=thr)
        finally:
            sw_cuda.align_full_prof = full
    if len(raw["kernels"]) != len(raw["plain"]) or any(
            not torch.equal(a, b) for ka, kb in zip(raw["kernels"],
                                                     raw["plain"])
            for a, b in zip(ka, kb)):
        raise AssertionError("the sample's raw outputs differ between the "
                             "kernels and the plain versions")
    key = lambda h: h["orf_idx"].astype(np.int64) * (1 << 32) \
        + h["target_idx"].astype(np.int64)
    ref = hits[np.isin(key(hits), sample[:, 0] * (1 << 32) + sample[:, 1])]
    for a, b, what in ((got["kernels"], got["plain"], "plain"),
                       (ref, got["plain"], "the step's")):
        if len(a) != len(b) or any(not np.array_equal(a[f], b[f])
                                   for f in a.dtype.names):
            raise AssertionError(f"the sample's hits differ from {what}")
    aligned = sum(int((o[0] > 0).sum()) for o in raw["plain"])
    return len(sample), aligned, len(ref)


def iter_child(td):
    """Phase 5g, in a process of its own that main() starts after the build
    and joins after phase 6b (its host stages take minutes, while the other
    phases run): (a) and (b), every ITER_FULL_EVERY-th of the search
    slice's 4,000 queries (a depth cut: the slice's widths and its mix of
    90/60/40% copies and decoys stay) against its 3,000 targets through
    `search --num-iterations ITER_FULL_ITERATIONS -a` on the card
    (run_iter_slice), reported by report_iter_run, then check_iter_sample
    on its last profile step; then (c), check_iter_cut. Writes
    td/result.json: (a)'s wall, launches and summed kernel ms, the sample's
    counts. Returns 0, or raises."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(GOLDEN))
    import make_iter_slice as mis
    from metaeuk_tpu_torch import cli
    from metaeuk_tpu_torch.io.mmseqsdb import read_db
    from metaeuk_tpu_torch.ops import sw_cuda, sw_torch, ungapped_cuda
    from metaeuk_tpu_torch.search import driver, prefilter
    if not torch.cuda.is_available():
        raise AssertionError("phase 5g needs the card")
    counters = (sw_cuda, ungapped_cuda)
    from metaeuk_tpu_torch.io.fasta import read_fasta
    from tools.make_metagenome import write_fasta
    t0 = time.perf_counter()
    paths = mis.iter_slice(mis.ITER_SLICE, td)
    queries = list(read_fasta(paths["queries"]))[::ITER_FULL_EVERY]
    write_fasta(td / "q_full.faa", queries)
    print(f"generated the search slice in {time.perf_counter() - t0:.2f} s; "
          f"its every {ITER_FULL_EVERY}nd query: {len(queries)} queries",
          flush=True)
    cfg = dict(mis.ITER_SLICE, num_iterations=ITER_FULL_ITERATIONS)
    argv = mis.search_args(cfg, td / "q_full.faa", paths["targets"],
                           td / "res", td / "tmp") + ["--device", "cuda"]
    run, last = run_iter_slice(torch, cli, argv, probe=lambda: probe_run(
        torch, counters, driver, prefilter, sw_cuda))
    counts, _ = mis.summary(cfg, td / "res", td / "tmp", read_db)
    ms_by = report_iter_run("full slice", run, counts)
    t0 = time.perf_counter()
    sample = check_iter_sample(np, torch, sw_cuda, sw_torch, last,
                               ITER_SAMPLE, ITER_SAMPLE_SEED)
    print(f"(b) {sample[0]} pairs of the last profile step ({sample[1]} "
          f"aligned, {sample[2]} hits): raw outputs and hits equal to the "
          f"plain versions' on the card and to the step's hits, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check_iter_cut(torch, cli, mis, read_db, td / "cut", counters, driver,
                   prefilter, sw_cuda)
    (td / "result.json").write_text(json.dumps({
        "wall": run["wall"], "launches": run["probe"]["launches"],
        "kernel_ms": ms_by, "counts": counts, "sample": sample}))
    return 0


def check_iter_cut(torch, cli, mis, read_db, td, counters, driver, prefilter,
                   sw_cuda):
    """Phase 5g (c): make_iter_slice.ITER_SLICE's three iterations on the
    search slice's cut (every 10th query) on the card, in td, reported by
    report_iter_run; the counts and every digest equal
    tests/golden/iter_slice.json's (the JAX package's), or raises."""
    iter_golden = json.loads((GOLDEN / "iter_slice.json").read_text())
    if iter_golden["input"] != json.loads(json.dumps(mis.ITER_SLICE)):
        raise AssertionError("iter_slice.json was made from another "
                             "input than make_iter_slice.ITER_SLICE")
    t0 = time.perf_counter()
    td.mkdir()
    paths = mis.iter_slice(mis.ITER_SLICE, td)
    cut_run, _ = run_iter_slice(torch, cli, mis.search_args(
        mis.ITER_SLICE, paths["cut"], paths["targets"], td / "res",
        td / "tmp") + ["--device", "cuda"],
        probe=lambda: probe_run(torch, counters, driver, prefilter, sw_cuda))
    cut_counts, cut_digests = mis.summary(mis.ITER_SLICE, td / "res",
                                          td / "tmp", read_db)
    report_iter_run("(c) the cut", cut_run, cut_counts)
    if cut_counts != iter_golden["counts"] or \
            cut_digests != iter_golden["sha256"]:
        raise AssertionError("the cut's iterative search differs from "
                             "iter_slice.json")
    print(f"(c) the cut ({len(cut_digests)} DBs): every digest equal to "
          f"iter_slice.json, {time.perf_counter() - t0:.2f} s", flush=True)


def check_kmerpf_slice(np, torch, device):
    """Phase 5n: (a) the k-mer slice's 61,457 fragments
    (tests/golden/make_kmerpf_slice.py) against its 3,000 targets through
    search/kmer_prefilter.py's KmerPrefilter.candidate_pairs on `device`,
    the counts set to 0 before it and read after it: the counts and the
    sha256 of the candidates, their scores and the kept pairs equal
    kmerpf_slice.json's (the JAX package's); the kernel of each staged
    width of the candidates' fragments launched (gapless_pair for the short
    buckets; the slice's seven fragments over 512 aa have no candidate, in
    the JAX package's run too, so gapless_long has no pair there), no other
    kernel and no plain version called; then every candidate scored again
    through launch("gapless_long") at one width and through the plain
    version on the card, both equal to the path's scores. (b) The planted
    cut (make_kmerpf_slice.PLANTED_CUT: a 1,024-aa fragment) through
    candidate_pairs on `device`, gapless_pair and gapless_long launched
    and no plain version called, its candidates, scores and kept pairs
    equal to the plain version's run on the CPU. Prints the wall, the stage
    seconds (index, screen, rescore, select), the pairs and cells, and each
    gapless kernel's launches and summed ms (CUDA events around each
    launch, after one uncounted launch of each kernel), by staged width and
    in all, beside its bound. Returns the launches of (a) and (b) by
    kernel."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(GOLDEN))
    import make_kmerpf_slice as mks
    from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, SeqDB
    from metaeuk_tpu_torch.ops import ungapped_cuda, ungapped_torch
    from metaeuk_tpu_torch.ops.orf import OrfExtractor
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.search.driver import pad_rows
    from metaeuk_tpu_torch.search.kmer_prefilter import KmerPrefilter
    from metaeuk_tpu_torch.search.prefilter import _bucket
    golden = json.loads((GOLDEN / "kmerpf_slice.json").read_text())
    if golden["input"] != mks.KMERPF_SLICE:
        raise AssertionError("kmerpf_slice.json was made from another input "
                             "than make_kmerpf_slice.KMERPF_SLICE")
    kw = mks.prefilter_kwargs(mks.KMERPF_SLICE)

    def run(frags, targets, dev):
        """(prefilter, kept, launches, plain, events, wall) of one
        candidate_pairs call on dev, its counts set to 0 before it."""
        ungapped_cuda.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with launch_events(torch, ungapped_cuda, by_lq=True) as events:
            pf = KmerPrefilter(Params(), targets, device=dev, **kw)
            kept = pf.candidate_pairs(frags)
            torch.cuda.synchronize()
        return (pf, kept, dict(ungapped_cuda.LAUNCHES),
                dict(ungapped_cuda.PLAIN_CALLS), events,
                time.perf_counter() - t0)

    def report(what, pf, frags, targets, events, wall):
        """{staged width: cells} of pf's last candidates, printed with the
        run's seconds and each kernel's events beside its bound."""
        cand = pf.last_candidates[0]
        f_lens = np.array([len(f) for f in frags], np.int64)[cand[:, 0]]
        cells = f_lens * targets.lengths[cand[:, 1]]
        widths = np.array([_bucket(max(1, int(n))) for n in f_lens])
        by_lq = {int(w): int(cells[widths == w].sum())
                 for w in np.unique(widths)}
        print(f"5n {what}: wall {wall:.3f} s; stage seconds "
              + json.dumps(pf.stage_seconds) + f"; {len(cand)} candidate "
              f"pairs, {int(cells.sum())} cells by staged width "
              + json.dumps(by_lq), flush=True)
        print_k7_by_lq(events, by_lq)
        for k, (n, ms) in event_ms(events).items():
            if " Lq " in k:
                continue
            c = sum(v for w, v in by_lq.items()
                    if ungapped_cuda.kernel_for(w) == k)
            bound_ms = c * GAPLESS_OPS / INT32_OPS_PER_S * 1e3
            print(f"5n {what}: {k} {n} launches, {ms:.3f} ms (CUDA events "
                  f"around each launch), {c} cells, bound {bound_ms:.4f} ms "
                  f"(operations; {bound_ms / max(ms, 1e-9):.1%} of it)",
                  flush=True)
        return by_lq

    # one launch of each kernel first, uncounted: a process's first launch
    # of a kernel loads its module, which is not kernel time
    warm = staged_batch(torch, np.random.default_rng(0), 32, 64, 4, 4, device)
    for k in ("gapless_pair", "gapless_long"):
        ungapped_cuda.launch(k, *warm, *[torch.arange(4, device=device)] * 2)
    t0 = time.perf_counter()
    frags, targets = mks.kmerpf_slice(mks.KMERPF_SLICE, OrfExtractor, Params,
                                      SeqDB, DBTYPE_AA)
    print(f"5n (a): generated {len(frags)} fragments and {len(targets)} "
          f"targets in {time.perf_counter() - t0:.2f} s", flush=True)
    pf, kept, launches, plain, events, wall = run(frags, targets, device)
    by_lq = report("(a) the k-mer slice", pf, frags, targets, events, wall)
    cand, scores = pf.last_candidates
    counts, digs = mks.summary(frags, targets, cand, scores, kept)
    print(f"5n (a): counts {counts}; launches {launches} plain {plain}",
          flush=True)
    if counts != golden["counts"] or digs != golden["sha256"]:
        raise AssertionError(f"5n differs from kmerpf_slice.json: digests "
                             f"{digs}")
    want = {ungapped_cuda.kernel_for(w) for w in by_lq}
    if "gapless_pair" not in want or any(
            (launches[k] > 0) != (k in want) for k in launches) or \
            any(plain.values()):
        raise AssertionError(f"5n (a) did not go through {sorted(want)} "
                             "alone")
    total = {k: launches[k] for k in ("gapless_pair", "gapless_long")}
    # every candidate again, on gapless_long and on the plain version
    t0 = time.perf_counter()
    frag_ids, li = np.unique(cand[:, 0], return_inverse=True)
    enc, bias = pf.encode([frags[i] for i in frag_ids])
    width = _bucket(max(len(e) for e in enc))
    mk = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dt)
    args = (mk(pad_rows(enc, width, np.uint8), torch.uint8),
            mk(pad_rows(bias, width, np.int8), torch.int8),
            mk([len(e) for e in enc], torch.int32), *pf.staged_targets(),
            mk(li.reshape(-1), torch.int32), mk(cand[:, 1], torch.int32))
    again = ungapped_cuda.launch("gapless_long", *args)
    ref = ungapped_torch.gapless_gathered(*args)
    if not (torch.equal(again, ref) and torch.equal(
            torch.from_numpy(scores).to(device), ref)):
        raise AssertionError("5n: the path's scores, gapless_long's and the "
                             "plain version's differ")
    print(f"5n (a): {len(cand)} candidates at width {width}: gapless_long "
          "and the plain version equal the path's scores "
          f"({time.perf_counter() - t0:.2f} s); counts and the 3 digests "
          "equal kmerpf_slice.json", flush=True)

    frags, targets = mks.planted_cut(mks.PLANTED_CUT, OrfExtractor, Params,
                                     SeqDB, DBTYPE_AA)
    pf, kept, launches, plain, events, wall = run(frags, targets, device)
    report("(b) the planted cut", pf, frags, targets, events, wall)
    ref_pf = KmerPrefilter(Params(), targets, device="cpu", **kw)
    ref_kept = ref_pf.candidate_pairs(frags)
    same = np.array_equal(kept, ref_kept) and all(
        np.array_equal(a, b) for a, b in zip(pf.last_candidates,
                                             ref_pf.last_candidates))
    print(f"5n (b): {len(kept)} kept pairs; launches {launches} plain "
          f"{plain}", flush=True)
    if not same:
        raise AssertionError("5n (b): the card's candidates, scores or kept "
                             "pairs differ from the plain version's")
    if min(launches["gapless_pair"], launches["gapless_long"]) == 0 or \
            launches["gapless_rows"] or any(plain.values()):
        raise AssertionError("5n (b) did not go through gapless_pair and "
                             "gapless_long alone")
    print("5n (b): candidates, scores and kept pairs equal the plain "
          "version's on the CPU", flush=True)
    return {k: total[k] + launches[k] for k in total}


def kmerpf_child(td):
    """Phase 5n, in a process of its own that main() starts before phase 5h
    and joins after phase 5m (its screen is seconds of host numpy a
    thousand fragments, while phases 5h-5j, whose kernels keep the card
    idle above 99.9% of the time, run; its CUDA events may include their
    kernels): check_kmerpf_slice on the card. Writes td/result.json: the
    path's gapless launches. Returns 0, or raises."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise AssertionError("phase 5n needs the card")
    launches = check_kmerpf_slice(np, torch, "cuda")
    (td / "result.json").write_text(json.dumps({"launches": launches}))
    return 0


def gumbel_child(td):
    """Phase 5k, in a process of its own that main() starts after the build
    and joins after phase 5j (its fits are minutes of host sampling and
    island scans, while the other phases run): check_gumbel_slice on the
    card over tests/golden/gumbel_slice.json's four systems at
    fit_gapped's defaults, GUMBEL_PLAIN_CHUNKS chunks a fit against the
    plain versions. Writes td/result.json: the phase's seconds and each
    fit's launches. Returns 0, or raises."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(GOLDEN))
    import make_gumbel_slice as mgs
    from metaeuk_tpu_torch import cli
    if not torch.cuda.is_available():
        raise AssertionError("phase 5k needs the card")
    golden = json.loads((GOLDEN / "gumbel_slice.json").read_text())
    if golden["fit_defaults"] != mgs.FIT_DEFAULTS:
        raise AssertionError("gumbel_slice.json was made at another size "
                             "than make_gumbel_slice.FIT_DEFAULTS")
    t0 = time.perf_counter()
    fits = check_gumbel_slice(np, torch, cli, td, "cuda", golden["systems"],
                              mgs.FIT_DEFAULTS, GUMBEL_PLAIN_CHUNKS)
    (td / "result.json").write_text(json.dumps({
        "seconds": time.perf_counter() - t0,
        "launches": {s: r["launches"] for s, r in fits.items()}}))
    return 0


# the multi-process worker of phase 5l, started as a script of the checkout
DIST_WORKER = ROOT / "metaeuk_tpu_torch" / "tools" / "dist_worker.py"
# seconds each of phase 5l's runs (all its worker processes) may take
DIST_RUN_TIMEOUT = 900
# the kernels whose launches, ms and bounds phase 5l reports per process
DIST_KERNELS = ("sw_pair_ends", "sw_pair_starts", "sw_qm_ends",
                "sw_qm_starts")


def run_dist_workers(n, contigs, targets, out, split, device,
                     timeout=DIST_RUN_TIMEOUT):
    """metaeuk_tpu_torch/tools/dist_worker.py in n processes at once on
    `device` (a gloo group on a free localhost port), easy-predict with
    --split `split` into `out`: (wall seconds, each process's JSON line,
    each process's "prefilter split" log lines). Raises unless every process
    exits 0 within `timeout` seconds; every process is stopped at exit."""
    from metaeuk_tpu_torch.tools.dryrun import free_port
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(DIST_WORKER), str(i), str(n),
         f"127.0.0.1:{port}", str(contigs), str(targets), str(out),
         str(split), "--device", device], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for i in range(n)]
    res = []
    try:
        for p in procs:
            left = max(1.0, timeout - (time.perf_counter() - t0))
            res.append(p.communicate(timeout=left))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for i, (_, e) in enumerate(res):
        if procs[i].returncode != 0:
            raise AssertionError(f"worker {i} of {n} exited "
                                 f"{procs[i].returncode}:\n{e[-3000:]}")
    return (wall, [json.loads(o.strip().splitlines()[-1]) for o, _ in res],
            [[ln for ln in e.splitlines() if "prefilter split" in ln]
             for _, e in res])


def check_dist_slice(contigs, targets, td, split, device, want=None):
    """Phase 5l's runs: easy-predict with --split `split` through the worker
    in one process, then in two (each on its contig half, the splits fanned
    round-robin over them), outputs under td; the two runs' digests equal
    (and equal `want` when given); each process of the second run built
    exactly its splits (split si on process si % 2), and the shared scratch
    holds the hit file of every split and query block. On the card every
    process launched K1/K2 and called no plain version. Returns {"one" |
    "two": {"wall", "procs", "logs", "digests"}}."""
    import re
    runs = {}
    for tag, n in (("one", 1), ("two", 2)):
        wall, procs, logs = run_dist_workers(n, contigs, targets, td / tag,
                                             split, device)
        runs[tag] = dict(wall=wall, procs=procs, logs=logs,
                         digests=digests(td / tag))
    if runs["two"]["digests"] != runs["one"]["digests"]:
        raise AssertionError("the two-process run's digests differ from the "
                             "one-process run's")
    if want is not None and runs["one"]["digests"] != want:
        raise AssertionError("the split runs' digests differ from the "
                             "golden's")
    for pi, logs in enumerate(runs["two"]["logs"]):
        built = sorted(int(re.search(r"split (\d+)/", ln).group(1)) - 1
                       for ln in logs if f"on process {pi}" in ln)
        if built != [si for si in range(split) if si % 2 == pi]:
            raise AssertionError(f"process {pi} built splits {built}")
    for si in range(split):
        for qp in range(2):
            if not (td / "two.dist_pref" / f"hits_{si}_{qp}.npz").exists():
                raise AssertionError(f"no hits_{si}_{qp}.npz in the shared "
                                     "scratch")
    if device == "cuda":
        for tag, run in runs.items():
            for rec in run["procs"]:
                if min(rec["kernels"].get(k, [0])[0]
                       for k in PAIR_KERNELS) == 0 or \
                        any(rec["plain_calls"].values()):
                    raise AssertionError(f"process {rec['rank']} of the "
                                         f"{tag}-process run did not go "
                                         "through K1/K2 alone")
    return runs


def report_dist_slice(runs):
    """Prints phase 5l: each run's wall; each process's wall, stage seconds,
    cells, K1-K4 launches and summed ms (CUDA events) beside their bounds
    (K1 from the forward cells and K2 from the reverse ones when no pair
    took the query-major tiles, else the forward and reverse passes'
    bounds over both routes), and the card's idle share of its wall."""
    for tag, run in runs.items():
        print(f"5l {tag}-process run: wall {run['wall']:.3f} s (the "
              "processes' start included)", flush=True)
        for rec in run["procs"]:
            who = f"5l {tag}-process run, process {rec['rank']}"
            ks = rec["kernels"]
            fwd, rev = rec["cells"]["fwd"], rec["cells"]["rev"]
            qm = any(ks.get(k, [0])[0] for k in ("sw_qm_ends",
                                                  "sw_qm_starts"))
            print(f"{who}: wall {rec['wall']:.3f} s; stage seconds "
                  + json.dumps(rec["stage_seconds"]) + f"; cells fwd {fwd} "
                  f"rev {rev}", flush=True)
            for k in DIST_KERNELS:
                n, ms = ks.get(k, [0, 0.0])
                cells = fwd if k.endswith("ends") else rev
                bound_ms = cells * SW_OPS / INT32_OPS_PER_S * 1e3
                what = "of both routes' pass" if qm else "operations"
                print(f"{who}: {k} {n} launches, {ms:.3f} ms (CUDA events "
                      f"around each launch), bound {bound_ms:.3f} ms ({what})",
                      flush=True)
            busy = sum(ms for _, ms in ks.values()) / 1e3
            print(f"{who}: kernels busy {busy:.3f} s, idle share "
                  f"{1 - busy / max(rec['wall'], 1e-9):.4%}; plain calls "
                  f"{sum(rec['plain_calls'].values())}", flush=True)


def dist_child(td):
    """Phase 5l, in a process of its own that main() starts after phase 5j
    and joins after phase 6b (while the other phases run): the 4.0 Mbp /
    8,000-target slice of tests/golden/dist_bench_slice.json through
    check_dist_slice on the card at its --split, the digests held to the
    file's (the JAX package's single-process split-2 run), reported by
    report_dist_slice. Writes td/result.json: the runs. Returns 0, or
    raises."""
    import torch
    sys.path.insert(0, str(ROOT))
    from tools.make_metagenome import make_metagenome, write_fasta
    if not torch.cuda.is_available():
        raise AssertionError("phase 5l needs the card")
    golden = json.loads((GOLDEN / "dist_bench_slice.json").read_text())
    t0 = time.perf_counter()
    contigs, proteins = make_metagenome(golden["mbp"], golden["targets"])
    write_fasta(td / "c.fna", contigs)
    write_fasta(td / "p.faa", proteins)
    print(f"generated {len(contigs)} contigs, {len(proteins)} targets in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    runs = check_dist_slice(td / "c.fna", td / "p.faa", td, golden["split"],
                            "cuda", golden["sha256"])
    report_dist_slice(runs)
    print("5l: both runs' digests equal dist_bench_slice.json; each process "
          "built its round-robin split", flush=True)
    (td / "result.json").write_text(json.dumps(runs))
    return 0


def check_mesh_steps(np, torch, sw_cuda, device, step):
    """Phase 5m (b): parallel/dist.py's dense and top-k steps on a one-rank
    mesh (tools/dryrun.py one_rank_group: NCCL on the card, gloo on the
    CPU) at `step`'s shapes (dryrun.SLICE_STEP's keys), each output equal to
    the plain dense cross product on the same device (the top-k in
    jax.lax.top_k's tie order); on the card K1's uncapped instance launched
    once a step and no plain version called. Returns (launches, plain calls,
    the steps' seconds, collective_report())."""
    from metaeuk_tpu_torch.parallel import dist
    from metaeuk_tpu_torch.tools import dryrun
    x = dryrun.mesh_inputs(step["Bq"], step["Nt"], step["Lq"], step["Lt"],
                           step["seed"])
    with dryrun.one_rank_group(device):
        dist.collective_report(reset=True)
        mesh = dist.make_mesh(torch.device(device).type)
        sw_cuda.reset_counts()
        t0 = time.perf_counter()
        got = dryrun.run_steps(mesh, x, step["k"])
        seconds = time.perf_counter() - t0
        launches, plain = dict(sw_cuda.LAUNCHES), dict(sw_cuda.PLAIN_CALLS)
        report = dist.collective_report()
    want = dryrun.expected_rows(x, step["k"], slice(0, step["Bq"]),
                                dryrun.plain_cross(x, device))
    for n, a in want.items():
        if not np.array_equal(got[n], a):
            raise AssertionError(f"the mesh step's {n} differs from the "
                                 "plain cross product")
    if torch.device(device).type == "cuda" and (
            launches["sw_pair_ends_nocap"] != 2 or any(plain.values())):
        raise AssertionError("the mesh steps did not go through K1's "
                             f"uncapped instance alone: {launches} {plain}")
    return launches, plain, seconds, report


def check_modular_workflows(cli, device, td):
    """Phase 4f, first part: MetaEuk's modular commands on tests/data
    through the port's CLI, on `device`: predictexons -> reduceredundancy
    -> unitesetstofasta, each DB equal to tests/golden/dbs (dp_preds,
    red_preds, red_clust) and the four outputs byte-identical to
    tests/golden/easypredict.*; then createdb, extractorfs --min-length 15
    (predictexons' preset), resultspercontig over the committed search_res
    and collectoptimalset, equal to tests/golden/percontig (by_contig,
    dp_preds). tests/test_torch_modular.py rehearses it on the CPU."""
    data, dbs, pc = ROOT / "tests" / "data", GOLDEN / "dbs", \
        GOLDEN / "percontig"
    c, t = str(data / "contigs.fna"), str(data / "proteins.faa")
    dev = ["--device", str(device)]
    cli.main(["predictexons", c, t, str(td / "dp"), *dev])
    same_db(td / "dp", dbs / "dp_preds")
    cli.main(["reduceredundancy", str(td / "dp"), str(td / "red"),
              str(td / "clust")])
    same_db(td / "red", dbs / "red_preds")
    same_db(td / "clust", dbs / "red_clust")
    cli.main(["unitesetstofasta", c, t, str(td / "red"), str(td / "ep"),
              *dev])
    for s in SUFFIXES:
        same_bytes(f"{td / 'ep'}.{s}", GOLDEN / f"easypredict.{s}")
    cli.main(["createdb", c, str(td / "contigs")])
    cli.main(["createdb", t, str(td / "targets")])
    cli.main(["extractorfs", str(td / "contigs"), str(td / "nucl_6f"),
              "--min-length", "15"])
    cli.main(["resultspercontig", str(td / "contigs"), str(td / "nucl_6f"),
              str(pc / "search_res"), str(td / "bc")])
    same_db(td / "bc", pc / "by_contig")
    cli.main(["collectoptimalset", str(td / "bc"), str(td / "targets"),
              str(td / "dp_pc")])
    same_db(td / "dp_pc", pc / "dp_preds")
    print(f"modular commands on {device}: predictexons, reduceredundancy "
          "and unitesetstofasta equal tests/golden/dbs and easypredict.*; "
          "extractorfs, resultspercontig and collectoptimalset equal "
          "tests/golden/percontig", flush=True)


def check_tax_workflows(cli, device, td):
    """Phase 4f, second part: taxtocontig on tests/golden/easypredict.* with
    the toy taxdump of tests/golden/tax, byte-identical to the MetaEuk
    binary's reftax_tax_per_{pred,contig}.tsv; then createdb + createtaxdb
    of the fixture proteins with tests/golden/tax2's taxdump and mapping,
    and taxonomy (default approx-2bLCA, with its pref and first
    intermediates), taxonomy --lca-mode 4 --tax-output-mode 2 and
    easy-taxonomy on queries_lin.faa, equal to the MMseqs2 goldens in
    tests/golden/tax2, as tests/test_taxworkflow.py compares them. On
    `device` (tests/test_torch_tax.py rehearses it on the CPU)."""
    data, tax, tax2 = ROOT / "tests" / "data", GOLDEN / "tax", \
        GOLDEN / "tax2"
    dev = ["--device", str(device)]
    dump = tax / "taxdump"
    cli.main(["taxtocontig", str(GOLDEN / "easypredict.fas"),
              str(GOLDEN / "easypredict.headersMap.tsv"),
              str(data / "proteins.faa"), str(tax / "tax_mapping.tsv"),
              str(dump / "names.dmp"), str(dump / "nodes.dmp"),
              str(td / "reftax"), "--merged-dmp", str(dump / "merged.dmp"),
              "--contigs", str(data / "contigs.fna"), *dev])
    for s in ("tax_per_pred", "tax_per_contig"):
        same_bytes(f"{td / 'reftax'}_{s}.tsv", tax / f"reftax_{s}.tsv")
    cli.main(["createdb", str(data / "proteins.faa"), str(td / "ptax")])
    cli.main(["createtaxdb", str(td / "ptax"), str(td / "ptax_tmp"),
              "--ncbi-tax-dump", str(tax2 / "taxdump"),
              "--tax-mapping-file", str(tax2 / "accmap.tsv")])
    q = str(data / "queries_lin.faa")
    cli.main(["createdb", q, str(td / "qdb")])
    cli.main(["taxonomy", str(td / "qdb"), str(td / "ptax"),
              str(td / "taxwf"), str(td / "taxwf_tmp"), *dev])
    same_db(td / "taxwf", tax2 / "taxwf")
    same_db(td / "taxwf_tmp" / "pref", tax2 / "taxwf_pref")
    same_db(td / "taxwf_tmp" / "first", tax2 / "taxwf_first")
    cli.main(["taxonomy", str(td / "qdb"), str(td / "ptax"),
              str(td / "taxth"), str(td / "taxth_tmp"), "--lca-mode", "4",
              "--tax-output-mode", "2", *dev])
    same_db(td / "taxth", tax2 / "taxth")
    same_db(f"{td / 'taxth'}_aln", tax2 / "taxth_aln")
    cli.main(["easy-taxonomy", q, str(td / "ptax"), str(td / "easytax"),
              str(td / "easytax_tmp"), *dev])
    for s in ("_lca.tsv", "_report", "_tophit_report", "_tophit_aln"):
        same_bytes(f"{td / 'easytax'}{s}", tax2 / f"easytax{s}")
    print(f"taxonomy on {device}: taxtocontig byte-identical to the MetaEuk "
          "binary's reftax TSVs; taxonomy (and its pref and first), "
          "taxonomy --lca-mode 4 --tax-output-mode 2 and easy-taxonomy "
          "equal tests/golden/tax2", flush=True)


def run_modular(cli, contigs, targets, td, device):
    """Phase 5f (a): predictexons -> reduceredundancy -> unitesetstofasta
    through the port's CLI on `device`, written under td (td / "slice.*"
    the outputs); returns {command: seconds} with the DP-format round
    trip's: dpformat.predictions_payload (dp_write, the predictions as
    text) and cli._parse_dp_payload (dp_parse, read back)."""
    from metaeuk_tpu_torch.pipeline import dpformat
    dev = ["--device", str(device)]
    seconds = {}
    with timed_calls(((dpformat, "predictions_payload", "dp_write"),
                      (cli, "_parse_dp_payload", "dp_parse"))) as st:
        for name, args in (
                ("predictexons", [str(contigs), str(targets),
                                  str(td / "dp"), *dev]),
                ("reduceredundancy", [str(td / "dp"), str(td / "red"),
                                      str(td / "clust")]),
                ("unitesetstofasta", [str(contigs), str(targets),
                                      str(td / "red"), str(td / "slice"),
                                      *dev])):
            t0 = time.perf_counter()
            cli.main([name, *args])
            seconds[name] = time.perf_counter() - t0
    return {**seconds, **st}


@contextlib.contextmanager
def tax_stages(workflow):
    """Host seconds of taxtocontig's parts, for this script's measurement
    only: the assigner's SearchDriver.search, TaxonomyAssigner.assign
    (search and the per-query LCA loop) and TaxToContig.run (assign, reading
    the predictions, writing the two TSVs); yields ({part: seconds}, [the
    search's hit arrays])."""
    seconds, hits = {"search": 0.0, "assign": 0.0, "run": 0.0}, []
    assign, run = workflow.TaxonomyAssigner.assign, workflow.TaxToContig.run

    def add(part, t0):
        seconds[part] += time.perf_counter() - t0

    def timed_assign(self, *a, **kw):
        search = self.driver.search

        def timed_search(*sa, **skw):
            t0 = time.perf_counter()
            hits.append(search(*sa, **skw))
            add("search", t0)
            return hits[-1]
        self.driver.search = timed_search
        t0 = time.perf_counter()
        try:
            return assign(self, *a, **kw)
        finally:
            add("assign", t0)
            del self.driver.search

    def timed_run(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return run(self, *a, **kw)
        finally:
            add("run", t0)
    workflow.TaxonomyAssigner.assign = timed_assign
    workflow.TaxToContig.run = timed_run
    try:
        yield seconds, hits
    finally:
        workflow.TaxonomyAssigner.assign = assign
        workflow.TaxToContig.run = run


def run_taxtocontig(cli, args, device, probe=contextlib.nullcontext):
    """One taxtocontig through the port's CLI (args: make_tax_slice.
    taxtocontig_args's command line) on `device`. probe() brackets the run
    as in run_search_slice. Returns its wall, stage seconds (load: the
    target DB, taxonomy, mapping and contigs; search; per_query: the LCA
    loop; io: reading the predictions and writing the TSVs), the driver's
    phase seconds and cells, its routes (pair_routes), what probe yielded
    and the search's hit array."""
    from metaeuk_tpu_torch.ops import sw_cuda
    from metaeuk_tpu_torch.search import driver
    from metaeuk_tpu_torch.tax import workflow
    for k in driver.CELLS:
        driver.CELLS[k] = 0
    driver.PHASE_SECONDS.clear()
    with probe() as rec, tax_stages(workflow) as (st, hits), \
            pair_routes(driver, sw_cuda) as routes:
        t0 = time.perf_counter()
        cli.main([*args, "--device", str(device)])
        wall = time.perf_counter() - t0
    stages = {"load": wall - st["run"], "search": st["search"],
              "per_query": st["assign"] - st["search"],
              "io": st["run"] - st["assign"]}
    return dict(wall=wall, stages=stages, routes=routes, probe=rec,
                phases=dict(driver.PHASE_SECONDS), cells=dict(driver.CELLS),
                hits=hits[0], pairs=sum(r["fwd"][0] for r in routes.values()
                                        if "fwd" in r))


def report_tax_run(run, r, need):
    """Prints one taxtocontig run of phase 5f as report_search_run does
    (raising unless it went through `need` and every kernel the routing
    sent pairs to, with no plain version called), then its pairs, hits and
    the SW kernels' summed ms over its wall (CUDA events; the length
    classes' side streams may overlap)."""
    report_search_run(run, r, need)
    ms = sum(v[1] for v in event_ms(r["probe"]["events"]).values())
    busy = ms / 1e3 / r["wall"]
    print(f"{run}: {r['pairs']} pairs, {len(r['hits'])} hits; SW kernels "
          f"{ms:.3f} ms summed over a wall of {r['wall']:.3f} s: busy share "
          f"{busy:.4%}, idle share {1 - busy:.4%}", flush=True)


# the host stages of the clustering and linear-search family that phase 5h
# times, in call order: (module or class of the port, attribute, stage)
def cluster_stage_specs():
    from metaeuk_tpu_torch.pipeline import (alnformat, clust, dbtools,
                                            dbtools2, dbtools3, filterdb,
                                            rescorediagonal)
    from metaeuk_tpu_torch.search import (align_module, driver, kmermatcher,
                                          linsearch_lin, searchdb)
    return ((searchdb, "_ensure_seqdb", "createdb"),
            (kmermatcher, "linclust_exact", "linclust"),
            (kmermatcher, "kmermatcher_db", "kmermatcher"),
            (rescorediagonal, "rescorediagonal", "rescorediagonal"),
            (dbtools, "createsubdb", "createsubdb"),
            (searchdb, "prefilter_db", "prefilter"),
            (align_module, "align_db", "align"),
            (driver.SearchDriver, "search", "SearchDriver.search"),
            (driver.SearchDriver, "backtraces", "backtraces"),
            (clust, "clust_db", "clust"),
            (clust, "mergeclusters", "mergeclusters"),
            (linsearch_lin, "build_linindex", "createlinindex"),
            (linsearch_lin, "kmersearch_db", "kmersearch"),
            (filterdb, "filterdb", "filterdb"),
            (dbtools2, "swapresults", "swapresults"),
            (dbtools3, "result2repseq", "result2repseq"),
            (dbtools2, "createseqfiledb", "createseqfiledb"),
            (dbtools2, "result2flat", "result2flat"),
            (alnformat, "write_blast_tab", "write_blast_tab"))


def cluster_args(run, paths, out, tmp, cut=False):
    """The port's CLI arguments of phase 5h's run (easy_cluster,
    easy_linclust or easy_linsearch) on make_cluster_slice.cluster_slice's
    paths (its cut with cut=True), at the commands' defaults."""
    if run == "easy_linsearch":
        q, t = ("cut_queries", "cut_targets") if cut else ("queries",
                                                           "targets")
        return ["easy-linsearch", paths[q], paths[t], f"{out}.m8", tmp]
    tool = "easy-cluster" if run == "easy_cluster" else "easy-linclust"
    return [tool, paths["cut" if cut else "all"], out, tmp]


def run_cluster_cmd(cli, argv, device, probe=contextlib.nullcontext):
    """One run of phase 5h through the port's CLI on `device` (run_timed_cmd
    with cluster_stage_specs)."""
    return run_timed_cmd(cli, [*argv, "--device", device],
                         cluster_stage_specs(), probe)


def run_timed_cmd(cli, argv, specs, probe=contextlib.nullcontext):
    """One command through the port's CLI, its calls of specs' functions
    timed (timed_steps) and the whole bracketed by probe() as in
    run_search_slice. Returns its wall, the timed_steps record, the
    driver's phase seconds and cells, its routes (pair_routes), what probe
    yielded and the SearchDriver.search hit arrays in call order."""
    from metaeuk_tpu_torch.ops import sw_cuda
    from metaeuk_tpu_torch.search import driver
    for k in driver.CELLS:
        driver.CELLS[k] = 0
    driver.PHASE_SECONDS.clear()
    with probe() as rec, timed_steps(specs) as (st, hits), \
            pair_routes(driver, sw_cuda) as routes:
        t0 = time.perf_counter()
        run_cli(cli, argv)
        wall = time.perf_counter() - t0
    return dict(wall=wall, steps=st, stages=stage_seconds(st), routes=routes,
                probe=rec, phases=dict(driver.PHASE_SECONDS),
                cells=dict(driver.CELLS), hits=hits,
                pairs=sum(r["fwd"][0] for r in routes.values()
                          if "fwd" in r))


def cluster_digests(run, out, tmp):
    """The digests of phase 5h's run, keyed as in
    tests/golden/cluster_slice.json's sha256 entries."""
    import make_cluster_slice as mcs
    from metaeuk_tpu_torch.io.mmseqsdb import read_db
    if run == "easy_linsearch":
        return mcs.linsearch_summary(f"{out}.m8", tmp, read_db)
    return mcs.cluster_summary(out, tmp, run == "easy_linclust", read_db)


def report_cluster_run(run, r, need=PAIR_KERNELS):
    """Prints one run of phase 5h as report_search_run does (raising unless
    it went through `need` and every kernel the routing sent pairs to, with
    no plain version called), then each timed step in call order (nested
    ones indented), its SearchDriver.search calls' pairs and hits, and the
    SW kernels' summed ms over its wall: the busy and idle shares."""
    report_search_run(run, r, need)
    print(f"{run}: seconds by step, in call order: " + "; ".join(
        f"{'  ' * d}{stage} {s:.3f}" for stage, d, s in r["steps"]))
    ms = sum(v[1] for v in event_ms(r["probe"]["events"]).values())
    busy = ms / 1e3 / r["wall"]
    print(f"{run}: {r['pairs']} pairs, hits by SearchDriver.search call "
          f"{[len(h) for h in r['hits']]}; SW kernels {ms:.3f} ms summed "
          f"over a wall of {r['wall']:.3f} s: busy share {busy:.4%}, idle "
          f"share {1 - busy:.4%}", flush=True)


CLUSTER_RUNS = ("easy_cluster", "easy_linclust", "easy_linsearch")


def check_cluster_slice(np, cli, td, device, probe=contextlib.nullcontext,
                        cfg=None):
    """Phase 5h: make_cluster_slice.py's slice (cfg, default CLUSTER_SLICE)
    under td on `device`. First the cut: easy-cluster, easy-linclust and
    easy-linsearch at their defaults; then the same three on the whole
    slice, each at the default routing and under METAEUK_QM=off, every
    SearchDriver.search hit array equal field by field and every output
    byte-identical. For CLUSTER_SLICE each cut's counts and digests equal
    tests/golden/cluster_slice.json's (the JAX package's), and each whole
    slice's where the file has the run. Each run reported by
    report_cluster_run. Returns ({run: its record}, {run: (counts,
    digests)}, keyed as the file's)."""
    import make_cluster_slice as mcs
    golden = json.loads((GOLDEN / "cluster_slice.json").read_text())
    cfg = cfg or mcs.CLUSTER_SLICE
    compare = cfg == mcs.CLUSTER_SLICE
    if compare and golden["input"] != json.loads(json.dumps(cfg)):
        raise AssertionError("cluster_slice.json was made from another "
                             "input than make_cluster_slice.CLUSTER_SLICE")

    def check(key, got, what, required=False):
        if compare and (required or key in golden["sha256"]):
            if got != (golden["counts"][key], golden["sha256"][key]):
                raise AssertionError(f"{what} differs from "
                                     "cluster_slice.json")
            print(f"{what}: counts and digests equal cluster_slice.json",
                  flush=True)
    t0 = time.perf_counter()
    paths = mcs.cluster_slice(cfg, td)
    print(f"generated the cluster slice in {time.perf_counter() - t0:.2f} s",
          flush=True)
    records, got = {}, {}
    for run in CLUSTER_RUNS:
        out, tmp = td / f"cut_{run}", td / f"cut_{run}_tmp"
        records[f"{run} (cut)"] = r = run_cluster_cmd(
            cli, cluster_args(run, paths, out, tmp, cut=True), device, probe)
        report_cluster_run(f"{run} (cut)", r)
        key = f"{run}_cut" if run == "easy_linsearch" else run
        got[key] = cluster_digests(run, out, tmp)
        print(f"{run} (cut): counts {json.dumps(got[key][0])}", flush=True)
        check(key, got[key], f"{run} on the cut", required=True)
    for run in CLUSTER_RUNS:
        done = {}
        for qm in ("auto", "off"):
            out, tmp = td / f"{run}_{qm}", td / f"{run}_{qm}_tmp"
            if qm == "off":
                os.environ["METAEUK_QM"] = qm
            try:
                records[f"{run} QM {qm}"] = r = run_cluster_cmd(
                    cli, cluster_args(run, paths, out, tmp), device, probe)
            finally:
                os.environ.pop("METAEUK_QM", None)
            report_cluster_run(f"{run} (METAEUK_QM={qm})", r)
            done[qm] = (r["hits"], cluster_digests(run, out, tmp))
            print(f"{run} (METAEUK_QM={qm}): counts "
                  f"{json.dumps(done[qm][1][0])}", flush=True)
        (h_auto, d_auto), (h_off, d_off) = done["auto"], done["off"]
        if len(h_auto) != len(h_off):
            raise AssertionError(f"{run}: the routings made different "
                                 "numbers of SearchDriver.search calls")
        for i, (a, b) in enumerate(zip(h_auto, h_off)):
            same_hits(np, a, b, f"{run}, align step {i}")
        if d_auto != d_off:
            raise AssertionError(f"{run}: outputs differ between the "
                                 "routings")
        print(f"{run} on the whole slice: hits of every align step and "
              "every output equal under the default routing and "
              "METAEUK_QM=off", flush=True)
        got[f"{run}_full"] = d_auto
        check(f"{run}_full", d_auto, f"{run} on the whole slice")
    return records, got


# the host stages of the multihit family that phase 5i times, in call
# order: (module or class of the port, attribute, stage)
def multihit_stage_specs():
    from metaeuk_tpu_torch import cli
    from metaeuk_tpu_torch.pipeline import (dbtools2, dbtools3, dbtools5,
                                            filterdb, multihit)
    from metaeuk_tpu_torch.search import align_module, driver, searchdb
    return ((cli, "cmd_createdb", "createdb"),
            (cli, "cmd_dbtool", "tsv2db"),
            (cli, "cmd_extractorfs", "extractorfs"),
            (cli, "cmd_translatenucs", "translatenucs"),
            (cli, "cmd_dbtool2", "orftocontig"),
            (filterdb, "filterdb", "filterdb"),
            (dbtools2, "swapdb", "swapdb"),
            (dbtools3, "result2stats", "result2stats"),
            (searchdb, "prefilter_db", "prefilter"),
            (align_module, "align_db", "align"),
            (driver.SearchDriver, "search", "SearchDriver.search"),
            (multihit, "besthitperset", "besthitperset"),
            (dbtools5, "mergeresultsbyset", "mergeresultsbyset"))


def check_multihit_slice(np, cli, td, device, probe=contextlib.nullcontext,
                         run="whole"):
    """Phase 5i: make_multihit_slice.py's set files (the run's sets: "whole"
    all 35, "cut" the first 12, "rehearsal" the first 3) under td on
    `device`: multihitdb over them, then multihitsearch of the set DB
    against itself at the default routing and under METAEUK_QM=off; the hit
    arrays and every output equal between the routings, and the counts and
    digests equal tests/golden/multihit_slice.json's run. Each command
    reported by report_cluster_run (multihitdb by its steps). Returns {run:
    its record}."""
    import make_multihit_slice as mms
    from metaeuk_tpu_torch.io.mmseqsdb import read_db
    golden = json.loads((GOLDEN / "multihit_slice.json").read_text())
    if golden["input"] != mms.MULTIHIT_SLICE:
        raise AssertionError("multihit_slice.json was made from another "
                             "input than make_multihit_slice.MULTIHIT_SLICE")
    t0 = time.perf_counter()
    sets = mms.multihit_slice(mms.MULTIHIT_SLICE, td,
                              mms.MULTIHIT_SLICE[mms.RUNS[run]])
    print(f"generated {len(sets)} set files in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    db = td / "mhdb"
    records = {"multihitdb": run_timed_cmd(
        cli, ["multihitdb", *sets, db, td / "dbtmp"],
        multihit_stage_specs())}
    r = records["multihitdb"]
    print(f"multihitdb: wall {r['wall']:.3f} s; seconds by step, in call "
          "order: " + "; ".join(f"{'  ' * d}{stage} {s:.3f}"
                                for stage, d, s in r["steps"]), flush=True)
    done = {}
    for qm in ("auto", "off"):
        tmp, out = td / f"tmp_{qm}", td / f"res_{qm}"
        if qm == "off":
            os.environ["METAEUK_QM"] = qm
        try:
            records[f"multihitsearch QM {qm}"] = r = run_timed_cmd(
                cli, ["multihitsearch", db, db, out, tmp, "--device",
                      device], multihit_stage_specs(), probe)
        finally:
            os.environ.pop("METAEUK_QM", None)
        report_cluster_run(f"multihitsearch (METAEUK_QM={qm})", r)
        done[qm] = (r["hits"], mms.summary(db, tmp, out, read_db))
        print(f"multihitsearch (METAEUK_QM={qm}): counts "
              f"{json.dumps(done[qm][1][0])}", flush=True)
    (h_auto, s_auto), (h_off, s_off) = done["auto"], done["off"]
    if len(h_auto) != len(h_off):
        raise AssertionError("multihitsearch: the routings made different "
                             "numbers of SearchDriver.search calls")
    for a, b in zip(h_auto, h_off):
        same_hits(np, a, b, "multihitsearch")
    if s_auto != s_off:
        raise AssertionError("multihitsearch: outputs differ between the "
                             "routings")
    if s_auto != (golden["counts"][run], golden["sha256"][run]):
        raise AssertionError(f"the multihit slice ({run}) differs from "
                             "multihit_slice.json")
    print(f"multihit slice ({run}, {len(sets)} sets): hits and outputs equal "
          "under the default routing and METAEUK_QM=off; counts and the "
          f"digests of {len(s_auto[1])} DBs equal multihit_slice.json",
          flush=True)
    return records


# phase 5j: the search request the server answers on the search slice
# (easy_search's alignment at its defaults)
SERVER_SEARCH = dict(evalue=1e-3, alignment_mode=3)


def serve_child(td, target_db, sock, warmup, device):
    """Phase 5j's server (`python3 chip_smoke.py --serve DIR TARGET_DB
    SOCKET WARMUP DEVICE`): the port's `gpuserver` through its CLI, with
    each prefilter and search request bracketed (one at a time) by the
    counts set to 0, CUDA events around each SW launch and pair_routes;
    appends each request's record to DIR/requests.jsonl: its op, out_db,
    seconds, launches, plain calls, kernel ms (event_ms), the driver's
    cells and the pairs and cells by route (on the CPU the plain versions'
    calls stand in for the launches, with no events). Returns the CLI's
    exit code."""
    import threading

    import torch
    sys.path.insert(0, str(ROOT))
    from metaeuk_tpu_torch import cli, server
    from metaeuk_tpu_torch.ops import sw_cuda, ungapped_cuda
    from metaeuk_tpu_torch.search import driver, prefilter
    counters = (sw_cuda, ungapped_cuda)
    handle, lock = server.TpuSearchServer.handle, threading.Lock()
    on_card = device == "cuda"

    def recorded(self, req):
        if req.get("op") not in ("prefilter", "search"):
            return handle(self, req)
        with lock:
            ctx = probe_run(torch, counters, driver, prefilter, sw_cuda) \
                if on_card else contextlib.nullcontext({})
            with ctx as rec, pair_routes(driver, sw_cuda) as routes:
                if not on_card:
                    for c in counters:
                        c.reset_counts()
                for k in driver.CELLS:
                    driver.CELLS[k] = 0
                t0 = time.perf_counter()
                resp = handle(self, req)
                seconds = time.perf_counter() - t0
            if not on_card:
                rec["events"] = {}
                rec["launches"] = counts(counters)[1]
                rec["plain"] = dict.fromkeys(rec["launches"], 0)
            with open(pathlib.Path(td) / "requests.jsonl", "a") as f:
                f.write(json.dumps(dict(
                    op=req["op"], out_db=req.get("out_db"), seconds=seconds,
                    launches=rec["launches"], plain=rec["plain"],
                    kernel_ms=event_ms(rec["events"]),
                    cells=dict(driver.CELLS), routes=routes)) + "\n")
        return resp
    server.TpuSearchServer.handle = recorded
    return cli.main(["gpuserver", target_db, "--socket", sock, "--warmup",
                     warmup, "--device", device])


def check_server_slice(td, queries, targets, device, want=None):
    """Phase 5j: the query and target FASTAs as easy_search's DBs under td;
    serve_child over the targets with --warmup 0 (startup, ping, shutdown),
    then with --warmup 1: ping, a prefilter and a search (SERVER_SEARCH)
    of the queries, the search's result equal to `want` (digests; None:
    the port's direct search_db on `device`) and its prefilter equal to the
    search's own, the same search again, then two at once to other DBs,
    both equal to the first; shutdown, exit 0, the socket gone. Prints the
    startup and request seconds and reports the first search's kernels.
    Returns {"startup": {warmup: seconds}, "requests": [records]}."""
    from concurrent.futures import ThreadPoolExecutor as Pool

    from metaeuk_tpu_torch.search import searchdb
    from metaeuk_tpu_torch.server import client_request
    td.mkdir(parents=True, exist_ok=True)
    q = searchdb._ensure_seqdb(str(queries), str(td / "query"))
    t = searchdb._ensure_seqdb(str(targets), str(td / "target"))
    sock = str(td / "srv.sock")

    def request(op, **kw):
        resp = client_request(sock, dict(op=op, **kw))
        if not resp.get("ok"):
            raise AssertionError(f"server {op}: {resp}")
        return resp

    def search(name):
        return request("search", query_db=q, out_db=str(td / name),
                       tmp=str(td / f"{name}_tmp"), **SERVER_SEARCH)
    startup, records = {}, []
    for warmup in ("0", "1"):
        log = td / f"server_w{warmup}.log"
        with server_process([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--serve", str(td), t, sock, warmup,
                             str(device)], sock, log) as (proc, secs):
            startup[warmup] = secs
            print(f"gpuserver --warmup {warmup} on {device}: listening "
                  f"after {secs:.2f} s", flush=True)
            request("ping")
            if warmup == "1":
                request("prefilter", query_db=q, out_db=str(td / "pref"))
                for name in ("first", "second"):
                    t0 = time.perf_counter()
                    search(name)
                    print(f"search request {name}: "
                          f"{time.perf_counter() - t0:.3f} s at the client",
                          flush=True)
                t0 = time.perf_counter()
                with Pool(2) as ex:
                    for f in [ex.submit(search, n) for n in ("c1", "c2")]:
                        f.result()
                print(f"two search requests at once: "
                      f"{time.perf_counter() - t0:.3f} s at the client",
                      flush=True)
            stop_server(proc, sock, request)
        print(log.read_text()[-2000:], flush=True)
    records = [json.loads(ln) for ln in
               (td / "requests.jsonl").read_text().splitlines()]
    first = next(r for r in records if r["op"] == "search")
    print(f"the first search request: {first['seconds']:.3f} s; cells "
          f"{json.dumps(first['cells'])}; pairs and cells by route and "
          "pass " + json.dumps(first["routes"]))
    report_kernels("the first search request", first["kernel_ms"],
                   first["routes"], first, ())
    for r in records:
        print(f"{r['op']} request to {pathlib.Path(r['out_db']).name}: "
              f"{r['seconds']:.3f} s in the server", flush=True)
    same_db(td / "pref", td / "first_tmp" / "pref_0")
    for name in ("second", "c1", "c2"):
        same_db(td / name, td / "first")
    if want is None:
        searchdb.search_db(q, t, str(td / "direct"), str(td / "direct_tmp"),
                           device=device, **SERVER_SEARCH)
        want = {s: sha256(f"{td / 'direct'}{s}") for s in DB_SUFFIXES}
    if {s: sha256(f"{td / 'first'}{s}") for s in DB_SUFFIXES} != want:
        raise AssertionError("the server's search differs from its "
                             "reference")
    print(f"server on {device}: the prefilter equal to the search's own, "
          "the search equal to its reference, the second and the two "
          "concurrent searches equal to the first; shutdown with exit 0 "
          "and its socket gone", flush=True)
    return {"startup": startup, "requests": records}


def qm_edge_tiles(np, rng, Lq, Lt):
    """pair_edge_batch's pairs as query-major tiles: the pairs' queries and
    targets are the staged rows, and tile k aligns query k against its own
    target k in lane 37 k % 128 and against other targets of the batch in
    lanes up to a random count (the rest padding lanes, some between live
    ones); then a tile of padding lanes only and a padding tile (qidx -1)
    with live lanes. Returns the numpy arrays (q, qb, ql, t, tl, qidx, lj)
    and, per lane, pair_edge_batch's expectation (None for other lanes)."""
    (q, qb, ql, t, tl), expect = pair_edge_batch(np, rng, Lq, Lt)
    B, TB = len(expect), 128
    qidx = np.arange(B + 2, dtype=np.int32) % B
    qidx[-1] = -1
    lj = np.full((B + 2, TB), -1, np.int32)
    lane_expect = [None] * ((B + 2) * TB)
    for k in range(B):
        live = int(rng.integers(1, TB + 1))
        lj[k, :live] = rng.integers(0, B, live)
        at = 37 * k % TB
        lj[k, at] = k
        lane_expect[k * TB + at] = expect[k]
    lj[-1, :64] = rng.integers(0, B, 64)
    return (q, qb, ql, t, tl, qidx, lj.reshape(-1)), lane_expect


def qm_cap_tiles(np, rng, Lq, Lt, n):
    """Two query-major tiles at (Lq, Lt) in which H passes 32767: query 0
    holds a run of n residues of W and C (bias 0) from row 100, target 0 the
    same run from column 50, target 1 the run's first half; query 1 and the
    other targets are random. Returns the numpy arrays (q, qb, ql, t, tl,
    qidx, lj)."""
    from metaeuk_tpu_torch.data.submat import encode_aa
    W, C = (int(encode_aa(r)[0]) for r in (b"W", b"C"))
    q = rng.integers(0, 20, (2, Lq))
    qb = rng.integers(-3, 4, (2, Lq))
    t = rng.integers(0, 20, (8, Lt))
    run = rng.choice([W, C], n)
    q[0, 100:100 + n], qb[0, 100:100 + n] = run, 0
    t[0, 50:50 + n] = run
    t[1, 7:7 + n // 2] = run[:n // 2]
    ql = np.array([n + 200, Lq // 8])
    tl = np.array([n + 150, n // 2 + 20, *rng.integers(1, Lt + 1, 6)])
    lj = np.full((2, 128), -1, np.int32)
    lj[0, :8] = np.arange(8)
    lj[1, 3:40] = rng.integers(0, 8, 37)
    return (q, qb, ql, t, tl, np.arange(2, dtype=np.int32), lj.reshape(-1))


def lane_lengths(torch, q_lens, t_lens, qidx, lj, Lq, Lt):
    """Each query-major lane's (query length, target length), (n_tiles *
    128,) int32 each, cut to (Lq, Lt); (0, 0) on a padding lane (lj < 0) or
    tile (qidx < 0), as the K3/K4 kernels read them."""
    qi, tj = qidx.long().repeat_interleave(128), lj.long()
    ok = ((qi >= 0) & (qi < len(q_lens)) & (tj >= 0) & (tj < len(t_lens)))
    n = torch.where(ok, q_lens[qi.clamp(0, max(len(q_lens) - 1, 0))], 0)
    m = torch.where(ok, t_lens[tj.clamp(0, max(len(t_lens) - 1, 0))], 0)
    return n.clamp(0, Lq).int(), m.clamp(0, Lt).int()


def check_qm_edges(torch, sw_cuda, sw_torch, errs):
    """K3/K4 on qm_edge_tiles at QM_EDGE_WIDTH, against the plain versions
    and the planted cells, K4 from the forward ends, over each lane's whole
    matrix and from random ends (-1 and past the lengths); then on
    qm_cap_tiles at QM_CAP_SHAPE, where the cap binds."""
    import numpy as np
    rng = np.random.default_rng(20260826)
    Lq = Lt = QM_EDGE_WIDTH
    arrays, expect = qm_edge_tiles(np, rng, Lq, Lt)
    cap_Lq, cap_Lt, cap_n = QM_CAP_SHAPE
    cases = [(arrays, expect, Lq, Lt),
             (qm_cap_tiles(np, rng, cap_Lq, cap_Lt, cap_n), None, cap_Lq,
              cap_Lt)]
    for arrays, expect, Lq, Lt in cases:
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            device="cuda", dtype=dt) for a, dt in zip(arrays, (
                torch.uint8, torch.int8, torch.int32, torch.uint8,
                torch.int32, torch.int32, torch.int32)))
        B = args[6].shape[0]
        got = sw_cuda.qm_ends(*args)
        torch.cuda.synchronize()
        ref = sw_torch.qm_ends(*args)
        errs["sw_qm_ends"] = max(errs["sw_qm_ends"], max_err(torch, got, ref))
        whole = tuple(w - 1 for w in lane_lengths(
            torch, args[2], args[4], args[5], args[6], Lq, Lt))
        ends = [(torch.clamp_min(ref[1], 0), torch.clamp_min(ref[2], 0)),
                whole,
                tuple(torch.from_numpy(rng.integers(-1, w + 2, B)).int()
                      .cuda() for w in (Lq, Lt))]
        starts = []
        for qe, te in ends:
            got = sw_cuda.qm_starts(*args, qe, te)
            torch.cuda.synchronize()
            starts.append(sw_torch.qm_starts(*args, qe, te))
            errs["sw_qm_starts"] = max(errs["sw_qm_starts"],
                                       max_err(torch, got, starts[-1]))
        if not torch.equal(ref[0], starts[0][0]):
            raise AssertionError("reverse score differs from forward best")
        if expect is None:
            if int(ref[0][0]) != 32767:
                raise AssertionError(f"cap run scored {int(ref[0][0])}, "
                                     "not the cap 32767")
            print(f"query-major cap run Lq={Lq} Lt={Lt}: a {cap_n}-aa "
                  "self-match scores 32767, ends at row "
                  f"{int(ref[1][0])}, column {int(ref[2][0])}; ends and "
                  "starts equal", flush=True)
            continue
        for b, ex in enumerate(expect):
            have = (tuple(int(ref[k][b]) for k in range(3)),
                    tuple(int(starts[1][k][b]) for k in range(3)))
            if ex is not None and have != ex:
                raise AssertionError(f"planted lane {b}: {have}, expected "
                                     f"{ex}")
        n_ties = sum(e is not None for e in expect)
        print(f"query-major edges Lq={Lq} Lt={Lt}: {B // 128} tiles, ends "
              f"and starts equal; {n_ties} planted lanes as expected "
              f"(scores up to {int(ref[0].max())})", flush=True)


def check_qm_rt_kernels(torch, sw_cuda, sw_torch, errs):
    import numpy as np
    rng = np.random.default_rng(20260823)
    TB = sw_torch.TB
    for Lq, Lt, nq, nt, nT, tq, (lo, hi) in QM_RT_SHAPES:
        tq = tq or sw_torch.TQ_RT
        q, qb, _, t, tl = (a.numpy().copy() for a in staged_batch(
            torch, rng, Lq, Lt, nq, nt, "cpu"))
        ql = rng.integers(lo, hi + 1, nq).astype(np.int32)
        ql[5::13] = 0
        plant_row_tile_ties(q, qb, ql, t, tl, tq, rng)
        col_ties = plant_column_ties(q, qb, ql, t, tl, rng)
        qidx = rng.integers(0, nq, nT).astype(np.int32)
        qidx[:2] = 0                        # query 0's row-tile ties
        qidx[-2] = 1                        # query 1's column ties
        qidx[-1] = -1                       # a padding tile
        lj = rng.integers(0, nt, (nT, TB)).astype(np.int32)
        lj[:, 100:] = -1                    # padding lanes
        lj[1, :] = np.arange(TB) % nt       # every target, repeats included
        lj[2, 5:40] = 1                     # one target many times (ties)
        lj[-2, :len(col_ties)] = list(col_ties)
        args = tuple(torch.from_numpy(a).cuda() for a in (
            q, qb, ql, t, tl, qidx, lj.reshape(-1)))
        got = sw_cuda.qm_ends_rt(*args, tq=tq)
        torch.cuda.synchronize()
        ref = sw_torch.qm_ends_rt(*args, tq=tq)
        errs["sw_qm_rt_ends"] = max(errs["sw_qm_rt_ends"],
                                    max_err(torch, got, ref))
        B = nT * TB
        whole = tuple(torch.full((B,), n - 1, dtype=torch.int32,
                                 device="cuda") for n in (Lq, Lt))
        ends = [(torch.clamp_min(ref[1], 0), torch.clamp_min(ref[2], 0)),
                whole]
        if tq < sw_torch.TQ_RT:   # random ends, past the lengths and -1
            ends.append(tuple(torch.from_numpy(rng.integers(-1, n + 2, B))
                              .int().cuda() for n in (Lq, Lt)))
        starts = []
        for k, (qe, te) in enumerate(ends):
            got = sw_cuda.qm_starts_rt(*args, qe, te, tq=tq)
            torch.cuda.synchronize()
            starts.append(sw_torch.qm_starts_rt(*args, qe, te, tq=tq))
            errs["sw_qm_rt_starts"] = max(errs["sw_qm_rt_starts"],
                                          max_err(torch, got, starts[-1]))
            if k == 0 and not torch.equal(ref[0], starts[-1][0]):
                raise AssertionError("reverse score differs from forward "
                                     "best")
        base = (nT - 2) * TB
        for lane, (k, (fwd, rev)) in enumerate(col_ties.items()):
            b = base + lane
            got_fwd = (int(ref[1][b]), int(ref[2][b]))
            got_rev = (int(starts[1][1][b]), int(starts[1][2][b]))
            if int(ref[0][b]) != 9 or got_fwd != fwd or got_rev != rev:
                raise AssertionError(
                    f"column tie of target {k}: score {int(ref[0][b])}, end "
                    f"{got_fwd}, start {got_rev}; expected 9, {fwd}, {rev}")
        tie = [int(ref[k][TB]) for k in range(3)]   # tile 1, lane 0: target 0
        print(f"long-query Lq={Lq} Lt={Lt} tiles={nT} (plain row tile {tq}),"
              f" query lengths up to {int(ql.max())}: ends and starts equal "
              f"({int((ref[0] > 0).sum())} lanes with a hit; planted row-tile"
              f" tie won at row {tie[1]}, column {tie[2]}, score {tie[0]}; "
              f"{len(col_ties)} column-boundary ties as expected)", flush=True)


def check_gapless_kernel(torch, ungapped_cuda, ungapped_torch, errs):
    import numpy as np
    rng = np.random.default_rng(20260822)
    for Lq, Lt, nq, nt in GAPLESS_SHAPES:
        staged = staged_batch(torch, rng, Lq, Lt, nq, nt, "cuda")
        # the prefilter's query-major cross product, then seeded pairs with
        # out-of-range indices (score 0)
        flat = torch.arange(nq * nt, device="cuda")
        pairs = [((flat // nt).int(), (flat % nt).int()),
                 tuple(torch.from_numpy(rng.integers(-1, n + 1, 4096))
                       .int().cuda() for n in (nq, nt))]
        name = ungapped_cuda.kernel_for(Lq)
        for li, lj in pairs:
            got = ungapped_cuda.gapless_scores_gathered(*staged, li, lj)
            torch.cuda.synchronize()
            ref = ungapped_torch.gapless_gathered(*staged, li, lj)
            errs[name] = max(errs[name], max_err(torch, (got,), (ref,)))
        print(f"gapless Lq={Lq} Lt={Lt} pairs={nq * nt}: {name} equal "
              f"(best {int(ref.max())})", flush=True)
    check_gapless_pairs(torch, ungapped_cuda, ungapped_torch, errs)


def plant_band_runs(np, rng, q, qb, ql, t, tl, plants):
    """Plants in place, on query rows nq - 8 .. nq - 5 against targets nt -
    8 .. nt - 5 of staged numpy matrices (row k against target k, on
    cross_gapless_rows's quiet background: residues other than W and C,
    bias -9), a run of 24 residues (Lq 32: 16) on a diagonal d with d & 3
    == k, k = 0 .. 3 (each lane of gapless_pair's band of four diagonals),
    from a row i0 with i0 & 3 == (k + 1) & 3, so that it crosses groups of
    four rows out of step; adds {(row, target): its self-score} to plants.
    Needs Lq >= 32, Lt >= 64 and nq, nt >= 8."""
    from metaeuk_tpu_torch.data.submat import BLOSUM62_SCORES, encode_aa
    W, C = (int(encode_aa(r)[0]) for r in (b"W", b"C"))
    quiet = np.array([a for a in range(20) if a not in (W, C)])
    (nq, Lq), (nt, Lt) = q.shape, t.shape
    L = min(24, Lq // 2)
    for k in range(4):
        r, c = nq - 8 + k, nt - 8 + k
        q[r], qb[r], t[c] = rng.choice(quiet, Lq), -9, rng.choice(quiet, Lt)
        ql[r], tl[c] = Lq, Lt
        i0 = 4 + ((k + 1) & 3)
        j0 = i0 + 12 + k
        seg = rng.integers(0, 20, L)
        q[r, i0:i0 + L], qb[r, i0:i0 + L] = seg, 0
        t[c, j0:j0 + L] = seg
        plants[(r, c)] = int(sum(BLOSUM62_SCORES[a, a] for a in seg))


def gapless_pair_lists(np, rng, nq, nt):
    """{name: (li, lj)} int32 pair lists over nq query rows and nt (over
    128) targets: the cross product query by query ("cross"); the same with
    every fifth pair repeated, shuffled ("shuffled"); seeded indices from
    -1 to nq + 1 and nt + 1 ("out_of_range"); query 0's one pair beside
    query 3 against every target and 40 repeats, more pairs than a block's
    128 threads, shuffled ("one_and_many")."""
    flat = np.arange(nq * nt)
    li, lj = flat // nt, flat % nt
    at = rng.permutation(np.r_[flat, flat[::5]])
    many = np.r_[np.arange(nt), rng.integers(0, nt, 40)]
    one_li = np.r_[0, np.full(len(many), 3)]
    one_lj = np.r_[rng.integers(0, nt), many]
    sh = rng.permutation(len(one_li))
    lists = {"cross": (li, lj), "shuffled": (li[at], lj[at]),
             "out_of_range": (rng.integers(-1, nq + 2, 4096),
                              rng.integers(-1, nt + 2, 4096)),
             "one_and_many": (one_li[sh], one_lj[sh])}
    return {k: (a.astype(np.int32), b.astype(np.int32))
            for k, (a, b) in lists.items()}


def check_gapless_pairs(torch, ungapped_cuda, ungapped_torch, errs):
    """gapless_pair against the plain version at GAPLESS_PAIR_SHAPES (the
    short-row widths 32, 64, 128 and 512) on cross_gapless_rows's planted
    matrices (zero-length row 1 and target 2, repeated targets, the first
    and last diagonals' single cells, runs ending at q_len - 1 and t_len -
    1 with padding that would extend them) plus plant_band_runs' runs on
    each lane of a band of four diagonals, through every list of
    gapless_pair_lists, at the wrapper's layout (these launches are small:
    each pair's bands dealt over 8-32 threads) and with a thread a pair
    (ungapped_cuda.PAIR_LAUNCH_THREADS 0); each call must go to
    gapless_pair, and the cross list's planted pairs must score their
    plants."""
    import numpy as np
    rng = np.random.default_rng(20261018)
    mk = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device="cuda", dtype=dt)
    for Lq, Lt, nq, nt in GAPLESS_PAIR_SHAPES:
        q, qb, ql, t, tl, plants = cross_gapless_rows(np, rng, Lq, Lt, nq, nt)
        plant_band_runs(np, rng, q, qb, ql, t, tl, plants)
        args = (mk(q, torch.uint8), mk(qb, torch.int8), mk(ql, torch.int32),
                mk(t, torch.uint8), mk(tl, torch.int32))
        sizes, threads = {}, ungapped_cuda.PAIR_LAUNCH_THREADS
        for name, (li, lj) in gapless_pair_lists(np, rng, nq, nt).items():
            li, lj = mk(li, torch.int32), mk(lj, torch.int32)
            ref = ungapped_torch.gapless_gathered(*args, li, lj)
            for launch_threads in (threads, 0):
                ungapped_cuda.PAIR_LAUNCH_THREADS = launch_threads
                before = ungapped_cuda.LAUNCHES["gapless_pair"]
                try:
                    got = ungapped_cuda.gapless_scores_gathered(*args, li, lj)
                finally:
                    ungapped_cuda.PAIR_LAUNCH_THREADS = threads
                torch.cuda.synchronize()
                if ungapped_cuda.LAUNCHES["gapless_pair"] != before + 1:
                    raise AssertionError(f"Lq={Lq} did not go to "
                                         "gapless_pair")
                errs["gapless_pair"] = max(errs["gapless_pair"],
                                           max_err(torch, (got,), (ref,)))
            sizes[name] = len(li)
            if name == "cross":
                scores = {k: int(ref[k[0] * nt + k[1]]) for k in plants}
        if scores != plants:
            raise AssertionError(f"planted scores {scores}, expected "
                                 f"{plants}")
        print(f"gapless_pair Lq={Lq} Lt={Lt} rows={nq} targets={nt}: equal "
              f"on every list {sizes} (planted {scores})", flush=True)


def long_gapless_pairs(np, rng, Lq, Lt, q_lo, q_hi):
    """A per-pair numpy batch (q, qb, ql, t, tl) at a long-row width (q_lo
    at least 400): three
    random pairs sharing a segment (the third of query length 0), then
    pairs on a quiet background (residues other than W and C, bias -9: no
    cell scores above 0) with one planted run each, in this order: the
    single cell of the first diagonal (row q_len - 1, column 0) and of the
    last (row 0, column t_len - 1); a run on the last diagonal of
    gapless_long's first 256-diagonal chunk and one on the first diagonal of
    its second; a run across each column-tile edge (512, 1024) below Lt -
    40; a run scoring over 128 that ends at row q_len - 1, then one that
    ends at column t_len - 1, each with padding past the length that would
    extend it."""
    from metaeuk_tpu_torch.data.submat import encode_aa
    W, C = (int(encode_aa(r)[0]) for r in (b"W", b"C"))
    quiet = np.array([a for a in range(20) if a not in (W, C)])
    edges = [e for e in (512, 1024) if e + 40 <= Lt]
    plants = ["first", "last", "chunk_end", "chunk_start",
              *(f"tile {e}" for e in edges), "row_end", "col_end"]
    B = 3 + len(plants)
    q = rng.integers(0, 20, (B, Lq))
    qb = rng.integers(-3, 4, (B, Lq))
    t = rng.integers(0, 20, (B, Lt))
    ql = rng.integers(q_lo, q_hi + 1, B)
    tl = rng.integers(Lt - Lt // 16, Lt + 1, B)
    ql[2] = 0
    for b in range(3):
        n = min(200, int(tl[b]) - 5)
        t[b, 5:5 + n] = q[b, 100:100 + n]
    ext = min(50, Lt // 5)   # padding that would extend a run
    for b, plant in enumerate(plants, start=3):
        q[b], qb[b], t[b] = rng.choice(quiet, Lq), -9, rng.choice(quiet, Lt)
        if plant == "row_end":
            ql[b] = min(ql[b], Lq - ext)
        if plant == "col_end":
            tl[b] = Lt - ext
        if plant.startswith("tile"):
            tl[b] = max(tl[b], int(plant.split()[1]) + 40)
        m, n = int(ql[b]), int(tl[b])

        def put(i0, j0, seg):
            q[b, i0:i0 + len(seg)], qb[b, i0:i0 + len(seg)] = seg, 0
            t[b, j0:j0 + len(seg)] = seg
        if plant == "first":
            put(m - 1, 0, [W])
        elif plant == "last":
            put(0, n - 1, [W])
        elif plant.startswith("chunk"):
            # diagonal d = 1 - m + 255 (or 256) meets column 0 at row -d
            put(m - 256 - (plant == "chunk_start"), 0, rng.integers(0, 20, 40))
        elif plant.startswith("tile"):
            put((m - 200) // 2, int(plant.split()[1]) - 40,
                rng.integers(0, 20, 80))
        elif plant == "row_end":
            L = min(150, n - ext)
            put(m - L, 0, rng.integers(0, 20, L))
            put(m, L, rng.integers(0, 20, ext))
        else:
            L, r0 = min(150, n), (m - 200) // 2
            put(r0, n - L, rng.integers(0, 20, L))
            put(r0 + L, n, rng.integers(0, 20, ext))
    return q, qb, ql, t, tl


def cross_gapless_rows(np, rng, Lq, Lt, nq, nt):
    """Staged numpy matrices (q, qb, ql, t, tl) for a cross product of nq
    query rows (at least 6) and nt targets (at least 9) at a short-row
    width, and {(row, target): score} of its planted pairs. Random rows and
    targets with ragged lengths, shared segments (real hits), row 1 and
    target 2 of length 0 and targets that repeat target 0; then the last
    four rows and targets on a quiet background (residues other than W and
    C, bias -9: no cell scores above 0), each pair with one plant: the
    single cell of the first diagonal (row q_len - 1, column 0) and of the
    last (row 0, column t_len - 1), scoring W-W (11); a run that ends at row
    q_len - 1 and one that ends at column t_len - 1, each with padding past
    the length that would extend it, scoring its self-score."""
    from metaeuk_tpu_torch.data.submat import BLOSUM62_SCORES, encode_aa
    W, C = (int(encode_aa(r)[0]) for r in (b"W", b"C"))
    quiet = np.array([a for a in range(20) if a not in (W, C)])
    q = rng.integers(0, 20, (nq, Lq))
    qb = rng.integers(-3, 4, (nq, Lq))
    ql = rng.integers(1, Lq + 1, nq)
    t = rng.integers(0, 20, (nt, Lt))
    tl = rng.integers(1, Lt + 1, nt)
    ql[1], tl[2] = 0, 0
    for k in range(3, nt - 4, 4):
        qi = k % (nq - 4)
        n = int(min(ql[qi], tl[k] - 3, 60))
        if n > 0:
            t[k, 3:3 + n] = q[qi, :n]
    t[4:nt - 4:5], tl[4:nt - 4:5] = t[0], tl[0]
    L = max(2, min(150, Lq // 3, Lt // 3))   # a planted run
    ext = max(1, min(50, L // 3))            # padding that would extend it
    plants = {}
    for k, plant in enumerate(("first", "last", "row_end", "col_end")):
        r, c = nq - 4 + k, nt - 4 + k
        q[r], qb[r], t[c] = rng.choice(quiet, Lq), -9, rng.choice(quiet, Lt)
        ql[r] = rng.integers(max(1, Lq // 2), Lq + 1)
        tl[c] = rng.integers(max(1, Lt // 2), Lt + 1)
        if plant == "row_end":
            ql[r] = Lq - ext
        if plant == "col_end":
            tl[c] = Lt - ext
        m, n = int(ql[r]), int(tl[c])
        seg = rng.integers(0, 20, L)

        def put(i0, j0, s):
            q[r, i0:i0 + len(s)], qb[r, i0:i0 + len(s)] = s, 0
            t[c, j0:j0 + len(s)] = s
        if plant in ("first", "last"):
            put(m - 1 if plant == "first" else 0,
                0 if plant == "first" else n - 1, [W])
            plants[(r, c)] = int(BLOSUM62_SCORES[W, W])
            continue
        if plant == "row_end":
            put(m - L, 0, seg)
            put(m, L, rng.integers(0, 20, ext))
        else:
            put(0, n - L, seg)
            put(L, n, rng.integers(0, 20, ext))
        plants[(r, c)] = int(sum(BLOSUM62_SCORES[a, a] for a in seg))
    return q, qb, ql, t, tl, plants


def check_gapless_rows(torch, ungapped_cuda, ungapped_torch, errs):
    """gapless_rows against the plain version at GAPLESS_SHAPES' short-row
    buckets, through the cross entry, on the planted matrices of
    cross_gapless_rows with a target block narrower than a block's 32
    columns and one as wide as the shape's; the whole cross product, then
    rows 1..nq - 1; each call must go to gapless_rows."""
    import numpy as np
    rng = np.random.default_rng(20260825)
    mk = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device="cuda", dtype=dt)
    for Lq, Lt, nq, nt in GAPLESS_SHAPES:
        if ungapped_cuda.kernel_for(Lq, cross=True) != "gapless_rows":
            continue
        for n_t in (20, nt):
            q, qb, ql, t, tl, plants = cross_gapless_rows(np, rng, Lq, Lt,
                                                          nq, n_t)
            args = (mk(q, torch.uint8), mk(qb, torch.int8),
                    mk(ql, torch.int32), mk(t, torch.uint8),
                    mk(tl, torch.int32))
            for r0, r1 in ((0, nq), (1, nq - 1)):
                before = ungapped_cuda.LAUNCHES["gapless_rows"]
                got = ungapped_cuda.gapless_scores_cross(*args, r0, r1)
                torch.cuda.synchronize()
                if ungapped_cuda.LAUNCHES["gapless_rows"] != before + 1:
                    raise AssertionError(f"Lq={Lq} did not go to "
                                         "gapless_rows")
                flat = torch.arange((r1 - r0) * n_t, device="cuda")
                ref = ungapped_torch.gapless_gathered(
                    *args, r0 + flat // n_t, flat % n_t).view(r1 - r0, n_t)
                errs["gapless_rows"] = max(errs["gapless_rows"],
                                           max_err(torch, (got,), (ref,)))
                if r0 == 0:
                    scores = {k: int(ref[k]) for k in plants}
            if scores != plants:
                raise AssertionError(f"planted scores {scores}, expected "
                                     f"{plants}")
            print(f"gapless_rows Lq={Lq} Lt={Lt} rows={nq} targets={n_t}: "
                  f"equal (best {int(ref.max())}; planted {scores})",
                  flush=True)


def check_gapless_long(torch, ungapped_cuda, ungapped_torch, errs):
    """gapless_long against the plain version at the long-row buckets: the
    planted pairs of long_gapless_pairs, then a staged cross product with
    seeded pairs whose indices are out of range; each call must go to
    gapless_long."""
    import numpy as np
    rng = np.random.default_rng(20260824)
    mk = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device="cuda", dtype=dt)
    for Lq, Lt, (q_lo, q_hi), nq, nt in GAPLESS_LONG_SHAPES:
        q, qb, ql, t, tl = long_gapless_pairs(np, rng, Lq, Lt, q_lo, q_hi)
        planted = (mk(q, torch.uint8), mk(qb, torch.int8),
                   mk(ql, torch.int32), mk(t, torch.uint8),
                   mk(tl, torch.int32))
        pairs = torch.arange(len(q), device="cuda", dtype=torch.int32)
        staged = staged_batch(torch, rng, Lq, Lt, nq, nt, "cuda")
        staged = (staged[0], staged[1], mk(rng.integers(q_lo, q_hi + 1, nq),
                                           torch.int32), *staged[3:])
        flat = torch.arange(nq * nt, device="cuda")
        oor = tuple(torch.from_numpy(rng.integers(-1, n + 1, 512)).int()
                    .cuda() for n in (nq, nt))
        for args, li, lj in ((planted, pairs, pairs),
                             (staged, (flat // nt).int(), (flat % nt).int()),
                             (staged, *oor)):
            before = ungapped_cuda.LAUNCHES["gapless_long"]
            got = ungapped_cuda.gapless_scores_gathered(*args, li, lj)
            torch.cuda.synchronize()
            if ungapped_cuda.LAUNCHES["gapless_long"] != before + 1:
                raise AssertionError(f"Lq={Lq} did not go to gapless_long")
            ref = ungapped_torch.gapless_gathered(*args, li, lj)
            errs["gapless_long"] = max(errs["gapless_long"],
                                       max_err(torch, (got,), (ref,)))
            if args is planted:
                scores = ref.tolist()
        if min(scores[-2:]) <= 128:
            raise AssertionError("the runs ending at q_len - 1 and t_len - 1 "
                                 "should score over 128")
        print(f"gapless_long Lq={Lq} Lt={Lt}: equal on {len(q)} planted "
              f"pairs (scores {scores}) and {nq * nt} staged pairs plus 512 "
              "with indices out of range", flush=True)


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(cells, ops_per_cell, tensors):
    """(bound_ms, bound_by): the larger of the operations over the int32
    rate and the bytes of every input and output (each moved once) over the
    memory rate."""
    ops_ms = cells * ops_per_cell / INT32_OPS_PER_S * 1e3
    byte_ms = sum(t.numel() * t.element_size() for t in tensors) \
        / BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= byte_ms else \
        (byte_ms, "bytes")


def sha256(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def digests(prefix):
    return {s: sha256(f"{prefix}.{s}") for s in SUFFIXES}


def reset(torch, counters, driver, prefilter):
    for c in counters:
        c.reset_counts()
    for k in driver.CELLS:
        driver.CELLS[k] = 0
    driver.PHASE_SECONDS.clear()
    prefilter.CELLS["gapless"] = 0
    prefilter.CELLS_BY_LQ.clear()
    torch.cuda.synchronize()


def counts(counters):
    launches, plain = {}, {}
    for c in counters:
        launches.update(c.LAUNCHES)
        plain.update(c.PLAIN_CALLS)
    return launches, plain


@contextlib.contextmanager
def probe_run(torch, counters, driver, prefilter, sw_cuda):
    """Brackets one run: the counts set to 0 before it, CUDA events around
    each SW launch (launch_events), the counts read after a synchronise;
    yields the record {"events", "launches", "plain"}, filled at exit."""
    reset(torch, counters, driver, prefilter)
    rec = {}
    with launch_events(torch, sw_cuda) as events:
        yield rec
        torch.cuda.synchronize()
    rec["events"] = events
    rec["launches"], rec["plain"] = counts(counters)


# each SW kernel's (route, pass) in pair_routes' tally
KERNEL_ROUTES = {"sw_pair_ends": ("pair", "fwd"),
                 "sw_pair_starts": ("pair", "rev"),
                 "sw_qm_ends": ("query-major", "fwd"),
                 "sw_qm_starts": ("query-major", "rev"),
                 "sw_pair_ends_nocap": ("realign", "fwd"),
                 "sw_pair_starts_nocap": ("realign", "rev")}


def report_search_run(run, r, need=PAIR_KERNELS):
    """Prints one run of phase 5e (or 5f): wall, stage, align-phase and
    realign seconds, pairs and cells by route, each SW kernel's launches and
    summed ms beside its bound; raises unless the run went through `need`
    (K1/K2 by default), the
    uncapped instances in the realign run and each of K1-K4 wherever the
    routing sent pairs (and nowhere else), with no plain version called."""
    rec, routes = r["probe"], r["routes"]
    print(f"{run}: wall {r['wall']:.3f} s")
    print(f"{run}: stage seconds " + json.dumps(r["stages"]))
    print(f"{run}: driver phase seconds " + json.dumps(r["phases"]))
    print(f"{run}: cells {json.dumps(r['cells'])}; pairs and cells by "
          "route and pass " + json.dumps(routes))
    # `need` in every run, the uncapped instances in the realign run
    report_kernels(run, event_ms(rec["events"]), routes, rec, list(need) + (
        list(NOCAP_KERNELS) if run == "align_realign" else []))


def report_kernels(run, ms_by, routes, rec, need):
    """Prints each SW kernel's launches and summed ms (ms_by: event_ms's)
    beside its bound from the cells pair_routes counted on its route, and
    the run's launches and plain calls (rec's); raises unless the run went
    through `need` and each kernel exactly where the routing sent pairs,
    with no plain version called."""
    for k, (n, ms) in ms_by.items():
        route, pas = KERNEL_ROUTES.get(k, (None, None))
        cells = routes.get(route, {}).get(pas, [0, 0])[1]
        ops = NOCAP_SW_OPS if k in NOCAP_KERNELS else SW_OPS
        bound_ms = cells * ops / INT32_OPS_PER_S * 1e3
        print(f"{run}: {k} {n} launches, {ms:.3f} ms of kernel time (CUDA "
              f"events around each launch), {cells} cells, bound "
              f"{bound_ms:.3f} ms (operations; "
              f"{bound_ms / max(ms, 1e-9):.1%} of it)", flush=True)
    print(f"{run}: launches {rec['launches']} plain {rec['plain']}",
          flush=True)
    need = list(need)
    for k, (route, pas) in KERNEL_ROUTES.items():
        routed = routes.get(route, {}).get(pas, [0, 0])[0] > 0
        if routed:
            need.append(k)
        elif rec["launches"][k]:
            raise AssertionError(f"{run}: {k} launched with no pair routed "
                                 "to it")
    if min(rec["launches"][k] for k in need) == 0 or \
            any(rec["plain"].values()):
        raise AssertionError(f"{run} did not go through {sorted(set(need))}")


def fragments(extractor, contigs):
    """The serial path's translated fragments (predict.py predict_exons)."""
    orf_aa = []
    for ci in range(len(contigs)):
        _, frags = extractor.extract_contig(contigs.seq_bytes(ci), ci)
        orf_aa.extend(extractor.translate_fragments(frags))
    return orf_aa


def time_kernels(torch, np, sw_cuda, sw_torch, ungapped_cuda,
                 ungapped_torch, errs):
    """{name: (ms, plain_ms, bound_ms, bound_by)} at main-path shapes; each
    kernel's output there must equal its plain version's (folded into
    errs)."""
    out = {}
    dev = "cuda"
    # pair kernels: lengths between half and all of the tier width
    Lq, Lt, B = TIME_SHAPE
    rng = np.random.default_rng(7)
    args = ragged_batch(torch, rng, Lq, Lt, B, dev)
    args = (*args[:2], torch.from_numpy(rng.integers(
        Lq // 2, Lq + 1, B)).int().cuda(), args[3], torch.from_numpy(
        rng.integers(Lt // 2, Lt + 1, B)).int().cuda())
    out.update(time_pair_kernels(torch, sw_cuda, sw_torch, args, errs))
    out.update(time_pair_kernels(torch, sw_cuda, sw_torch, args, errs,
                                 nocap=True))
    out.update(time_prof_kernels(torch, sw_cuda, sw_torch, args, errs))
    out.update(time_prof_kernels(torch, sw_cuda, sw_torch, args, errs,
                                 nocap=True))
    # the k-mer slice's largest bucket: lengths drawn from its percentiles
    Lq, Lt, B = KMER_PAIR_SHAPE
    pct, q_at, t_at = KMER_PAIR_LENGTHS
    draw = lambda at: torch.from_numpy(np.rint(np.interp(
        rng.uniform(0, 100, B), pct, at))).int().cuda()
    args = ragged_batch(torch, rng, Lq, Lt, B, dev)
    args = (*args[:2], draw(q_at), args[3], draw(t_at))
    time_pair_kernels(torch, sw_cuda, sw_torch, args, errs)

    # query-major kernels at both shapes, then the pair kernels on the same
    # pairs
    rng = np.random.default_rng(8)
    nt = 3000
    for k, (_, *case) in enumerate(qm_time_cases(torch, np, rng, nt)):
        rows, pair_ms = time_qm_kernels(torch, sw_cuda, sw_torch, *case,
                                        errs, plain=k == 0)
        if k == 0:
            out.update(rows)
            same = pair_ms

    out["gapless_pair"] = time_gapless_pair(torch, rng, nt, ungapped_cuda,
                                            ungapped_torch, errs)
    return out, same


def time_gapless_pair(torch, rng, nt, ungapped_cuda, ungapped_torch, errs):
    """(ms, plain_ms, bound_ms, bound_by) of gapless_pair at
    GAPLESS_TIME_SHAPE: the prefilter's cross product of one bucket pair
    (nt targets) as a pair list, query by query (its callers' order); prints
    its ms there and on the same pairs shuffled (the wrapper's sort and
    work list inside the time), both outputs equal to the plain version's,
    beside the bound and the thread-per-pair design's ms."""
    dev = "cuda"
    Lq, Lt, B = GAPLESS_TIME_SHAPE
    nq = B // nt + 1
    staged = staged_batch(torch, rng, Lq, Lt, nq, nt, dev, lo=Lq // 2)
    flat = torch.arange(B, device=dev)
    li, lj = (flat // nt).int(), (flat % nt).int()
    shuffle = torch.from_numpy(rng.permutation(B)).to(dev)
    cells = int((staged[2][li.long()].long()
                 * staged[4][lj.long()].long()).sum())
    ref = ungapped_torch.gapless_gathered(*staged, li, lj)
    best = ungapped_cuda.gapless_scores_gathered(*staged, li, lj)
    shuffled = ungapped_cuda.gapless_scores_gathered(
        *staged, li[shuffle], lj[shuffle])
    errs["gapless_pair"] = max(errs["gapless_pair"], max_err(
        torch, (best, shuffled), (ref, ref[shuffle])))
    ms, kernel_ms = {}, {}
    for k, (a, b) in (("in pair-list order", (li, lj)),
                      ("shuffled", (li[shuffle], lj[shuffle]))):
        call = lambda a=a, b=b: ungapped_cuda.gapless_scores_gathered(
            *staged, a, b)
        ms[k] = time_ms(torch, call, 10)
        with launch_events(torch, ungapped_cuda) as events:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        kernel_ms[k] = event_ms(events)["gapless_pair"][1] / 10
    row = (ms["in pair-list order"],
           time_ms(torch, lambda: ungapped_torch.gapless_gathered(
               *staged, li, lj), 2),
           *bound(cells, GAPLESS_OPS, (*staged, li, lj, best)))
    print(f"gapless_pair pairs={B} Lq={Lq} Lt={Lt}, {cells} cells: "
          + ", ".join(f"{k} {v:.4f} ms ({cells / v * 1e3:.4e} cells/s; the "
                      f"kernel alone {kernel_ms[k]:.4f} ms)"
                      for k, v in ms.items())
          + f"; bound {row[2]:.4f} ms ({row[3]}); the thread-per-pair "
          f"design {GAPLESS_PAIR_THREAD_MS} ms; both outputs equal the "
          "plain version's", flush=True)
    return row


def qm_time_cases(torch, np, rng, nt):
    """[(name, staged matrices, qidx, lj)] of phase 6's query-major shapes
    on the card: QM_TIME_SHAPE (one query per tile, 128 distinct targets
    per tile, lengths between half and all of the tier widths), then
    QM_BUCKET_SHAPE (live lanes, query and target lengths drawn from
    QM_BUCKET_LENGTHS' percentiles); nt staged targets each."""
    TB, dev, out = 128, "cuda", []
    Lq, Lt, nT = QM_TIME_SHAPE
    q, qb, _, t, _ = staged_batch(torch, rng, Lq, Lt, nT, nt, dev, lo=1)
    ql = torch.from_numpy(rng.integers(Lq // 2, Lq + 1, nT)).int().cuda()
    tl = torch.from_numpy(rng.integers(Lt // 2, Lt + 1, nt)).int().cuda()
    lj = np.stack([rng.choice(nt, TB, replace=False) for _ in range(nT)])
    out.append(("QM_TIME_SHAPE", (q, qb, ql, t, tl)))
    lanes = [lj]
    Lq, Lt, nT = QM_BUCKET_SHAPE
    pct, live_at, q_at, t_at = QM_BUCKET_LENGTHS
    draw = lambda at, n: np.rint(np.interp(rng.uniform(0, 100, n), pct,
                                           at)).astype(np.int64)
    q, qb, _, t, _ = staged_batch(torch, rng, Lq, Lt, nT, nt, dev, lo=1)
    lj = np.full((nT, TB), -1)
    for k, live in enumerate(draw(live_at, nT)):
        lj[k, :live] = rng.choice(nt, live, replace=False)
    out.append(("QM_BUCKET_SHAPE", (
        q, qb, torch.from_numpy(draw(q_at, nT)).int().cuda(), t,
        torch.from_numpy(draw(t_at, nt)).int().cuda())))
    lanes.append(lj)
    return [(name, staged, torch.arange(len(lj), device=dev,
                                        dtype=torch.int32),
             torch.from_numpy(lj.reshape(-1)).int().cuda())
            for (name, staged), lj in zip(out, lanes)]


def time_qm_kernels(torch, sw_cuda, sw_torch, staged, qidx, lj, errs,
                    plain):
    """({K3, K4: (ms, plain_ms, bound_ms, bound_by)}, (K1 ms, K2 ms)) on one
    query-major launch (K4 from K3's ends), each output equal to its plain
    version's, then the pair kernels on the same pairs (padding lanes
    dropped); plain_ms is None unless plain."""
    TB = sw_torch.TB
    Lq, Lt, nT = staged[0].shape[1], staged[3].shape[1], qidx.shape[0]
    args = (*staged, qidx, lj)
    ends = sw_cuda.qm_ends(*args)
    qe, te = torch.clamp_min(ends[1], 0), torch.clamp_min(ends[2], 0)
    live = lj >= 0
    lane_q = qidx.long().repeat_interleave(TB)
    q_len = torch.where(live, staged[2][lane_q], 0)
    t_len = torch.where(live, staged[4][lj.long().clamp_min(0)], 0)
    fwd = int((q_len.long() * t_len.long()).sum())
    rev = int(((torch.minimum(qe, q_len - 1).long() + 1).clamp_min(0)
               * (torch.minimum(te, t_len - 1).long() + 1).clamp_min(0))
              .sum())
    errs["sw_qm_ends"] = max(errs["sw_qm_ends"], max_err(
        torch, ends, sw_torch.qm_ends(*args)))
    starts = sw_cuda.qm_starts(*args, qe, te)
    errs["sw_qm_starts"] = max(errs["sw_qm_starts"], max_err(
        torch, starts, sw_torch.qm_starts(*args, qe, te)))
    plain_ms = (lambda fn: time_ms(torch, fn, 2)) if plain else \
        (lambda fn: None)
    rows = {
        "sw_qm_ends": (
            time_ms(torch, lambda: sw_cuda.qm_ends(*args), 10),
            plain_ms(lambda: sw_torch.qm_ends(*args)),
            *bound(fwd, SW_OPS, (*args, *ends))),
        "sw_qm_starts": (
            time_ms(torch, lambda: sw_cuda.qm_starts(*args, qe, te), 10),
            plain_ms(lambda: sw_torch.qm_starts(*args, qe, te)),
            *bound(rev, SW_OPS, (*args, qe, te, *starts)))}
    keep = live.nonzero().squeeze(1)
    lq, lt = lane_q[keep], lj.long()[keep]
    pair_args = (staged[0][lq], staged[1][lq], q_len[keep], staged[3][lt],
                 t_len[keep])
    pe, ps = qe[keep], te[keep]
    same = (time_ms(torch, lambda: sw_cuda.sw_ends(*pair_args), 10),
            time_ms(torch, lambda: sw_cuda.sw_starts(*pair_args, pe, ps),
                    10))
    print(f"query-major tiles={nT} ({len(keep)} live lanes of {nT * TB}) "
          f"Lq={Lq} Lt={Lt}: {fwd} forward cells, {rev} reverse cells; "
          f"pair kernels on the same pairs: ends {same[0]:.4f} ms, starts "
          f"{same[1]:.4f} ms", flush=True)
    for k, (ms, p_ms, bound_ms, by) in rows.items():
        print(f"  {k}: kernel {ms:.4f} ms, plain "
              f"{'not timed' if p_ms is None else f'{p_ms:.4f} ms'}, bound "
              f"{bound_ms:.4f} ms ({by}; {bound_ms / ms:.1%} of it)",
              flush=True)
    return rows, same


def time_pair_kernels(torch, sw_cuda, sw_torch, args, errs, nocap=False):
    """{K1, K2: (ms, plain_ms, bound_ms, bound_by)} on one pair batch, K2
    from the forward ends; each output equal to its plain version's. With
    nocap, their uncapped instances under the realign matrix."""
    kw = dict(scoring=realign_scoring("cuda"), cap=None) if nocap else {}
    e_name, s_name = (f"{k}_nocap" if nocap else k for k in PAIR_KERNELS)
    ops = NOCAP_SW_OPS if nocap else SW_OPS
    _, qe, te = sw_torch.sw_ends(*args, **kw)
    qe, te = torch.clamp_min(qe, 0), torch.clamp_min(te, 0)
    fwd = int((args[2].long() * args[4].long()).sum())
    rev = int(((torch.minimum(qe, args[2] - 1).long() + 1)
               * (torch.minimum(te, args[4] - 1).long() + 1)).sum())
    ends = sw_cuda.sw_ends(*args, **kw)
    errs[e_name] = max(errs[e_name], max_err(
        torch, ends, sw_torch.sw_ends(*args, **kw)))
    errs[s_name] = max(errs[s_name], max_err(
        torch, sw_cuda.sw_starts(*args, qe, te, **kw),
        sw_torch.sw_starts(*args, qe, te, **kw)))
    out = {e_name: (
        time_ms(torch, lambda: sw_cuda.sw_ends(*args, **kw), 10),
        time_ms(torch, lambda: sw_torch.sw_ends(*args, **kw), 2),
        *bound(fwd, ops, (*args, *ends))), s_name: (
        time_ms(torch, lambda: sw_cuda.sw_starts(*args, qe, te, **kw), 10),
        time_ms(torch, lambda: sw_torch.sw_starts(*args, qe, te, **kw), 2),
        *bound(rev, ops, (*args, qe, te, *ends)))}
    (B, Lq), Lt = args[0].shape, args[3].shape[1]
    print(f"pair B={B} Lq={Lq} Lt={Lt}: {fwd} forward cells, {rev} "
          "reverse cells", flush=True)
    for k, (ms, plain_ms, bound_ms, by) in out.items():
        print(f"{k} at B={B} Lq={Lq} Lt={Lt}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; "
              f"{bound_ms / ms:.1%} of it)", flush=True)
    return out


def time_prof_kernels(torch, sw_cuda, sw_torch, args, errs, nocap=False):
    """{K1's, K2's PSSM entry (nocap: their uncapped instances): (ms,
    plain_ms, bound_ms, bound_by)} on time_pair_kernels' batch `args` as
    PSSM pairs: rows submat[q] + bias staged (int32, as the profile search
    stages them) in a shuffled order, K2 from the forward ends; outputs
    equal to the plain versions' and to sw_pair_ends' / sw_pair_starts'
    (nocap: their uncapped instances') on the same pairs."""
    from metaeuk_tpu_torch import state
    fwd_name, rev_name = PROF_NOCAP_KERNELS if nocap else PROF_KERNELS
    kw = {"cap": None} if nocap else {}
    ops = NOCAP_SW_OPS if nocap else SW_OPS
    q, qb, ql, t, tl = args
    B = q.shape[0]
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(5)) \
        .cuda()
    inv = torch.argsort(perm).int()
    sub = state.default_scoring(q.device).submat
    prof = (sub[q.long()] + qb.int()[:, :, None])[perm]
    staged = (prof, ql[perm], t[perm], tl[perm], inv, inv)
    plain = sw_cuda._gathered(*staged)
    ends = sw_cuda.sw_ends_prof(*staged, **kw)
    max_err(torch, ends, sw_cuda.sw_ends(*args, **kw))
    errs[fwd_name] = max(errs[fwd_name], max_err(
        torch, ends, sw_torch.sw_ends_prof(*plain, **kw)))
    qe, te = torch.clamp_min(ends[1], 0), torch.clamp_min(ends[2], 0)
    starts = sw_cuda.sw_starts_prof(*staged, qe, te, **kw)
    max_err(torch, starts, sw_cuda.sw_starts(*args, qe, te, **kw))
    errs[rev_name] = max(errs[rev_name], max_err(
        torch, starts, sw_torch.sw_starts_prof(*plain, qe, te, **kw)))
    fwd = int((ql.long() * tl.long()).sum())
    rev = int(((torch.minimum(qe, ql - 1).long() + 1)
               * (torch.minimum(te, tl - 1).long() + 1)).sum())
    # the kernels read the staged rows as int8
    inputs = (prof.to(torch.int8), *staged[1:])
    out = {fwd_name: (
        time_ms(torch, lambda: sw_cuda.sw_ends_prof(*staged, **kw), 10),
        time_ms(torch, lambda: sw_torch.sw_ends_prof(*plain, **kw), 2),
        *bound(fwd, ops, (*inputs, *ends))), rev_name: (
        time_ms(torch, lambda: sw_cuda.sw_starts_prof(*staged, qe, te, **kw),
                10),
        time_ms(torch, lambda: sw_torch.sw_starts_prof(*plain, qe, te, **kw),
                2),
        *bound(rev, ops, (*inputs, qe, te, *starts)))}
    (_, Lq, _), Lt = prof.shape, t.shape[1]
    for k, (ms, plain_ms, bound_ms, by) in out.items():
        print(f"{k} at B={B} Lq={Lq} Lt={Lt}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; "
              f"{bound_ms / ms:.1%} of it); outputs equal to the sequence "
              "entry's", flush=True)
    return out


def time_gapless_long(torch, np, ungapped_cuda, ungapped_torch, errs):
    """(ms, plain_ms, bound_ms, bound_by) of gapless_long at
    GAPLESS_LONG_TIME_SHAPE (the prefilter's cross product of the query
    rows and the targets), its output there equal to the plain version's
    (gapless_pair stages a query's profile in shared memory and takes no
    such width)."""
    Lq, Lt, nq, (q_lo, q_hi), nt, (t_lo, t_hi) = GAPLESS_LONG_TIME_SHAPE
    rng = np.random.default_rng(12)
    q, qb, _, t, _ = staged_batch(torch, rng, Lq, Lt, nq, nt, "cuda")
    ql = torch.from_numpy(rng.integers(q_lo, q_hi + 1, nq)).int().cuda()
    tl = torch.from_numpy(rng.integers(t_lo, t_hi + 1, nt)).int().cuda()
    flat = torch.arange(nq * nt, device="cuda")
    args = (q, qb, ql, t, tl, (flat // nt).int(), (flat % nt).int())
    cells = int((ql[args[5].long()].long() * tl[args[6].long()].long())
                .sum())
    best = ungapped_cuda.launch("gapless_long", *args)
    ref = ungapped_torch.gapless_gathered(*args)
    errs["gapless_long"] = max(errs["gapless_long"],
                               max_err(torch, (best,), (ref,)))
    row = (time_ms(torch, lambda: ungapped_cuda.launch("gapless_long", *args),
                   10),
           time_ms(torch, lambda: ungapped_torch.gapless_gathered(*args), 1),
           *bound(cells, GAPLESS_OPS, (*args, best)))
    print(f"gapless_long: {nq} query rows of {q_lo}-{q_hi} aa (Lq {Lq}) x "
          f"{nt} targets of {t_lo}-{t_hi} aa (Lt {Lt}), {cells} cells: "
          f"kernel {row[0]:.4f} ms ({cells / row[0] * 1e3:.4e} cells/s), "
          f"bound {row[2]:.4f} ms ({row[3]}), plain {row[1]:.4f} ms; "
          "outputs equal", flush=True)
    return row


def time_gapless_rows(torch, np, ungapped_cuda, ungapped_torch, errs):
    """(ms, plain_ms, bound_ms, bound_by) of gapless_rows at the first of
    GAPLESS_ROWS_TIME_SHAPES, through the cross entry on every query row and
    target; at each shape prints the ms of the three gapless kernels on the
    same launch beside its bound, every output equal to the plain
    version's."""
    out = None
    for seed, (Lq, Lt, nq, (q_lo, q_hi), nt, (t_lo, t_hi)) in enumerate(
            GAPLESS_ROWS_TIME_SHAPES, start=13):
        rng = np.random.default_rng(seed)
        q, qb, _, t, _ = staged_batch(torch, rng, Lq, Lt, nq, nt, "cuda")
        ql = torch.from_numpy(rng.integers(q_lo, q_hi + 1, nq)).int().cuda()
        tl = torch.from_numpy(rng.integers(t_lo, t_hi + 1, nt)).int().cuda()
        args = (q, qb, ql, t, tl, 0, nq)
        cells = int(ql.long().sum()) * int(tl.long().sum())
        flat = torch.arange(nq * nt, device="cuda")
        plain = lambda: ungapped_torch.gapless_gathered(
            q, qb, ql, t, tl, flat // nt, flat % nt).view(nq, nt)
        ref = plain()
        ms = {}
        for k in ("gapless_rows", "gapless_pair", "gapless_long"):
            best = ungapped_cuda.launch_cross(k, *args)
            errs[k] = max(errs[k], max_err(torch, (best,), (ref,)))
            ms[k] = time_ms(torch, lambda k=k: ungapped_cuda.launch_cross(
                k, *args), 10 if k == "gapless_rows" else 3)
        bound_ms, by = bound(cells, GAPLESS_OPS, (q, qb, ql, t, tl, ref))
        if out is None:
            out = (ms["gapless_rows"], time_ms(torch, plain, 1), bound_ms,
                   by)
        print(f"gapless cross launch: {nq} query rows of {q_lo}-{q_hi} aa "
              f"(Lq {Lq}) x {nt} targets of {t_lo}-{t_hi} aa (Lt {Lt}), "
              f"{cells} cells, bound {bound_ms:.4f} ms ({by}): " + ", ".join(
                  f"{k} {v:.4f} ms ({cells / v * 1e3:.4e} cells/s)"
                  for k, v in ms.items()) + "; all outputs equal the plain "
              "version's", flush=True)
    return out


def time_qm_rt(torch, np, sw_cuda, sw_torch, errs):
    """{name: (ms, plain_ms, bound_ms, bound_by)} of K5/K6 at
    QM_RT_TIME_SHAPE, one query per tile and 128 distinct targets per tile,
    each kernel's output there equal to its plain version's, and the pair
    kernels' (ends, starts) ms on the same pairs; then the same for K5/K6 at
    QM_RT_WIDE_SHAPE, printed only."""
    Lq, Lt, nT = QM_RT_TIME_SHAPE
    cases = ((10, Lq, Lt, nT, Lt // 2, Lt), (11, *QM_RT_WIDE_SHAPE))
    for seed, Lq, Lt, nT, t_lo, t_hi in cases:
        rng = np.random.default_rng(seed)
        TB, nt, dev = sw_torch.TB, 3000, "cuda"
        q, qb, _, t, _ = staged_batch(torch, rng, Lq, Lt, nT, nt, dev)
        ql = torch.from_numpy(rng.integers(Lq // 2, Lq + 1, nT)).int().cuda()
        tl = torch.from_numpy(rng.integers(t_lo, t_hi + 1, nt)).int().cuda()
        qidx = torch.arange(nT, device=dev, dtype=torch.int32)
        lj = torch.from_numpy(np.stack([rng.choice(nt, TB, replace=False)
                                        for _ in range(nT)]).reshape(-1))
        args = (q, qb, ql, t, tl, qidx, lj.int().cuda())
        ends = sw_cuda.qm_ends_rt(*args)
        qe, te = torch.clamp_min(ends[1], 0), torch.clamp_min(ends[2], 0)
        lane_q = qidx.long().repeat_interleave(TB)
        q_len, t_len = ql[lane_q], tl[args[-1].long()]
        fwd = int((q_len.long() * t_len.long()).sum())
        rev = int(((torch.minimum(qe, q_len - 1).long() + 1)
                   * (torch.minimum(te, t_len - 1).long() + 1)).sum())
        errs["sw_qm_rt_ends"] = max(errs["sw_qm_rt_ends"], max_err(
            torch, ends, sw_torch.qm_ends_rt(*args)))
        starts = sw_cuda.qm_starts_rt(*args, qe, te)
        errs["sw_qm_rt_starts"] = max(errs["sw_qm_rt_starts"], max_err(
            torch, starts, sw_torch.qm_starts_rt(*args, qe, te)))
        row = {
            "sw_qm_rt_ends": (
                time_ms(torch, lambda: sw_cuda.qm_ends_rt(*args), 3),
                time_ms(torch, lambda: sw_torch.qm_ends_rt(*args), 1),
                *bound(fwd, SW_OPS, (*args, *ends))),
            "sw_qm_rt_starts": (
                time_ms(torch, lambda: sw_cuda.qm_starts_rt(*args, qe, te),
                        3),
                time_ms(torch, lambda: sw_torch.qm_starts_rt(*args, qe, te),
                        1),
                *bound(rev, SW_OPS, (*args, qe, te, *starts)))}
        print(f"long-query tiles={nT} (pairs {nT * TB}) Lq={Lq} Lt={Lt}, "
              f"targets {t_lo}-{t_hi} aa: {fwd} forward cells, {rev} reverse "
              "cells", flush=True)
        for k, (ms, plain_ms, bound_ms, by) in row.items():
            print(f"  {k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({by})", flush=True)
        if seed == cases[0][0]:
            out = row
            pair_args = (q[lane_q], qb[lane_q], q_len, t[args[-1].long()],
                         t_len)
            same = (time_ms(torch, lambda: sw_cuda.sw_ends(*pair_args), 1),
                    time_ms(torch, lambda: sw_cuda.sw_starts(*pair_args, qe,
                                                             te), 1))
            print(f"  pair kernels on the same pairs: ends {same[0]:.4f} ms,"
                  f" starts {same[1]:.4f} ms", flush=True)
    return out, same


def bits(torch, t):
    """Floats as their bit patterns, so equality is exact to the bit."""
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(
        t.dtype)
    return t if view is None else t.view(view)


# T2's and T3's edge reps: none, one, the remainder loop alone (7), one
# unrolled block (8), both (61); scans of 0, 0, 1, 5, 7, 31, 33 and 64
# passes (the wavefront's ramp is 32 steps); on a width that is not a
# multiple of a block's columns
KBENCH_EDGE_REPS = {"shift": (0, 1, 7, 8, 61),
                    "scan": (0, 7, 8, 40, 61, 248, 264, 512)}
KBENCH_EDGE_COLS = 37


def check_kbench_kernels(torch, kbench_cuda, kbench_torch, kb, errs):
    """Every kbench case at the TPU shape and REPS on seeded non-zero
    inputs, each dtype's chain also at n_ops 2 and on one warp, and every
    shift amount the kernel is built for, both fills."""
    checks = [(name, kb.SHAPE, kb.REPS, {}) for name in kb.CASES]
    for name in ("alu_i32", "alu_i16", "alu_f32", "alu_bf16"):
        checks.append((name, kb.SHAPE, kb.REPS, {"n_ops": 2}))
        words = 64 if name in ("alu_i16", "alu_bf16") else 32
        checks.append((name, (1, words), kb.REPS, {}))
    for amount in kbench_cuda.SHIFT_AMOUNTS:
        for roll in (False, True):
            checks.append(("shift_i32", kb.SHAPE, 64,
                           {"amount": amount, "roll": roll}))
    checks.append(("shift_i16", kb.SHAPE, kb.REPS, {"amount": 3}))
    checks.append(("shift_i16", kb.SHAPE, kb.REPS, {"amount": 64,
                                                    "roll": True}))
    edge = (kb.SHAPE[0], KBENCH_EDGE_COLS)
    for amount in kbench_cuda.SHIFT_AMOUNTS:
        for roll in (False, True):
            for reps in KBENCH_EDGE_REPS["shift"]:
                checks.append(("shift_i32", edge, reps,
                               {"amount": amount, "roll": roll}))
    for reps in KBENCH_EDGE_REPS["shift"]:
        checks.append(("shift_i16", edge, reps, {"amount": 3}))
    kernel_of = {"alu": "kb_alu", "shift": "kb_shift", "scan": "kb_scan"}
    for seed, (name, shape, reps, extra) in enumerate(checks, 1):
        kind, _, kw = kb.CASES[name]
        kw = {**kw, **extra}
        x = kb.case_input(name, "cuda", seed=seed, shape=shape)
        got = getattr(kbench_cuda, kind)(x, reps, **kw)
        torch.cuda.synchronize()
        ref = getattr(kbench_torch, kind)(x, reps, **kw)
        k = kernel_of[kind]
        errs[k] = max(errs[k], max_err(torch, (bits(torch, got),),
                                       (bits(torch, ref),)))
    # columns below NEG, where the Pallas scan's fill reaches every row but
    # the last
    x = kb.case_input("scan256", "cuda", seed=len(checks) + 1)
    x[:, :3] = -2_000_000 - torch.arange(256, device="cuda",
                                         dtype=torch.int32)[:, None]
    errs["kb_scan"] = max(errs["kb_scan"], max_err(
        torch, (kbench_cuda.scan(x),), (kbench_torch.scan(x),)))
    x = scan_edge_input(torch, kb)
    for reps in KBENCH_EDGE_REPS["scan"]:
        errs["kb_scan"] = max(errs["kb_scan"], max_err(
            torch, (kbench_cuda.scan(x, reps),),
            (kbench_torch.scan(x, reps),)))
    print(f"kbench: {len(checks) + 1 + len(KBENCH_EDGE_REPS['scan'])} cases "
          f"equal to the plain versions bit for bit (the 11 cases at "
          f"{kb.SHAPE}, REPS {kb.REPS}; n_ops 2; one warp; shift amounts "
          f"{kbench_cuda.SHIFT_AMOUNTS} with zero fill and wrapped; a scan "
          f"with columns below NEG; at {KBENCH_EDGE_COLS} columns, shifts at "
          f"reps {KBENCH_EDGE_REPS['shift']} and scans at reps "
          f"{KBENCH_EDGE_REPS['scan']}, int32 extremes among them)",
          flush=True)


def scan_edge_input(torch, kb):
    """(256, KBENCH_EDGE_COLS) int32 on the card: seeded values, columns
    below NEG, a column of INT_MIN, one of INT_MIN on its first rows, one
    near INT_MAX."""
    x = kb.case_input("scan256", "cuda", seed=13,
                      shape=(kb.SHAPE[0], KBENCH_EDGE_COLS))
    rows = torch.arange(kb.SHAPE[0], device="cuda", dtype=torch.int32)
    x[:, 0] = -2_000_000 - rows
    x[:, 1] = -2 ** 31
    x[:5, 2] = -2 ** 31
    x[:, 3] = 2 ** 31 - 1 - rows
    return x


# T4's row-stripe case: (Lq, Lt, tiles, tj, unroll), three stripes of 512
# rows at the warp class; planted runs of equal score (STRIPE_RUN's length
# at 11 a cell) at rows ending 15 (stripe 0) and 1039 (stripe 2, the same
# thread), lane 0 meeting the second at an earlier column (60) than the
# first (210), so that the later stripe's earlier column wins the tie
STRIPE_SHAPE = (1100, 300, 2, 100, 4)
STRIPE_RUN = 6


def stripe_variant_inputs(np, variant):
    """(prof float32, tc int32) of STRIPE_SHAPE in numpy: scores -20 but on
    two planted runs A (rows 10..15) and B (rows 1034..1039) and a few 11s
    (single-cell ties on the other lanes); -128 in classes 21..31; +GE on
    classes 0..20 for the folded variants. Lane 0 of tile 0 holds B at
    column 55 and A at column 205; lanes 1-3 never score, lanes 10-19
    repeat lane 5."""
    Lq, Lt, n_tiles, _, _ = STRIPE_SHAPE
    rng = np.random.default_rng(20261018)
    prof = np.full((n_tiles, Lq, 32), -20, np.float32)
    prof[:, rng.integers(0, Lq, 40), rng.integers(0, 20, 40)] = 11
    A = rng.integers(0, 20, STRIPE_RUN)
    B = (A + 1 + rng.integers(0, 18, STRIPE_RUN)) % 20
    for k in range(STRIPE_RUN):
        prof[:, 10 + k, A[k]] = prof[:, 1034 + k, B[k]] = 11
    prof[:, :, 21:] = -128
    if variant in ("fold", "fold_nocap"):
        prof[:, :, :21] += 1
    tc = rng.integers(0, 20, (Lt, n_tiles * 128)).astype(np.int32)
    tc[55:55 + STRIPE_RUN, 0], tc[205:205 + STRIPE_RUN, 0] = B, A
    tc[:, 1], tc[:, 2], tc[:, 3] = 25, 40, -1
    tc[:, 10:20] = tc[:, 5:6]
    return prof, tc


def variant_checks(torch, np, kvar):
    """(what, prof, tc, variant, tj, unroll) on the card: every variant and
    the uN / tjN sweeps at the TPU tool's default shape; every variant on a
    small shape with lanes that never score (codes at -128 or outside the
    profile), repeated lanes and a narrow score range (ties); every variant
    where H passes 32767; every variant at Lq 1,100 (STRIPE_SHAPE: three row
    stripes, a tie across them); nocap where its packed word wraps."""
    V = ("base", "fold", "nocap", "fold_nocap", "nof")
    for v in V:
        yield (v, *kvar.variant_inputs(v, 256, 2048, 32, "cuda"), v, 256, 8)
    for u in (1, 2, 4, 16):
        yield (f"u{u}", *kvar.variant_inputs("base", 256, 2048, 32, "cuda"),
               "base", 256, u)
    for tj in (100, 1024):
        yield (f"tj{tj}", *kvar.variant_inputs("base", 256, 2048, 32,
                                               "cuda"), "base", tj, 8)
    rng = np.random.default_rng(20261016)
    Lq, Lt, nT = 96, 300, 3
    prof = rng.integers(0, 3, (nT, Lq, 32)).astype(np.float32)
    prof[:, :, 21:] = -128
    tc = rng.integers(0, 20, (Lt, nT * 128)).astype(np.int32)
    tc[:, 7] = 25                          # every cell at -128
    tc[:, 8] = 40                          # outside the profile: 0
    tc[:, 9] = -1
    tc[:, 10:40] = tc[:, 5:6]              # one lane repeated
    cap = np.full((1, 256, 32), 200, np.float32)
    cap[:, :, 21:] = -128
    cap_tc = np.zeros((512, 128), np.int32)
    cap_tc[:, 1] = 25
    for v in V:
        shift = 1 if v in ("fold", "fold_nocap") else 0
        p = prof.copy()
        p[:, :, :21] += shift
        yield (f"ragged {v}", torch.from_numpy(p).bfloat16().cuda(),
               torch.from_numpy(tc).cuda(), v, 100, 8)
        p = cap.copy()
        p[:, :, :21] += shift
        yield (f"cap {v}", torch.from_numpy(p).bfloat16().cuda(),
               torch.from_numpy(cap_tc).cuda(), v, 512, 8)
        p, t = stripe_variant_inputs(np, v)
        yield (f"stripes {v}", torch.from_numpy(p).bfloat16().cuda(),
               torch.from_numpy(t).cuda(), v, *STRIPE_SHAPE[3:])
    # H past 65,536 (300 rows of 250 but one in seven), where the packed
    # words wrap: nocap's (hu * 32768), through the kernel's exact rescan of
    # every row; fold_nocap's (H' * 32768, H' = H + i ge), through its
    # words a row, which wrap at other columns than the unfolded word
    wrap = np.full((1, 300, 32), 250, np.float32)
    wrap[:, ::7, 3] = -50
    wrap[:, :, 21:] = -128
    wrap_tc = np.random.default_rng(1).integers(0, 21, (600, 128)).astype(
        np.int32)
    wrap_tc[:, 1] = 25
    for v in ("nocap", "fold_nocap"):
        p = wrap.copy()
        if v == "fold_nocap":
            p[:, :, :21] += 1
        yield (f"wrap {v}", torch.from_numpy(p).bfloat16().cuda(),
               torch.from_numpy(wrap_tc).cuda(), v, 600, 8)


def check_variant_kernel(torch, np, qm_variants_cuda, qm_variants_torch,
                         kvar, errs):
    for what, prof, tc, v, tj, u in variant_checks(torch, np, kvar):
        got = qm_variants_cuda.qm_variant_ends(prof, tc, v, tj, u)
        torch.cuda.synchronize()
        ref = qm_variants_torch.qm_variant_ends(prof, tc, v, tj, u)
        errs["qm_variant_ends"] = max(errs["qm_variant_ends"],
                                      max_err(torch, got, ref))
        if what.startswith("cap"):
            over = int(ref[0][0]) > 32767
            if over != (v in ("nocap", "fold_nocap")) or int(ref[0][1]):
                raise AssertionError(f"{what}: best {int(ref[0][0])}, the "
                                     "cap case does not pass 32767")
        if what.startswith("stripes") and [int(o[0]) for o in ref] != [
                11 * STRIPE_RUN, 1039, 54 + STRIPE_RUN]:
            raise AssertionError(f"{what}: lane 0 {[int(o[0]) for o in ref]}"
                                 ", not the later stripe's earlier tie")
        print(f"variant {what} (Lq {prof.shape[1]}, Lt {tc.shape[0]}, "
              f"tiles {prof.shape[0]}, tj {tj}, u {u}): equal; lane 0 "
              f"{[int(o[0]) for o in ref]}, {int((ref[0] > 0).sum())} lanes "
              "with a hit", flush=True)


# T1's pipes on an H100 SXM: int32 at INT32_OPS_PER_S (one DPX add-max a
# step; __viaddmax_s16x2 two lanes a step); float32 and packed bfloat16 at
# the FP32 instruction rate (128 lanes an SM, half the data sheet's 67
# TFLOP/s that counts an FMA as two), add and max one instruction each,
# two lanes an instruction for bfloat16
FP32_INSTR_PER_S = 67e12 / 2
ALU_PIPE = {   # case: (instructions a step, their rate)
    "alu_i32": (1, INT32_OPS_PER_S), "alu_i16": (0.5, INT32_OPS_PER_S),
    "alu_f32": (2, FP32_INSTR_PER_S), "alu_bf16": (1, FP32_INSTR_PER_S)}


def kbench_bound(kb, name, x):
    """(bound_ms, bound_by, rule) of a kbench case on x: the least
    instructions over the pipe's rate, or its bytes (x read, out written)
    over the memory rate. T2 needs one max an element a rep (the move can be
    a register rename; int16 packed two a word); T3 n - 1 max and one
    subtraction an element a pass."""
    kind = kb.CASES[name][0]
    n = x.numel()
    if kind == "alu":
        per_step, rate = ALU_PIPE[name]
        instr = kb.REPS * 4 * n * per_step
        rule = f"{per_step} instr/step at {rate:.4g}/s"
    elif kind == "shift":
        rate = INT32_OPS_PER_S
        instr = kb.REPS * n * (0.5 if x.dtype.itemsize == 2 else 1)
        rule = f"1 max/element/rep at {rate:.4g}/s"
    else:
        rate = INT32_OPS_PER_S
        instr = (kb.REPS // 8) * 2 * n
        rule = f"2 ops/element/pass at {rate:.4g}/s"
    ops_ms = instr / rate * 1e3
    byte_ms = 2 * n * x.element_size() / BYTES_PER_S * 1e3
    return (ops_ms, "operations", rule) if ops_ms >= byte_ms else \
        (byte_ms, "bytes", rule)


def sm_clock_mhz():
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def one_warp_latency(torch, kbench_cuda, kb):
    """T1 on one warp (32 words): ms per call over about 1.5 s of queued
    calls, the SM clock read by nvidia-smi while they run, and the cycles
    per dependent step (one add-max) and per operation (two a step)."""
    reps = 16384
    for name in ("alu_i32", "alu_i16", "alu_f32", "alu_bf16"):
        words = 64 if name in ("alu_i16", "alu_bf16") else 32
        x = kb.case_input(name, "cuda", seed=3, shape=(1, words))
        run = lambda: kbench_cuda.alu(x, reps)
        per_call = time_ms(torch, run, 20)
        n = max(20, int(1500 / per_call))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            run()
        stop.record()
        mhz = sm_clock_mhz()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / n
        cyc = ms * 1e-3 * mhz * 1e6 / (reps * 4)
        print(f"{name} on one warp: {ms:.4f} ms per call of {reps} reps x 4 "
              f"dependent steps, SM clock {mhz:.0f} MHz during the run: "
              f"{cyc:.2f} cycles per dependent step, {cyc / 2:.2f} per "
              "operation (latency)", flush=True)


def sass_census(_build):
    """The opcodes of each kb_alu chain at n_ops 8 (the kernel unrolled for
    n_ops / 2 = 4 steps), from cuobjdump -sass of the built library (what
    T1's dtypes end in)."""
    import re
    import shutil
    from collections import Counter
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        print("cuobjdump not found: SASS census not taken", flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(_build.build("kbench"))],
                          capture_output=True, text=True, check=True).stdout
    op = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
    found = 0
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        tag = next((t for t in ("AluI16x2", "AluBF16x2", "AluI32", "AluF32")
                    if t in name), None)
        if tag is None or "Li4E" not in name:
            continue
        found += 1
        ops = Counter(op.findall(fn))
        print(f"SASS {tag} (n_ops 8): " + ", ".join(
            f"{k} {v}" for k, v in ops.most_common(8)), flush=True)
    if found != 4:
        raise AssertionError(f"cuobjdump showed {found} of the 4 kb_alu "
                             "chains at n_ops 8")


def run_tools(torch, np, kb, kvar, kbench_cuda, kbench_torch,
              qm_variants_cuda, qm_variants_torch, _build):
    """Both entry points over all their cases, counted; then each new
    kernel's time beside its bound and its plain version's, T2's and T3's
    floors (tools/torch_kbench_floors.py), their one-call yardsticks, T1
    on one warp and the SASS census. ({name: (ms, plain_ms, bound_ms,
    bound_by)}, launches, {name: library_ms})."""
    for c in (kbench_cuda, qm_variants_cuda):
        c.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kres = kb.main([])
    kvar.main([])
    kvar.main(["u1", "u2", "u4", "u16", "tj64", "tj1024"])
    torch.cuda.synchronize()
    launches, plain = counts((kbench_cuda, qm_variants_cuda))
    print(f"entry points: {time.perf_counter() - t0:.2f} s, launches "
          f"{launches}, plain {plain}", flush=True)
    if min(launches.values()) == 0 or any(plain.values()):
        raise AssertionError("the entry points did not go through the "
                             "kernels")
    out, library = {}, {}
    rows = {}
    for name in kb.CASES:
        x = kb.case_input(name, "cuda")
        kind, _, kw = kb.CASES[name]
        plain_ms = time_ms(torch, lambda: getattr(kbench_torch, kind)(
            x, kb.REPS, **kw), 2)
        bound_ms, by, rule = kbench_bound(kb, name, x)
        rows[name] = (kres[name][0] / 1e3, plain_ms, bound_ms, by)
        print(f"{name}: kernel {kres[name][0] / 1e3:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}: {rule})",
              flush=True)
    for k, name in (("kb_alu", "alu_i32"), ("kb_shift", "shift_i32"),
                    ("kb_scan", "scan256")):
        out[k] = rows[name]
    from tools import torch_kbench_floors as floors
    raw = floors.measure(torch, kbench_cuda, kbench_torch, kb)
    floors.report(raw, floors.derive(raw, sys.modules[__name__], kbench_cuda,
                                     kb), "floors")
    for name in floors.CASES:
        x = kb.case_input(name, "cuda", seed=5)
        ms = time_ms(torch, lambda: kb.yardstick(name, x), 10)
        if not torch.equal(kb.yardstick(name, x), kb.run_case(name, x)):
            raise AssertionError(f"{name}'s yardstick differs from its "
                                 "kernel's output")
        if name in ("shift_i32", "scan256"):
            library["kb_" + kb.CASES[name][0]] = ms
        print(f"{name} library yardstick (tools/kbench.py yardstick): "
              f"{ms:.4f} ms, equal output", flush=True)
    prof, tc = kvar.variant_inputs("base", 256, 2048, 32, "cuda")
    cells = 32 * 128 * 256 * 2048
    run = lambda: qm_variants_cuda.qm_variant_ends(prof, tc)
    out["qm_variant_ends"] = (
        time_ms(torch, run, 10),
        time_ms(torch, lambda: qm_variants_torch.qm_variant_ends(prof, tc),
                1),
        *bound(cells, SW_OPS, (prof, tc, *run())))
    print(f"qm_variant_ends base, 32 tiles, Lq 256, Lt 2048 ({cells} cells):"
          f" kernel {out['qm_variant_ends'][0]:.4f} ms, plain "
          f"{out['qm_variant_ends'][1]:.4f} ms, bound "
          f"{out['qm_variant_ends'][2]:.4f} ms", flush=True)
    one_warp_latency(torch, kbench_cuda, kb)
    sass_census(_build)
    return out, launches, library


# T4 base against K3 on the same pairs: (queries of Lq aa, one a tile;
# targets of Lt aa, one a lane)
T4_K3_SHAPE = (32, 256, 4096, 2048)


def t4_against_k3(torch, np, sw_cuda, qm_variants_cuda):
    """T4 base and K3 (sw_qm_ends) on T4_K3_SHAPE's pairs, query q on tile
    q and target 128 q + l on its lane l: T4's profile rows are the scores
    K3 reads for each row (BLOSUM62's row of the query's code plus the
    row's bias, in the matrix's classes; -128 in the rest), its codes the
    targets'. The outputs must be equal. (t4_ms, k3_ms), each over 10
    calls of the wrapper."""
    from metaeuk_tpu_torch.state import default_scoring
    nq, Lq, nt, Lt = T4_K3_SHAPE
    rng = np.random.default_rng(20261018)
    sub = default_scoring("cuda").submat
    alph = sub.shape[0]
    q = rng.integers(0, alph, (nq, Lq))
    qb = rng.integers(-3, 4, (nq, Lq))
    t = rng.integers(0, alph, (nt, Lt))
    for k in range(0, nt, 7):              # real hits: a query's segment
        t[k, 100 + k % 900:160 + k % 900] = q[k // 128, 50:110]
    mk = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device="cuda", dtype=dt)
    args = (mk(q, torch.uint8), mk(qb, torch.int8),
            mk(np.full(nq, Lq), torch.int32), mk(t, torch.uint8),
            mk(np.full(nt, Lt), torch.int32), mk(np.arange(nq), torch.int32),
            mk(np.arange(nt), torch.int32))
    prof = torch.full((nq, Lq, 32), -128, dtype=torch.int32, device="cuda")
    prof[:, :, :alph] = sub.to(torch.int32)[args[0].long()] \
        + args[1].to(torch.int32)[:, :, None]
    prof = prof.bfloat16()
    tc = args[3].to(torch.int32).t().contiguous()
    run_t4 = lambda: qm_variants_cuda.qm_variant_ends(prof, tc)
    run_k3 = lambda: sw_cuda.qm_ends(*args)
    got, ref = run_t4(), run_k3()
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError("T4 base and K3 differ on the same pairs")
    t4_ms, k3_ms = time_ms(torch, run_t4, 10), time_ms(torch, run_k3, 10)
    print(f"T4 base vs K3 on the same {nq * 128} pairs (Lq {Lq}, Lt {Lt}, "
          f"{int((ref[0] > 0).sum())} hits, best {int(ref[0].max())}): equal;"
          f" T4 {t4_ms:.4f} ms, K3 {k3_ms:.4f} ms, T4/K3 "
          f"{t4_ms / k3_ms:.3f}", flush=True)
    return t4_ms, k3_ms


@contextlib.contextmanager
def child_process(mode, *args, env=None):
    """Starts phase 5g's (a) and (b) (mode --iter-slice: iter_child), phase
    5k (mode --gumbel-slice: gumbel_child), phase 5l (mode --dist-slice:
    dist_child) or a run of phase 5o (mode --bench: bench_child), `python3
    chip_smoke.py MODE DIR ARGS`, with `env` added to the environment, in a
    process of its own and a session of its own, its output to DIR/log;
    yields (the process, DIR); at exit stops it and every process it
    started (its session's process group) and removes DIR."""
    import shutil
    import signal
    td = pathlib.Path(tempfile.mkdtemp(prefix="meuk_child"))
    with open(td / "log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), mode, str(td),
             *args], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
            env=dict(os.environ, **(env or {})), start_new_session=True)
        try:
            yield proc, td
        finally:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            shutil.rmtree(td, ignore_errors=True)


# phase 5o: the bench's configuration (its defaults, set here so that the
# environment cannot change them) with one timed run
BENCH_ENV = dict(METAEUK_BENCH_MBP="4", METAEUK_BENCH_TARGETS="8000",
                 METAEUK_BENCH_RUNS="1")
# the bench's contigs there and its selftest's checks, light and full (the
# draws of its seeds)
BENCH_CONTIGS = 572
BENCH_CHECKS = {"light": 140, "full": 253}
# K1-K6, the kernels the bench's runs launch
BENCH_KERNELS = (*PAIR_KERNELS, "sw_qm_ends", "sw_qm_starts", *RT_KERNELS)


def bench_child(td, args):
    """One run of phase 5o: the port's package as `python -m
    metaeuk_tpu_torch bench ARGS` runs it (runpy), its temporary directory
    under td; then td/counts.json: the SW and gapless wrappers' launches
    and plain calls. Returns the bench's exit code; a kernel that fails to
    build or launch raises."""
    import runpy
    sys.path.insert(0, str(ROOT))
    tempfile.tempdir = str(td)
    sys.argv = ["metaeuk_tpu_torch", "bench", *args]
    try:
        runpy.run_module("metaeuk_tpu_torch", run_name="__main__",
                         alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = 0 if e.code is None else e.code
    from metaeuk_tpu_torch.ops import sw_cuda, ungapped_cuda
    launches, plain = counts((sw_cuda, ungapped_cuda))
    (td / "counts.json").write_text(json.dumps({"launches": launches,
                                                "plain": plain}))
    return rc


# phase 5o's two runs, started together: the main run and the selftest
BENCH_RUNS = {"bench": (), "selftest": ("--selftest",)}


def run_benches(deadline):
    """Phase 5o: BENCH_RUNS' runs of `bench ARGS` (bench_child) at
    BENCH_ENV, each in a process of its own, started together and joined by
    `deadline` seconds on the script's clock. Prints their JSON lines and
    returns {name: {"lines", "launches", "plain", "digests" (the main run's
    outputs, its last timed run's), "seconds"}}. Raises unless each exits
    0."""
    runs = {}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        procs = {name: stack.enter_context(
            child_process("--bench", *args, env=BENCH_ENV))
            for name, args in BENCH_RUNS.items()}
        for name, (proc, td) in procs.items():
            rc = join_child(proc, deadline - (time.perf_counter() - t0))
            log = (td / "log").read_text()
            lines = [json.loads(ln) for ln in log.splitlines()
                     if ln.startswith("{")]
            for ln in lines:
                print(json.dumps(ln), flush=True)
            if rc != 0:
                print(log[-6000:], flush=True)
                raise AssertionError(f"bench run {name} failed (exit {rc})")
            rec = runs[name] = json.loads((td / "counts.json").read_text())
            outs = sorted(td.glob("meukbench*/ours.gff"))
            rec["digests"] = digests(outs[0].with_suffix("")) if outs \
                else None
            rec["lines"] = lines
            rec["seconds"] = time.perf_counter() - t0
    return runs


def check_bench(runs, golden):
    """Phase 5o's checks on the main run and the selftest run: the
    selftest lines (no mismatch, every check drawn), the configuration, the
    kernel rates, K1-K6 launched with no plain call, and the main run's
    outputs against dist_bench_slice.json's digests."""
    *st, main_line = runs["bench"]["lines"]
    want = {"fails": 0, "checks": BENCH_CHECKS["light"]}
    if [{k: r[k] for k in want} for r in st] != [want] \
            or main_line["extra"]["selftest"] != want:
        raise AssertionError("the bench's light selftest failed")
    full = runs["selftest"]["lines"]
    if full != [{"selftest": "sw_cuda_kernels_vs_oracle", "fails": 0,
                 "checks": BENCH_CHECKS["full"]}]:
        raise AssertionError("bench --selftest failed")
    ex = main_line["extra"]
    if ex["config"] != {"mbp": 4.0, "targets": 8000,
                        "contigs": BENCH_CONTIGS} or not \
            main_line["value"] > 0 or len(ex["ours_walls_s"]) != 1:
        raise AssertionError(f"the bench ran another configuration: {ex}")
    rates = [ex["sw_kernel_cells_per_s"],
             *ex["sw_kernel_qm_cells_per_s"].values()]
    if len(rates) != 3 or not all(r and r > 0 for r in rates):
        raise AssertionError(f"a kernel rate is missing: {rates}")
    launched = {k: sum(r["launches"][k] for r in runs.values())
                for k in BENCH_KERNELS}
    plain = {k: n for r in runs.values() for k, n in r["plain"].items()
             if n}
    print("5o launches (bench, --selftest): " + json.dumps(
        {k: [r["launches"][k] for r in runs.values()]
         for k in BENCH_KERNELS}) + f"; plain calls {plain}", flush=True)
    if min(launched.values()) == 0 or plain:
        raise AssertionError("the bench did not go through K1-K6 alone")
    if runs["bench"]["digests"] != golden["sha256"]:
        raise AssertionError(
            "the bench's unsplit outputs differ from dist_bench_slice.json's "
            f"split-2 digests: {runs['bench']['digests']}")
    print("5o: the unsplit run's 4 sha256 digests equal "
          "dist_bench_slice.json's (the JAX package's --split 2 run)",
          flush=True)


# seconds after its start by which the script joins the processes of
# phases 5g, 5k and 5l (the whole script must end within 1200 s)
CHILD_DEADLINE = 1140
# phase 5m: the driver's device list on the one card
MESH_DEVICES = ["cuda:0", "cuda:0"]


def join_child(proc, seconds):
    """proc's exit code once it ends, waiting at most `seconds` (at least
    one); None if it is still running then."""
    try:
        return proc.wait(timeout=max(1, seconds))
    except subprocess.TimeoutExpired:
        return None


def main():
    if not (ROOT / CSRC / "sw_pair.cu").exists():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--iter-slice"]:
        return iter_child(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--gumbel-slice"]:
        return gumbel_child(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--kmerpf-slice"]:
        return kmerpf_child(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--dist-slice"]:
        return dist_child(pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--serve"]:
        return serve_child(*sys.argv[2:7])
    if sys.argv[1:2] == ["--bench"]:
        return bench_child(pathlib.Path(sys.argv[2]), sys.argv[3:])
    # every process a phase starts (phases 5g's and 5k's) is stopped at exit
    with contextlib.ExitStack() as stack:
        return run_phases(stack)


def run_phases(stack):
    """The phases of the module docstring, in order; processes they start
    are registered on `stack`."""
    t_start = time.perf_counter()
    import numpy as np
    import torch
    phase("1 device")
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} numpy {np.__version__}", flush=True)

    sys.path.insert(0, str(ROOT))
    from metaeuk_tpu_torch import cli, native
    from metaeuk_tpu_torch.io.seqdb import DBTYPE_AA, DBTYPE_NUCL, SeqDB
    from metaeuk_tpu_torch.ops import (_build, sw_cuda, sw_torch,
                                       ungapped_cuda, ungapped_torch)
    from metaeuk_tpu_torch.ops.orf import OrfExtractor
    from metaeuk_tpu_torch.params import Params
    from metaeuk_tpu_torch.pipeline.predict import EasyPredict
    from metaeuk_tpu_torch.ops import (kbench_cuda, kbench_torch,
                                       qm_variants_cuda, qm_variants_torch)
    from metaeuk_tpu_torch.search import driver, prefilter, profile_search
    from metaeuk_tpu_torch.tools import kbench as kb
    from metaeuk_tpu_torch.tools import kernel_variants as kvar
    from metaeuk_tpu_torch.tools import dryrun
    counters = (sw_cuda, ungapped_cuda)

    phase("2 build")
    t0 = time.perf_counter()
    sources = sorted({s[:-3] for s, _ in KERNELS.values()})
    # qm_variants.cu (T4's 125 template instances, about 100 s of nvcc)
    # builds beside phase 3 and is joined before phase 3b, its first user
    builder = stack.enter_context(ThreadPoolExecutor(len(sources) + 1))
    t4_build = builder.submit(_build.load, "qm_variants")
    host = builder.submit(native.get_lib)
    for f in [builder.submit(_build.load, s) for s in sources
              if s != "qm_variants"]:
        f.result()
    if host.result() is None:
        raise AssertionError("the native host library did not build")
    print(f"nvcc builds of {sources} but qm_variants and the g++ host "
          f"library {native.library_path().name}: "
          f"{time.perf_counter() - t0:.2f} s")
    for s in sources:
        if s != "qm_variants":
            b = _build.BUILT.get(s, {})
            print(f"{s}.cu {b.get('seconds', 0.0):.2f} s")
            print(b.get("ptxas", "(cached)"), flush=True)
    usage = ptxas_usage(_build.BUILT.get("sw_qm_rt", {}).get("ptxas", ""))
    for k, tag in RT_KERNEL_SYMBOLS.items():
        found = [v for n, v in usage.items() if tag in n]
        print(f"{k}: " + (f"{found[0][0]} registers, {found[0][1]} bytes "
                          f"spill stores, {found[0][2]} bytes spill loads"
                          if found else "no ptxas report (a cached build)"),
              flush=True)
    pair_usage = ptxas_usage(_build.BUILT.get("sw_pair", {}).get("ptxas",
                                                                  ""))
    qm_usage = ptxas_usage(_build.BUILT.get("sw_qm", {}).get("ptxas", ""))
    # K1/K2's instances: <G, R, reverse pass, uncapped (kWide), row source>
    for name, usage, symbol, rev, rows in (
            ("sw_pair_ends", pair_usage, PAIR_KERNEL_SYMBOL, "0ELb0",
             "PairRows"),
            ("sw_pair_starts", pair_usage, PAIR_KERNEL_SYMBOL, "1ELb0",
             "PairRows"),
            ("sw_pair_ends_nocap", pair_usage, PAIR_KERNEL_SYMBOL, "0ELb1",
             "PairRows"),
            ("sw_pair_starts_nocap", pair_usage, PAIR_KERNEL_SYMBOL,
             "1ELb1", "PairRows"),
            ("sw_pair_ends_prof", pair_usage, PAIR_KERNEL_SYMBOL, "0ELb0",
             "ProfRows"),
            ("sw_pair_starts_prof", pair_usage, PAIR_KERNEL_SYMBOL, "1ELb0",
             "ProfRows"),
            ("sw_pair_ends_prof_nocap", pair_usage, PAIR_KERNEL_SYMBOL,
             "0ELb1", "ProfRows"),
            ("sw_pair_starts_prof_nocap", pair_usage, PAIR_KERNEL_SYMBOL,
             "1ELb1", "ProfRows"),
            ("sw_qm_ends", qm_usage, QM_KERNEL_SYMBOLS["sw_qm_ends"], None,
             ""),
            ("sw_qm_starts", qm_usage, QM_KERNEL_SYMBOLS["sw_qm_starts"],
             None, "")):
        for g, r in sw_cuda.PAIR_CLASSES:
            # the uncapped entries launch the capped instance up to 128 rows
            shared = rev is not None and rev.endswith("1") and g * r <= 128
            inst = rev[:-1] + "0" if shared else rev
            tag = f"{symbol}ILi{g}ELi{r}E" + (
                "" if rev is None else f"Lb{inst}E")
            found = [v for n, v in usage.items() if tag in n and rows in n]
            print(f"{name} (G {g}, R {r}"
                  f"{', the capped instance' if shared else ''}): " + (
                f"{found[0][0]} registers, {found[0][1]} bytes spill "
                f"stores, {found[0][2]} bytes spill loads" if found
                else "no ptxas report (a cached build)"), flush=True)

    # phase 5g's full-slice run goes in a process of its own, started once
    # the kernels are built and joined after phase 6b: its host stages
    # (result2profile's round) outlast phases 3-6b, during which it uses
    # the card for a few seconds only (step 0's alignment); so does phase
    # 5k, whose fits are host sampling and island scans but for 0.1 s of
    # kernels each, joined after phase 5j
    child, child_td = stack.enter_context(child_process("--iter-slice"))
    gumbel, gumbel_td = stack.enter_context(child_process("--gumbel-slice"))

    phase("3 kernels against their plain versions")
    errs = dict.fromkeys(KERNELS, 0)
    check_pair_kernels(torch, sw_cuda, sw_torch, errs)
    check_pair_edges(torch, sw_cuda, sw_torch, errs)
    check_nocap_kernels(torch, sw_cuda, sw_torch, errs)
    check_prof_kernels(torch, sw_cuda, sw_torch, errs)
    check_prof_edges(torch, sw_cuda, sw_torch, errs)
    check_prof_kernels(torch, sw_cuda, sw_torch, errs, nocap=True)
    check_prof_edges(torch, sw_cuda, sw_torch, errs, nocap=True)
    check_prof_cap_runs(torch, sw_cuda, sw_torch, errs)
    check_qm_kernels(torch, sw_cuda, sw_torch, errs)
    check_qm_edges(torch, sw_cuda, sw_torch, errs)
    check_qm_rt_kernels(torch, sw_cuda, sw_torch, errs)
    check_gapless_kernel(torch, ungapped_cuda, ungapped_torch, errs)
    check_gapless_rows(torch, ungapped_cuda, ungapped_torch, errs)
    check_gapless_long(torch, ungapped_cuda, ungapped_torch, errs)

    phase("3b microbenchmark kernels against their plain versions")
    t0 = time.perf_counter()
    t4_build.result()
    report_t4_build(_build, sw_cuda, t_start)
    check_kbench_kernels(torch, kbench_cuda, kbench_torch, kb, errs)
    check_variant_kernel(torch, np, qm_variants_cuda, qm_variants_torch,
                         kvar, errs)
    print(f"phase 3b: {time.perf_counter() - t0:.2f} s", flush=True)

    from tools.make_metagenome import make_metagenome, write_fasta
    sys.path.insert(0, str(GOLDEN))
    import make_long_slice as mls
    import make_profile_slice as mps
    ungapped = json.loads((GOLDEN / "ungapped_slice.json").read_text())
    launches = {}
    with tempfile.TemporaryDirectory(prefix="meuk_smoke") as td:
        td = pathlib.Path(td)
        phase("4 easy-predict on tests/data against the goldens")
        reset(torch, counters, driver, prefilter)
        out = td / "fixture"
        t0 = time.perf_counter()
        cli.main(["easy-predict", str(ROOT / "tests" / "data" /
                                      "contigs.fna"),
                  str(ROOT / "tests" / "data" / "proteins.faa"), str(out),
                  "--device", "cuda"])
        run_l, run_p = counts(counters)
        print(f"fixture wall {time.perf_counter() - t0:.2f} s, launches "
              f"{run_l}, plain {run_p}")
        for s in SUFFIXES:
            if pathlib.Path(f"{out}.{s}").read_bytes() != \
                    (GOLDEN / f"easypredict.{s}").read_bytes():
                raise AssertionError(f"easypredict.{s} differs from golden")
        if min(run_l[k] for k in PAIR_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("fixture run did not go through the kernels")
        print("fixture: 4 outputs byte-identical to the goldens", flush=True)

        phase("4b easy-predict --prefilter-mode ungapped against the JAX "
              "package's digests")
        reset(torch, counters, driver, prefilter)
        out = td / "ungapped_fixture"
        cli.main(["easy-predict", str(ROOT / "tests" / "data" /
                                      "contigs.fna"),
                  str(ROOT / "tests" / "data" / "proteins.faa"), str(out),
                  "--device", "cuda", "--prefilter-mode", "ungapped"])
        run_l, run_p = counts(counters)
        print(f"ungapped fixture launches {run_l}, plain {run_p}")
        if digests(out) != ungapped["fixture"]["sha256"]:
            raise AssertionError("ungapped fixture digests differ")
        if run_l["gapless_rows"] == 0 or any(run_p.values()):
            raise AssertionError("ungapped fixture run did not go through "
                                 "the gapless kernel")
        meta = ungapped["metagenome"]
        contigs, proteins = make_metagenome(meta["mbp"], meta["targets"],
                                            meta["seed"])
        write_fasta(td / "m.fna", contigs)
        write_fasta(td / "m.faa", proteins)
        reset(torch, counters, driver, prefilter)
        out = td / "ungapped_meta"
        t0 = time.perf_counter()
        EasyPredict(Params(prefilter_mode="ungapped"), device="cuda").run(
            str(td / "m.fna"), str(td / "m.faa"), str(out))
        run_l, run_p = counts(counters)
        print(f"ungapped {meta['mbp']} Mbp wall "
              f"{time.perf_counter() - t0:.2f} s, launches {run_l}, plain "
              f"{run_p}")
        if digests(out) != meta["sha256"]:
            raise AssertionError("ungapped metagenome digests differ")
        if min(run_l[k] for k in UNGAPPED_KERNELS) == 0 or \
                any(run_p.values()):
            raise AssertionError("ungapped metagenome run did not go "
                                 "through the gapless and query-major "
                                 "kernels")
        print("ungapped: fixture and metagenome digests equal "
              "ungapped_slice.json", flush=True)

        phase("4c easy-predict on long frames against the JAX package's "
              "digests")
        long_golden = json.loads((GOLDEN / "long_slice.json").read_text())
        if long_golden["input"] != mls.GOLDEN_INPUT:
            raise AssertionError("long_slice.json was made from another "
                                 "input than make_long_slice.GOLDEN_INPUT")
        contigs, proteins = mls.long_slice(mls.GOLDEN_INPUT)
        write_fasta(td / "g.fna", contigs)
        write_fasta(td / "g.faa", proteins)
        for mode in ("kmer", "ungapped"):
            reset(torch, counters, driver, prefilter)
            out = td / f"long_{mode}"
            t0 = time.perf_counter()
            EasyPredict(Params(prefilter_mode=mode), device="cuda").run(
                str(td / "g.fna"), str(td / "g.faa"), str(out))
            run_l, run_p = counts(counters)
            print(f"long-frame golden, {mode} mode: wall "
                  f"{time.perf_counter() - t0:.2f} s, launches {run_l}, "
                  f"plain {run_p}")
            if digests(out) != long_golden[mode]["sha256"]:
                raise AssertionError(f"long-frame {mode} digests differ")
            need = RT_KERNELS + (("gapless_long",) if mode == "ungapped"
                                 else ())
            if min(run_l[k] for k in need) == 0 or any(run_p.values()):
                raise AssertionError(f"long-frame {mode} run did not go "
                                     f"through {need}")
        print("long frames: k-mer and ungapped digests equal long_slice.json",
              flush=True)

        phase("4d easy-predict against an HMM-profile DB, and slice_search_db")
        prof_golden = json.loads((GOLDEN / "profile_slice.json").read_text())
        reset(torch, counters, driver, prefilter)
        out = td / "profile_fixture"
        cli.main(["easy-predict", str(ROOT / "tests" / "data" /
                                      "contigs.fna"),
                  str(GOLDEN / "profile" / "profileDB"), str(out),
                  "--device", "cuda"])
        run_l, run_p = counts(counters)
        print(f"profile fixture launches {run_l}, plain {run_p}")
        for s in SUFFIXES:
            if pathlib.Path(f"{out}.{s}").read_bytes() != \
                    (GOLDEN / "profile" / f"pp.{s}").read_bytes():
                raise AssertionError(f"pp.{s} differs from golden")
        if min(run_l[k] for k in PROF_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("profile fixture run did not go through the "
                                 "PSSM kernels")
        reset(torch, counters, driver, prefilter)
        mps.write_query_db(mps.SEARCH_QUERIES, td / "qdb")
        profile_search.slice_search_db(
            str(td / "qdb"), str(mps.SEARCH_PROFILES), str(td / "slice_db"),
            device="cuda")
        run_l, run_p = counts(counters)
        got = {s: sha256(f"{td / 'slice_db'}{s}") for s in mps.DB_SUFFIXES}
        if got != prof_golden["slice_search"]["sha256"]:
            raise AssertionError("slice_search_db digests differ")
        if min(run_l[k] for k in PROF_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("slice_search_db did not go through the "
                                 "PSSM kernels")
        print("profile: fixture outputs byte-identical to pp.*, "
              "slice_search_db digests equal profile_slice.json", flush=True)
        check_profile_aligner(np, torch, counters, driver, prefilter)

        phase("4e the search workflows on tests/data against the MMseqs2 "
              "goldens")
        reset(torch, counters, driver, prefilter)
        (td / "wf").mkdir()
        t0 = time.perf_counter()
        check_search_workflows(cli, "cuda", td / "wf")
        run_l, run_p = counts(counters)
        print(f"search workflows {time.perf_counter() - t0:.2f} s, "
              f"launches {run_l}, plain {run_p}", flush=True)
        if min(run_l[k] for k in PAIR_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("the search workflows did not go through "
                                 "the pair kernels")

        phase("4f MetaEuk's modular commands and the taxonomy workflows on "
              "tests/data against the goldens")
        reset(torch, counters, driver, prefilter)
        (td / "mod").mkdir()
        (td / "tax").mkdir()
        t0 = time.perf_counter()
        check_modular_workflows(cli, "cuda", td / "mod")
        check_tax_workflows(cli, "cuda", td / "tax")
        run_l, run_p = counts(counters)
        print(f"modular and taxonomy commands {time.perf_counter() - t0:.2f}"
              f" s, launches {run_l}, plain {run_p}", flush=True)
        if min(run_l[k] for k in PAIR_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("the modular and taxonomy commands did not "
                                 "go through the pair kernels")

        phase("4g the iterative search and the profile tools on the fixtures "
              "against the goldens")
        reset(torch, counters, driver, prefilter)
        (td / "prof").mkdir()
        t0 = time.perf_counter()
        n = check_profile_workflows(cli, "cuda", td / "prof")
        run_l, run_p = counts(counters)
        print(f"iterative search and profile tools: {n} outputs equal to "
              f"their goldens, {time.perf_counter() - t0:.2f} s, launches "
              f"{run_l}, plain {run_p}", flush=True)
        if min(run_l[k] for k in ("sw_pair_ends", *PROF_NOCAP_KERNELS)) \
                == 0 or any(run_p.values()):
            raise AssertionError("the iterative search and the profile tools"
                                 " did not go through K1 and the uncapped "
                                 "PSSM instances")

        phase("4h the clustering and linear-search family on the fixtures "
              "against the MMseqs2 goldens")
        reset(torch, counters, driver, prefilter)
        (td / "clu").mkdir()
        t0 = time.perf_counter()
        n, pcr = check_cluster_workflows(cli, "cuda", td / "clu")
        run_l, run_p = counts(counters)
        print(f"clustering and linear search: {n} outputs equal to their "
              f"goldens, {time.perf_counter() - t0:.2f} s, launches {run_l}, "
              f"plain {run_p}", flush=True)
        # its profile-vs-member step (the other launches are K1/K2's, the
        # recomputed cluster alignments)
        for k, (m, ms) in event_ms(pcr["events"]).items():
            if k not in PROF_NOCAP_PASS:
                continue
            cells = pcr["cells"][PROF_NOCAP_PASS[k]]
            bound_ms = cells * NOCAP_SW_OPS / INT32_OPS_PER_S * 1e3
            print(f"pickconsensusrep: {k} {m} launches, {ms:.3f} ms of "
                  "kernel time (CUDA events around each launch), "
                  f"{pcr['cells'][0]} profile pairs, {cells} cells, bound "
                  f"{bound_ms:.6f} ms (operations)", flush=True)
        if min(run_l[k] for k in PAIR_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("the clustering and linear-search family "
                                 "did not go through the pair kernels")
        if min(pcr["launches"][k] for k in PROF_NOCAP_KERNELS) == 0 or \
                any(pcr["launches"][k] for k in PROF_KERNELS):
            raise AssertionError("pickconsensusrep did not go through the "
                                 "uncapped PSSM instances alone")

        phase("4i the multihit family, the DB utilities and the resident "
              "server on the fixtures against the MMseqs2 goldens")
        t0 = time.perf_counter()
        _, mh = check_db_cli(cli, "cuda", td / "dbcli", probe=lambda: (
            probe_run(torch, counters, driver, prefilter, sw_cuda)))
        print(f"DB utilities and the multihit family: "
              f"{time.perf_counter() - t0:.2f} s; multihitsearch's launches "
              f"{mh['launches']}, plain {mh['plain']}", flush=True)
        if min(mh["launches"][k] for k in PAIR_KERNELS) == 0 or \
                any(mh["plain"].values()):
            raise AssertionError("multihitsearch did not go through the pair "
                                 "kernels")
        check_server_fixture(cli, "cuda", td / "srv")
        print(f"phase 4i: {time.perf_counter() - t0:.2f} s", flush=True)

        phase("4j the M11b commands and search's nucleotide branch on the "
              "fixtures against the MMseqs2 goldens")
        t0 = time.perf_counter()
        reset(torch, counters, driver, prefilter)
        n, _ = check_db_cli(cli, "cuda", td / "util", cases=UTIL_CLI_CASES,
                            fixture=util_cli_fixture)
        run_l, run_p = counts(counters)
        print(f"phase 4j: {n} outputs equal to their goldens, "
              f"{time.perf_counter() - t0:.2f} s; launches {run_l}, plain "
              f"{run_p}", flush=True)
        if any(run_p.values()):
            raise AssertionError("phase 4j called a plain version")

        phase("5 k-mer main path: 1.6 Mbp / 3000-target slice")
        golden = json.loads((GOLDEN / "multichip_slice.json").read_text())
        t5 = t0 = time.perf_counter()
        contigs, proteins = make_metagenome(golden["mbp"], golden["targets"])
        write_fasta(td / "c.fna", contigs)
        write_fasta(td / "p.faa", proteins)
        print(f"generated {len(contigs)} contigs, {len(proteins)} targets "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        out = td / "slice"
        reset(torch, counters, driver, prefilter)
        t0 = time.perf_counter()
        with launch_events(torch, sw_cuda) as sw_ev:
            ep = EasyPredict(device="cuda")
            ep.run(str(td / "c.fna"), str(td / "p.faa"), str(out))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print_sw_ms(sw_ev, "k-mer slice")
        run_l, run_p = counts(counters)
        align_s = sum(driver.PHASE_SECONDS.values())
        cells = driver.CELLS["fwd"] + driver.CELLS["rev"]
        slice_wall = wall
        print(f"slice wall {wall:.3f} s")
        print("stage seconds " + json.dumps(
            {**ep.predict_stage_seconds, **ep.stage_seconds}))
        print("align phase seconds " + json.dumps(driver.PHASE_SECONDS))
        print(f"cells {json.dumps(driver.CELLS)}; aligned cells/s over the "
              f"align phases {cells / align_s:.4e}")
        print(f"launches {run_l} plain {run_p}", flush=True)
        if digests(out) != golden["sha256"]:
            raise AssertionError("slice digests differ")
        if min(run_l[k] for k in PAIR_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("main path did not go through the pair "
                                 "kernels")
        for k in PAIR_KERNELS:
            launches[k] = run_l[k]
        print("slice: 4 sha256 digests equal multichip_slice.json",
              flush=True)

        phase("5b ungapped path: 0.4 Mbp / 3000-target slice")
        t0 = time.perf_counter()
        contigs, proteins = make_metagenome(UNGAPPED_SLICE["mbp"],
                                            UNGAPPED_SLICE["targets"],
                                            UNGAPPED_SLICE["seed"])
        write_fasta(td / "u.fna", contigs)
        write_fasta(td / "u.faa", proteins)
        print(f"generated {len(contigs)} contigs, {len(proteins)} targets "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        tmp = td / "u_tmp"
        out = td / "u_slice"
        p = Params(prefilter_mode="ungapped")
        reset(torch, counters, driver, prefilter)
        t0 = time.perf_counter()
        with launch_events(torch, sw_cuda) as sw_ev, \
                launch_events(torch, ungapped_cuda, by_lq=True) as gap_ev:
            ep = EasyPredict(p, device="cuda")
            ep.run(str(td / "u.fna"), str(td / "u.faa"), str(out),
                   tmp_dir=str(tmp))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print_sw_ms(sw_ev, "ungapped slice (default routing)")
        run_l, run_p = counts(counters)
        print_k7_by_lq(gap_ev, prefilter.CELLS_BY_LQ)
        stages = {**ep.predict_stage_seconds, **ep.stage_seconds}
        gap_cells = prefilter.CELLS["gapless"]
        align_s = sum(driver.PHASE_SECONDS.values())
        cells = driver.CELLS["fwd"] + driver.CELLS["rev"]
        pairs = np.load(tmp / "pref_pairs.npy")
        hits_qm = np.load(tmp / "search_hits.npy")
        print(f"ungapped slice wall {wall:.3f} s, {len(pairs)} candidate "
              f"pairs, {len(hits_qm)} hits")
        print("stage seconds " + json.dumps(stages))
        print("align phase seconds (default routing) "
              + json.dumps(driver.PHASE_SECONDS))
        print(f"gapless cells {gap_cells}; gapless cells/s over the "
              f"ungapped prefilter stage "
              f"{gap_cells / stages['ungapped prefilter']:.4e}")
        print(f"cells {json.dumps(driver.CELLS)}; aligned cells/s over the "
              f"align phases {cells / align_s:.4e}")
        print(f"launches {run_l} plain {run_p}", flush=True)
        if min(run_l[k] for k in UNGAPPED_KERNELS) == 0 or \
                any(run_p.values()):
            raise AssertionError("ungapped path did not go through the "
                                 "gapless and query-major kernels")
        for k in (*UNGAPPED_KERNELS, "gapless_pair"):
            launches[k] = run_l[k]

        # the same pairs through the pair kernels (K1/K2)
        orf_aa = fragments(OrfExtractor(p),
                           SeqDB.from_fasta(str(td / "u.fna"), DBTYPE_NUCL))
        targets = SeqDB.from_fasta(str(td / "u.faa"), DBTYPE_AA)
        reset(torch, counters, driver, prefilter)
        os.environ["METAEUK_QM"] = "off"
        try:
            t0 = time.perf_counter()
            with launch_events(torch, sw_cuda) as sw_ev:
                hits_pair = driver.SearchDriver(p, targets, "cuda").search(
                    orf_aa, pair_generator=pairs)
                torch.cuda.synchronize()
            pair_wall = time.perf_counter() - t0
        finally:
            del os.environ["METAEUK_QM"]
        print_sw_ms(sw_ev, "ungapped slice (METAEUK_QM=off)")
        run_l, _ = counts(counters)
        print(f"pair-kernel alignment of the same pairs {pair_wall:.3f} s; "
              "align phase seconds (METAEUK_QM=off) "
              + json.dumps(driver.PHASE_SECONDS))
        print(f"launches {run_l}", flush=True)
        same_hits(np, hits_qm, hits_pair, "ungapped slice")

        phase("5c long frames at full width: the ungapped slice plus "
              f"{mls.CHIP_SLICE['n_mid'] + mls.CHIP_SLICE['n_long']} "
              "long-frame contigs")
        t0 = time.perf_counter()
        contigs, proteins = mls.long_slice(mls.CHIP_SLICE)
        write_fasta(td / "l.fna", contigs)
        write_fasta(td / "l.faa", proteins)
        long_contigs = [c for c in contigs if c[0].startswith("long")]
        write_fasta(td / "lo.fna", long_contigs)
        frames = mls.chip_slice_lengths()
        print(f"generated {len(contigs)} contigs ({len(frames)} long frames "
              f"of {min(frames)}-{max(frames)} aa in "
              f"{sum(len(c[1]) for c in long_contigs)} nt of contigs), "
              f"{len(proteins)} targets in {time.perf_counter() - t0:.2f} s",
              flush=True)
        tmp = td / "l_tmp"
        p = Params(prefilter_mode="ungapped")
        reset(torch, counters, driver, prefilter)
        t0 = time.perf_counter()
        with launch_events(torch, sw_cuda) as sw_ev, \
                launch_events(torch, ungapped_cuda, by_lq=True) as gap_ev:
            ep = EasyPredict(p, device="cuda")
            ep.run(str(td / "l.fna"), str(td / "l.faa"), str(td / "l_slice"),
                   tmp_dir=str(tmp))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, (n, ms) in event_ms({**sw_ev, **gap_ev}).items():
            print(f"{k}: {n} launches, {ms:.3f} ms of kernel time "
                  "(CUDA events around each launch)", flush=True)
        print_k7_by_lq(gap_ev, prefilter.CELLS_BY_LQ)
        run_l, run_p = counts(counters)
        pairs = np.load(tmp / "pref_pairs.npy")
        hits_qm = np.load(tmp / "search_hits.npy")
        print(f"long-frame slice wall {wall:.3f} s, {len(pairs)} candidate "
              f"pairs, {len(hits_qm)} hits")
        print("stage seconds " + json.dumps(
            {**ep.predict_stage_seconds, **ep.stage_seconds}))
        print("align phase seconds (default routing) "
              + json.dumps(driver.PHASE_SECONDS))
        print(f"gapless cells {prefilter.CELLS['gapless']}; cells "
              f"{json.dumps(driver.CELLS)}")
        print(f"launches {run_l} plain {run_p}", flush=True)
        if min(run_l[k] for k in (*UNGAPPED_KERNELS, *RT_KERNELS,
                                  "gapless_long")) == 0 \
                or any(run_p.values()):
            raise AssertionError("long-frame slice did not go through the "
                                 "gapless (both), query-major and row-tiled "
                                 "kernels")
        for k in (*RT_KERNELS, "gapless_long"):
            launches[k] = run_l[k]
        orf_aa = fragments(OrfExtractor(p),
                           SeqDB.from_fasta(str(td / "l.fna"), DBTYPE_NUCL))
        lens = np.array([len(a) for a in orf_aa])
        cands = np.bincount(pairs[:, 0], minlength=len(lens))[lens > 4096]
        print(f"{len(cands)} fragments over 4096 aa: {int(cands.sum())} "
              f"candidate pairs, {int(cands.min())}-{int(cands.max())} each",
              flush=True)

        # the same pairs through the pair kernels (K1/K2)
        targets = SeqDB.from_fasta(str(td / "l.faa"), DBTYPE_AA)
        reset(torch, counters, driver, prefilter)
        with pair_kernels_only(driver), launch_events(torch, sw_cuda) as ev:
            t0 = time.perf_counter()
            hits_pair = driver.SearchDriver(p, targets, "cuda").search(
                orf_aa, pair_generator=pairs)
            torch.cuda.synchronize()
            pair_wall = time.perf_counter() - t0
        print_sw_ms(ev, "long-frame slice (METAEUK_QM=off)")
        run_l, _ = counts(counters)
        print(f"pair-kernel alignment of the same pairs {pair_wall:.3f} s; "
              "align phase seconds (METAEUK_QM=off, pair launches up to "
              f"{OFF_CELL_BUDGET} cells) " + json.dumps(driver.PHASE_SECONDS))
        print(f"launches {run_l}", flush=True)
        same_hits(np, hits_qm, hits_pair, "long-frame slice")

        # k-mer mode on the long-frame contigs alone, both routings
        hits_k, align_s = {}, {}
        for mode in ("auto", "off"):
            reset(torch, counters, driver, prefilter)
            ctx = pair_kernels_only(driver) if mode == "off" else \
                contextlib.nullcontext()
            with ctx, launch_events(torch, sw_cuda) as ev:
                t0 = time.perf_counter()
                EasyPredict(device="cuda").run(
                    str(td / "lo.fna"), str(td / "l.faa"),
                    str(td / f"lk_{mode}"), tmp_dir=str(td / f"lk_{mode}_tmp"))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print_sw_ms(ev, f"long-frame contigs, k-mer mode, "
                            f"METAEUK_QM={mode}")
            run_l, run_p = counts(counters)
            hits_k[mode] = np.load(td / f"lk_{mode}_tmp" / "search_hits.npy")
            align_s[mode] = sum(driver.PHASE_SECONDS.values())
            print(f"long-frame contigs, k-mer mode, METAEUK_QM={mode}: wall "
                  f"{wall:.3f} s, align phases {align_s[mode]:.3f} s "
                  + json.dumps(driver.PHASE_SECONDS))
            print(f"cells {json.dumps(driver.CELLS)}; launches {run_l} "
                  f"plain {run_p}", flush=True)
            if any(run_p.values()) or (mode == "auto" and min(
                    run_l[k] for k in RT_KERNELS) == 0):
                raise AssertionError("k-mer long-frame run did not go "
                                     "through the kernels")
        same_hits(np, hits_k["auto"], hits_k["off"], "k-mer long-frame run")
        if digests(td / "lk_auto") != digests(td / "lk_off"):
            raise AssertionError("k-mer long-frame outputs differ between "
                                 "the routings")

        phase("5d profile search at full width: the k-mer slice's contigs "
              "against 3000 HMM profiles")
        cfg = prof_golden["input"]
        t0 = time.perf_counter()
        (td / "ps").mkdir()
        contigs_p, profdb = mps.profile_slice(cfg, td / "ps")
        print(f"generated the profile slice {cfg} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        reset(torch, counters, driver, prefilter)
        profile_search.PHASE_SECONDS.clear()
        for k in profile_search.COUNTS:
            profile_search.COUNTS[k] = 0
        out = td / "ps" / "pp"
        t0 = time.perf_counter()
        with launch_events(torch, sw_cuda) as sw_ev:
            ep = EasyPredict(device="cuda")
            ep.run(str(contigs_p), str(profdb), str(out))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_l, run_p = counts(counters)
        pc = profile_search.COUNTS
        print(f"profile slice wall {wall:.3f} s")
        print("stage seconds " + json.dumps(
            {**ep.predict_stage_seconds, **ep.stage_seconds}))
        print("profile search phase seconds "
              + json.dumps(profile_search.PHASE_SECONDS))
        print(f"pairs {pc['pairs']}, forward cells {pc['fwd_cells']}, "
              f"reverse cells {pc['rev_cells']}")
        for k, (n, ms) in event_ms(sw_ev).items():
            cells = pc["fwd_cells"] if "ends" in k else pc["rev_cells"]
            bound_ms = cells * SW_OPS / INT32_OPS_PER_S * 1e3
            print(f"profile slice: {k} {n} launches, {ms:.3f} ms of kernel "
                  f"time (CUDA events around each launch), bound "
                  f"{bound_ms:.3f} ms (operations, {cells} cells; "
                  f"{bound_ms / ms:.1%} of it)", flush=True)
        print(f"launches {run_l} plain {run_p}", flush=True)
        if min(run_l[k] for k in PROF_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("profile slice did not go through the PSSM "
                                 "kernels")
        for k in PROF_KERNELS:
            launches[k] = run_l[k]
        if cfg != mps.PROFILE_SLICE:
            raise AssertionError("profile_slice.json was made from another "
                                 "input than make_profile_slice.PROFILE_SLICE")
        if digests(out) != prof_golden["sha256"]:
            raise AssertionError("profile slice digests differ")
        print("profile slice: 4 sha256 digests equal profile_slice.json",
              flush=True)

        phase("5e the search workflows at full width: 4,000 queries against "
              "the k-mer slice's 3,000 targets")
        import make_search_slice as mss
        search_golden = json.loads((GOLDEN / "search_slice.json")
                                   .read_text())
        if search_golden["input"] != mss.SEARCH_SLICE:
            raise AssertionError("search_slice.json was made from another "
                                 "input than make_search_slice.SEARCH_SLICE")
        if native.get_lib() is None:
            raise AssertionError("the native host library did not load: "
                                 "backtraces would be empty")
        (td / "ss").mkdir()
        runs, got = run_search_slice(
            mss.SEARCH_SLICE, td / "ss", "cuda", probe=lambda: probe_run(
                torch, counters, driver, prefilter, sw_cuda))
        for run, r in runs.items():
            report_search_run(run, r)
        for k in NOCAP_KERNELS:
            launches[k] = runs["align_realign"]["probe"]["launches"][k]
        for k, v in got.items():
            if v != search_golden[k]:
                raise AssertionError(f"search slice {k} digests differ")
        print("search slice: easy_search's m8 and result DB and align "
              "--realign -a's DB equal search_slice.json", flush=True)

        phase("5f MetaEuk's modular commands and taxtocontig at full width: "
              "the k-mer slice, its 3,000 targets under a synthetic "
              "taxonomy")
        import make_tax_slice as mts
        tax_golden = json.loads((GOLDEN / "tax_slice.json").read_text())
        if tax_golden["input"] != mts.TAX_SLICE:
            raise AssertionError("tax_slice.json was made from another input "
                                 "than make_tax_slice.TAX_SLICE")
        (td / "m5").mkdir()
        reset(torch, counters, driver, prefilter)
        t0 = time.perf_counter()
        secs = run_modular(cli, td / "c.fna", td / "p.faa", td / "m5",
                           "cuda")
        run_l, run_p = counts(counters)
        print(f"modular commands on the k-mer slice: wall "
              f"{time.perf_counter() - t0:.3f} s beside phase 5's "
              f"easy-predict wall {slice_wall:.3f} s; seconds "
              + json.dumps(secs))
        print(f"launches {run_l} plain {run_p}", flush=True)
        if digests(td / "m5" / "slice") != golden["sha256"]:
            raise AssertionError("modular commands' slice digests differ "
                                 "from multichip_slice.json")
        if min(run_l[k] for k in PAIR_KERNELS) == 0 or any(run_p.values()):
            raise AssertionError("predictexons did not go through the pair "
                                 "kernels")
        print("modular commands: 4 sha256 digests equal multichip_slice.json",
              flush=True)
        t0 = time.perf_counter()
        paths = mts.tax_slice(mts.TAX_SLICE, td / "m5")
        print(f"generated the tax slice {mts.TAX_SLICE} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        tax_runs = {}
        for run, qm, base in (("taxtocontig", None, "tax"),
                              ("taxtocontig_qm_off", "off", "tax_off")):
            if qm:
                os.environ["METAEUK_QM"] = qm
            try:
                tax_runs[run] = r = run_taxtocontig(
                    cli, mts.taxtocontig_args(
                        mts.TAX_SLICE, paths, td / "m5" / "slice",
                        td / "m5" / base, paths["contigs"]),
                    "cuda", probe=lambda: probe_run(
                        torch, counters, driver, prefilter, sw_cuda))
            finally:
                os.environ.pop("METAEUK_QM", None)
            # every prediction carries all 3,000 targets as candidates, and
            # each of the driver's coarse target tiers (up to 256 aa, up to
            # 1024) holds over 1,000 of them, so the default routing sends
            # every forward pair to K3 (QM_MIN_CANDS 48) and none to K1
            report_tax_run(run, r, PAIR_KERNELS if qm else ("sw_qm_ends",))
            if qm and r["probe"]["launches"]["sw_qm_ends"]:
                raise AssertionError(f"{run} launched K3")
        same_hits(np, tax_runs["taxtocontig"]["hits"],
                  tax_runs["taxtocontig_qm_off"]["hits"],
                  "taxtocontig on the k-mer slice")
        if mts.tsv_digests(td / "m5" / "tax") != \
                mts.tsv_digests(td / "m5" / "tax_off"):
            raise AssertionError("taxtocontig's TSVs differ between the "
                                 "routings")
        print("taxtocontig on the k-mer slice: hits and both TSVs equal "
              "under the default routing and METAEUK_QM=off", flush=True)
        reset(torch, counters, driver, prefilter)
        t0 = time.perf_counter()
        cli.main(["easy-predict", str(paths["cut"]), str(paths["targets"]),
                  str(td / "m5" / "cut"), "--device", "cuda"])
        run_l, run_p = counts(counters)
        print(f"easy-predict on the cut ({mts.TAX_SLICE['cut_contigs']} "
              f"contigs): wall {time.perf_counter() - t0:.3f} s, launches "
              f"{run_l}, plain {run_p}", flush=True)
        if digests(td / "m5" / "cut") != tax_golden["easy_predict"]:
            raise AssertionError("the cut's easy-predict digests differ from "
                                 "tax_slice.json")
        cut = run_taxtocontig(
            cli, mts.taxtocontig_args(mts.TAX_SLICE, paths, td / "m5" / "cut",
                                      td / "m5" / "cut_tax", paths["cut"]),
            "cuda", probe=lambda: probe_run(torch, counters, driver,
                                            prefilter, sw_cuda))
        report_tax_run("taxtocontig_cut", cut, ("sw_qm_ends",))
        if mts.tsv_digests(td / "m5" / "cut_tax") != \
                tax_golden["taxtocontig"]:
            raise AssertionError("the cut's taxtocontig digests differ from "
                                 "tax_slice.json")
        print("tax slice cut: easy-predict and taxtocontig digests equal "
              "tax_slice.json", flush=True)
        print(f"phases 5-5f: {time.perf_counter() - t5:.2f} s", flush=True)

        # phase 5n's process starts here, beside phases 5h-5j, whose host
        # stages leave the card idle: its screen would slow phases 3-5g
        kmerpf, kmerpf_td = stack.enter_context(
            child_process("--kmerpf-slice"))

        phase("5h the clustering and linear-search family at full width: "
              "the search slice's 7,000 proteins, their cut against the JAX "
              "package, then both routings")
        (td / "cs").mkdir()
        t0 = time.perf_counter()
        records, _ = check_cluster_slice(
            np, cli, td / "cs", "cuda", probe=lambda: probe_run(
                torch, counters, driver, prefilter, sw_cuda))
        print("phase 5h walls " + json.dumps(
            {k: round(r["wall"], 3) for k, r in records.items()}))
        print(f"phase 5h: {time.perf_counter() - t0:.2f} s, the script at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

        phase("5i the multihit family at full width: the k-mer slice's 245 "
              "contigs in 35 sets, multihitdb and multihitsearch at both "
              "routings")
        (td / "mh").mkdir()
        t0 = time.perf_counter()
        records = check_multihit_slice(
            np, cli, td / "mh", "cuda", probe=lambda: probe_run(
                torch, counters, driver, prefilter, sw_cuda))
        print("phase 5i walls " + json.dumps(
            {k: round(r["wall"], 3) for k, r in records.items()}))
        print(f"phase 5i: {time.perf_counter() - t0:.2f} s, the script at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

        phase("5j the resident server at full width: gpuserver on the search "
              "slice's 3,000 targets, 4,000 queries a request")
        t0 = time.perf_counter()
        (td / "sv").mkdir()
        q, t = mss.search_slice(mss.SEARCH_SLICE, td / "sv")
        check_server_slice(td / "sv", q, t, "cuda",
                           want=search_golden["easy_search"]["result"])
        print(f"phase 5j: {time.perf_counter() - t0:.2f} s, the script at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

        # phase 5l's worker processes start here, beside phases 5k-6b and
        # 5g's tail: their host stages (a minute of k-mer prefilter on every
        # core) would slow phases 3-5j, which set the script's wall
        dist5l, dist5l_td = stack.enter_context(
            child_process("--dist-slice"))

        phase("5k the runtime Gumbel fit at full size: four scoring systems "
              "of gumbel_slice.json on K1/K2's uncapped instances (their "
              "process, started after the build, joined)")
        t0 = time.perf_counter()
        rc = join_child(gumbel, CHILD_DEADLINE - (t0 - t_start))
        print(f"waited {time.perf_counter() - t0:.2f} s for it; its output:",
              flush=True)
        print((gumbel_td / "log").read_text(), flush=True)
        if rc != 0:
            raise AssertionError(f"phase 5k's process failed (exit {rc})")
        fits = json.loads((gumbel_td / "result.json").read_text())
        for k in NOCAP_KERNELS:
            n = sum(r[k] for r in fits["launches"].values())
            print(f"{k}: {launches[k]} launches in phase 5e's realign run "
                  f"and {n} in phase 5k's fits", flush=True)
            launches[k] += n
        print(f"phase 5k: {fits['seconds']:.2f} s in its process, the script "
              f"at {time.perf_counter() - t_start:.1f} s", flush=True)

        phase("5m the driver's device fan-out and the sharded steps: the "
              "k-mer slice over devices [cuda:0, cuda:0], then the dense "
              "and top-k steps on a 1 x 1 NCCL mesh")
        t0 = time.perf_counter()
        out = td / "fanned"
        with probe_run(torch, counters, driver, prefilter, sw_cuda) as rec:
            EasyPredict(device="cuda", devices=MESH_DEVICES).run(
                str(td / "c.fna"), str(td / "p.faa"), str(out))
        wall = time.perf_counter() - t0
        print(f"5m (a) fanned k-mer slice: wall {wall:.3f} s (phase 5's "
              f"{slice_wall:.3f} s on one entry)", flush=True)
        print_sw_ms(rec["events"], "5m (a) fanned k-mer slice")
        print(f"5m (a) launches {rec['launches']} plain {rec['plain']} "
              "(phase 5 on one entry: " + json.dumps(
                  {k: launches[k] for k in PAIR_KERNELS}) + ")", flush=True)
        if digests(out) != golden["sha256"]:
            raise AssertionError("the fanned slice's digests differ from "
                                 "multichip_slice.json")
        if min(rec["launches"][k] for k in PAIR_KERNELS) == 0 or \
                any(rec["plain"].values()):
            raise AssertionError("the fanned slice did not go through the "
                                 "pair kernels")
        for k in sw_cuda.KERNELS:
            launches[k] = launches.get(k, 0) + rec["launches"][k]
        print("5m (a): 4 sha256 digests equal multichip_slice.json with the "
              f"driver over {MESH_DEVICES}", flush=True)
        t0 = time.perf_counter()
        st = dryrun.SLICE_STEP
        with launch_events(torch, sw_cuda) as mesh_ev:
            mesh_l, _, secs, report = check_mesh_steps(np, torch, sw_cuda,
                                                       "cuda", st)
        ms = event_ms(mesh_ev)["sw_pair_ends_nocap"]
        cells = 2 * st["Bq"] * st["Nt"] * st["Lq"] * st["Lt"]
        print(f"5m (b) the dense and top-{st['k']} steps, {st['Bq']} x "
              f"{st['Nt']} pairs at {st['Lq']} x {st['Lt']} on a 1 x 1 NCCL "
              f"mesh: {secs:.3f} s; sw_pair_ends_nocap {ms[0]} launches, "
              f"{ms[1]:.3f} ms (CUDA events), {cells} cells, bound "
              f"{cells * NOCAP_SW_OPS / INT32_OPS_PER_S * 1e3:.3f} ms "
              "(operations); every output equal to the plain cross product "
              "on the card; collective bytes per rank "
              + json.dumps(report) + "; the 2 x 2 mesh is checked by the "
              "CPU tests only (tests/test_torch_dist.py)", flush=True)
        launches["sw_pair_ends_nocap"] += mesh_l["sw_pair_ends_nocap"]
        print(f"phase 5m: {time.perf_counter() - t0:.2f} s, the script at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

        phase("5n the k-mer-index prefilter at full width: the k-mer "
              "slice's 61,457 fragments against its 3,000 targets, then the "
              "planted cut (its process, started before phase 5h, joined)")
        t0 = time.perf_counter()
        rc = join_child(kmerpf, CHILD_DEADLINE - (t0 - t_start))
        print(f"waited {time.perf_counter() - t0:.2f} s for it; its output:",
              flush=True)
        print((kmerpf_td / "log").read_text(), flush=True)
        if rc != 0:
            raise AssertionError(f"phase 5n's process failed (exit {rc})")
        for k, n in json.loads((kmerpf_td / "result.json").read_text())[
                "launches"].items():
            launches[k] = launches.get(k, 0) + n
        print(f"phase 5n joined, the script at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    phase("6 kernel and plain-version times")
    times, same = time_kernels(torch, np, sw_cuda, sw_torch, ungapped_cuda,
                               ungapped_torch, errs)
    rt_times, _ = time_qm_rt(torch, np, sw_cuda, sw_torch, errs)
    times.update(rt_times)
    times["gapless_long"] = time_gapless_long(torch, np, ungapped_cuda,
                                              ungapped_torch, errs)
    times["gapless_rows"] = time_gapless_rows(torch, np, ungapped_cuda,
                                              ungapped_torch, errs)
    for k, (ms, plain_ms, bound_ms, by) in times.items():
        print(f"{k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}); output equal to the plain "
              "version's", flush=True)

    phase("6b the microbenchmark entry points: kbench (T1-T3) and "
          "kernel_variants (T4)")
    t0 = time.perf_counter()
    tool_times, tool_launches, library = run_tools(
        torch, np, kb, kvar, kbench_cuda, kbench_torch, qm_variants_cuda,
        qm_variants_torch, _build)
    times.update(tool_times)
    launches.update(tool_launches)
    t4_against_k3(torch, np, sw_cuda, qm_variants_cuda)
    print(f"phase 6b: {time.perf_counter() - t0:.2f} s", flush=True)

    phase("5o the bench: python -m metaeuk_tpu_torch bench at 4 Mbp / "
          "8,000 targets with one timed run, and bench --selftest")
    t0 = time.perf_counter()
    runs = run_benches(CHILD_DEADLINE - (t0 - t_start))
    check_bench(runs, json.loads(
        (GOLDEN / "dist_bench_slice.json").read_text()))
    for r in runs.values():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"phase 5o: {time.perf_counter() - t0:.2f} s (bench "
          f"{runs['bench']['seconds']:.2f} s, --selftest joined at "
          f"{runs['selftest']['seconds']:.2f} s, started together), the "
          f"script at {time.perf_counter() - t_start:.1f} s", flush=True)

    phase("5g the iterative search at full width: search "
          "--num-iterations on every second of the search slice's 4,000 "
          "queries, then 3 iterations on its cut (their process, started "
          "after the build, joined)")
    t0 = time.perf_counter()
    rc = join_child(child, CHILD_DEADLINE - (t0 - t_start))
    print(f"waited {time.perf_counter() - t0:.2f} s for it; its output:",
          flush=True)
    print((child_td / "log").read_text(), flush=True)
    if rc != 0:
        raise AssertionError(f"phase 5g's full-slice process failed (exit "
                             f"{rc})")
    full = json.loads((child_td / "result.json").read_text())
    for k in PROF_NOCAP_KERNELS:
        launches[k] = full["launches"][k]
    print(f"phase 5g: the full slice's wall {full['wall']:.3f} s, the "
          f"script at {time.perf_counter() - t_start:.1f} s", flush=True)

    phase("5l the multi-process easy-predict at the size of "
          "dist_bench_slice.json: one process, then two on the card (their "
          "process, started after phase 5j, joined)")
    t0 = time.perf_counter()
    rc = join_child(dist5l, CHILD_DEADLINE - (t0 - t_start))
    print(f"waited {time.perf_counter() - t0:.2f} s for it; its output:",
          flush=True)
    print((dist5l_td / "log").read_text(), flush=True)
    if rc != 0:
        raise AssertionError(f"phase 5l's process failed (exit {rc})")
    for run in json.loads((dist5l_td / "result.json").read_text()).values():
        for rec in run["procs"]:
            for k, (n, _) in rec["kernels"].items():
                launches[k] = launches.get(k, 0) + n
    print(f"phase 5l joined, the script at {time.perf_counter() - t_start:.1f}"
          " s", flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": f"{CSRC}/{src}",
         "replaces": rep, "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": times[k][2], "bound_by": times[k][3],
         "library_ms": library.get(k)}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
