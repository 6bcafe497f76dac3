#!/usr/bin/env python3
"""Smoke run of elasticsearch_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from elasticsearch_tpu_torch/csrc
(nvcc, into elasticsearch_tpu_torch/_build/), indexes a 1M-document
synthetic MS MARCO-passage-shaped corpus into 16 compressed shards on the
card, answers 256 `_search` bodies (match OR / AND / minimum_should_match)
through GpuSearchService from many threads and then through the node's
REST API, the same bodies with boost 1e-15 (weights packable() refuses:
the compressed_exact path), and the traffic once more over a (1, 1)
device mesh through the collective tail, and checks:

  device         nvidia-smi name and power limit, torch and CUDA versions
  build          kernel build seconds; corpus, shards, postings; resident
                 bytes of the compressed pack
  kernel_parity  every launch shape the main path used, plus a u8-delta
                 doc stream index, a match of the corpus's most frequent
                 terms (full 4096-lane slots, T >= 16: rows past the
                 shared-memory sort and select), from + size 10,000
                 (kernel k 16,384, more candidates than kk) and the
                 fixed train's bodies at size 10 (kernel k 128): the
                 kernels against their plain torch version on the card,
                 scores as uint32, docs and totals exactly, with and
                 without totals; slot_decode's own outputs (kth, group
                 and slot bounds, which the results cannot show) against
                 the plain stages bit for bit; the rows (slots, for
                 slot_decode) each size class took (every class must
                 take some); every train's shard_topk (the cross-shard
                 top-k) of the counted run and of those launches against
                 its plain version (values as uint32, positions exact),
                 kernel k 16,384 (its device-memory sort) among them
  e2e            the counted run on GpuSearchService(device="cuda:0"):
                 queries, hits, batch sizes, launches per kernel of the
                 path (all must be > 0), and 16 sampled queries against
                 the numpy oracle (top-10 ids, scores within rel=1e-5,
                 abs=1e-6)
  exact          the first 128 bodies and the stop-word bodies with
                 boost 1e-15 through the service, counts reset just
                 before: compressed_exact trains (> 0, and no compressed
                 one), exact_merge and shard_topk launches (> 0), every
                 exact launch's outputs against the plain version bit for
                 bit (the merge and parts classes taken; the rows of
                 each class from the launch run again with stats), every
                 train's shard_topk, and sampled hits against the oracle
                 times the boost
  mesh           the service on make_mesh() pinned to cuda:0, shape
                 (1, 1): the e2e bodies through the NCCL all_gather and
                 all_reduce at world size 1 (calls counted), its hits
                 equal to the e2e run's bit for bit; the collective
                 tail's ms per train (CUDA events around each nccl call)
                 beside its bytes bound; the cards the machine shows and
                 the one used
  trace          the same traffic again with stage timers and
                 torch.profiler: each request's lowering, wait in the
                 batcher (window and queue), train execution and
                 response assembly; device time and idle share
  kernels_extra  the five kernels' ms (median of 5, CUDA events) and
                 device ms (mean of 5, torch.profiler) at the stop-word,
                 from + size 10,000 and size-10 launches, each one train
                 of its bodies, with the slots slot_decode selects in,
                 and the k10000 gather's shape (timed in kernels)
  kernels        one JSON line: per kernel (the five merge kernels,
                 shard_topk on the fixed train's gather and on the
                 k10000 train's (kernel k 16,384, the device class),
                 exact_merge on the fixed train's bodies with boost 1e-15,
                 also at each window cap), median ms
                 over >= 20 timed
                 launches (CUDA events around each launch: a launch the
                 device waits for counts its wait) and device_ms (mean
                 device time from torch.profiler) of one fixed train (the
                 first 128 bodies, 16 shards x 128 queries), launches per
                 train of the
                 counted run, the plain version's ms (the whole plain
                 pipeline), the bytes bound at 3.35 TB/s, torch.sort as
                 the sort's yardstick and torch.topk as slot_decode's
                 (of its kth alone; no single torch call computes what
                 the other three compute: library_ms null, and
                 library_of says why), torch.topk as shard_topk's and a
                 stable torch.sort of the lanes' (row, doc) keys as
                 exact_merge's, the size classes the rows of the timed
                 launch took, the blocks per SM of the newer kernels, and
                 the slots slot_decode selected in

  rest           the node over HTTP on the card (the path users call; its
                 mesh pinned to cuda:0):
                 1M docs by _bulk (4,000-doc requests from 2 clients),
                 _refresh, _forcemerge, _refresh, then the 256 bodies from
                 128 keep-alive clients with and without _source; every
                 recorded launch against the plain version, the hits
                 against the oracle, the two runs against each other and
                 against e2e (scores bit for bit, ids per score), then
                 the exact phase's bodies (every exact launch and every
                 train's shard_topk against the plain version, the hits
                 against the exact phase's up to ties), the hbm
                 breaker at 0 and memory_allocated() back at its value
                 before the pack after DELETE; ingest docs/s, q/s, the
                 StageTimes of each run, the device idle share, which
                 host C helpers ran, resident bytes. The kernels line
                 adds each kernel's launches in the first REST run
                 (launches_rest; exact_merge's in the exact run)
  planner        the planner path on the same node: the body index and a
                 100,000-doc "typed" index (cut from 1M to keep the run
                 inside its limit; body, a Zipf `views` long, a
                 `published` date, a `tag` keyword, a `flag` boolean) by
                 _bulk; match_all (size 10; from + size 10,000), size 0,
                 bool must/filter/must_not, match_phrase, prefix,
                 wildcard, fuzzy, constant_score, ids, exists,
                 multi_match, min_score, a body matching nothing, ranges
                 on views and published (one past the data: can_match
                 skips), a term on flag and function_score with
                 field_value_factor (log1p; none) from one client: a
                 cold pass of each body once (it builds the host segment
                 packs; its first-request ms is kept apart), then the
                 timed window, the mix PLANNER_ROUNDS times over: q/s,
                 per-request ms over the window, can_match skips,
                 shard_topk launches and size classes; the device busy
                 share of one more round under the profiler;
                 fails on a failed shard, on a window response whose hits
                 differ from the cold pass's, on a shard_topk call of the
                 cold pass != top_k_plain
                 (the k 10,000 tie row and an all -inf row among them), or
                 when execute_query on the card != the CPU plain path on
                 any shard (the log bodies too, bitwise) or the response !=
                 the merge of the card's shard results. The kernels line
                 adds shard_topk on a planner row (~62,600 wide) at k 10
                 and k 10,000
  fields         the rarer field types and an analysis chain on the same
                 node, after planner: a "fields" index of 50,000 docs
                 (cut from 1M; 4 shards; Rally geonames' location,
                 http_logs' clientip, nested's objects in an array) by
                 _bulk, its text under a custom analyzer (standard
                 tokenizer, lowercase, the corpus's 25 most frequent words
                 as stop words, 100 synonym rules over band words,
                 porter_stem), with an ip, a geo_point, an integer and a
                 date range, a rank_feature, nested comments (1-5), a
                 completion and a 64-dim dense_vector; a "queries" index
                 of 1,000 percolator queries. The 256 bodies on the
                 analyzed field without _source and 64 of them at boost
                 1e-15 (counts reset just before: the five fused
                 kernels, exact_merge and shard_topk must launch; every
                 fused shape, exact merge and shard_topk call against
                 its plain version bit for bit; the bodies whose terms
                 the synonyms expand counted, > 0). Then the planner mix
                 (geo_distance in four units, geo_bounding_box with one
                 box across the antimeridian, ip term / CIDR / range,
                 range-field relations, rank_feature saturation with and
                 without a pivot, log, sigmoid and a bool-should hybrid,
                 nested in bool with each score_mode, percolate of 4
                 documents) once cold and once warm: q/s and per-request
                 ms of the warm pass, the device busy share of one more
                 pass under the profiler; fails on a body matching
                 nothing, on a warm response != the cold one, or when
                 execute_query on the card != the CPU plain path on any
                 shard or the response != the merge of the shard
                 results. The kernels line adds launches_fields
  rest_api       the REST remainder on the same node, after fields and
                 before delta, on the 1M-doc rest index at full width:
                 the 256 bodies (no _source) as 4 concurrent _msearch
                 requests of 64 items, each response's bytes equal to
                 its items' _search bytes (took at 0) taken just before;
                 16 boost-1e-15 bodies in one _msearch (exact_merge);
                 16 _count bodies, each equal to the exact total of its
                 search; a filtered alias (a term filter) searched and
                 counted: its bytes == the bool with the filter, per
                 shard execute_query on the card == the CPU plain path;
                 _explain of 8 top hits, card == CPU bitwise; one call
                 each of _field_caps, _validate/query, _termvectors,
                 _analyze, _stats, _nodes/stats, _cluster/health
                 ?wait_for_status=green and the _cat tables (text/plain);
                 then a 20,000-doc, 4-shard index of the line's own (cut
                 from 1M: close, open, shrink and split rebuild packs and
                 copy documents on the host): close, a search's
                 index_closed_exception 400, open, the same bytes as
                 before the close with one pack charged for the index;
                 shrink to 1 shard and split to 8 (a write block first),
                 each target searched (card == CPU per shard, totals
                 kept); DELETE of every index the line made. Counts reset
                 just before and read just after (the five fused
                 kernels, exact_merge and shard_topk must launch), every
                 recorded launch against its plain version bit for bit;
                 the hbm breaker before, at its peak and after, and
                 memory_allocated() back at its value before the line.
                 Its _cat/indices lists the lifecycle index (a 1M-doc
                 index's listing walks every translog op: ~5.5 s).
                 The kernels line adds launches_rest_api
  search_features
                 the planner path's search features, in two parts on
                 indices other lines built: on the planner line's typed
                 index before its DELETE, sort (views desc, published
                 asc, tag), 5 search_after pages of 100 (== one window
                 of 500), collapse on tag, rescore (window 100),
                 highlight, the term and phrase suggesters, a
                 script_score with log and pow, a scroll over one tag's
                 docs (~2,000) in pages of 500 (every _id once, the count
                 == _count) then cleared, a PIT whose search_after pages
                 == the sorted from/size windows then closed (the hbm
                 breaker and memory_allocated() back at their values
                 before the contexts), _rank_eval of 2 requests; on the
                 fields line's index before its DELETE, script_score
                 with cosineSimilarity and l2norm over the 64-dim
                 vectors and the completion suggester. Each body once
                 cold, then FEATURE_ROUNDS warm rounds from one client
                 (the phrase suggester's host scans: one). Counts reset
                 before each part and read after it (shard_topk must
                 launch); every shard_topk call == its plain version,
                 and per body and shard the coordinator's shard query
                 phase under the body's features on the card == the CPU
                 plain path (ids, scores, sort values, totals).
                 Per-feature ms (mean, p50, max), the line's seconds.
                 The rest node's heap is frozen after its ingest
                 (gc.freeze), so the drains' collections skip the 1M
                 docs' objects. The kernels line adds
                 launches_search_features
  delta          streaming appends on the same node (its default chain
                 settings: 4 deltas, 50,000 docs), after the planner
                 line and before the DELETE: 5 batches of 10,000 new
                 corpus docs by _bulk with refresh=true, the 256 bodies
                 (no _source) after each: chains of 1-4 raw delta packs,
                 then a fold by the background compactor, the bodies
                 once more after it; after the fourth batch a probe of
                 the OR bodies with the full-postings tiers shrunk (the
                 only route to pruned_candidates' u32-key mode on a
                 delta). Per run q/s, chain length, delta bytes,
                 StageTimes and launches (counts reset before each);
                 per batch the append's and the refresh-to-searchable
                 seconds, beside the fold's full-build seconds. Fails
                 unless every kernel of the chain launched, every
                 recorded launch equals its plain version bit for bit,
                 the oracle holds on the chain (its own statistics
                 groups), the probe and the fold, the fold equals a
                 fresh delta-off build on the card over the same
                 readers (ids, scores as uint32, totals) and no
                 compaction failed; one more append leaves a chain for
                 the DELETE's drain check. The kernels line adds the
                 u32-key mode's row and every entry's launches_delta

  raw            segments past 65,408 docs, which take a raw pack (int32
                 docs and f32 impacts, doc-sorted and impact-sorted) and
                 the pruned tiers: the corpus over 2 shards (~500,000
                 docs a segment, MS MARCO passage's width at 16 shards),
                 resident through a service with an hbm breaker (its
                 charge = the resident bytes = the doc-sorted pack with
                 its live masks plus the impact-sorted copy); the e2e
                 bodies from 128 clients, counts reset just before and
                 read just after (raw_merge, pruned_candidates and
                 pruned_rescore must each launch), the tiers each query
                 took (full-32, full-128, prefix-16k, escalated-64k,
                 exact), the gte results, q/s and the stage means; then
                 the stop-word bodies at from + size 10,000, the exact
                 phase's boost-1e-15 bodies and prefix-tier probes;
                 every recorded raw_merge / pruned_candidates /
                 pruned_rescore call against its plain version bit for
                 bit, every shard_topk, the 16 sampled hits against the
                 oracle; delete_index drains the breaker to 0 and
                 memory_allocated() back; the routes of the counted run
                 and the probes must equal RAW_TIERS / RAW_GTE (the
                 extra bodies' split between full-32 and exact depends
                 on which trains the from + size 10,000 bodies join),
                 and the queries each pruned_candidates class took in
                 each window are counted (each recorded call launched
                 once more with stats), a class no query took named
                 with the reason. REST: a default one-shard
                 index of 70,000 docs by _bulk, force-merged to one
                 segment, answers a match and an `and` _search 200 from
                 a raw pack. The kernels line adds the three kernels,
                 each timed alone on the first 128 bodies as one train;
                 pruned_candidates also on the probes' widest prefix-16k
                 and escalated-64k groups (its classes, blocks and
                 blocks per SM), pruned_rescore on the probes' widest
                 score-and-order call (with its device ms at each
                 staged-levels setting) and on the fixed train's widest
                 order-only call
  service        the kernel path's remainder, one line a part as it
                 ends (part wide_rows, rest, raw) and a summary of
                 their seconds after raw. Rows past 1,024 slots on the e2e
                 service's 1M-doc pack (after exact): terms over 1,100
                 and 3,000 mid-frequency words (T 2048, 4096; windows
                 past 1,024 terms) and a match of the most frequent
                 words that push a row past 1,024 slots, each at size
                 10 and 1,000 and at boost 1e-15 (exact_merge), one
                 train each, counts reset just before; every launch
                 against the plain version bit for bit (its rows with
                 slots and one padding row, whose outputs every padding
                 row must repeat), each launch's T, window and size
                 classes, the size-1,000 bodies' top-10 against the
                 oracle. On the raw pack (in raw): a match of its most
                 frequent words, as many as fill more than 1,024 and
                 2,048 slots a row (the exact ref launch: raw_merge at
                 T 2048 and 4096), checked the same way. On the rest node (after
                 its waves and exact run, before planner): prewarm of
                 the 1M-doc index (its seconds, signatures, a request
                 sent while it runs answered by the planner), three
                 `profile: true` bodies (the kernel section's variant
                 and plan-cache outcome; the response the wave's),
                 `timeout: 10s` (the kernel), a planner body at
                 `timeout: 0ms` (timed out, == the same request on the
                 CPU), the slow log at 0 ms (one line a shard) and
                 after its reset (none). The rest line gains each
                 wave's plan-cache hits and misses (every body of the
                 second wave hits), the most trains in flight at once
                 (a launch begun, its finish not ended; each wave must
                 reach 2) and
                 the batch_wait split's means. The
                 kernels line adds the fused train, exact_merge and
                 raw_merge at T 2048 and 4096 (CUDA-event and device
                 ms, the plain version on the checked rows, the bytes
                 bound, a stable torch.sort of the same keys)

The last line is {"ok": true, "device": {...}}; any failure exits
non-zero without it. Without a CUDA device the script exits 2 at once.
"""

from __future__ import annotations

import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_DOCS = 1_000_000      # cut from MS MARCO passage's 8.8M to fit the run
VOCAB = 30_000
SEED = 42
SHARDS = 16
N_QUERIES = 256
K = 1000                # from + size: the kernel's k bucket is 1024
WAVES = (128, 64, 64)   # concurrent client waves → 128- and 64-query trains
ORACLE_SAMPLE = 16
MAX_K = 10_000          # the largest from + size the service takes
TIMED = 25              # timed kernel launches after warm-up
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FIELD = "body"
INDEX = "msmarco"
REST_INDEX = "msmarco-rest"
BULK_DOCS = 4000        # docs per _bulk request
BULK_CLIENTS = 2
REST_CLIENTS = 128
PALLAS_LINE = "elasticsearch_tpu/ops/pallas_merge.py:155"
#: the XLA steps the two newer kernels replace
TOPK_LINE = "elasticsearch_tpu/parallel/distributed.py:703"
EXACT_LINE = "elasticsearch_tpu/ops/sparse.py:549"
EXACT_BOOST = 1e-15
TYPED_INDEX = "typed"
TYPED_DOCS = 100_000    # cut from 1M to keep the smoke inside its limit
TYPED_SHARDS = 4
PLANNER_ROUNDS = 1      # the planner's timed window: the mix this many
                        # times (cut from 5 for the delta line, from 2 for
                        # the service line)
PLANNER_TOPK_LINE = "elasticsearch_tpu/ops/bm25.py:138"
FEATURE_ROUNDS = 3      # warm rounds of the search_features bodies
FEATURE_PAGES = 5       # search_after pages of the sort body
FEATURE_RESCORE_WINDOW = 100
FEATURE_TAG = "t3"      # ~2,000 of the typed index's docs
FEATURE_SCROLL_PAGE = 500
FIELDS_INDEX = "fields"
FIELDS_DOCS = 50_000    # cut from 1M to keep the phase near 120 s
FIELDS_SHARDS = 4
FIELDS_STOP = 25        # the corpus's most frequent words, as stop words
FIELDS_SYNONYMS = 100   # equivalence rules of 3 band words (ids 20-3000)
FIELDS_EXACT = 64       # bodies of the analyzed field with boost 1e-15
VEC_DIMS = 64
QUERIES_INDEX = "queries"
STORED_QUERIES = 1_000
RAW_INDEX = "msmarco-raw"
RAW_SHARDS = 2          # ~500,000 docs a segment: MS MARCO passage's width
                        # at 16 shards, past the 16-bit doc stream
RAW_REST_INDEX = "raw-rest"
RAW_REST_DOCS = 70_000  # one default shard above 65,408 docs: a raw pack
RAW_KERNELS = ("raw_merge", "pruned_candidates", "pruned_rescore")
#: the routes of the raw line's counted run and probes (queries a tier
#: took; each probe a train of its own) and their gte results: the pruned
#: kernels compute the reference's function, so a kernel change cannot
#: move them. The extra bodies' split between full-32 and exact is not
#: fixed: a train's k is its largest from + size, and an OR body that
#: shares a train with a from + size 10,000 body takes exact
RAW_TIERS = {"run": {"full-32": 128, "exact": 128},
             "probes": {"full-128": 2, "prefix-16k": 6, "escalated-64k": 2,
                        "exact": 2}}
RAW_GTE = {"run": 0, "probes": 4}
RAW_EXTRA = (130, ("full-32", "exact"))   # queries, the tiers they take
#: why the raw traffic may leave a pruned_candidates class untaken
CAND_CLASS_ABSENT = {
    "cand.shared": "every phase-A query of this traffic holds more than "
                   "CAND_BAND_CAP lanes (a term of a 500,000-doc row "
                   "fills its 4,096-lane slots)",
    "cand.bands": "no phase-A query of this traffic holds more than "
                  "CAND_BAND_CAP lanes",
    "cand.device": "no band of this traffic holds more than CAND_BAND_CAP "
                   "items: a query's lanes spread evenly over its gids, "
                   "and its bands are cut for half the cap; the kernel "
                   "tests shrink the cap to reach the class",
}
RAW_LINES = {"raw_merge": "elasticsearch_tpu/ops/sparse.py:666",
             "pruned_candidates": "elasticsearch_tpu/parallel/"
                                  "distributed.py:971",
             "pruned_rescore": "elasticsearch_tpu/parallel/"
                               "distributed.py:1052"}
#: the kernels each path launches
MAIN_KERNELS = ("slot_decode", "row_pack", "row_sort", "run_sum",
                "select_rescore", "shard_topk")
EXACT_KERNELS = ("exact_merge", "shard_topk")
#: the five kernels of one fused merge launch
FUSED_KERNELS = ("slot_decode", "row_pack", "row_sort", "run_sum",
                 "select_rescore")
#: the delta phase (in the rest node, after the planner): batches of
#: new corpus docs appended by _bulk with refresh=true, a search round
#: after each; the node's default chain settings (4 deltas, 50,000 docs)
DELTA_BATCHES = 5
DELTA_DOCS = 10_000
#: one more append after the fold, so that the DELETE meets a chain
DELTA_TAIL_DOCS = 2_000
#: the kernels the delta phase must launch: the compressed base's, the
#: raw deltas' (raw_merge for AND / msm, the full-postings tier for OR),
#: and pruned_candidates' u32-key mode in the prefix probe
DELTA_KERNELS = MAIN_KERNELS + RAW_KERNELS + ("pruned_candidates.pack_keys",)
#: the rest_api line (in the rest node, after fields, before delta): the
#: 256 bodies as MSEARCH_CLIENTS concurrent _msearch requests, the
#: first REST_API_EXACT with boost 1e-15 in one more, REST_API_COUNTS
#: _count bodies, ALIAS_BODIES searches and counts through a filtered
#: alias, _explain of REST_API_EXPLAIN top hits; and the lifecycle on a
#: LIFE_DOCS-doc index of its own (close, open, shrink, split)
MSEARCH_CLIENTS = 4
REST_API_EXACT = 16
REST_API_COUNTS = 16
REST_API_EXPLAIN = 8
ALIAS = "msmarco-filtered"
ALIAS_BODIES = 4
LIFE_INDEX = "rest-life"
LIFE_DOCS = 20_000      # cut from 1M: the lifecycle copies docs on the host
LIFE_SHARDS = 4
#: the exact merge's classes the exact phase's rows must take (a row of
#: one window and a row cut into parts; the radix class takes a row only
#: when one of its slots' docs descend)
#: the service line's wide rows: terms bodies over this many mid-frequency
#: words from vocabulary rank WIDE_FIRST_RANK (one slot a term a row:
#: T 2048, T 4096), and the raw pack's most frequent words (past 8 terms:
#: the exact ref launch), as many as fill more than each of
#: WIDE_RAW_SLOTS slots a row: raw_merge at T 2048 and 4096
SERVICE_BUDGET_S = 30   # the service line's parts together
WIDE_TERMS = (1100, 3000)
WIDE_FIRST_RANK = 200
WIDE_RAW_SLOTS = (1024, 2048)
WIDE_TIMED_SLOTS = (2048, 4096)
WIDE_TIMED = 3          # timed launches of a wide kernels-line entry
WIDE_PLAIN_ROWS = 4     # rows of a wide launch the plain version takes at once
WIDE_ROW_OPERANDS = ("res_starts", "res_lens", "blk_starts", "slot_terms",
                     "dbs_starts", "dlo_starts")
WIDE_FN = {"fused": "fused_merge_topk", "exact": "exact_merge_topk",
           "raw": "raw_merge_topk"}
WIDE_PLAIN = {"fused": "fused_merge_topk_plain",
              "exact": "exact_merge_topk_plain",
              "raw": "raw_merge_topk_plain"}
EXACT_REQUIRED = ("exact.merge", "exact.parts")
#: window caps (lanes) at which the kernels line also times exact_merge
EXACT_WINDOW_CAPS = (1024, 2048, 4096, 8192)
KERNEL_SOURCE = "elasticsearch_tpu_torch/csrc/merge_topk.cu"
#: the size-class counters (merge_kernel.SIZE_CLASSES) of each kernel
CLASSES_OF = {"slot_decode": ("slot_decode",), "row_pack": ("row_pack",),
              "row_sort": ("row_sort",),
              "run_sum": ("run_sum",),
              "select_rescore": ("select", "rescore", "final")}
#: the one torch call that computes each kernel's function, or why none
LIBRARY_OF = {
    "slot_decode": "torch.topk(imp, kk, dim=2) on the decoded [R, T, "
                   "max_len] lane bounds of the same launch: the kth "
                   "output only; the decode of the code16 stream and the "
                   "group and slot upper bounds are not in it",
    "row_pack": "none: decode, block-max skip and compaction into packed "
                "keys; torch.masked_select compacts but does not decode "
                "or skip",
    "row_sort": "torch.sort of the same keys, the row id in the high bits",
    "run_sum": "none: segment_reduce sums runs in another order (the "
               "reference's doubling tree is not a torch call) and has no "
               "msm filter or count-key totals",
    "select_rescore": "none: torch.topk breaks ties in no fixed order and "
                      "does not rescore through the residual tables",
}


_T0 = time.perf_counter()
#: the cyclic collector's full (generation 2) collections: count and
#: seconds since the start (a pause stops every serving thread)
GC_FULL = {"count": 0, "seconds": 0.0}
_GC_START = []


def _gc_timer(phase, info):
    if info.get("generation") != 2:
        return
    if phase == "start":
        _GC_START.append(time.perf_counter())
    elif _GC_START:
        GC_FULL["count"] += 1
        GC_FULL["seconds"] += time.perf_counter() - _GC_START.pop()


def log(phase: str, **fields) -> None:
    """One phase's line; t_s is the seconds since the script started,
    gc_full the full collections so far (count, seconds)."""
    fields["t_s"] = time.perf_counter() - _T0
    fields["gc_full"] = dict(GC_FULL)
    print(f"{phase}: " + json.dumps(fields, sort_keys=False), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_bodies(corpus):
    """128 OR, 64 AND and 64 minimum_should_match=2 match bodies."""
    bodies = []
    for qi in range(N_QUERIES):
        text = corpus.query_text(qi)
        if qi % 4 == 1:
            spec = {"query": text, "operator": "and"}
        elif qi % 4 == 2:
            spec = {"query": text, "minimum_should_match": 2}
        else:
            spec = {"query": text}
        bodies.append({"query": {"match": {FIELD: spec}}, "size": K})
    return bodies


def drive(svc, index, bodies, refused=None):
    """Send `bodies` in concurrent waves; → responses in order. With a
    `refused` list, a query the kernel path refuses (NotLowerable with
    planner False: more slots a row than its merge kernel holds) answers
    None and its body joins the list; without one the refusal raises."""
    from elasticsearch_tpu_torch.common.errors import NotLowerable

    def search(body):
        try:
            return svc.search(index, body)
        except NotLowerable as exc:
            if refused is None or exc.planner:
                raise
            refused.append(body)
            return None

    out = [None] * len(bodies)
    pos = 0
    with ThreadPoolExecutor(max_workers=max(WAVES)) as pool:
        for wave in WAVES:
            idx = list(range(pos, min(pos + wave, len(bodies))))
            futs = [pool.submit(search, bodies[i]) for i in idx]
            for i, f in zip(idx, futs):
                out[i] = f.result()
            pos += wave
        rest = list(range(pos, len(bodies)))
        futs = [pool.submit(search, bodies[i]) for i in rest]
        for i, f in zip(rest, futs):
            out[i] = f.result()
    return out


def build_index(svc, name, corpus, n_docs, shards):
    """Route docs by the reference's murmur3 of the _id and build one
    segment per shard from the token ids (array ops; a CPU test holds
    this equal to SegmentWriter)."""
    import numpy as np

    from elasticsearch_tpu_torch.index.segment import segment_from_token_ids
    from elasticsearch_tpu_torch.indices.routing import shard_for

    ids = [f"d{i}" for i in range(n_docs)]
    shard_of = np.array([shard_for(i, shards) for i in ids])
    svc.create_index(name, shards, {"properties": {FIELD: {"type": "text"}}})
    segments = []
    for s in range(shards):
        members = np.nonzero(shard_of == s)[0]
        seg = segment_from_token_ids(
            f"{name}-s{s}", [ids[i] for i in members],
            [corpus.doc_tokens[i] for i in members], corpus.vocab, FIELD)
        svc.add_segment(name, s, seg)
        segments.append(seg)
    return segments


class LaunchRecorder:
    """Wraps merge_kernel.<fn> (fused_merge_topk, or exact_merge_topk)
    while a path runs and keeps the operands of the first launch of
    every distinct shape; with every=True, the operands and the outputs
    (device copies) of every launch instead."""

    def __init__(self, merge_kernel, fn="fused_merge_topk", every=False):
        self.mk = merge_kernel
        self.fn = fn
        self.every = every
        self.real = getattr(merge_kernel, fn)
        self.shapes = {}
        self.launches = []

    def __enter__(self):
        def record(*args, **kw):
            out = self.real(*args, **kw)
            if self.every:
                self.launches.append((args, dict(kw),
                                      tuple(o.clone() for o in out)))
            else:
                r, t = args[2].shape
                key = (r, t, kw["max_len"], kw["k"],
                       bool(kw["with_counts"]),
                       kw.get("doc_bases") is not None)
                self.shapes.setdefault(key, (args, dict(kw)))
            return out
        setattr(self.mk, self.fn, record)
        return self

    def __exit__(self, *exc):
        setattr(self.mk, self.fn, self.real)


def exact_recorder(merge_kernel):
    """A LaunchRecorder of the exact merge (kernel_ab.fixed_train's
    recorder argument)."""
    return LaunchRecorder(merge_kernel, "exact_merge_topk")


class TopkRecorder:
    """Wraps merge_kernel.shard_topk (the cross-shard top-k of every
    train: sparse.hierarchical_top_k calls it) while a path runs and
    keeps each call's input, k and outputs (device copies). With `tag`,
    a function of no arguments, `tags` holds in step with `calls` what
    it returned at each call."""

    def __init__(self, merge_kernel, stats=None, tag=None):
        self.mk = merge_kernel
        self.real = merge_kernel.shard_topk
        self.calls = []
        self.stats = stats   # the size classes of every call, when given
        self.tag = tag
        self.tags = []

    def __enter__(self):
        def record(vals, k, **kw):
            if self.stats is not None and "stats" not in kw:
                kw["stats"] = self.stats
            out = self.real(vals, k, **kw)
            self.calls.append((vals.clone(), k, out[0].clone(),
                               out[1].clone()))
            if self.tag is not None:
                self.tags.append(self.tag())
            return out
        self.mk.shard_topk = record
        return self

    def __exit__(self, *exc):
        self.mk.shard_topk = self.real


def check_topk_calls(mk, calls):
    """Every recorded shard_topk against the plain version on its input:
    values as uint32, positions exactly; raises on a mismatch. Empties
    `calls` as it goes → {calls, shapes}."""
    import torch
    shapes = {}
    n = 0
    while calls:
        vals, k, got_v, got_p = calls.pop()
        want_v, want_p = mk.shard_topk_plain(vals, k)
        if not (torch.equal(got_v.view(torch.int32),
                            want_v.view(torch.int32))
                and torch.equal(got_p, want_p)):
            raise AssertionError(f"shard_topk != plain at [{vals.shape[0]},"
                                 f" {vals.shape[1]}] k={k}")
        key = f"B{vals.shape[0]}xN{vals.shape[1]}k{k}"
        shapes[key] = shapes.get(key, 0) + 1
        n += 1
        del vals, got_v, got_p
    return {"calls": n, "shapes": shapes,
            "tolerance": "bitwise: values as uint32, positions exact"}


def check_exact_launches(mk, launches):
    """Every recorded exact-merge launch's outputs against the plain
    version on its operands: scores as uint32, docs and totals exactly;
    raises on a mismatch. Empties `launches` → {launches, shapes}."""
    import torch
    shapes = {}
    classes = dict.fromkeys(mk.EXACT_CLASSES, 0)
    n = 0
    while launches:
        args, kw, got = launches.pop()
        # the rows each class took: the launch again with stats (after
        # the counted run), which must give the recorded outputs
        stats = {}
        again = mk.exact_merge_topk(*args, **dict(kw, stats=stats))
        for name, rows in stats["exact_classes"].items():
            classes[name] += rows
        want = mk.exact_merge_topk_plain(*args, **kw)
        torch.cuda.synchronize()
        same, err = bitwise_equal(list(got), list(want))
        r, t = args[2].shape
        key = f"R{r}xT{t}k{kw['k']}"
        if not same or not bitwise_equal(list(again), list(got))[0]:
            raise AssertionError(f"exact merge != plain at {key}, "
                                 f"max_abs_err {err}")
        shapes[key] = shapes.get(key, 0) + 1
        n += 1
        del args, kw, got, want
    return {"launches": n, "shapes": shapes, "size_classes": classes,
            "tolerance": "bitwise: scores as uint32, docs and totals "
                         "exact"}


def exact_bodies(bodies):
    """The match bodies with boost EXACT_BOOST on the clause: the slot
    weight idf·(k1+1)·boost falls below PACKED_WEIGHT_MIN, so the batch
    fails packable() and takes compressed_exact (at 1M docs idf·2.2 is
    at most ~31, where a boost of 1e-13 would still pass)."""
    out = []
    for b in bodies:
        (field, spec), = b["query"]["match"].items()
        spec = spec if isinstance(spec, dict) else {"query": spec}
        out.append(dict(b, query={"match": {
            field: dict(spec, boost=EXACT_BOOST)}}))
    return out


def exact_phase(svc, mk, corpus, bodies, segments, stop_bodies):
    """The compressed_exact path through the service at the e2e width:
    the first 128 bodies and the stop-word bodies with boost 1e-15, the
    launch counts reset just before and read just after; every exact
    launch's outputs and every train's shard_topk against their plain
    versions; the sampled hits against the oracle scaled by the boost.
    → (log fields, responses, launches, trains)."""
    run = exact_bodies(bodies[:128]) + exact_bodies(stop_bodies)
    mk.reset_launches()
    svc.variant_launches.clear()
    svc.batcher.batch_sizes.clear()
    with LaunchRecorder(mk, "exact_merge_topk", every=True) as rec, \
            TopkRecorder(mk) as top:
        t0 = time.perf_counter()
        responses = drive(svc, INDEX, run)
        wall = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    variants = dict(svc.variant_launches)
    trains = sum(svc.batcher.batch_sizes.values())
    if not variants.get("compressed_exact") or variants.get("compressed"):
        raise AssertionError(f"the exact bodies took {variants}")
    zero = [n for n in EXACT_KERNELS if launches[n] <= 0]
    if zero:
        raise AssertionError(f"kernels not launched on the exact path: "
                             f"{zero}")
    parity = check_exact_launches(mk, rec.launches)
    if not all(parity["size_classes"][c] for c in EXACT_REQUIRED):
        raise AssertionError(f"an exact size class took no row: "
                             f"{parity['size_classes']}")
    topk = check_topk_calls(mk, top.calls)
    sample = oracle_check(responses[:128], run[:128], corpus, segments,
                          boost=EXACT_BOOST)
    for resp in responses[128:]:
        hits = resp["hits"]
        if len(hits["hits"]) != min(K, hits["total"]["value"]):
            raise AssertionError(f"exact stop-word body: "
                                 f"{len(hits['hits'])} hits of "
                                 f"{hits['total']}")
    out = dict(queries=len(run), boost=EXACT_BOOST, seconds=wall,
               hits=sum(len(r["hits"]["hits"]) for r in responses),
               trains=trains, variant_launches=variants,
               compressed_exact_launches=variants["compressed_exact"],
               launches=launches, exact_parity=parity, shard_topk=topk,
               oracle_checked=len(sample),
               oracle_tolerance="top-10 ids, scores rel=1e-5 "
                                "abs=1e-6 x boost")
    return out, run, responses, launches, trains


def mesh_phase(segments, bodies, mk, e2e_responses):
    """The service on make_mesh() pinned to one card, shape (1, 1): the
    e2e index (its segments) and bodies, through the collective tail
    (NCCL all_gather and all_reduce at world size 1), counts reset just
    before and read just after; hits equal to the e2e run's bit for bit
    (same segments, so the same ordinals and tie order)."""
    import torch
    from torch.cuda import nccl

    from elasticsearch_tpu_torch.parallel.mesh import make_mesh
    from elasticsearch_tpu_torch.search.gpu_service import GpuSearchService

    mesh = make_mesh(devices=[torch.device("cuda", 0)])
    svc = GpuSearchService(mesh=mesh, max_batch=128)
    calls = {"all_gather": 0, "all_reduce": 0}
    saved = {name: getattr(nccl, name) for name in calls}
    timed = []   # (name, start event, end event, bytes moved)

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors or ())

    def counted(name):
        def call(inputs, outputs=None, *a, **kw):
            calls[name] += 1
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = saved[name](inputs, outputs, *a, **kw)
            end.record()
            # each input read once and each output written once (an
            # in-place all_reduce writes its inputs)
            timed.append((name, start, end, nbytes(inputs)
                          + nbytes(outputs if outputs is not None
                                   else inputs)))
            return out
        return call

    spent = {}
    t_phase = time.perf_counter()
    try:
        svc.create_index(INDEX, SHARDS,
                         {"properties": {FIELD: {"type": "text"}}})
        for s, seg in enumerate(segments):
            svc.add_segment(INDEX, s, seg)
        t_warm = time.perf_counter()
        drive(svc, INDEX, bodies[:8])   # places the pack
        spent["warm_s"] = time.perf_counter() - t_warm
        for name in calls:
            setattr(nccl, name, counted(name))
        mk.reset_launches()
        svc.batcher.batch_sizes.clear()
        with TopkRecorder(mk) as top:
            t0 = time.perf_counter()
            responses = drive(svc, INDEX, bodies)
            wall = time.perf_counter() - t0
        launches = dict(mk.LAUNCHES)
        trains = sum(svc.batcher.batch_sizes.values())
    finally:
        for name, fn in saved.items():
            setattr(nccl, name, fn)
        t_close = time.perf_counter()
        svc.close()
        spent["close_s"] = time.perf_counter() - t_close
    spent["phase_s"] = time.perf_counter() - t_phase
    zero = [n for n in MAIN_KERNELS if launches[n] <= 0]
    if zero:
        raise AssertionError(f"kernels not launched on the mesh path: "
                             f"{zero}")
    if not calls["all_gather"] or not calls["all_reduce"]:
        raise AssertionError(f"the mesh path made no NCCL collective: "
                             f"{calls}")
    if hits_of(responses) != hits_of(e2e_responses):
        raise AssertionError("the (1, 1) mesh's hits differ from the e2e "
                             "run's")
    torch.cuda.synchronize()
    tail_ms = sum(a.elapsed_time(b) for _, a, b, _ in timed)
    tail_bytes = sum(n for *_, n in timed)
    tail = {"trains": trains, "calls": len(timed),
            "ms_per_train": tail_ms / max(trains, 1),
            "bytes_per_train": tail_bytes / max(trains, 1),
            "bound_ms_per_train": tail_bytes / max(trains, 1)
            / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes (world size 1: the collectives copy within "
                        "the card)",
            "timed_by": "CUDA events around each nccl call"}
    cards = torch.cuda.device_count()
    out = dict(shape=[1, 1], devices=[str(d) for d in mesh.devices],
               cards_visible=cards, cards_used=1,
               queries=len(responses), seconds=wall,
               qps=len(responses) / wall, nccl_calls=calls,
               collective_tail=tail,
               launches=launches, shard_topk=check_topk_calls(mk, top.calls),
               hits_equal_e2e="bit for bit: ids and scores in order",
               **spent)
    if cards > 1:
        out["note"] = (f"the machine shows {cards} cards; this phase used "
                       f"one (cuda:0)")
    return out


def bitwise_equal(got, want):
    import torch
    if len(got) != len(want):
        return False, float("inf")
    a, b = got[0], want[0]
    same = (torch.equal(a.view(torch.int32), b.view(torch.int32))
            and all(torch.equal(x, y) for x, y in zip(got[1:], want[1:])))
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a[fin].double() - b[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        err = float("inf")
    return same, err


def check_launch(mk, label, args, kw):
    """One recorded launch: the kernels against their plain version on
    its operands, with and without totals, and slot_decode's own outputs
    → (entry, worst error, size classes taken); raises on a mismatch."""
    import torch
    stats = {}
    got = mk.fused_merge_topk(*args, **dict(kw, stats=stats))
    want = mk.fused_merge_topk_plain(*args, **kw)
    torch.cuda.synchronize()
    same, err = bitwise_equal(got, want)
    # slot_decode's kth, grp_ub and slot_ub: a kth too low would only
    # make the skip drop fewer lanes, which the results cannot show
    slot_diff = None
    if stats["do_skip"]:
        slot_diff = mk.slot_decode_mismatches(
            stats["slot_decode_output"], mk.slot_decode_plain(*args, **kw))
    r, t = args[2].shape
    took = {c: n for c, n in stats["classes"].items() if n}
    entry = dict(launch=label, rows=r, slots=t, max_len=kw["max_len"],
                 k=kw["k"], msm_rows=int((args[5] > 1).sum()),
                 delta=kw.get("doc_bases") is not None,
                 with_totals=bool(kw["with_totals"]),
                 skip=bool(stats["do_skip"]),
                 lanes=stats["lanes"], keys_after_skip=stats["keys"],
                 keys_before_skip=stats["count_keys"],
                 candidates=stats["candidates"],
                 select_slots=stats["select_slots"], size_classes=took,
                 bitwise=same,
                 slot_decode_bitwise=None if slot_diff is None
                 else not slot_diff)
    if not same:
        raise AssertionError(f"kernel != plain at shape {entry}, "
                             f"max_abs_err {err}")
    if slot_diff:
        raise AssertionError(f"slot_decode's {slot_diff} != the plain "
                             f"stages' at shape {entry}")
    # the same operands without totals (no pre-skip count keys)
    kw2 = dict(kw, with_totals=False)
    same2, err2 = bitwise_equal(mk.fused_merge_topk(*args, **kw2),
                                mk.fused_merge_topk_plain(*args, **kw2))
    if not same2:
        raise AssertionError(f"kernel != plain without totals at {entry}")
    return entry, max(err, err2), took


def kernel_parity(mk, launches):
    """The kernels against their plain version on each recorded launch
    [(label, args, kw)], with and without totals → (entries, worst
    error, rows per size class over all launches)."""
    worst = 0.0
    checked = []
    skipping = 0
    classes = dict.fromkeys(mk.SIZE_CLASSES, 0)
    for label, args, kw in launches:
        entry, err, took = check_launch(mk, label, args, kw)
        worst = max(worst, err)
        for c, n in took.items():
            classes[c] += n
        checked.append(entry)
        if entry["keys_before_skip"] > entry["keys_after_skip"]:
            skipping += 1
        if label == "stopwords" and not (took.get("row_sort.device")
                                         and took.get("select.device")
                                         and took.get("row_pack.split")
                                         and took.get("run_sum.tiled")):
            raise AssertionError(f"the stop-word launch stayed in shared "
                                 f"memory: {entry}")
        if label == "k10000" and not (kw["k"] == mk.K_LIMIT
                                      and took.get("final.trim")):
            raise AssertionError(f"the k = 10,000 launch did not trim "
                                 f"past kk: {entry}")
        if label == "size10 train" and not (kw["k"] == 128 and took.get(
                "slot_decode.select_warp")):
            raise AssertionError(f"the size-10 train did not select in "
                                 f"short slots at kernel k 128: {entry}")
    if not skipping:
        raise AssertionError("no parity shape dropped lanes through the "
                             "block-max skip")
    missing = [c for c, n in classes.items() if not n]
    if missing:
        raise AssertionError(f"size classes no parity launch took: "
                             f"{missing}")
    return checked, worst, classes


def oracle_check(responses, bodies, corpus, segments, boost=1.0):
    """Top-10 of sampled queries vs the numpy oracle, its scores times
    the bodies' `boost` (tolerances scaled with them). `segments` lists
    the statistics groups in pack-row order: a segment (one shard), or
    a list of segments that share their statistics (a shard's segments
    in one pack; a delta chain's groups, pack by pack). Ties go to the
    earlier group, then segment, then the lower doc."""
    import numpy as np

    from elasticsearch_tpu_torch.ops import reference_impl

    groups = [g if isinstance(g, (list, tuple)) else [g] for g in segments]
    n = len(responses)
    sample = list(range(0, n, max(1, n // ORACLE_SAMPLE)))[:ORACLE_SAMPLE]
    for qi in sample:
        spec = bodies[qi]["query"]["match"][FIELD]
        terms = spec["query"].split()
        need = (len(terms) if spec.get("operator") == "and"
                else int(spec.get("minimum_should_match", 1)))
        ranked, dense = [], []
        for gi, group in enumerate(groups):
            doc_count, avgdl = reference_impl.shard_stats(group, FIELD)
            dfs = {t: reference_impl.shard_doc_freq(group, FIELD, t)
                   for t in terms}
            for si, seg in enumerate(group):
                scores = reference_impl.score_segment(
                    seg, FIELD, terms, doc_count=doc_count, avgdl=avgdl,
                    doc_freqs=dfs)
                cnt = np.zeros(seg.num_docs, dtype=np.int64)
                for t in terms:
                    entry = seg.postings[FIELD].get(t)
                    if entry is not None:
                        cnt[entry[0]] += 1
                scores = np.where(cnt >= need, scores, 0.0).astype(
                    np.float32)
                dense.append({seg.doc_ids[d]: float(scores[d]) * boost
                              for d in np.nonzero(scores > 0)[0]})
                for d, sc in reference_impl.topk_from_scores(scores, 10):
                    ranked.append((-sc, gi, si, d, seg.doc_ids[d]))
        ranked.sort()
        expect = [(doc_id, -neg * boost) for neg, _, _, _, doc_id in
                  ranked[:10]]
        hits = responses[qi]["hits"]["hits"][:10]
        if len(hits) != len(expect):
            raise AssertionError(f"query {qi}: {len(hits)} hits, oracle "
                                 f"{len(expect)}")
        oracle_of = {}
        for d in dense:
            oracle_of.update(d)
        atol = 1e-6 * boost
        for pos, (hit, (eid, esc)) in enumerate(zip(hits, expect)):
            if abs(hit["_score"] - esc) > atol + 1e-5 * abs(esc):
                raise AssertionError(f"query {qi} rank {pos}: score "
                                     f"{hit['_score']} vs oracle {esc}")
            if hit["_id"] != eid:
                # equal ids up to ties: the doc taken must score the same
                # as the oracle's doc at this rank, within the tolerance
                alt = oracle_of.get(hit["_id"], 0.0)
                if abs(alt - esc) > atol + 1e-5 * abs(esc):
                    raise AssertionError(f"query {qi} rank {pos}: id "
                                         f"{hit['_id']} vs oracle {eid}")
    return sample


def traced_run(svc, bodies, mk):
    """The main path once more, with host-clock timers around the
    service's stages and torch.profiler recording CUDA activity: where a
    request's and a batch's time goes and how long the device sits idle.
    The timer around the kernel call synchronizes the device before and
    after."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch.parallel import distributed as dist
    from elasticsearch_tpu_torch.search import gpu_service as gs

    spent = {"execute": 0.0, "prepare": 0.0, "kernel_call": 0.0,
             "finish": 0.0}
    lock = threading.Lock()

    def timed(name, fn, sync):
        def wrapper(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                with lock:
                    spent[name] += time.perf_counter() - t
        return wrapper

    # per request: search() entry, submit, its train's start and end,
    # search() return (the flat query object names the request; `alive`
    # keeps each one, so no two requests share an id())
    marks, alive = {}, []
    current = threading.local()
    real_search, real_submit = svc.search, svc.batcher.submit
    real_launch, real_finish = svc.batcher.launch, svc.batcher.finish

    def search(name, body):
        t = time.perf_counter()
        resp = real_search(name, body)
        marks[current.flat]["enter"] = t
        marks[current.flat]["leave"] = time.perf_counter()
        return resp

    def submit(resident, flat, k):
        current.flat = id(flat)
        alive.append(flat)
        marks[id(flat)] = {"submit": time.perf_counter()}
        return real_submit(resident, flat, k)

    # a train: its launch (on the pack's launch worker) to its finish
    # (on the completion thread); trains overlap, their halves are summed
    def launch(resident, flats, k):
        t = time.perf_counter()
        st = real_launch(resident, flats, k)
        with lock:
            spent["execute"] += time.perf_counter() - t
        st["trace_start"] = t
        return st

    def finish(st):
        t = time.perf_counter()
        try:
            return real_finish(st)
        finally:
            t_end = time.perf_counter()
            with lock:
                spent["execute"] += t_end - t
            for f in st["flats"]:
                marks[id(f)].update(start=st["trace_start"], end=t_end)

    patches = [(dist, "prepare_query_batch", "prepare", False),
               (mk, "fused_merge_topk", "kernel_call", True),
               (gs, "_finish_exact", "finish", False)]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _, _ in patches]
    for obj, attr, name, sync in patches:
        setattr(obj, attr, timed(name, getattr(obj, attr), sync))
    saved += [(svc, "search", real_search),
              (svc.batcher, "submit", real_submit),
              (svc.batcher, "launch", real_launch),
              (svc.batcher, "finish", real_finish)]
    svc.search, svc.batcher.submit = search, submit
    svc.batcher.launch, svc.batcher.finish = launch, finish
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive(svc, INDEX, bodies)
            wall = time.perf_counter() - t0
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    per_name = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            per_name[ev.key] = per_name.get(ev.key, 0.0) + us / 1e3
    busy_ms = sum(per_name.values())
    top = dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:8])
    stages = {"lower": ("enter", "submit"), "batcher_wait": ("submit",
                                                             "start"),
              "train": ("start", "end"), "assemble": ("end", "leave")}
    per_request = {}
    for stage, (a, b) in stages.items():
        ms = sorted((m[b] - m[a]) * 1e3 for m in marks.values())
        per_request[stage] = {"mean_ms": statistics.fmean(ms),
                              "p50_ms": ms[len(ms) // 2],
                              "max_ms": ms[-1]}
    return dict(
        queries=len(bodies), window_s=svc.batcher.window_s,
        per_request=per_request, wall_s=wall,
        batch_execute_s=spent["execute"],
        prepare_query_batch_s=spent["prepare"],
        kernel_call_s=spent["kernel_call"], finish_s=spent["finish"],
        outside_batches_s=wall - spent["execute"],
        device_busy_ms=busy_ms if busy_ms > 0 else "not measured",
        device_idle_share=(1.0 - busy_ms / 1e3 / wall) if busy_ms > 0
        else "not measured",
        top_device_ms=top)


def rest_raw(host, port, method, path, body=None, raw=None, conn=None):
    """One request to the node over HTTP/1.1 → (status, body bytes,
    content type)."""
    import http.client
    own = conn is None
    if own:
        conn = http.client.HTTPConnection(host, port, timeout=600)
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    conn.request(method, path, data,
                 {"Content-Type": "application/x-ndjson" if raw is not None
                  else "application/json"})
    resp = conn.getresponse()
    payload = resp.read()
    if own:
        conn.close()
    return resp.status, payload, resp.getheader("Content-Type")


def rest_raw_many(host, port, requests, clients):
    """(method, path, body, raw) requests from `clients` threads, each on
    its own keep-alive connection → ([(status, bytes)] in order, wall
    s)."""
    import http.client
    import threading
    local = threading.local()

    def one(req):
        conn = getattr(local, "conn", None)
        if conn is None:
            conn = local.conn = http.client.HTTPConnection(host, port,
                                                           timeout=600)
        method, path, body, raw = req
        status, data, _ = rest_raw(host, port, method, path, body, raw,
                                   conn=conn)
        return status, data

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        out = list(pool.map(one, requests))
    return out, time.perf_counter() - t0


def rest_http(host, port, method, path, body=None, raw=None, conn=None):
    """One request to the node over HTTP/1.1 → (status, parsed body)."""
    status, payload, _ = rest_raw(host, port, method, path, body, raw, conn)
    return status, (json.loads(payload) if payload else None)


def rest_bulk_load(host, port, corpus, n_docs, index=REST_INDEX):
    """_bulk n_docs corpus documents (ids d{i}) in BULK_DOCS-doc NDJSON
    requests from BULK_CLIENTS clients, then _refresh → seconds."""
    import http.client
    import threading
    starts = list(range(0, n_docs, BULK_DOCS))
    errors = []

    def client(ci):
        conn = http.client.HTTPConnection(host, port, timeout=600)
        try:
            for si in range(ci, len(starts), BULK_CLIENTS):
                lines = []
                for i in range(starts[si], min(starts[si] + BULK_DOCS,
                                               n_docs)):
                    lines.append('{"index":{"_id":"d%d"}}' % i)
                    lines.append(json.dumps({FIELD: corpus.doc_text(i)}))
                status, resp = rest_http(
                    host, port, "POST", f"/{index}/_bulk",
                    raw=("\n".join(lines) + "\n").encode(), conn=conn)
                if status != 200 or resp.get("errors"):
                    errors.append(str(resp)[:500])
                    return
        finally:
            conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(BULK_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"_bulk failed: {errors[0]}")
    status, resp = rest_http(host, port, "POST", f"/{index}/_refresh")
    if status != 200:
        raise AssertionError(f"_refresh: {resp}")
    return time.perf_counter() - t0


def rest_queries(host, port, bodies, index=REST_INDEX):
    """`bodies` as POST /{index}/_search from REST_CLIENTS threads, each
    on its own keep-alive connection → (responses in order, wall s)."""
    t0 = time.perf_counter()
    answers, _ = rest_raw_many(
        host, port, [("POST", f"/{index}/_search", b, None) for b in bodies],
        REST_CLIENTS)
    for status, data in answers:
        if status != 200:
            raise AssertionError(f"_search {status}: {data[:500]!r}")
    return [json.loads(d) for _, d in answers], time.perf_counter() - t0


def device_busy_ms(prof):
    """Device time summed over the profiled kernels, ms (0: none seen)."""
    busy = 0.0
    for ev in prof.key_averages():
        busy += getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
    return busy


def hits_of(responses):
    """[(ids, scores)] of each response's hits."""
    return [([h["_id"] for h in r["hits"]["hits"]],
             [h["_score"] for h in r["hits"]["hits"]]) for r in responses]


def same_up_to_ties(got, want):
    """Two runs over the same documents whose ordinals may differ (two
    _bulk clients interleave their requests, and ties break toward the
    lower ordinal): the same scores bit for bit in the same order, the
    same ids at each score, and at each response's last score (where the
    window cuts a tie) the same number of hits."""
    if len(got) != len(want):
        return False
    for (g_ids, g_sc), (w_ids, w_sc) in zip(got, want):
        if g_sc != w_sc:
            return False
        last = w_sc[-1] if w_sc else None
        g_by, w_by = {}, {}
        for by, ids, scores in ((g_by, g_ids, g_sc), (w_by, w_ids, w_sc)):
            for i, sc in zip(ids, scores):
                if sc != last:
                    by.setdefault(sc, set()).add(i)
        if g_by != w_by:
            return False
    return True


def planner_bodies(corpus):
    """The planner line's bodies: (index, label, body). The body index's
    words are generator words (ids 20-3000: neither stop words nor
    hapaxes); the phrase is two adjacent words of a document, the pair
    whose commoner word is rarest (few candidates to verify)."""
    tokens = corpus.doc_tokens[123_457]
    pair = max(range(len(tokens) - 1),
               key=lambda i: min(tokens[i], tokens[i + 1]))
    phrase = f"{corpus.vocab[tokens[pair]]} {corpus.vocab[tokens[pair + 1]]}"
    q0 = corpus.query_text(0)
    out = [
        ("match_all_10", {"query": {"match_all": {}}, "size": 10}),
        ("match_all_k10000", {"query": {"match_all": {}}, "from": 9990,
                              "size": 10}),
        ("size_0", {"query": {"match": {FIELD: q0}}, "size": 0}),
        ("bool", {"query": {"bool": {
            "must": [{"match": {FIELD: "w25 w40"}}],
            "filter": [{"term": {FIELD: "w90"}}],
            "must_not": [{"term": {FIELD: "w31"}}]}}, "size": 100}),
        ("match_phrase", {"query": {"match_phrase": {FIELD: phrase}}}),
        ("prefix", {"query": {"prefix": {FIELD: "w123"}}, "size": 50}),
        ("wildcard", {"query": {"wildcard": {FIELD: "w12?4"}}}),
        ("fuzzy", {"query": {"fuzzy": {FIELD: "w1234"}}, "size": 20}),
        ("constant_score", {"query": {"constant_score": {
            "filter": {"term": {FIELD: "w77"}}, "boost": 1.5}}}),
        ("ids", {"query": {"ids": {"values": ["d1", "d500000", "d999999",
                                             "nope"]}}}),
        ("exists", {"query": {"exists": {"field": FIELD}}}),
        ("multi_match", {"query": {"multi_match": {
            "query": corpus.query_text(1), "fields": [FIELD]}},
            "size": 30}),
        ("min_score", {"query": {"match": {FIELD: corpus.query_text(2)}},
                       "min_score": 8.0, "size": 50}),
        ("no_match", {"query": {"bool": {"must_not": [
            {"match_all": {}}]}}}),
    ]
    typed = [
        ("range_views", {"query": {"range": {"views": {"gte": 3,
                                                       "lt": 40}}},
                         "size": 50}),
        ("range_published", {"query": {"range": {"published": {
            "gte": "2021-01-01", "lt": "2022-07-01T00:00:00Z"}}},
            "size": 50}),
        ("range_future", {"query": {"range": {"published": {
            "gte": "2030-01-01"}}}}),
        ("term_flag", {"query": {"term": {"flag": True}}, "size": 20}),
        ("fvf_log1p", {"query": {"function_score": {
            "query": {"match": {FIELD: q0}},
            "field_value_factor": {"field": "views",
                                   "modifier": "log1p"}}}, "size": 100}),
        ("fvf_none", {"query": {"function_score": {
            "query": {"bool": {"filter": [{"term": {"flag": False}}]}},
            "field_value_factor": {"field": "views", "factor": 0.5,
                                   "missing": 1},
            "boost_mode": "replace"}}, "size": 100}),
    ]
    return ([(REST_INDEX, label, b) for label, b in out]
            + [(TYPED_INDEX, label, b) for label, b in typed])


def typed_bulk_load(host, port, corpus):
    """The typed index: TYPED_DOCS corpus bodies with a Zipf `views`
    long, a `published` date (epoch millis over 2019-2024), a `tag`
    keyword and a `flag` boolean, from the seed; by _bulk, then
    _refresh → seconds."""
    import numpy as np
    status, resp = rest_http(host, port, "PUT", f"/{TYPED_INDEX}", {
        "settings": {"number_of_shards": TYPED_SHARDS,
                     "translog": {"durability": "async"}},
        "mappings": {"properties": {
            FIELD: {"type": "text"}, "views": {"type": "long"},
            "published": {"type": "date"}, "tag": {"type": "keyword"},
            "flag": {"type": "boolean"}}}})
    if status != 200:
        raise AssertionError(f"PUT {TYPED_INDEX}: {resp}")
    rng = np.random.default_rng(SEED + 1)
    views = np.minimum(rng.zipf(1.5, TYPED_DOCS), 10**7)
    published = 1546300800000 + rng.integers(0, 6 * 365 * 86_400_000,
                                             TYPED_DOCS)
    tags = rng.integers(0, 50, TYPED_DOCS)
    flags = rng.random(TYPED_DOCS) < 0.3
    t0 = time.perf_counter()
    for start in range(0, TYPED_DOCS, BULK_DOCS):
        lines = []
        for i in range(start, min(start + BULK_DOCS, TYPED_DOCS)):
            lines.append('{"index":{"_id":"t%d"}}' % i)
            lines.append(json.dumps({
                FIELD: corpus.doc_text(i), "views": int(views[i]),
                "published": int(published[i]), "tag": f"t{tags[i]}",
                "flag": bool(flags[i])}))
        status, resp = rest_http(host, port, "POST",
                                 f"/{TYPED_INDEX}/_bulk",
                                 raw=("\n".join(lines) + "\n").encode())
        if status != 200 or resp.get("errors"):
            raise AssertionError(f"typed _bulk: {str(resp)[:500]}")
    status, resp = rest_http(host, port, "POST", f"/{TYPED_INDEX}/_refresh")
    if status != 200:
        raise AssertionError(f"typed _refresh: {resp}")
    return time.perf_counter() - t0


def same_shard_results(got, want):
    """Two execute_query results: ids in order, scores as uint32 and
    totals."""
    import numpy as np
    if got.total_hits != want.total_hits or len(got.hits) != len(want.hits):
        return False
    g = np.array([h.score for h in got.hits], dtype=np.float32)
    w = np.array([h.score for h in want.hits], dtype=np.float32)
    return [h.doc_id for h in got.hits] == [h.doc_id for h in want.hits] \
        and np.array_equal(g.view(np.uint32), w.view(np.uint32))


def chain_groups(chain):
    """The statistics groups of a delta chain in its union's row order:
    pack by pack, each of its index shards' segments (oracle_check's
    `segments`)."""
    groups = []
    for part in chain.parts:
        rows = {}
        for row, seg in enumerate(part.row_segments):
            rows.setdefault(part.pack.row_group[row], []).append(seg)
        groups += [rows[g] for g in sorted(rows)]
    return groups


def delta_append(host, port, docs, first, n):
    """_bulk n documents (docs(i) the text of the i-th) as ids d{first},
    d{first + 1}, ...: BULK_DOCS-doc requests, the last with
    ?refresh=true → (seconds of the whole append, seconds of the last
    request)."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=600)
    t0 = time.perf_counter()
    try:
        for lo in range(0, n, BULK_DOCS):
            hi = min(n, lo + BULK_DOCS)
            lines = []
            for i in range(lo, hi):
                lines.append('{"index":{"_id":"d%d"}}' % (first + i))
                lines.append(json.dumps({FIELD: docs(i)}))
            last = hi == n
            t_last = time.perf_counter()
            status, resp = rest_http(
                host, port, "POST", f"/{REST_INDEX}/_bulk"
                + ("?refresh=true" if last else ""),
                raw=("\n".join(lines) + "\n").encode(), conn=conn)
            if status != 200 or resp.get("errors"):
                raise AssertionError(f"delta _bulk: {str(resp)[:500]}")
    finally:
        conn.close()
    end = time.perf_counter()
    return end - t0, end - t_last


def delta_phase(host, port, node, corpus, bodies, mk, smi):
    """_delta_run with a delta-off service of the same mesh beside the
    node's (the fold's oracle), closed however the run ends."""
    from elasticsearch_tpu_torch.search.gpu_service import GpuSearchService
    full = GpuSearchService(mesh=node.gpu_search.mesh, max_batch=128)
    try:
        return _delta_run(host, port, node, corpus, bodies, mk, smi, full)
    finally:
        full.close()


def _delta_run(host, port, node, corpus, bodies, mk, smi, full):
    """Streaming appends to the rest node's resident 1M-doc index (the
    node's default delta settings): DELTA_BATCHES batches of DELTA_DOCS
    new corpus docs (ids past the first million) by _bulk with
    refresh=true, each followed by the 256 bodies (no _source) from
    REST_CLIENTS clients: chains of 1-4 raw deltas, then a fifth that
    crosses max_packs and makes the background compactor fold the chain;
    the bodies once more after the fold. After the fourth batch, the OR
    bodies again with the full-postings tiers shrunk (a probe: no body
    of this traffic reaches the prefix tier on a delta, whose rows hold
    ~625 docs, so the u32-key mode of pruned_candidates would not run).
    Counts reset before each run and read after it. Checks: every
    recorded launch against its plain version bit for bit (fused shapes,
    raw_merge / pruned_candidates / pruned_rescore calls, every
    shard_topk); the chain's and the probe's hits against the oracle
    with the chain's statistics groups; after the fold, the node's hits
    equal a fresh delta-off build's on the card over the same readers
    (ids, scores as uint32, totals) and the oracle's; no compaction
    failure. Leaves one more delta chained, for the DELETE's drain
    check → (log fields, kernels entries, launches by kernel)."""
    from concurrent.futures import ThreadPoolExecutor as Pool

    import torch

    from elasticsearch_tpu_torch.benchmark import corpus as corpus_mod
    from elasticsearch_tpu_torch.search import dsl, gpu_service

    gs = node.gpu_search
    svc = node.indices.index(REST_INDEX)
    if not gs.packs.delta_enabled or gs.stats()["deltas"]["packs"]:
        raise AssertionError("the rest node serves no bare chain: "
                             f"{gs.stats()['deltas']}")
    n_new = DELTA_BATCHES * DELTA_DOCS + DELTA_TAIL_DOCS
    t_phase = t0 = time.perf_counter()
    new = corpus_mod.generate(n_new, vocab_size=VOCAB, num_queries=1,
                              seed=SEED + 1)
    out = {"nvidia_smi": smi, "batches": DELTA_BATCHES,
           "batch_docs": DELTA_DOCS, "max_packs": gs.packs.delta_max_packs,
           "max_docs": gs.packs.delta_max_docs,
           "corpus_s": time.perf_counter() - t0}
    run_bodies = [dict(b, _source=False) for b in bodies]
    or_bodies = [b for i, b in enumerate(run_bodies) if i % 4 in (0, 3)]
    appended = 0
    total_launches = dict.fromkeys(DELTA_KERNELS, 0)
    runs = []

    def run(label, these):
        gs.stages.reset()
        mk.reset_launches()
        responses, wall = rest_queries(host, port, these)
        launches = dict(mk.LAUNCHES)
        for name in DELTA_KERNELS:
            total_launches[name] += launches[name]
        st = gs.stats()["deltas"]
        runs.append(dict(
            run=label, queries=len(responses), wall_s=wall,
            qps=len(responses) / wall, chain_len=st["packs"],
            delta_bytes=st["bytes"], launches={
                n: launches[n] for n in DELTA_KERNELS},
            stage_means_ms={k: v["mean_ms"]
                            for k, v in gs.stages.snapshot().items()}))
        return responses

    with LaunchRecorder(mk) as rec, RawRecorder(mk) as raw, \
            TopkRecorder(mk) as top:
        for b in range(DELTA_BATCHES):
            append_s, last_s = delta_append(
                host, port, lambda i, o=appended: new.doc_text(o + i),
                N_DOCS + appended, DELTA_DOCS)
            appended += DELTA_DOCS
            t1 = time.perf_counter()
            rest_queries(host, port, run_bodies[:1])   # builds the delta
            first_s = time.perf_counter() - t1
            responses = run(f"batch{b + 1}", run_bodies)
            runs[-1].update(append_s=append_s, docs=appended,
                            refresh_to_searchable_s=last_s + first_s,
                            first_search_s=first_s)
            if b == 3:
                chain = gs.packs.get_chain(svc, FIELD)
                groups4 = chain_groups(chain)
                del chain
                chain4 = responses
                # the probe: OR bodies on the prefix tier of each delta
                saved = gpu_service.FULL_SLOT_BUCKETS
                gpu_service.FULL_SLOT_BUCKETS = (1,)
                try:
                    n_raw = len(raw.calls)
                    probed = run("probe", or_bodies)
                finally:
                    gpu_service.FULL_SLOT_BUCKETS = saved
                probe_calls = [c for c in raw.calls[n_raw:]
                               if c[0] == "pruned_candidates"
                               and c[2].get("pack_keys")]
        # the oracle of the fold: a fresh delta-off build over the same
        # readers, built while the compactor folds the chain
        t3 = time.perf_counter()
        full.packs.get(svc, FIELD)
        out["fresh_build_s"] = time.perf_counter() - t3
        # the fold: the fifth delta crossed max_packs
        t2 = time.perf_counter()
        while not (gs.compaction_idle()
                   and gs.delta_stats.compactions >= 1):
            if time.perf_counter() - t2 > 600:
                raise AssertionError("the compactor did not fold the "
                                     f"chain: {gs.stats()['deltas']}")
            time.sleep(0.05)
        wait_s = time.perf_counter() - t2
        folded = run("after_fold", run_bodies)
    t_checks = time.perf_counter()
    ds = gs.stats()["deltas"]
    out.update(runs=runs, compactions=ds["compactions"],
               compaction_failures=ds["compaction_failures"],
               compact_s=ds["compact_seconds"], fold_wait_s=wait_s,
               full_rebuild_s=ds["compact_seconds"],
               appends=ds["appends"])
    if ds["compaction_failures"] or ds["compactions"] != 1 or ds["packs"]:
        raise AssertionError(f"delta lifecycle: {ds}")
    if [r["chain_len"] for r in runs[:4]] != [1, 2, 3, 4]:
        raise AssertionError(f"chain lengths {[r['chain_len'] for r in runs]}")
    zero = [n for n in DELTA_KERNELS if total_launches[n] <= 0]
    if zero:
        raise AssertionError(f"delta phase: kernels not launched: {zero}")
    # the probe's kernel timed before the checks consume the calls
    if not probe_calls:
        raise AssertionError("the probe made no u32-key candidates call")
    kernels = [pack_keys_entry(mk, max(probe_calls, key=lambda c: int(
        c[1][3].clamp(min=0, max=c[2]["max_len"]).sum())),
        runs[4]["launches"]["pruned_candidates.pack_keys"])]
    del probe_calls
    # every launch against its plain version
    shapes = list(rec.shapes.values())
    rec.shapes.clear()
    worst = 0.0
    n_shapes = len(shapes)
    while shapes:
        args, kw = shapes.pop()
        _, err, _ = check_launch(mk, "delta", args, kw)
        worst = max(worst, err)
        del args, kw
    out["parity"] = dict(fused_shapes=n_shapes, max_abs_err=worst,
                         raw=check_raw_calls(mk, raw.calls),
                         shard_topk=check_topk_calls(mk, top.calls),
                         tolerance="bitwise: scores as uint32, docs, gids "
                                   "and totals exact")
    # the oracle: the chain of four with its own statistics groups, the
    # probe's hits likewise (exact scores, their rounding may differ from
    # the full tier's), the fold with one group a shard
    segs = [[v.segment for v in svc.shard(s).acquire_searcher().views]
            for s in range(SHARDS)]
    t_oracle = time.perf_counter()
    out["oracle_checked"] = {
        "chain4": len(oracle_check(chain4, run_bodies, corpus, groups4)),
        "probe": len(oracle_check(probed, or_bodies, corpus, groups4)),
        "after_fold": len(oracle_check(folded, run_bodies, corpus, segs))}
    totals = {id(b): r["hits"]["total"] for b, r in zip(run_bodies, chain4)}
    if [r["hits"]["total"] for r in probed] != [totals[id(b)]
                                                  for b in or_bodies]:
        raise AssertionError("the probe's totals differ from the chain's")
    out["oracle_s"] = time.perf_counter() - t_oracle
    del chain4, probed, groups4, segs
    # the fold against the fresh delta-off build over the same readers
    def same(body):
        q = dsl.parse_query(body["query"])
        return same_flat_result(gs.try_search(svc, q, k=K),
                                full.try_search(svc, q, k=K))

    with Pool(max_workers=REST_CLIENTS) as pool:
        equal = list(pool.map(same, run_bodies))
    differ = [i for i, e in enumerate(equal) if not e]
    if differ:
        raise AssertionError(f"queries {differ[:8]}: the fold != a fresh "
                             f"full build")
    out["fold_equals_full_build"] = len(equal)
    full.close()
    # one more append: the DELETE after this phase meets a chain
    append_s, last_s = delta_append(
        host, port, lambda i: new.doc_text(appended + i),
        N_DOCS + appended, DELTA_TAIL_DOCS)
    rest_queries(host, port, run_bodies[:8])
    if gs.stats()["deltas"]["packs"] != 1:
        raise AssertionError(f"no chain before DELETE: "
                             f"{gs.stats()['deltas']}")
    out["tail"] = dict(docs=DELTA_TAIL_DOCS, append_s=append_s,
                       chain=gs.stats()["deltas"])
    del new
    torch.cuda.synchronize()
    out.update(checks_s=time.perf_counter() - t_checks,
               seconds=time.perf_counter() - t_phase)
    return out, kernels, total_launches


def same_flat_result(got, want):
    """Two kernel-path results: ids in order, scores as uint32, totals
    and their relation."""
    import numpy as np
    return (got.total_hits == want.total_hits
            and got.total_relation == want.total_relation
            and np.array_equal(got.scores.view(np.uint32),
                               want.scores.view(np.uint32))
            and np.array_equal(got.resident.resolve_ids(got.rows, got.ords),
                               want.resident.resolve_ids(want.rows,
                                                         want.ords)))


def pack_keys_entry(mk, call, launches):
    """The kernels line's row of pruned_candidates in its u32-key mode
    (pack_keys), on the probe's widest call: ms, device ms, the plain
    version, the bytes bound, and a stable torch.sort of the same u32
    keys (query in the high bits) as the library call."""
    import torch

    from elasticsearch_tpu_torch.ops import sparse

    _, args, kw, got = call
    flat_docs, flat_imps, starts, lengths, weights, prow = args
    max_len, d1 = kw["max_len"], kw["d_pad"] + 1
    docs = sparse._window(flat_docs, starts, max_len)
    imps = sparse._window(flat_imps, starts, max_len)
    valid = (torch.arange(max_len, device=docs.device)[None, None, :]
             < lengths[:, :, None])
    grel = (prow.to(torch.int64) - int(prow[0, 0])).clamp(min=0)
    key = (((grel[:, :, None] * d1 + docs) << 16)
           | sparse.impact_code16(weights[:, :, None] * imps))
    qrow = torch.arange(docs.shape[0], device=docs.device)[:, None, None]
    keys = ((qrow << 32) | key)[valid]
    del docs, imps, valid, key
    stats = {}
    mk.pruned_candidates(*args, **dict(kw, stats=stats))
    e = timed_entry(
        "merge_topk.pruned_candidates.pack_keys", "pruned_candidates",
        lambda ev: mk.pruned_candidates(*args, **dict(kw, events=ev)),
        ("cand_part_kernel", "cand_band_kernel"),
        lambda: mk.pruned_candidates_plain(*args, **kw),
        "pruned_candidates_plain (pack_keys): the group's sort of u32 "
        "keys, run sums and top-k",
        time_cuda(lambda: torch.sort(keys, stable=True), TIMED),
        "torch.sort(stable=True) of the same lanes' u32 keys (group gid "
        "<< 16 | impact code), the query in the high bits: the sort alone",
        raw_bytes("pruned_candidates", args, kw, got),
        group="the delta phase's probe: its widest prefix-16k group on a "
              "delta",
        shape={"queries": starts.shape[0], "slots": starts.shape[1],
               "max_len": max_len, "k": kw["k"], "pack_keys": True,
               "lanes": int(keys.numel())},
        size_classes=stats["cand_classes"], blocks=stats["cand_blocks"],
        smem=stats["cand_smem"], blocks_per_sm=stats["cand_blocks_per_sm"])
    e.update(route="cuda", source=KERNEL_SOURCE,
             replaces=RAW_LINES["pruned_candidates"], launches=launches,
             max_abs_err=0.0, bound_ms=e["bytes"] / HBM_BYTES_PER_S * 1e3,
             bound_by="bytes")
    return e


def search_once(host, port, what, index, label, body):
    """One POST /{index}/_search from one client → (response, ms);
    raises on a status other than 200 or a failed shard."""
    t1 = time.perf_counter()
    status, resp = rest_http(host, port, "POST", f"/{index}/_search", body)
    ms = (time.perf_counter() - t1) * 1e3
    if status != 200:
        raise AssertionError(f"{what} {label}: {status} {str(resp)[:500]}")
    if resp["_shards"]["failed"] > 0:
        raise AssertionError(f"{what} {label}: shard failures "
                             f"{resp['_shards']}")
    return resp, ms


def check_shards_on_card(node, what, bodies, responses):
    """Per body (index, label, body) and shard: execute_query on the
    card against the CPU plain path over the same reader (ids, scores
    as uint32, totals), and the response against the coordinator's
    merge of the card's shard results → shards checked."""
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.query_phase import execute_query

    dev = node.gpu_search.mesh.grid[0][0]
    checked = 0
    for (index, label, body), resp in zip(bodies, responses):
        svc = node.indices.index(index)
        query = dsl.parse_query(body["query"])
        size, from_ = body.get("size", 10), body.get("from", 0)
        merged, total = [], 0
        for si, (_, shard) in enumerate(sorted(svc.shards.items())):
            reader = shard.acquire_searcher()
            kw = dict(size=size + from_, from_=0,
                      min_score=body.get("min_score"))
            gpu = execute_query(reader, query, device=dev, **kw)
            cpu = execute_query(reader, query, device="cpu", **kw)
            if not same_shard_results(gpu, cpu):
                raise AssertionError(f"{what} {label}: shard {si} on the "
                                     f"card != the CPU plain path")
            total += gpu.total_hits
            merged += [(-h.score, si, r, h) for r, h in enumerate(gpu.hits)]
            checked += 1
        merged.sort(key=lambda t: (t[0], t[1], t[2]))
        window = merged[from_: from_ + size]
        got = [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]
        want = [(h.doc_id, h.score) for *_, h in window]
        if got != want or resp["hits"]["total"]["value"] != total:
            raise AssertionError(f"{what} {label}: the response is not "
                                 f"the merge of the shard results")
    return checked


def planner_phase(host, port, node, corpus, mk, smi, features):
    """The planner path over HTTP on the card: the body index (16
    shards of ~62,500 docs, one segment each) and the typed index, from
    one client. A cold pass sends each body once (it builds the host
    segment packs and fills the analyzer memo), launches counted and
    every shard_topk recorded (with its size classes); then the timed
    window sends the mix PLANNER_ROUNDS times, launches counted, each
    response's hits equal to the cold pass's; one more round runs under
    the profiler for the device busy share. Per body
    and shard, execute_query on the card against the CPU plain path
    over the same reader, and the response's hits against the
    coordinator's merge of the card's shard results. → (line, kernels
    entries)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {"nvidia_smi": smi, "typed_docs": TYPED_DOCS,
           "typed_shards": TYPED_SHARDS,
           "typed_note": ("the typed index is cut from 1M documents to "
                          "100,000 to keep the smoke inside its limit")}
    out["typed_ingest_s"] = typed_bulk_load(host, port, corpus)
    bodies = planner_bodies(corpus)

    def send(index, label, body):
        return search_once(host, port, "planner", index, label, body)

    # cold pass: each body once, every shard_topk recorded
    classes = {}
    mk.reset_launches()
    with TopkRecorder(mk, stats=classes) as top:
        t0 = time.perf_counter()
        cold = [send(*b) for b in bodies]
        torch.cuda.synchronize()
        cold_wall = time.perf_counter() - t0
    cold_launches = dict(mk.LAUNCHES)
    responses = [r for r, _ in cold]

    def run_mix(times):
        for (index, label, body), want in zip(bodies, responses):
            resp, ms = send(index, label, body)
            times.append(ms)
            if hits_of([resp]) != hits_of([want]) or \
                    resp["hits"]["total"] != want["hits"]["total"]:
                raise AssertionError(f"planner {label}: the window's hits "
                                     f"differ from the cold pass's")

    # the timed window: the same mix PLANNER_ROUNDS times, warm
    mk.reset_launches()
    times = []
    t0 = time.perf_counter()
    for _ in range(PLANNER_ROUNDS):
        run_mix(times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    if cold_launches["shard_topk"] <= 0 or launches["shard_topk"] <= 0:
        raise AssertionError("the planner launched no shard_topk")
    # the device busy share from one more round under the profiler,
    # outside the window (its overhead and its event parsing, which
    # grows with the events, stay out of the timed numbers)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_mix([])
        torch.cuda.synchronize()
        busy_wall = time.perf_counter() - t0
    busy = device_busy_ms(prof)
    # the dense segment rows of the kernels line: match_all at k 10 and
    # at from + size 10,000 (rows of ties)
    rows = {}
    for vals, k, _, _ in top.calls:
        live = vals[torch.isfinite(vals)]
        if k in (10, 10_000) and k not in rows and live.numel() > k \
                and bool((live == live[0]).all()):
            rows[k] = vals
    tie_k10000 = 10_000 in rows
    all_inf = any(bool(torch.isneginf(v).all()) for v, *_ in top.calls)
    if not tie_k10000 or not all_inf:
        raise AssertionError(f"planner shard_topk calls lack the k 10,000 "
                             f"tie row ({tie_k10000}) or an all -inf row "
                             f"({all_inf})")
    out["shard_topk"] = check_topk_calls(mk, top.calls)

    checked = check_shards_on_card(node, "planner", bodies, responses)
    kernels = [topk_entry(mk, f"merge_topk.shard_topk.planner_k{k}",
                          rows[k], k, launches, len(times),
                          replaces=PLANNER_TOPK_LINE)
               for k in sorted(rows)]
    del rows
    # the search_features line's typed part (`features`: the line's
    # record, which the fields line completes and logs)
    t_feat = time.perf_counter()
    features["typed"], features["launches"] = features_typed(
        host, port, node, corpus, mk)
    features["seconds"] = {"typed": time.perf_counter() - t_feat}
    for index in (TYPED_INDEX,):
        status, resp = rest_http(host, port, "DELETE", f"/{index}")
        if status != 200:
            raise AssertionError(f"DELETE {index}: {resp}")
    n = len(bodies)
    out.update(
        cold={"requests": n, "wall_s": cold_wall,
              "first_request_ms": cold[0][1],
              "first_request_note": ("the first body-index request builds "
                                     "the 16 host segment packs"),
              "per_body_ms": {label: ms for (_, label, _), (_, ms)
                              in zip(bodies, cold)},
              "launches": cold_launches},
        rounds=PLANNER_ROUNDS, requests=len(times), wall_s=wall,
        qps=len(times) / wall,
        request_ms={"mean": statistics.mean(times),
                    "p50": statistics.median(times), "max": max(times)},
        slowest=bodies[times.index(max(times)) % n][1],
        per_body_ms_p50={label: statistics.median(times[i::n])
                         for i, (_, label, _) in enumerate(bodies)},
        can_match_skipped=sum(r["_shards"]["skipped"] for r in responses),
        hits=sum(len(r["hits"]["hits"]) for r in responses),
        launches=launches,
        shard_topk_per_request=launches["shard_topk"] / len(times),
        shard_topk_size_classes=classes.get("topk_classes"),
        device_busy_ms=busy if busy > 0 else "not measured",
        device_busy_share=(busy / 1e3 / busy_wall) if busy > 0
        else "not measured",
        device_busy_of=("one more round of the mix under torch.profiler, "
                        "after the window"),
        shards_checked=checked,
        parity=("every body and shard: execute_query on the card == the "
                "CPU plain path (ids, scores as uint32, totals; the log "
                "bodies too), and the response == the merge "
                "of the card's shard results"))
    return out, kernels


def feature_bodies(corpus):
    """The search_features line's bodies on the typed index: (label,
    body). Word ids 20-3000 are generator words (neither stop words nor
    hapaxes)."""
    q0 = corpus.query_text(0)
    words = " ".join(corpus.vocab[t] for t in (31, 57, 1234))
    return [
        # every doc sorted by its fields, as Rally's desc_sort_* tasks
        ("sort", {"query": {"match_all": {}}, "size": 100, "sort": [
            {"views": "desc"}, {"published": "asc"},
            {"tag": {"order": "asc", "missing": "_first"}}]}),
        ("collapse", {"query": {"match": {FIELD: q0}}, "size": 20,
                      "collapse": {"field": "tag"}}),
        ("rescore", {"query": {"match": {FIELD: q0}}, "size": 20,
                     "rescore": {"window_size": FEATURE_RESCORE_WINDOW,
                                 "query": {"rescore_query": {"range": {
                                     "views": {"gte": 3}}},
                                     "rescore_query_weight": 2.0}}}),
        ("highlight", {"query": {"match": {FIELD: words}}, "size": 20,
                       "highlight": {"fields": {FIELD: {
                           "fragment_size": 60}}}}),
        ("script_score", {"query": {"script_score": {
            "query": {"match": {FIELD: q0}},
            "script": {"source": "Math.log(2 + doc['views'].value) "
                                 "* Math.pow(_score, 0.5)"}}},
            "size": 20}),
        ("term_suggest", {"size": 0, "suggest": {"fix": {
            "text": "w1243x w57x",
            "term": {"field": FIELD, "prefix_length": 3}}}}),
        # the phrase suggester scans every term of the field a token
        # (a Python edit distance each, as the reference's): two tokens
        ("phrase_suggest", {"query": {"match": {FIELD: words}},
                            "size": 10, "suggest": {"fix": {
                                "text": "w57x w1234",
                                "phrase": {"field": FIELD}}}}),
    ]


def check_feature_shards(node, what, index, bodies):
    """Per body (label, body) and shard: the coordinator's shard query
    phase under the body's features (sort and search_after, collapse,
    the rescore chain) on the card against the CPU plain path over the
    same reader: ids, scores, sort values and totals exactly → shards
    checked."""
    from elasticsearch_tpu_torch.search import coordinator, dsl

    dev = node.gpu_search.mesh.grid[0][0]
    svc = node.indices.index(index)
    checked = 0
    for label, body in bodies:
        features = coordinator.Features.of(body)
        query = dsl.parse_query(body.get("query") or {"match_all": {}})
        size, from_ = body.get("size", 10), body.get("from", 0)
        for num, shard in sorted(svc.shards.items()):
            reader = shard.acquire_searcher()
            res = [coordinator.query_shard(
                reader, query, features, size=size, from_=from_,
                min_score=body.get("min_score"), device=d)
                for d in (dev, "cpu")]
            got, want = ([(h.doc_id, h.score, h.sort_values)
                          for h in r.hits] + [r.total_hits] for r in res)
            if got != want:
                raise AssertionError(f"{what} {label}: shard {num} on the "
                                     f"card != the CPU plain path")
            checked += 1
    return checked


def features_typed(host, port, node, corpus, mk):
    """The search features on the planner line's typed index, before its
    DELETE: each feature body once cold, then FEATURE_ROUNDS warm rounds
    from one client; search_after paging; a scroll and a PIT over one
    tag's documents, then the contexts freed; _rank_eval. Counts reset
    just before and read just after; every recorded shard_topk against
    its plain version; per body and shard, the card against the CPU
    plain path → (line, launches)."""
    import gc

    import torch

    hbm = node.breakers.get_breaker("hbm")
    out = {}
    bodies = feature_bodies(corpus)

    def send(label, body, path=f"/{TYPED_INDEX}/_search", params=""):
        t0 = time.perf_counter()
        status, resp = rest_http(host, port, "POST", path + params, body)
        ms = (time.perf_counter() - t0) * 1e3
        if status != 200:
            raise AssertionError(f"search_features {label}: {status} "
                                 f"{str(resp)[:500]}")
        if "_shards" in resp and resp["_shards"]["failed"] > 0:
            raise AssertionError(f"search_features {label}: shard "
                                 f"failures {resp['_shards']}")
        return resp, ms

    mk.reset_launches()
    with TopkRecorder(mk) as top:
        cold = {label: send(label, body) for label, body in bodies}
        times = {label: [] for label, _ in bodies}
        for r in range(FEATURE_ROUNDS):
            for label, body in bodies:
                if label == "phrase_suggest" and r > 0:
                    continue   # one warm request: seconds of host scans
                resp, ms = send(label, body)
                times[label].append(ms)
                if hits_of([resp]) != hits_of([cold[label][0]]) or \
                        resp.get("suggest") != cold[label][0].get("suggest"):
                    raise AssertionError(f"search_features {label}: a warm "
                                         f"answer differs from the cold one")
        # search_after: FEATURE_PAGES pages of the sort body, equal to one
        # window of their length
        sort_body = dict(bodies[0][1])
        pages, sa_cursor, t_pages = [], None, []
        for _ in range(FEATURE_PAGES):
            b = dict(sort_body)
            if sa_cursor is not None:
                b["search_after"] = sa_cursor
            resp, ms = send("search_after", b)
            t_pages.append(ms)
            if len(resp["hits"]["hits"]) != sort_body["size"]:
                raise AssertionError(f"search_features: a search_after page "
                                     f"of {len(resp['hits']['hits'])} hits")
            pages += resp["hits"]["hits"]
            sa_cursor = resp["hits"]["hits"][-1]["sort"]
        window, _ = send("search_after_window", dict(
            sort_body, size=FEATURE_PAGES * sort_body["size"]))
        if [(h["_id"], h["sort"]) for h in pages] != \
                [(h["_id"], h["sort"]) for h in window["hits"]["hits"]]:
            raise AssertionError("search_features: the search_after pages "
                                 "!= the sorted window")
        times["search_after_page"] = t_pages
        # the contexts: a scroll and a PIT over one tag's documents
        n_calls = len(top.calls)
        gc.collect()
        torch.cuda.synchronize()
        mem_before, hbm_before = torch.cuda.memory_allocated(), hbm.used
        tag_query = {"term": {"tag": FEATURE_TAG}}
        status, counted = rest_http(host, port, "POST",
                                    f"/{TYPED_INDEX}/_count",
                                    {"query": tag_query})
        n_tag = counted["count"]
        page, ms = send("scroll", {"query": tag_query,
                                   "size": FEATURE_SCROLL_PAGE},
                        params="?scroll=1m")
        t_scroll = [ms]
        sid = page["_scroll_id"]
        scrolled = [h["_id"] for h in page["hits"]["hits"]]
        while page["hits"]["hits"]:
            page, ms = send("scroll_page", {"scroll": "1m",
                                            "scroll_id": sid},
                            path="/_search/scroll")
            t_scroll.append(ms)
            scrolled += [h["_id"] for h in page["hits"]["hits"]]
        if len(scrolled) != n_tag or len(set(scrolled)) != n_tag:
            raise AssertionError(f"search_features: the scroll gave "
                                 f"{len(scrolled)} ids ({len(set(scrolled))}"
                                 f" distinct) of {n_tag}")
        status, freed = rest_http(host, port, "DELETE", "/_search/scroll",
                                  {"scroll_id": sid})
        if status != 200 or freed["num_freed"] != 1:
            raise AssertionError(f"search_features: clear scroll {freed}")
        status, opened = rest_http(host, port, "POST",
                                   f"/{TYPED_INDEX}/_pit?keep_alive=1m")
        pid = opened["id"]
        pit_sort = [{"published": "asc"}, {"views": "desc"}]
        cursor, t_pit, n_pit = None, [], 0
        for i in range(-(-n_tag // FEATURE_SCROLL_PAGE) + 1):
            b = {"query": tag_query, "size": FEATURE_SCROLL_PAGE,
                 "sort": pit_sort, "pit": {"id": pid}}
            if cursor is not None:
                b["search_after"] = cursor
            resp, ms = send("pit_page", b, path="/_search")
            t_pit.append(ms)
            want, _ = send("pit_window", {
                "query": tag_query, "sort": pit_sort,
                "from": i * FEATURE_SCROLL_PAGE,
                "size": FEATURE_SCROLL_PAGE})
            if hits_of([resp]) != hits_of([want]):
                raise AssertionError(f"search_features: PIT page {i} != "
                                     f"the sorted from/size window")
            hits = resp["hits"]["hits"]
            n_pit += len(hits)
            if not hits:
                break
            cursor = hits[-1]["sort"]
        if n_pit != n_tag:
            raise AssertionError(f"search_features: the PIT pages held "
                                 f"{n_pit} of {n_tag}")
        status, closed = rest_http(host, port, "DELETE", "/_pit",
                                   {"id": pid})
        if status != 200 or closed["num_freed"] != 1:
            raise AssertionError(f"search_features: close PIT {closed}")
        # the contexts' shard_topk calls are checked here and their
        # recorded copies dropped: the drain check sees what the
        # contexts held, not what the recorder keeps
        context_calls = top.calls[n_calls:]
        del top.calls[n_calls:]
        out["shard_topk_contexts"] = check_topk_calls(mk, context_calls)
        mem_after = None
        for polls in range(1, 51):
            gc.collect()
            torch.cuda.synchronize()
            mem_after = torch.cuda.memory_allocated()
            if mem_after == mem_before and hbm.used == hbm_before:
                break
            time.sleep(0.1)
        if mem_after != mem_before or hbm.used != hbm_before:
            raise AssertionError(f"search_features: hbm {hbm.used} / memory "
                                 f"{mem_after} after the contexts, "
                                 f"{hbm_before} / {mem_before} before")
        times["scroll_page"] = t_scroll
        times["pit_page"] = t_pit
        # _rank_eval: two rated requests
        ranked = [h["_id"] for h in cold["script_score"][0]["hits"]["hits"]]
        rank_body = {"requests": [
            {"id": "script", "request": bodies[4][1],
             "ratings": [{"_id": d, "rating": 3 - i}
                         for i, d in enumerate(ranked[:3])]},
            {"id": "rescore", "request": bodies[2][1],
             "ratings": [{"_id": d, "rating": 1} for d in ranked[3:8]]}],
            "metric": {"dcg": {"k": 10, "normalize": True}}}
        rank, ms = send("rank_eval", rank_body,
                        path=f"/{TYPED_INDEX}/_rank_eval")
        times["rank_eval"] = [ms]
    launches = dict(mk.LAUNCHES)
    if launches["shard_topk"] <= 0:
        raise AssertionError("search_features launched no shard_topk")
    out["shard_topk"] = check_topk_calls(mk, top.calls)
    shard_bodies = [(label, body) for label, body in bodies
                    if body.get("size", 10) > 0]
    shard_bodies.append(("search_after", dict(sort_body,
                                              search_after=sa_cursor)))
    shard_bodies.append(("scroll", {"query": tag_query,
                                    "size": FEATURE_SCROLL_PAGE}))
    out["shards_checked"] = check_feature_shards(
        node, "search_features", TYPED_INDEX, shard_bodies)
    out.update(
        per_feature_ms={label: {"mean": statistics.mean(ts),
                                "p50": statistics.median(ts),
                                "max": max(ts), "requests": len(ts)}
                        for label, ts in times.items()},
        cold_ms={label: ms for label, (_, ms) in cold.items()},
        hits={label: len(r["hits"]["hits"]) for label, (r, _)
              in cold.items()},
        search_after=dict(pages=FEATURE_PAGES, page_size=sort_body["size"],
                          equal_to_window=True),
        scroll=dict(query=tag_query, matching=n_tag,
                    page_size=FEATURE_SCROLL_PAGE, pages=len(t_scroll),
                    every_id_once=True, count_equals=True),
        pit=dict(pages=len(t_pit), sort=pit_sort,
                 equal_to_windows=True),
        contexts_memory=dict(hbm_before=hbm_before, hbm_after=hbm.used,
                             memory_allocated_before=mem_before,
                             memory_allocated_after=mem_after,
                             drain_polls=polls),
        rank_eval=dict(requests=2, metric_score=rank["metric_score"]),
        launches=launches)
    return out, launches


def features_fields(host, port, node, mk):
    """The search features on the fields line's index, before its
    DELETE: script_score with cosineSimilarity and l2norm over the
    64-dim `vec`, and the completion suggester on `suggest`; timed as
    features_typed does, every shard_topk against its plain version, per
    body and shard the card against the CPU plain path → (line,
    launches)."""
    import numpy as np
    q = [round(float(x), 3) for x in
         np.random.default_rng([SEED, 9]).standard_normal(VEC_DIMS)]
    bodies = [
        ("cosine", {"query": {"script_score": {
            "query": {"match_all": {}},
            "script": {"source": "cosineSimilarity(params.q, 'vec') + 1.0",
                       "params": {"q": q}}}}, "size": 20}),
        ("l2norm", {"query": {"script_score": {
            "query": {"exists": {"field": "pagerank"}},
            "script": {"source": "1 / (1 + l2norm(params.q, 'vec'))",
                       "params": {"q": q}}}}, "size": 20}),
        ("completion", {"size": 0, "suggest": {"c": {
            "prefix": "w12", "completion": {"field": "suggest",
                                            "size": 10}}}}),
    ]
    mk.reset_launches()
    times = {label: [] for label, _ in bodies}
    with TopkRecorder(mk) as top:
        cold = {}
        for r in range(FEATURE_ROUNDS + 1):
            for label, body in bodies:
                resp, ms = search_once(host, port, "search_features",
                                       FIELDS_INDEX, label, body)
                if r == 0:
                    cold[label] = (resp, ms)
                elif hits_of([resp]) != hits_of([cold[label][0]]) or \
                        resp.get("suggest") != cold[label][0].get("suggest"):
                    raise AssertionError(f"search_features {label}: a warm "
                                         f"answer differs from the cold one")
                else:
                    times[label].append(ms)
    launches = dict(mk.LAUNCHES)
    if launches["shard_topk"] <= 0:
        raise AssertionError("search_features (fields) launched no "
                             "shard_topk")
    options = cold["completion"][0]["suggest"]["c"][0]["options"]
    if not options:
        raise AssertionError("search_features: no completion option")
    out = {"shard_topk": check_topk_calls(mk, top.calls),
           "shards_checked": check_feature_shards(
               node, "search_features", FIELDS_INDEX, bodies[:2]),
           "per_feature_ms": {label: {"mean": statistics.mean(ts),
                                      "p50": statistics.median(ts),
                                      "max": max(ts), "requests": len(ts)}
                              for label, ts in times.items()},
           "cold_ms": {label: ms for label, (_, ms) in cold.items()},
           "completion_options": len(options), "launches": launches}
    return out, launches


def fields_analysis(corpus):
    """The `fields` index's settings: FIELDS_SHARDS shards and the
    analyzer "chain" (standard tokenizer, lowercase, the corpus's
    FIELDS_STOP most frequent words as stop words, FIELDS_SYNONYMS
    equivalence rules of three band words each, porter_stem)."""
    import numpy as np
    counts = np.bincount(np.concatenate(corpus.doc_tokens[:FIELDS_DOCS]),
                         minlength=len(corpus.vocab))
    stop = [corpus.vocab[int(i)]
            for i in np.argsort(-counts, kind="stable")[:FIELDS_STOP]]
    rng = np.random.default_rng(SEED + 2)
    band = rng.permutation(np.arange(20, 3001))[:3 * FIELDS_SYNONYMS]
    rules = [", ".join(corpus.vocab[int(w)] for w in band[3 * i: 3 * i + 3])
             for i in range(FIELDS_SYNONYMS)]
    return {"number_of_shards": FIELDS_SHARDS,
            "translog": {"durability": "async"},
            "analysis": {
                "filter": {
                    "corpus_stop": {"type": "stop", "stopwords": stop},
                    "band_syn": {"type": "synonym", "synonyms": rules}},
                "analyzer": {"chain": {
                    "type": "custom", "tokenizer": "standard",
                    "filter": ["lowercase", "corpus_stop", "band_syn",
                               "porter_stem"]}}}}


#: the `fields` mapping: the corpus text under the custom chain, and a
#: field of each rarer type (Rally's geonames `location`, http_logs
#: `clientip`, nested's objects in an array)
FIELDS_MAPPING = {"properties": {
    FIELD: {"type": "text", "analyzer": "chain"},
    "clientip": {"type": "ip"},
    "location": {"type": "geo_point"},
    "slots": {"type": "integer_range"},
    "period": {"type": "date_range"},
    "pagerank": {"type": "rank_feature"},
    "comments": {"type": "nested", "properties": {
        "author": {"type": "keyword"}, "likes": {"type": "long"}}},
    "suggest": {"type": "completion"},
    "vec": {"type": "dense_vector", "dims": VEC_DIMS}}}


def fields_doc(rng, corpus, i):
    """Document i of the `fields` index, its values drawn from `rng`:
    an IPv4 address (one in ten written IPv4-mapped, two in ten IPv6),
    a point in one of the three input forms, an integer and a date
    range, a rank feature (absent in one doc of eleven), 1-5 comment
    objects, a completion and a VEC_DIMS vector."""
    a, b, c, d = (int(x) for x in rng.integers(0, 256, 4))
    kind = i % 10
    if kind < 7:
        ip = f"{a}.{b}.{c}.{d}"
    elif kind == 7:
        ip = f"::ffff:{a}.{b}.{c}.{d}"
    else:
        ip = f"2001:db8:{a:x}{b:02x}::{c:x}{d:02x}"
    lat = round(float(rng.uniform(-90, 90)), 6)
    lon = round(float(rng.uniform(-180, 180)), 6)
    location = ({"lat": lat, "lon": lon}, f"{lat},{lon}", [lon, lat])[i % 3]
    lo = int(rng.integers(0, 1000))
    start = 1546300800000 + int(rng.integers(0, 6 * 365)) * 86_400_000
    doc = {FIELD: corpus.doc_text(i), "clientip": ip, "location": location,
           "slots": {"gte": lo, "lte": lo + int(rng.integers(0, 50))},
           "period": {"gte": start,
                      "lt": start + int(rng.integers(1, 90)) * 86_400_000},
           "comments": [{"author": f"u{int(rng.integers(0, 200))}",
                         "likes": int(rng.integers(0, 100))}
                        for _ in range(int(rng.integers(1, 6)))],
           "suggest": {"input": [corpus.vocab[int(t)]
                                 for t in corpus.doc_tokens[i][:2]],
                       "weight": int(rng.integers(1, 100))},
           "vec": [round(float(x), 3)
                   for x in rng.standard_normal(VEC_DIMS)]}
    if i % 11:
        doc["pagerank"] = round(float(rng.lognormal(0.0, 1.5)) + 1e-3, 4)
    return doc


def fields_bulk_load(host, port, corpus):
    """The `fields` index (FIELDS_DOCS documents, ids f{i}) by _bulk from
    BULK_CLIENTS clients, then _refresh → seconds."""
    import http.client
    import threading

    import numpy as np
    starts = list(range(0, FIELDS_DOCS, BULK_DOCS))
    errors = []

    def client(ci):
        conn = http.client.HTTPConnection(host, port, timeout=600)
        try:
            for si in range(ci, len(starts), BULK_CLIENTS):
                rng = np.random.default_rng([SEED, 3, si])
                lines = []
                for i in range(starts[si],
                               min(starts[si] + BULK_DOCS, FIELDS_DOCS)):
                    lines.append('{"index":{"_id":"f%d"}}' % i)
                    lines.append(json.dumps(fields_doc(rng, corpus, i)))
                status, resp = rest_http(
                    host, port, "POST", f"/{FIELDS_INDEX}/_bulk",
                    raw=("\n".join(lines) + "\n").encode(), conn=conn)
                if status != 200 or resp.get("errors"):
                    errors.append(str(resp)[:500])
                    return
        finally:
            conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(BULK_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"fields _bulk failed: {errors[0]}")
    status, resp = rest_http(host, port, "POST", f"/{FIELDS_INDEX}/_refresh")
    if status != 200:
        raise AssertionError(f"fields _refresh: {resp}")
    return time.perf_counter() - t0


def stored_queries(corpus):
    """STORED_QUERIES percolator queries from the seed, in the shapes of
    the fields line's planner bodies: a match on the analyzed text, a
    CIDR term, an ip range, a range-field relation, a geo_distance, a
    bool of a match and a filter."""
    import numpy as np
    rng = np.random.default_rng(SEED + 4)
    out = []
    for i in range(STORED_QUERIES):
        w = corpus.vocab[int(rng.integers(20, 3000))]
        kind = i % 6
        if kind == 0:
            q = {"match": {FIELD: w}}
        elif kind == 1:
            q = {"term": {"clientip": f"{int(rng.integers(0, 256))}.0.0.0/8"}}
        elif kind == 2:
            q = {"range": {"clientip": {"gte": "2001:db8::",
                                        "lt": "2001:db9::"}}}
        elif kind == 3:
            lo = int(rng.integers(0, 1000))
            q = {"range": {"slots": {
                "gte": lo, "lte": lo + 100,
                "relation": ("intersects", "within", "contains")[i % 3]}}}
        elif kind == 4:
            q = {"geo_distance": {"distance": f"{int(rng.integers(1, 30))}00km",
                                  "location": [float(rng.uniform(-180, 180)),
                                               float(rng.uniform(-60, 60))]}}
        else:
            q = {"bool": {"must": [{"match": {FIELD: w}}],
                          "filter": [{"exists": {"field": "pagerank"}}]}}
        out.append(q)
    return out


def fields_planner_bodies(corpus):
    """The fields line's planner mix: (index, label, body)."""
    import numpy as np
    q0 = corpus.query_text(3)
    rng = np.random.default_rng(SEED + 5)
    docs = [fields_doc(rng, corpus, FIELDS_DOCS + j) for j in range(4)]
    known_ip = fields_doc(np.random.default_rng([SEED, 3, 0]), corpus,
                          0)["clientip"]
    nested = {"bool": {"must": [{"term": {"comments.author": "u7"}},
                                {"range": {"comments.likes": {"gte": 20}}}]}}
    out = [
        ("geo_distance_km", {"query": {"geo_distance": {
            "distance": "300km", "location": {"lat": 48.85, "lon": 2.35}}},
            "size": 20}),
        ("geo_distance_mi", {"query": {"geo_distance": {
            "distance": "250mi", "location": "40.7,-74.0"}}, "size": 20}),
        ("geo_distance_m", {"query": {"geo_distance": {
            "distance": "900000m", "location": [0.0, 0.0]}}, "size": 20}),
        ("geo_distance_nmi", {"query": {"geo_distance": {
            "distance": "400nmi", "location": "u4pruydqqvj"}},
            "size": 20}),
        ("geo_bbox", {"query": {"geo_bounding_box": {"location": {
            "top_left": {"lat": 60, "lon": -10},
            "bottom_right": {"lat": 35, "lon": 30}}}}, "size": 20}),
        ("geo_bbox_antimeridian", {"query": {"geo_bounding_box": {
            "location": {"top": 20, "left": 170, "bottom": -20,
                         "right": -170}}}, "size": 20}),
        ("ip_term", {"query": {"term": {"clientip": known_ip}}}),
        ("ip_cidr", {"query": {"term": {"clientip": "10.0.0.0/8"}},
                     "size": 20}),
        ("ip_cidr_mapped", {"query": {"term": {
            "clientip": "::ffff:0:0/96"}}, "size": 20}),
        ("ip_range_v4", {"query": {"range": {"clientip": {
            "gte": "192.168.0.0", "lt": "193.0.0.0"}}}, "size": 20}),
        ("ip_range_v6", {"query": {"range": {"clientip": {
            "gt": "2001:db8:8000::"}}}, "size": 20}),
        ("range_intersects", {"query": {"range": {"slots": {
            "gte": 100, "lte": 110}}}, "size": 20}),
        ("range_within", {"query": {"range": {"slots": {
            "gte": 0, "lte": 60, "relation": "within"}}}, "size": 20}),
        ("range_contains", {"query": {"range": {"slots": {
            "gte": 500, "lte": 502, "relation": "contains"}}},
            "size": 20}),
        ("range_date", {"query": {"range": {"period": {
            "gte": "2021-06-01", "lte": "2021-06-30"}}}, "size": 20}),
        ("rank_saturation", {"query": {"rank_feature": {
            "field": "pagerank"}}, "size": 20}),
        ("rank_saturation_pivot", {"query": {"rank_feature": {
            "field": "pagerank", "saturation": {"pivot": 2.5}}},
            "size": 20}),
        ("rank_log", {"query": {"rank_feature": {
            "field": "pagerank", "log": {"scaling_factor": 1.5}}},
            "size": 20}),
        ("rank_sigmoid", {"query": {"rank_feature": {
            "field": "pagerank", "sigmoid": {"pivot": 3.0,
                                             "exponent": 0.6}}},
            "size": 20}),
        ("rank_hybrid", {"query": {"bool": {
            "must": [{"match": {FIELD: q0}}],
            "should": [{"rank_feature": {"field": "pagerank",
                                         "saturation": {"pivot": 2.0}}}]}},
            "size": 20}),
    ] + [
        (f"nested_{mode}", {"query": {"bool": {
            "must": [{"match": {FIELD: q0}}],
            "should": [{"nested": {"path": "comments", "score_mode": mode,
                                   "query": nested}}]}}, "size": 20})
        for mode in ("sum", "avg", "min", "max", "none")]
    return [(FIELDS_INDEX, label, b) for label, b in out] + [
        (QUERIES_INDEX, "percolate", {"query": {"percolate": {
            "field": "query", "documents": docs}}, "size": 50})]


def fields_phase(host, port, node, corpus, bodies, mk, smi, features):
    """The rarer field types and the analysis chain on the same node:
    the `fields` index (FIELDS_DOCS docs over FIELDS_SHARDS shards by
    _bulk, the text under the custom chain) and a `queries` index of
    STORED_QUERIES percolator queries. The kernel path: the 256 match
    bodies on the analyzed field (no _source) from REST_CLIENTS clients,
    then FIELDS_EXACT of them with boost 1e-15, counts reset just before and
    read just after (the merge kernels, exact_merge and shard_topk must
    each launch), every fused_merge_topk shape, exact merge and
    shard_topk call against its plain version bit for bit. The planner
    path: the mix of fields_planner_bodies once cold and once warm (q/s
    and per-request ms of the warm pass), the device busy share of one
    more pass under the profiler; per body and shard execute_query on
    the card == the CPU plain path, and the response == the merge of
    the card's shard results → (line, launches of the kernel path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.gpu_service import lower_query

    t_phase = time.perf_counter()
    out = {"nvidia_smi": smi, "docs": FIELDS_DOCS, "shards": FIELDS_SHARDS,
           "stored_queries": STORED_QUERIES,
           "note": ("cut from 1M documents to 50,000 to keep the phase "
                    "near 120 s (the analysis chain runs in Python at "
                    "ingest); shapes from the Rally tracks "
                    "geonames (location), http_logs (clientip) and nested "
                    "(objects in an array), data from the seed")}
    settings = fields_analysis(corpus)
    for index, mapping, shards in (
            (FIELDS_INDEX, FIELDS_MAPPING, FIELDS_SHARDS),
            (QUERIES_INDEX, {"properties": dict(
                FIELDS_MAPPING["properties"],
                query={"type": "percolator"})}, 1)):
        status, resp = rest_http(host, port, "PUT", f"/{index}", {
            "settings": dict(settings, number_of_shards=shards),
            "mappings": mapping})
        if status != 200:
            raise AssertionError(f"PUT {index}: {resp}")
    out["ingest_s"] = fields_bulk_load(host, port, corpus)
    out["ingest_docs_per_s"] = FIELDS_DOCS / out["ingest_s"]
    lines = []
    for i, q in enumerate(stored_queries(corpus)):
        lines += ['{"index":{"_id":"q%d"}}' % i, json.dumps({"query": q})]
    for raw, path in (("\n".join(lines) + "\n", f"/{QUERIES_INDEX}/_bulk"),
                      (None, f"/{QUERIES_INDEX}/_refresh")):
        status, resp = rest_http(host, port, "POST", path,
                                 raw=raw.encode() if raw else None)
        if status != 200 or (resp or {}).get("errors"):
            raise AssertionError(f"{path}: {str(resp)[:500]}")

    out["stored_queries_s"] = time.perf_counter() - t_phase \
        - out["ingest_s"]

    # -- the kernel path under the chain ---------------------------------
    t_kernel = time.perf_counter()
    mapper = node.indices.index(FIELDS_INDEX).mapper
    expanded = stopped = 0
    for b in bodies:
        spec = b["query"]["match"][FIELD]
        text = spec if isinstance(spec, str) else spec["query"]
        flat = lower_query(dsl.parse_query(b["query"]), mapper)
        words = text.split()
        expanded += len(flat.terms) > len(words)
        stopped += any(w in settings["analysis"]["filter"]["corpus_stop"][
            "stopwords"] for w in words)
    if not expanded:
        raise AssertionError("no body's terms expand through the synonyms")
    # without _source: the rest line measures the fetch; here the
    # ~2 KB sources (a 64-dim vector each) would take most of the run
    run_bodies = [dict(b, _source=False) for b in bodies]
    exact_run = exact_bodies(run_bodies[:FIELDS_EXACT])
    rest_queries(host, port, run_bodies[:8], FIELDS_INDEX)  # builds the pack
    mk.reset_launches()
    with LaunchRecorder(mk) as rec, TopkRecorder(mk) as top, \
            LaunchRecorder(mk, "exact_merge_topk", every=True) as ex:
        responses, wall = rest_queries(host, port, run_bodies,
                                       FIELDS_INDEX)
        exact_resp, exact_wall = rest_queries(host, port, exact_run,
                                              FIELDS_INDEX)
        torch.cuda.synchronize()
    launches = dict(mk.LAUNCHES)
    zero = [n for n in MAIN_KERNELS + EXACT_KERNELS if launches[n] <= 0]
    if zero:
        raise AssertionError(f"fields: kernels not launched on the "
                             f"analyzed field: {zero}")
    worst = 0.0
    shapes = list(rec.shapes.values())
    for args, kw in shapes:
        _, err, _ = check_launch(mk, "fields", args, kw)
        worst = max(worst, err)
    out["kernel_path"] = dict(
        queries=len(responses), wall_s=wall, qps=len(responses) / wall,
        exact_queries=len(exact_resp), exact_wall_s=exact_wall,
        hits=sum(len(r["hits"]["hits"]) for r in responses),
        bodies_expanded_by_synonyms=expanded,
        bodies_with_stop_words=stopped, launches=launches,
        parity=dict(fused_merge_topk_shapes=len(shapes), max_abs_err=worst,
                    exact_merge=check_exact_launches(mk, ex.launches),
                    shard_topk=check_topk_calls(mk, top.calls),
                    tolerance="bitwise: scores as uint32, docs and "
                              "totals exact"))
    del shapes, responses, exact_resp
    out["kernel_path"]["phase_s"] = time.perf_counter() - t_kernel

    # -- the planner path over the rarer types ---------------------------
    t_planner = time.perf_counter()
    mix = fields_planner_bodies(corpus)

    def send(index, label, body):
        return search_once(host, port, "fields", index, label, body)

    t0 = time.perf_counter()
    cold = [send(*b) for b in mix]
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    responses = [r for r, _ in cold]
    empty = [label for (_, label, _), r in zip(mix, responses)
             if not r["hits"]["hits"]]
    if empty:
        raise AssertionError(f"fields: bodies matching nothing: {empty}")
    times = []
    t0 = time.perf_counter()
    for (index, label, body), want in zip(mix, responses):
        resp, ms = send(index, label, body)
        times.append(ms)
        if hits_of([resp]) != hits_of([want]) or \
                resp["hits"]["total"] != want["hits"]["total"]:
            raise AssertionError(f"fields {label}: the warm pass's hits "
                                 f"differ from the cold pass's")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in mix:
            send(*b)
        torch.cuda.synchronize()
        busy_wall = time.perf_counter() - t0
    busy = device_busy_ms(prof)

    t_checks = time.perf_counter()
    checked = check_shards_on_card(node, "fields", mix, responses)
    # the search_features line's fields part, then the line
    t_feat = time.perf_counter()
    feat_fields, feat_launches = features_fields(host, port, node, mk)
    features["seconds"]["fields"] = time.perf_counter() - t_feat
    features["launches"] = {name: n + feat_launches.get(name, 0)
                            for name, n in features["launches"].items()}
    log("search_features", nvidia_smi=smi, typed=features["typed"],
        fields=feat_fields, launches=features["launches"],
        seconds=dict(features["seconds"],
                     line=sum(features["seconds"].values())),
        parity=("every body and shard: the shard query phase under the "
                "body's features on the card == the CPU plain path (ids, "
                "scores, sort values, totals); every shard_topk == its "
                "plain version bit for bit"))
    for index in (FIELDS_INDEX, QUERIES_INDEX):
        status, resp = rest_http(host, port, "DELETE", f"/{index}")
        if status != 200:
            raise AssertionError(f"DELETE {index}: {resp}")
    out["planner"] = dict(
        requests=len(times), cold_wall_s=cold_wall, wall_s=wall,
        qps=len(times) / wall,
        request_ms={"mean": statistics.mean(times),
                    "p50": statistics.median(times), "max": max(times)},
        slowest=mix[times.index(max(times))][1],
        per_body_ms={label: ms for (_, label, _), ms in zip(mix, times)},
        cold_per_body_ms={label: ms for (_, label, _), (_, ms)
                          in zip(mix, cold)},
        totals={label: r["hits"]["total"]["value"]
                for (_, label, _), r in zip(mix, responses)},
        device_busy_ms=busy if busy > 0 else "not measured",
        device_busy_share=(busy / 1e3 / busy_wall) if busy > 0
        else "not measured",
        device_busy_of="one more pass of the mix under torch.profiler",
        shards_checked=checked, checks_s=time.perf_counter() - t_checks,
        phase_s=time.perf_counter() - t_planner,
        parity=("every body and shard: execute_query on the card == the "
                "CPU plain path (ids, scores as uint32, totals), and the "
                "response == the merge of the card's shard results"))
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches


_TOOK = re.compile(rb'"took": \d+')


def took0(data):
    """Response bytes with every took at 0 (wall-clock time)."""
    return _TOOK.sub(b'"took": 0', data)


def msearch_payload(bodies):
    return "".join(json.dumps({"index": REST_INDEX}) + "\n" + json.dumps(b)
                   + "\n" for b in bodies).encode()


def msearch_as_searches(host, port, bodies, search_bytes, clients):
    """`bodies` as `clients` concurrent _msearch requests of
    len(bodies) / clients items; each response's bytes must equal the
    items' _search bytes (`search_bytes`, took at 0) spliced into the
    _msearch envelope → (items, wall s)."""
    per = len(bodies) // clients
    reqs = [("POST", "/_msearch", None,
             msearch_payload(bodies[i * per:(i + 1) * per]))
            for i in range(clients)]
    answers, wall = rest_raw_many(host, port, reqs, clients)
    for ci, (status, data) in enumerate(answers):
        items = [s[:-1] + b', "status": 200}'
                 for s in search_bytes[ci * per:(ci + 1) * per]]
        want = b'{"took": 0, "responses": [' + b", ".join(items) + b"]}"
        if status != 200 or took0(data) != want:
            raise AssertionError(f"rest_api: _msearch request {ci} is not "
                                 f"its items' _search bytes")
    return per * clients, wall


def explain_on_cpu(node, index, doc_id, query):
    """The planner's score of one document on the CPU plain path."""
    from elasticsearch_tpu_torch.search.planner import SegmentQueryExecutor
    svc = node.indices.index(index)
    reader = svc.shard(svc.shard_for_id(doc_id)).acquire_searcher()
    for vi, view in enumerate(reader.views):
        ord_ = view.segment.id_to_ord.get(doc_id)
        if ord_ is not None and view.live_mask[ord_]:
            mask, score = SegmentQueryExecutor(reader, vi, "cpu").execute(
                query)
            return bool(mask[ord_]), float(score[ord_])
    raise AssertionError(f"rest_api: {doc_id} is not live in {index}")


def rest_api_phase(host, port, node, corpus, bodies, mk, smi):
    """The REST remainder on the rest node's 1M-doc index and its
    lifecycle on an index of the line's own; counts reset just before,
    read just after, every recorded launch against its plain version,
    the hbm breaker and memory_allocated() back at their values before
    the line after it deletes what it made → (line, launches)."""
    import contextlib
    import gc

    import numpy as np
    import torch

    from elasticsearch_tpu_torch.search import dsl

    t_phase = time.perf_counter()
    hbm = node.breakers.get_breaker("hbm")
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    hbm_before = hbm.used
    peak = [hbm_before]
    steps = {}   # seconds of each step of the line

    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        steps[name] = time.perf_counter() - t0
        peak[0] = max(peak[0], hbm.used)

    call_s = {}   # seconds of each call (kept: the introspection's)

    def call(method, path, body=None, raw=None, want=200):
        t0 = time.perf_counter()
        status, data, ctype = rest_raw(host, port, method, path, body, raw)
        call_s[f"{method} {path}"] = time.perf_counter() - t0
        if status != want:
            raise AssertionError(f"rest_api {method} {path}: {status} "
                                 f"{data[:500]!r}")
        return data, ctype

    routes = set()
    out = {"nvidia_smi": smi, "index": REST_INDEX, "docs": N_DOCS,
           "shards": SHARDS, "msearch_clients": MSEARCH_CLIENTS,
           "life_docs": LIFE_DOCS, "life_shards": LIFE_SHARDS,
           "steps_s": steps,
           "note": ("close, open, shrink and split on an index of "
                    f"{LIFE_DOCS} docs built in the line (cut from 1M: "
                    "they rebuild packs and copy documents on the host)")}
    try:
        run_bodies = [dict(b, _source=False) for b in bodies]
        exact_run = exact_bodies(run_bodies[:REST_API_EXACT])
        with step("search"):   # the bytes each _msearch item must equal
            searched = []
            for group in (run_bodies, exact_run):   # exact trains apart
                searched += rest_raw_many(
                    host, port, [("POST", f"/{REST_INDEX}/_search", b,
                                  None) for b in group], REST_CLIENTS)[0]
            if any(s != 200 for s, _ in searched):
                raise AssertionError("rest_api: a _search failed")
            search_bytes = [took0(d) for _, d in searched]
            search_resp = [json.loads(d) for d in search_bytes]
            del searched
        mk.reset_launches()
        with LaunchRecorder(mk) as rec, TopkRecorder(mk) as top, \
                LaunchRecorder(mk, "exact_merge_topk", every=True) as ex:
            with step("msearch"):
                items, wall = msearch_as_searches(
                    host, port, run_bodies,
                    search_bytes[:len(run_bodies)], MSEARCH_CLIENTS)
                exact_items, exact_wall = msearch_as_searches(
                    host, port, exact_run, search_bytes[len(run_bodies):], 1)
            routes.add("_msearch")
            out["msearch"] = dict(items=items, requests=MSEARCH_CLIENTS,
                                  wall_s=wall, items_per_s=items / wall,
                                  exact_items=exact_items,
                                  exact_wall_s=exact_wall,
                                  same_as_search="every item's bytes == its "
                                                 "_search's, took at 0")
            with step("count"):   # the exact total of the same query
                counted = rest_raw_many(host, port, [
                    ("POST", f"/{REST_INDEX}/_count",
                     {"query": b["query"]}, None)
                    for b in run_bodies[:REST_API_COUNTS]],
                    REST_API_COUNTS)[0]
                for i, (status, data) in enumerate(counted):
                    total = search_resp[i]["hits"]["total"]
                    if status != 200 or total["relation"] != "eq" or \
                            json.loads(data)["count"] != total["value"]:
                        raise AssertionError(
                            f"rest_api: _count of body {i} != its "
                            f"search's exact total {total}")
            routes.add("_count")
            filt = {"term": {FIELD: corpus.vocab[40]}}
            alias_mix, alias_resp = [], []
            with step("alias"):
                call("PUT", f"/{REST_INDEX}/_alias/{ALIAS}",
                     {"filter": filt})
                for i in range(ALIAS_BODIES):
                    body = {"query": run_bodies[i]["query"], "size": 10}
                    via, _ = call("POST", f"/{ALIAS}/_search", body)
                    as_bool = {"query": {"bool": {
                        "must": [body["query"]], "filter": [filt]}},
                        "size": 10}
                    direct, _ = call("POST", f"/{REST_INDEX}/_search",
                                     as_bool)
                    if took0(via) != took0(direct):
                        raise AssertionError(f"rest_api: alias search {i} "
                                             f"!= the bool with its filter")
                    counted, _ = call("POST", f"/{ALIAS}/_count",
                                      {"query": body["query"]})
                    resp = json.loads(via)
                    if json.loads(counted)["count"] != \
                            resp["hits"]["total"]["value"]:
                        raise AssertionError(f"rest_api: alias count {i} "
                                             f"!= its search's total")
                    alias_mix.append((REST_INDEX, f"alias{i}", as_bool))
                    alias_resp.append(resp)
            routes.update(("_alias", "_count via alias",
                           "_search via alias"))
            with step("explain"):   # each body's top hit, card == CPU
                same_score = 0
                for i in range(REST_API_EXPLAIN):
                    top_id = search_resp[i]["hits"]["hits"][0]["_id"]
                    query = {"query": run_bodies[i]["query"]}
                    data, _ = call("POST",
                                   f"/{REST_INDEX}/_explain/{top_id}", query)
                    got = json.loads(data)
                    matched, value = explain_on_cpu(
                        node, REST_INDEX, top_id,
                        dsl.parse_query(query["query"]))
                    card = np.float32(got["explanation"]["value"])
                    if got["matched"] is not matched or card.view(
                            np.uint32) != np.float32(value).view(np.uint32):
                        raise AssertionError(f"rest_api: _explain of "
                                             f"{top_id} on the card != the "
                                             f"CPU plain path")
                    same_score += card == np.float32(
                        search_resp[i]["hits"]["hits"][0]["_score"])
            routes.add("_explain")
            out["explain"] = dict(docs=REST_API_EXPLAIN,
                                  card_equals_cpu="bitwise",
                                  equal_to_kernel_score=int(same_score))
            with step("introspection"):
                call_s.clear()
                call("GET", f"/{REST_INDEX}/_field_caps")
                data, _ = call("POST",
                               f"/{REST_INDEX}/_validate/query?explain",
                               {"query": run_bodies[0]["query"]})
                if not json.loads(data)["valid"]:
                    raise AssertionError("rest_api: _validate/query")
                data, _ = call("GET", f"/{REST_INDEX}/_termvectors/d0")
                if not json.loads(data)["found"]:
                    raise AssertionError("rest_api: _termvectors d0")
                data, _ = call("POST", f"/{REST_INDEX}/_analyze",
                               {"field": FIELD, "text": corpus.doc_text(0)})
                if [t["token"] for t in json.loads(data)["tokens"]] != \
                        corpus.doc_text(0).split():
                    raise AssertionError("rest_api: _analyze")
                data, _ = call("GET", f"/{REST_INDEX}/_stats")
                if json.loads(data)["_all"]["primaries"]["docs"][
                        "count"] != N_DOCS:
                    raise AssertionError("rest_api: _stats docs")
                data, _ = call("GET", "/_nodes/stats")
                stats = next(iter(json.loads(data)["nodes"].values()))
                if "tpu_search" not in stats or stats["breakers"]["hbm"][
                        "estimated_size_in_bytes"] != hbm.used:
                    raise AssertionError("rest_api: _nodes/stats")
                data, _ = call("GET", "/_cluster/health?wait_for_status="
                                      "green")
                if json.loads(data)["status"] != "green":
                    raise AssertionError("rest_api: health")
                cat = {}
                # (_cat/indices walks every translog op of the tables
                # it lists: it runs on the lifecycle's index, below)
                for table in ("", "/health", "/count",
                              "/shards", "/nodes", "/aliases", "/master",
                              "/allocation", "/recovery"):
                    data, ctype = call("GET", f"/_cat{table}?v")
                    if not ctype.startswith("text/plain"):
                        raise AssertionError(f"rest_api: _cat{table} is "
                                             f"{ctype}")
                    cat[f"_cat{table}"] = len(data.splitlines())
                if f" {N_DOCS}".encode() not in call(
                        "GET", f"/_cat/count/{REST_INDEX}")[0]:
                    raise AssertionError("rest_api: _cat/count")
            routes.update(("_field_caps", "_validate/query", "_termvectors",
                           "_analyze", "_stats", "_nodes/stats",
                           "_cluster/health", *cat))
            out["cat_lines"] = cat
            out["introspection_s"] = dict(call_s)
            # -- the lifecycle on an index of its own ---------------------
            with step("life_ingest"):
                call("PUT", f"/{LIFE_INDEX}", {
                    "settings": {"number_of_shards": LIFE_SHARDS},
                    "mappings": {"properties": {FIELD: {"type": "text"}}}})
                rest_bulk_load(host, port, corpus, LIFE_DOCS,
                               index=LIFE_INDEX)
                data, ctype = call("GET", f"/_cat/indices/{LIFE_INDEX}?v")
                if not ctype.startswith("text/plain") or \
                        LIFE_INDEX.encode() not in data:
                    raise AssertionError(f"rest_api: _cat/indices is "
                                         f"{ctype}")
                cat["_cat/indices"] = len(data.splitlines())
                routes.add("_cat/indices")
            life_bodies = run_bodies[:16]
            life_reqs = [("POST", f"/{LIFE_INDEX}/_search", b, None)
                         for b in life_bodies]
            life_key = f"{LIFE_INDEX}/{FIELD}"
            with step("close_open"):
                before = [took0(d) for _, d in rest_raw_many(
                    host, port, life_reqs, 16)[0]]
                peak[0] = max(peak[0], hbm.used)
                one_pack = node.gpu_search.packs.stats()["packs"][
                    life_key]["hbm_bytes"]
                call("POST", f"/{LIFE_INDEX}/_close")
                closed_hbm = hbm.used
                data, _ = call("POST", f"/{LIFE_INDEX}/_search",
                               life_bodies[0], want=400)
                if json.loads(data)["error"]["type"] != \
                        "index_closed_exception":
                    raise AssertionError("rest_api: a closed index's "
                                         "search")
                call("POST", f"/{LIFE_INDEX}/_open")
                after = [took0(d) for _, d in rest_raw_many(
                    host, port, life_reqs, 16)[0]]
                if after != before:
                    raise AssertionError("rest_api: the reopened index "
                                         "answers other bytes")
                packs = node.gpu_search.packs.stats()["packs"]
                life_packs = [k for k in packs
                              if k.startswith(f"{LIFE_INDEX}/")]
                reopened = packs[life_key]["hbm_bytes"]
                if closed_hbm != hbm_before or life_packs != [life_key] or \
                        hbm.used - hbm_before != reopened:
                    raise AssertionError(
                        f"rest_api: after close/open the breaker reads "
                        f"{hbm.used - hbm_before} for {life_packs}, one "
                        f"pack is {reopened} (before the close {one_pack},"
                        f" closed {closed_hbm - hbm_before})")
            out["lifecycle"] = dict(one_pack_bytes=one_pack,
                                    hbm_closed=closed_hbm,
                                    reopened_pack=reopened)
            call("PUT", f"/{LIFE_INDEX}/_settings",
                 {"index": {"blocks": {"write": True}}})
            resize_checks = []   # (mode, mix, responses), checked later
            for mode, target, n in (("shrink", f"{LIFE_INDEX}-1", 1),
                                    ("split", f"{LIFE_INDEX}-8", 8)):
                with step(mode):
                    data, _ = call("PUT", f"/{LIFE_INDEX}/_{mode}/{target}",
                                   {"settings": {"index": {
                                       "number_of_shards": n}}})
                    copied = json.loads(data)["copied_docs"]
                with step(f"{mode}_search"):
                    mix = [(target, f"{target}-{i}", body) for i, (_, _, body)
                           in enumerate(alias_mix[:2])]
                    resize_checks.append((mode, mix, [
                        search_once(host, port, "rest_api", *m)[0]
                        for m in mix]))
                    totals = [json.loads(d)["hits"]["total"]["value"]
                              for _, d in rest_raw_many(host, port, [
                                  ("POST", f"/{target}/_search", b, None)
                                  for b in life_bodies], 16)[0]]
                if copied != LIFE_DOCS or totals != [
                        json.loads(b)["hits"]["total"]["value"]
                        for b in before]:
                    raise AssertionError(f"rest_api: {mode} copied "
                                         f"{copied} docs or changed a "
                                         f"total")
                out["lifecycle"][mode] = dict(target=target, shards=n,
                                              copied=copied)
            routes.update(("_close", "_open", "_settings", "_shrink",
                           "_split", "_bulk", "_search"))
        launches = dict(mk.LAUNCHES)
        zero = [n for n in MAIN_KERNELS + EXACT_KERNELS if launches[n] <= 0]
        if zero:
            raise AssertionError(f"rest_api: kernels not launched: {zero}")
        # the checks below launch kernels of their own, after the read
        with step("resize_checks"):
            for mode, mix, resps in resize_checks:
                out["lifecycle"][mode]["shards_checked"] = \
                    check_shards_on_card(node, "rest_api", mix, resps)
            del resize_checks
        with step("deletes"):
            for index in (LIFE_INDEX, f"{LIFE_INDEX}-1", f"{LIFE_INDEX}-8"):
                call("DELETE", f"/{index}")
            call("DELETE", f"/{REST_INDEX}/_alias/{ALIAS}")
            torch.cuda.synchronize()
        with step("alias_checks"):
            out["alias"] = dict(
                bodies=ALIAS_BODIES, filter=filt,
                shards_checked=check_shards_on_card(node, "rest_api",
                                                    alias_mix, alias_resp),
                parity=("alias search == the bool with its filter (bytes);"
                        " per shard execute_query on the card == the CPU "
                        "plain path; the response == the merge of the "
                        "card's shards"))
        with step("launch_checks"):
            worst = 0.0
            n_shapes = len(rec.shapes)
            while rec.shapes:   # each launch's operands go once checked
                args, kw = rec.shapes.popitem()[1]
                worst = max(worst, check_launch(mk, "rest_api", args,
                                                kw)[1])
                del args, kw
            out["parity"] = dict(
                fused_merge_topk_shapes=n_shapes, max_abs_err=worst,
                exact_merge=check_exact_launches(mk, ex.launches),
                shard_topk=check_topk_calls(mk, top.calls),
                tolerance="bitwise: scores as uint32, docs and totals exact")
        with step("drain"):
            mem_after = None
            for polls in range(1, 51):   # the retired batchers let go
                gc.collect()
                torch.cuda.synchronize()
                mem_after = torch.cuda.memory_allocated()
                if mem_after == mem_before and hbm.used == hbm_before:
                    break
                time.sleep(0.1)
        out.update(routes=sorted(routes), launches=launches,
                   hbm_before=hbm_before, hbm_peak=peak[0],
                   hbm_after=hbm.used,
                   memory_allocated_before=mem_before,
                   memory_allocated_after=mem_after, drain_polls=polls,
                   phase_s=time.perf_counter() - t_phase)
        if hbm.used != hbm_before or mem_after != mem_before:
            raise AssertionError(f"rest_api: hbm {hbm.used} / memory "
                                 f"{mem_after} after the deletes, "
                                 f"{hbm_before} / {mem_before} before the "
                                 f"line")
    except BaseException:
        out["phase_s"] = time.perf_counter() - t_phase
        log("rest_api_failed", **out)
        raise
    return out, launches


def rest_phase(corpus, bodies, mk, smi, e2e_responses, data_root,
               exact_run, exact_responses):
    """The node over HTTP on the card, on make_mesh() pinned to one card
    (the collective tail at world size 1): a 16-shard index with the
    body text mapping and async translog durability, the e2e corpus
    loaded by _bulk, _refresh, _forcemerge, _refresh, then the e2e
    bodies from REST_CLIENTS threads, as they are (1000 hits with
    _source) and with "_source": false, then the exact phase's bodies.
    Checks the launches against the plain version (every train's
    shard_topk, every exact merge), the hits against the numpy oracle,
    the two runs against each other and against the in-process e2e run,
    the exact run against the in-process exact phase; then runs the
    planner, fields, rest_api and delta lines on the same node, and
    checks that deleting
    the index (a delta chained on it) drains the hbm breaker to 0 and
    returns torch.cuda.memory_allocated() to its value before the
    pack."""
    import gc
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch import native
    from elasticsearch_tpu_torch.node import Node, serve
    from elasticsearch_tpu_torch.parallel.mesh import make_mesh

    data = os.path.join(data_root, "chip_smoke_rest")
    shutil.rmtree(data, ignore_errors=True)
    # the reference's settings defaults; the node's own mesh, on one card
    node = Node(data, mesh=make_mesh(devices=[torch.device("cuda", 0)]))
    server = serve(node, "127.0.0.1", 0)
    host, port = server.server_address
    out = {"nvidia_smi": smi, "docs": N_DOCS, "shards": SHARDS,
           "bulk_docs": BULK_DOCS, "bulk_clients": BULK_CLIENTS,
           "clients": REST_CLIENTS,
           "window_s": node.gpu_search.batcher.window_s}
    try:
        status, resp = rest_http(host, port, "PUT", f"/{REST_INDEX}", {
            "settings": {"number_of_shards": SHARDS,
                         "translog": {"durability": "async"}},
            "mappings": {"properties": {FIELD: {"type": "text"}}}})
        if status != 200:
            raise AssertionError(f"PUT index: {resp}")
        ingest_s = rest_bulk_load(host, port, corpus, N_DOCS)
        t0 = time.perf_counter()
        for method, path in (("POST", f"/{REST_INDEX}/_forcemerge"),
                             ("POST", f"/{REST_INDEX}/_refresh")):
            status, resp = rest_http(host, port, method, path)
            if status != 200:
                raise AssertionError(f"{path}: {resp}")
        out.update(ingest_s=ingest_s, ingest_docs_per_s=N_DOCS / ingest_s,
                   forcemerge_refresh_s=time.perf_counter() - t0)
        svc = node.indices.index(REST_INDEX)
        segments = [svc.shard(s).acquire_searcher().views[0].segment
                    for s in range(SHARDS)]
        gc.collect()
        # the 1M documents' objects live until the node closes: frozen,
        # the later collections of the drain checks skip them (each full
        # collection over them took ~5.7 s)
        gc.freeze()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        hbm = node.breakers.get_breaker("hbm")

        runs = {}
        launches = {}
        with LaunchRecorder(mk) as rec, TopkRecorder(mk) as top:
            rest_queries(host, port, bodies[:8])   # builds the pack
            resident = node.gpu_search.packs.residents()[0]
            out.update(resident_bytes=resident.nbytes_device(),
                       hbm_charged=hbm.used,
                       pack_build_misses=node.gpu_search.packs.misses)
            if hbm.used != resident.nbytes_device():
                raise AssertionError(f"hbm charge {hbm.used} != resident "
                                     f"bytes {resident.nbytes_device()}")
            del resident
            for label, source in (("source", True), ("nosource", False)):
                run_bodies = [dict(b, _source=source) for b in bodies]
                node.gpu_search.stages.reset()
                mk.reset_launches()
                plans0 = node.gpu_search.plans.stats()
                node.gpu_search.batcher.max_inflight = 0
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    responses, wall = rest_queries(host, port, run_bodies)
                    torch.cuda.synchronize()
                launches[label] = dict(mk.LAUNCHES)
                plans1 = node.gpu_search.plans.stats()
                busy = device_busy_ms(prof)
                stages = node.gpu_search.stages.snapshot()
                runs[label] = responses
                out[label] = dict(
                    queries=len(responses), wall_s=wall,
                    qps=len(responses) / wall,
                    hits=sum(len(r["hits"]["hits"]) for r in responses),
                    launches=launches[label],
                    stages=stages,
                    device_busy_ms=busy if busy > 0 else "not measured",
                    device_idle_share=(1.0 - busy / 1e3 / wall) if busy > 0
                    else "not measured",
                    plan_cache={n: plans1[n] - plans0[n]
                                for n in ("hits", "misses")},
                    max_inflight=node.gpu_search.batcher.max_inflight,
                    batch_wait_split_mean_ms={
                        part: stages.get(f"batch_wait.{part}",
                                         {}).get("mean_ms")
                        for part in ("queue", "window", "dispatch",
                                     "completion")})
                zero = [n for n in MAIN_KERNELS if launches[label][n] <= 0]
                if zero:
                    raise AssertionError(f"{label}: kernels not launched "
                                         f"through REST: {zero}")
                if out[label]["max_inflight"] < 2:
                    raise AssertionError(f"{label}: no train launched while "
                                         "another was in flight")
            shapes = list(rec.shapes.values())
            rec.shapes.clear()
        mk.reset_launches()
        with LaunchRecorder(mk, "exact_merge_topk", every=True) as ex, \
                TopkRecorder(mk) as top_exact:
            exact_resp, exact_wall = rest_queries(host, port, exact_run)
        launches["exact"] = dict(mk.LAUNCHES)
        zero = [n for n in EXACT_KERNELS if launches["exact"][n] <= 0]
        if zero:
            raise AssertionError(f"exact: kernels not launched through "
                                 f"REST: {zero}")
        out["exact"] = dict(queries=len(exact_resp), wall_s=exact_wall,
                            qps=len(exact_resp) / exact_wall,
                            launches=launches["exact"],
                            parity=check_exact_launches(mk, ex.launches),
                            shard_topk=check_topk_calls(mk,
                                                        top_exact.calls))
        if not same_up_to_ties(hits_of(exact_resp),
                               hits_of(exact_responses)):
            raise AssertionError("REST exact hits differ from the "
                                 "in-process exact phase's")
        out["shard_topk"] = check_topk_calls(mk, top.calls)
        del exact_resp
        n_shapes = len(shapes)
        worst = 0.0
        while shapes:   # each launch's operands go as soon as checked
            args, kw = shapes.pop()
            _, err, _ = check_launch(mk, "rest", args, kw)
            worst = max(worst, err)
            del args, kw
        out["parity"] = dict(shapes=n_shapes, max_abs_err=worst,
                             tolerance="bitwise: scores as uint32, docs "
                                       "and totals exact")
        oracle_check(runs["source"], bodies, corpus, segments)
        if hits_of(runs["source"]) != hits_of(runs["nosource"]):
            raise AssertionError("the _source and no-_source runs differ")
        if any("_source" in h for r in runs["nosource"]
               for h in r["hits"]["hits"]):
            raise AssertionError("_source: false returned _source")
        if not same_up_to_ties(hits_of(runs["source"]),
                               hits_of(e2e_responses)):
            raise AssertionError("REST hits differ from the in-process "
                                 "e2e run's")
        out["same_as_e2e"] = ("scores bit for bit, ids up to ties at the "
                              "last score")
        out["native"] = native.used()
        # the plan key ignores _source: every body of the second wave
        # hits the plan the first one cached
        if out["nosource"]["plan_cache"] != {"hits": len(bodies),
                                             "misses": 0}:
            raise AssertionError(f"the second wave's plan cache: "
                                 f"{out['nosource']['plan_cache']}")
        out["service"] = service_rest(host, port, node, bodies, runs, smi)
        log("service", part="rest", **out["service"])
        del runs, segments, svc
        features = {}
        planner, planner_kernels = planner_phase(host, port, node, corpus,
                                                 mk, smi, features)
        fields, fields_launches = fields_phase(host, port, node, corpus,
                                               bodies, mk, smi, features)
        rest_api, rest_api_launches = rest_api_phase(host, port, node,
                                                     corpus, bodies, mk,
                                                     smi)
        delta, delta_kernels, delta_launches = delta_phase(
            host, port, node, corpus, bodies, mk, smi)
        status, resp = rest_http(host, port, "DELETE", f"/{REST_INDEX}")
        if status != 200:
            raise AssertionError(f"DELETE index: {resp}")
        mem_after = None
        for _ in range(50):   # the retired batcher thread lets go
            gc.collect()
            torch.cuda.synchronize()
            mem_after = torch.cuda.memory_allocated()
            if mem_after == mem_before:
                break
            time.sleep(0.1)
        out.update(hbm_after_delete=hbm.used,
                   memory_allocated_before_pack=mem_before,
                   memory_allocated_after_delete=mem_after,
                   deltas_at_delete=delta["tail"]["chain"]["packs"])
        if hbm.used != 0:
            raise AssertionError(f"hbm breaker reads {hbm.used} after "
                                 f"DELETE")
        if mem_after != mem_before:
            raise AssertionError(f"memory_allocated {mem_after} after "
                                 f"DELETE, {mem_before} before the pack")
    except BaseException:
        log("rest_failed", **out)
        raise
    finally:
        server.shutdown()
        server.server_close()
        node.close()
        shutil.rmtree(data, ignore_errors=True)
        gc.unfreeze()
    return out, dict(launches["source"],
                     exact_merge=launches["exact"]["exact_merge"]), \
        planner, planner_kernels, delta, delta_kernels, delta_launches, \
        fields, fields_launches, rest_api, rest_api_launches, \
        features["launches"]


def time_events(fn, n):
    """Median ms per kernel name over n calls of fn(events)."""
    import torch
    per = {}
    for _ in range(n):
        events = []
        fn(events)
        torch.cuda.synchronize()
        call = {}
        for name, start, end in events:
            call[name] = call.get(name, 0.0) + start.elapsed_time(end)
        for name, ms in call.items():
            per.setdefault(name, []).append(ms)
    return {name: statistics.median(v) for name, v in per.items()}


def time_cuda(fn, n):
    """Median ms of fn() over n calls (CUDA events, after one warm-up)."""
    import torch
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_sort_input(sort_input):
    """The row sort's unsorted keys of every row as one int64 tensor,
    the row id in the high 32 bits: the input of the one library sort
    that computes the same function."""
    import torch
    row_off = sort_input["row_off"]
    out = []
    for keys, n in ((sort_input["keys"], sort_input["n_keys"]),
                    (sort_input["count_keys"], sort_input["n_count_keys"])):
        if keys is None:
            continue
        idx = torch.arange(keys.numel(), device=keys.device)
        row = torch.searchsorted(row_off, idx, right=True) - 1
        valid = idx - row_off[row] < n.to(torch.int64)[row]
        out.append((row[valid] << 32)
                   | (keys[valid].to(torch.int64) & 0xFFFFFFFF))
    return out


def kernel_bounds(stats, doc_bytes):
    """Least bytes each kernel must move for this launch's data: each
    input read once, each output written once."""
    r, t, g = stats["rows"], stats["slots"], stats["n_grp"]
    keys, ckeys = stats["keys"], stats["count_keys"]
    cand, picked, kk = stats["candidates"], stats["picked"], stats["kk"]
    return {
        # the selecting slots' codes and starts, every slot's length,
        # weight, block start and block-max window; kth, slot_ub, grp_ub
        "slot_decode": (stats["kth_lanes"] * 2 + stats["select_slots"] * 4
                        + r * t * 12 + r * t * (g + 1) * 2
                        + r * t * (g + 2) * 4),
        "row_pack": (stats["lanes"] * (doc_bytes + 2) + r * t * g * 4
                     + (keys + ckeys) * 4),
        "row_sort": (keys + ckeys) * 8,
        "run_sum": (keys + ckeys) * 4 + cand * 12 + r * 8,
        # candidates read once; each picked candidate's matched posting
        # at least once (doc, rank, residual value); outputs written once
        "select_rescore": cand * 12 + picked * 7 + r * kk * 8,
    }


def exact_sort_keys(args, kw):
    """The exact merge's sort input as one int64 tensor: every valid
    lane's doc, its row in the high 32 bits (a stable torch.sort of it
    orders the lanes as the kernel's sort does)."""
    import torch

    from elasticsearch_tpu_torch.ops import sparse
    docs, _ = sparse._lane_decode(
        *args[:5], max_len=kw["max_len"], d_pad=kw["d_pad"], exact=False,
        doc_bases=kw.get("doc_bases"), dbs_starts=kw.get("dbs_starts"),
        dlo_starts=kw.get("dlo_starts"))
    lanes = torch.arange(kw["max_len"], device=docs.device)
    valid = lanes[None, None, :] < args[3][:, :, None]
    rows = torch.arange(docs.shape[0], device=docs.device)[:, None, None]
    return ((rows << 32) | docs)[valid]


def topk_entry(mk, name, vals, k, launches, n_trains,
               replaces=TOPK_LINE):
    """A kernels-line entry of shard_topk on one gather: its ms and
    device ms, the stable sort (its plain version) and torch.topk timed
    on the same tensor, the bytes bound, the size classes its rows took
    and the blocks per SM of each of its kernels."""
    import torch

    from elasticsearch_tpu_torch.tools.kernel_ab import profiled
    b, n = vals.shape
    kk = min(k, n)
    topk_bytes = b * n * 4 + b * kk * (4 + 8)
    stats = {}
    mk.shard_topk(vals, k, stats=stats)
    return {
        "name": name, "kernel": "shard_topk", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": replaces,
        "launches": launches["shard_topk"], "max_abs_err": 0.0,
        "ms": time_events(lambda ev: mk.shard_topk(vals, k, events=ev),
                          TIMED)["shard_topk"],
        "device_ms": profiled(lambda: mk.shard_topk(vals, k),
                              TIMED).get("shard_topk"),
        "plain_ms": time_cuda(lambda: mk.shard_topk_plain(vals, k), TIMED),
        "plain_of": "shard_topk_plain: a stable descending torch.sort",
        "bound_ms": topk_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_cuda(lambda: torch.topk(vals, kk, dim=1),
                                TIMED),
        "library_of": "torch.topk(vals, k, dim=1): the same values, no "
                      "fixed order among equal ones",
        "launches_per_batch": launches["shard_topk"] / n_trains,
        "shape": {"rows": b, "width": n, "k": k}, "bytes": topk_bytes,
        "size_classes": stats["topk_classes"],
        "slices": stats["topk_slices"],
        "blocks_per_sm": stats["topk_blocks_per_sm"]}


def newer_kernel_entries(mk, svc, topk_calls, exact_bodies_128, launches,
                         n_trains, exact_launches, exact_trains,
                         doc_bytes):
    """The kernels line's shard_topk and exact_merge entries: shard_topk
    timed on the fixed train's gather (its tail's input) and on the
    k10000 train's (kernel k 16,384: the device class), exact_merge on
    the fixed train's bodies with boost 1e-15 as one train (its own
    shard_topk over the candidates is timed apart and not in its ms), at
    the package's window cap and at each of EXACT_WINDOW_CAPS."""
    import torch

    from elasticsearch_tpu_torch.tools.kernel_ab import (fixed_train,
                                                         profiled)
    entries = [topk_entry(mk, name, vals, k, launches, n_trains)
               for name, (vals, k) in topk_calls]
    args, kw = fixed_train(svc, mk, exact_recorder, INDEX, FIELD, K,
                           exact_bodies_128)
    stats = {}
    mk.exact_merge_topk(*args, **dict(kw, stats=stats))
    r, t = args[2].shape
    exact_bytes = (stats["lanes"] * (doc_bytes + 2) + r * t * 24
                   + stats["candidates"] * 8 + r * 4)
    keys = exact_sort_keys(args, kw)
    library = time_cuda(lambda: torch.sort(keys, stable=True), TIMED)
    del keys

    def exact_ms():
        return time_events(
            lambda ev: mk.exact_merge_topk(*args, **dict(kw, events=ev)),
            TIMED)["exact_merge"]

    by_cap = {}
    default_cap = mk.EXACT_WINDOW_CAP
    try:
        for cap in EXACT_WINDOW_CAPS:
            mk.EXACT_WINDOW_CAP = cap
            cap_stats = {}
            mk.exact_merge_topk(*args, **dict(kw, stats=cap_stats))
            by_cap[cap] = {"ms": exact_ms(),
                           "window_lanes": cap_stats["window_lanes"],
                           "smem": cap_stats["exact_smem"],
                           "blocks_per_sm":
                               cap_stats["exact_blocks_per_sm"],
                           "size_classes": cap_stats["exact_classes"]}
    finally:
        mk.EXACT_WINDOW_CAP = default_cap
    entries.append({
        "name": "merge_topk.exact_merge", "kernel": "exact_merge",
        "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": EXACT_LINE,
        "launches": exact_launches["exact_merge"], "max_abs_err": 0.0,
        "ms": exact_ms(),
        "device_ms": profiled(lambda: mk.exact_merge_topk(*args, **kw),
                              TIMED).get("exact_merge"),
        "plain_ms": time_cuda(
            lambda: mk.exact_merge_topk_plain(*args, **kw), 5),
        "plain_of": "exact_merge_topk_plain, the whole exact pipeline "
                    "with its top-k",
        "bound_ms": exact_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": library,
        "library_of": "torch.sort(stable=True) of the same lanes' (row << "
                      "32 | doc) keys: the sort alone, without the decode, "
                      "the run sums or the msm filter",
        "launches_per_batch": exact_launches["exact_merge"] / exact_trains,
        "shape": {"rows": r, "slots": t, "max_len": kw["max_len"],
                  "k": kw["k"]},
        "bytes": exact_bytes, "lanes": stats["lanes"],
        "longest_row": int(args[3].clamp(min=0).sum(dim=1).max()),
        "candidates": stats["candidates"],
        "size_classes": stats["exact_classes"],
        "window_lanes": stats["window_lanes"], "smem": stats["exact_smem"],
        "blocks_per_sm": stats["exact_blocks_per_sm"],
        "by_window_cap": by_cap})
    return entries


# ---------------------------------------------------------------------------
# service: rows past 1,024 slots, the plan cache, prewarm, profile,
# timeout, the slow log and the pipelined batcher
# ---------------------------------------------------------------------------

def wide_slots(svc, index, words):
    """The slots the widest pack row of a query of `words` needs (the
    service's own count: Σ ceil(postings / CHUNK_CAP), a slot at least a
    term)."""
    from elasticsearch_tpu_torch.search import gpu_service as gs
    return gs._slots_needed(svc.resident(index, FIELD),
                            gs.FlatQuery(FIELD, list(words), 1.0, 1))


def wide_bodies(svc, vocab):
    """[(label, body, words, boost)]: terms over WIDE_TERMS mid-frequency
    words (one slot a term a row: T 2048, T 4096) and a match of the most
    frequent words, as many as push a row past 1,024 slots; each at size
    10 and K, and at K with boost EXACT_BOOST (the exact merge)."""
    queries = []
    for n in WIDE_TERMS:
        words = list(vocab[WIDE_FIRST_RANK: WIDE_FIRST_RANK + n])
        queries.append((f"terms{n}", words, "terms"))
    n = 2
    while wide_slots(svc, INDEX, vocab[:n]) <= 1024:
        n += 8
    queries.append((f"match{n}", list(vocab[:n]), "match"))
    out = []
    for label, words, kind in queries:
        for size, boost in ((10, 1.0), (K, 1.0), (K, EXACT_BOOST)):
            if kind == "terms":
                query = {"terms": {FIELD: words}}
                if boost != 1.0:
                    query["terms"]["boost"] = boost
            else:
                query = {"match": {FIELD: {"query": " ".join(words)}}}
                if boost != 1.0:
                    query["match"][FIELD]["boost"] = boost
            tag = "boost" if boost != 1.0 else f"size{size}"
            out.append((f"{label}.{tag}", {"query": query, "size": size},
                        words, boost))
    return out


def wide_rows(args, kw, rows):
    """A launch's operands restricted to `rows` (the merge kernels'
    rows are independent: a row's outputs depend on its own slots)."""
    import torch
    idx = torch.as_tensor(rows, device=args[2].device)
    sub = list(args[:2]) + [a[idx] for a in args[2:6]]
    return sub, {n: (v[idx] if n in WIDE_ROW_OPERANDS and v is not None
                     else v) for n, v in kw.items()}


def wide_plain(mk, kind, args, kw, rows):
    """The plain version of a wide launch on `rows`, WIDE_PLAIN_ROWS rows
    a call (a whole launch of T 4096 × 4096 lanes × 128 rows does not fit
    the card's memory in the plain version's dense layout)."""
    import torch
    plain = getattr(mk, WIDE_PLAIN[kind])
    outs = []
    for a in range(0, len(rows), WIDE_PLAIN_ROWS):
        sub, skw = wide_rows(args, kw, rows[a: a + WIDE_PLAIN_ROWS])
        outs.append(plain(*sub, **skw))
    return [torch.cat([o[i] for o in outs]) for i in range(len(outs[0]))]


def wide_check_rows(args):
    """The rows a wide launch's check takes: every row with slots (its
    queries'), and the first row without (a padding query's), which
    stands for the other padding rows: their operands hold no lane."""
    import torch
    live = args[3].clamp(min=0).sum(dim=1) > 0
    rows = torch.nonzero(live).flatten().tolist()
    empty = torch.nonzero(~live).flatten().tolist()
    return rows + empty[:1], empty


def check_wide_launch(mk, kind, label, args, kw, got):
    """One recorded wide launch (its outputs `got`) against the plain
    version: its rows with slots and one padding row bit for bit, every
    padding row's outputs equal to that one's; the launch again with
    stats for its size classes → log entry; raises on a mismatch."""
    import torch
    rows, empty = wide_check_rows(args)
    want = wide_plain(mk, kind, args, kw, rows)
    idx = torch.as_tensor(rows, device=got[0].device)
    same, err = bitwise_equal([o[idx] for o in got], want)
    for o in got:
        if empty and not torch.equal(
                o[empty].view(torch.int32) if o.dtype == torch.float32
                else o[empty],
                (o[empty[:1]].view(torch.int32)
                 if o.dtype == torch.float32 else o[empty[:1]]).expand(
                    len(empty), *o.shape[1:])):
            same = False
    r, t = args[2].shape
    if not same:
        raise AssertionError(f"{kind} wide launch {label} (R{r} T{t}) != "
                             f"plain, max_abs_err {err}")
    stats = {}
    getattr(mk, WIDE_FN[kind])(*args, **dict(kw, stats=stats))
    torch.cuda.synchronize()
    classes = stats.get("classes") or stats.get("exact_classes")
    return dict(launch=label, kernel=kind, rows=r, slots=t,
                t_window=kw["t_window"], k=kw["k"],
                lanes=stats["lanes"], rows_checked=len(rows),
                padding_rows=len(empty), bitwise=True,
                size_classes={c: n for c, n in classes.items() if n},
                table_blocks=stats.get("table_blocks")), err


def wide_lane_keys(args, kw, raw):
    """Every valid lane's (row << 32 | doc) of a launch, gathered lane by
    lane (not through the dense [R, T, max_len] decode): the input of
    the stable torch.sort that stands as the exact and raw merges'
    library call."""
    import torch
    starts = args[2].to(torch.int64)
    lengths = args[3].clamp(min=0).to(torch.int64)
    r, t = lengths.shape
    dev = lengths.device
    flat_len = lengths.flatten()
    n = int(flat_len.sum())
    slot = torch.repeat_interleave(torch.arange(r * t, device=dev),
                                   flat_len)
    first = torch.cumsum(flat_len, 0) - flat_len
    lane = torch.arange(n, device=dev) - first[slot]
    pos = starts.flatten()[slot] + lane
    if raw:
        doc = args[0][pos].to(torch.int64)
    elif kw.get("doc_bases") is not None:
        base = (kw["dbs_starts"].flatten()[slot].to(torch.int64)
                + (kw["dlo_starts"].flatten()[slot].to(torch.int64)
                   + lane) // 128)
        doc = ((kw["doc_bases"].view(torch.int16)[base].to(torch.int64)
                & 0xFFFF) + args[0][pos].to(torch.int64))
    else:
        doc = args[0].view(torch.int16)[pos].to(torch.int64) & 0xFFFF
    return ((slot // t) << 32) | doc


def wide_entry(mk, kind, name, label, args, kw, launches, doc_bytes,
               err):
    """A kernels-line entry of one wide launch: CUDA-event ms (summed
    over the kind's kernels) and device ms, the plain version's ms on
    the checked rows, the bytes bound and the stable torch.sort of the
    same lanes' keys."""
    import torch

    from elasticsearch_tpu_torch.tools.kernel_ab import profiled
    fn = getattr(mk, WIDE_FN[kind])
    stats = {}
    fn(*args, **dict(kw, stats=stats))
    r, t = args[2].shape
    names = (FUSED_KERNELS if kind == "fused"
             else ("raw_merge",) if kind == "raw" else ("exact_merge",))
    per = time_events(lambda ev: fn(*args, **dict(kw, events=ev)),
                      WIDE_TIMED)
    functions = {"fused": ("slot_decode", "row_pack", "pack_table",
                           "row_sort", "run_sum", "select_rescore"),
                 "exact": ("exact_merge", "exact_finish"),
                 "raw": ("exact_merge", "exact_finish")}
    device = profiled(lambda: fn(*args, **kw), WIDE_TIMED,
                      {kind: functions[kind]}).get(kind)
    rows, _ = wide_check_rows(args)
    plain_ms = time_cuda(lambda: wide_plain(mk, kind, args, kw, rows), 1)
    if kind == "fused":
        bound = sum(kernel_bounds(stats, doc_bytes).values())
        keys = library_sort_input(stats.pop("sort_input"))
        library = time_cuda(lambda: [torch.sort(k) for k in keys],
                            WIDE_TIMED)
        library_of = ("torch.sort of the row sort's keys (row << 32 | "
                      "key), each key set")
    else:
        bound = (stats["lanes"] * (4 + 4 if kind == "raw"
                                   else doc_bytes + 2)
                 + r * t * 24 + stats["candidates"] * 8 + r * 4)
        keys = [wide_lane_keys(args, kw, kind == "raw")]
        library = time_cuda(lambda: torch.sort(keys[0], stable=True),
                            WIDE_TIMED)
        library_of = ("torch.sort(stable=True) of the same lanes' (row << "
                      "32 | doc) keys")
    del keys
    return {
        "name": name, "kernel": names[0] if kind != "fused" else "fused",
        "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": RAW_LINES["raw_merge"] if kind == "raw"
        else EXACT_LINE if kind == "exact" else PALLAS_LINE,
        "launches": launches[names[-1]], "max_abs_err": err,
        "ms": sum(per.get(n, 0.0) for n in names),
        "ms_by_kernel": {n: per.get(n) for n in names},
        "device_ms": device, "plain_ms": plain_ms,
        "plain_of": (f"the plain version on the launch's {len(rows)} "
                     f"checked rows (its rows with slots and one padding "
                     f"row), {WIDE_PLAIN_ROWS} rows a call"),
        "bound_ms": bound / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": bound, "library_ms": library, "library_of": library_of,
        "launch": label, "shape": {"rows": r, "slots": t,
                                   "t_window": kw["t_window"],
                                   "max_len": kw["max_len"], "k": kw["k"]},
        "lanes": stats["lanes"],
        "size_classes": {c: n for c, n in (
            stats.get("classes") or stats.get("exact_classes")).items()
            if n}}


def wide_phase(svc, mk, corpus, segments, doc_bytes):
    """Rows past 1,024 slots on the e2e service's 1M-doc compressed pack:
    wide_bodies one train each, the launch counts reset just before and
    read just after; every fused and exact launch against the plain
    version (check_wide_launch), the top-10 of the size-K and boosted
    bodies against the oracle (terms as the same words' OR match), the
    size-10 hits a prefix of the size-K ones → (log fields, kernels-line
    entries)."""
    t0 = time.perf_counter()
    bodies = wide_bodies(svc, corpus.vocab)
    mk.reset_launches()
    with LaunchRecorder(mk, every=True) as fused, \
            LaunchRecorder(mk, "exact_merge_topk", every=True) as exact:
        answered = {label: svc.search(INDEX, body)
                    for label, body, _, _ in bodies}
    launches = dict(mk.LAUNCHES)
    zero = [n for n in MAIN_KERNELS + EXACT_KERNELS if launches[n] <= 0]
    if zero:
        raise AssertionError(f"wide rows: kernels not launched: {zero}")
    checked, worst, timed = [], 0.0, {}
    for kind, rec in (("fused", fused), ("exact", exact)):
        labels = [label for label, body, _, boost in bodies
                  if (boost != 1.0) == (kind == "exact")]
        if len(rec.launches) != len(labels):
            raise AssertionError(f"wide rows: {len(rec.launches)} {kind} "
                                 f"launches for {labels}")
        for label, (args, kw, got) in zip(labels, rec.launches):
            entry, err = check_wide_launch(mk, kind, label, args, kw, got)
            checked.append(entry)
            worst = max(worst, err)
            if entry["slots"] <= 1024 or kw["t_window"] <= 1024 and \
                    label.startswith("terms"):
                raise AssertionError(f"wide rows: {entry} is not wide")
            if label.endswith(f"size{K}") or label.endswith("boost"):
                timed.setdefault((kind, entry["slots"]),
                                 (label, args, kw, err))
        rec.launches.clear()
    for label, body, words, boost in bodies:
        resp = answered[label]
        if label.endswith("size10"):
            big = answered[label.replace("size10", f"size{K}")]
            if hits_of([resp])[0][1] != hits_of([big])[0][1][:10]:
                raise AssertionError(f"{label}: size 10 is not the size "
                                     f"{K} answer's head")
        elif boost == 1.0:   # the boosted bodies: bitwise above
            oracle_check([resp], [{"query": {"match": {FIELD: {
                "query": " ".join(words)}}}}], corpus, segments)
    entries = []
    for (kind, t), (label, args, kw, err) in sorted(timed.items()):
        if t in WIDE_TIMED_SLOTS:
            entries.append(wide_entry(
                mk, kind, f"merge_topk.{kind}.T{t}", label, args, kw,
                launches, doc_bytes, err))
    del timed
    out = dict(bodies=[dict(label=label, terms=len(words),
                            slots=wide_slots(svc, INDEX, words),
                            total=answered[label]["hits"]["total"])
                       for label, _, words, _ in bodies],
               launches=launches, checked=checked, max_abs_err=worst,
               tolerance="bitwise: scores as uint32, docs and totals "
                         "exact",
               seconds=time.perf_counter() - t0)
    return out, entries


def wide_raw(svc, mk, corpus, segments):
    """The raw pack's most frequent words, as many as fill more than
    each of WIDE_RAW_SLOTS slots a row (past 8 terms: the exact ref
    launch, through raw_merge at T 2048 and 4096) at size K, each launch
    against the plain version, the top-10 against the oracle → (log
    fields, kernels-line entries)."""
    t0 = time.perf_counter()
    words = []
    for slots in WIDE_RAW_SLOTS:
        n = 9
        while wide_slots(svc, RAW_INDEX, corpus.vocab[:n]) <= slots:
            n += 1
        words.append(n)
    mk.reset_launches()
    bodies = [{"query": {"match": {FIELD: {
        "query": " ".join(corpus.vocab[:n])}}}, "size": K} for n in words]
    with LaunchRecorder(mk, "raw_merge_topk", every=True) as rec:
        answered = [svc.search(RAW_INDEX, b) for b in bodies]
    launches = dict(mk.LAUNCHES)
    if len(rec.launches) != len(bodies):
        raise AssertionError(f"wide raw: {len(rec.launches)} raw_merge "
                             f"launches for {len(bodies)} bodies")
    checked, entries, worst = [], [], 0.0
    for n, (args, kw, got) in zip(words, rec.launches):
        entry, err = check_wide_launch(mk, "raw", f"match{n}", args, kw,
                                       got)
        checked.append(entry)
        worst = max(worst, err)
        if entry["slots"] not in WIDE_TIMED_SLOTS:
            raise AssertionError(f"wide raw: {entry} is not at T 2048 or "
                                 f"4096")
        entries.append(wide_entry(mk, "raw",
                                  f"merge_topk.raw_merge.T{entry['slots']}",
                                  f"match{n}", args, kw, launches, 4, err))
    rec.launches.clear()
    oracle_check(answered, bodies, corpus, segments)
    return dict(words=words, launches=launches,
                checked=checked, max_abs_err=worst,
                totals=[r["hits"]["total"] for r in answered],
                seconds=time.perf_counter() - t0), entries


def close_up_to_ties(got, want, rtol=1e-5):
    """One response's (ids, scores) against another's from a path that
    sums in another order: each rank's score within rtol, and the same
    ids above the last score's tie group."""
    g_ids, g_sc = got
    w_ids, w_sc = want
    if len(g_sc) != len(w_sc):
        return False
    if any(abs(a - b) > rtol * abs(b) + 1e-6 for a, b in zip(g_sc, w_sc)):
        return False
    if not w_sc:
        return True
    cut = w_sc[-1] * (1 + rtol) + 1e-6
    head = sum(1 for sc in w_sc if sc > cut)
    return set(g_ids[:head]) == set(w_ids[:head])


class SlowLogCounter(logging.Handler):
    """Counts the records of the search slow log's channel."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def service_rest(host, port, node, bodies, runs, smi):
    """The node's serving features on the 1M-doc index after the REST
    waves: prewarm (a request sent while it runs goes to the planner and
    gives the kernel's hits up to ties), three `profile: true` bodies
    (the kernel section; the response the wave's without `profile`),
    `timeout: 10s` (the kernel, not timed out), a planner body at
    `timeout: 0ms` (timed out, equal to the same request on the CPU), a
    slow-log threshold of 0ms (one line a shard of a planner body; none
    after the reset) → log fields."""
    import threading

    from elasticsearch_tpu_torch.common.logging import SEARCH_SLOWLOG
    from elasticsearch_tpu_torch.search import coordinator
    from elasticsearch_tpu_torch.search.gpu_service import GpuSearchService

    t_start = time.perf_counter()
    gpu = node.gpu_search
    idx = node.indices.index(REST_INDEX)
    out = {"nvidia_smi": smi}
    path = f"/{REST_INDEX}/_search"
    # -- prewarm, and a request while it runs
    mid = None
    for attempt in range(3):
        fallback0 = gpu.fallback
        result = {}
        t0 = time.perf_counter()
        thread = threading.Thread(
            target=lambda: result.update(gpu.prewarm(idx, FIELD)))
        thread.start()
        while gpu.stats()["prewarm"]["state"] != "warming" and \
                thread.is_alive():
            time.sleep(0.0005)
        status, mid = rest_http(host, port, "POST", path,
                                dict(bodies[0], _source=False))
        thread.join()
        if status != 200:
            raise AssertionError(f"mid-warm request: {status} {mid}")
        if gpu.fallback > fallback0:
            break
    else:
        raise AssertionError("no request landed inside the prewarm")
    if not close_up_to_ties(hits_of([mid])[0],
                            hits_of([runs["nosource"][0]])[0]):
        raise AssertionError("the planner's mid-warm answer differs from "
                             "the kernel's")
    errors = [e for e in result["compiled"] if e.get("error")]
    if errors:
        raise AssertionError(f"prewarm signatures failed: {errors}")
    out["prewarm"] = dict(
        seconds=time.perf_counter() - t0, attempts=attempt + 1,
        total_seconds=result["total_seconds"],
        pack_seconds=result["pack_seconds"],
        signatures=len(result["compiled"]),
        compiled=result["compiled"], progress=gpu.stats()["prewarm"],
        mid_warm_request="the planner (fallback +1): the kernel's ids up "
                         "to ties, scores within rel 1e-5 (the planner "
                         "sums a doc's terms in another order)")
    # -- profile: true on three bodies
    profiles = []
    for i in range(3):
        status, resp = rest_http(host, port, "POST", path,
                                 dict(bodies[i], _source=False,
                                      profile=True))
        if status != 200:
            raise AssertionError(f"profile body {i}: {status}")
        tpu = resp["profile"]["tpu"][0]
        if hits_of([resp]) != hits_of([runs["nosource"][i]]) or (
                resp["hits"]["total"]
                != runs["nosource"][i]["hits"]["total"]):
            raise AssertionError(f"profile body {i}'s response differs "
                                 f"from the wave's")
        if resp["profile"]["shards"][0]["searches"][0]["collector"][0][
                "name"] != "TpuKernelTopK":
            raise AssertionError("the profile body left the kernel path")
        profiles.append(dict(variant=tpu["variant"],
                             plan_cache=tpu["plan_cache"],
                             stages_ms=tpu["stages_ms"]))
    out["profile"] = profiles
    # -- timeout: 10s on the kernel path; 0ms on a planner body
    served = gpu.served
    status, resp = rest_http(host, port, "POST", path,
                             dict(bodies[3], _source=False,
                                  timeout="10s"))
    if status != 200 or resp["timed_out"] or gpu.served != served + 1:
        raise AssertionError(f"timeout 10s: {status}, timed_out "
                             f"{resp.get('timed_out')}, served "
                             f"{gpu.served - served}")
    planner_body = {"query": {"match": {FIELD: bodies[4]["query"]["match"][
        FIELD]}}, "sort": ["_score"], "size": 10, "timeout": "0ms"}
    status, resp = rest_http(host, port, "POST", path, planner_body)
    cpu = GpuSearchService(device="cpu")
    try:
        want = coordinator.search(node.indices, REST_INDEX,
                                  dict(planner_body), {}, cpu)
    finally:
        cpu.close()
    resp["took"] = want["took"] = 0
    if status != 200 or not resp["timed_out"] or json.dumps(resp) != \
            json.dumps(want):
        raise AssertionError(f"timeout 0ms: {status} {resp} vs CPU {want}")
    out["timeout"] = {"10s": "kernel, timed_out false",
                      "0ms": dict(timed_out=resp["timed_out"],
                                  total=resp["hits"]["total"],
                                  shards=resp["_shards"],
                                  card_equals_cpu=True)}
    # -- the slow log: 0 ms, one line a shard of a planner body, reset
    counter = SlowLogCounter()
    logging.getLogger(SEARCH_SLOWLOG).addHandler(counter)
    try:
        key = "index.search.slowlog.threshold.query.warn"
        lines = []
        for value in ("0ms", None):
            status, resp = rest_http(host, port, "PUT",
                                     f"/{REST_INDEX}/_settings",
                                     {key: value})
            if status != 200:
                raise AssertionError(f"slow log setting: {resp}")
            before = len(counter.records)
            status, _ = rest_http(host, port, "POST", path,
                                  dict(planner_body, timeout="60s"))
            lines.append(len(counter.records) - before)
        if lines != [SHARDS, 0]:
            raise AssertionError(f"slow log lines {lines}, expected "
                                 f"[{SHARDS}, 0]")
    finally:
        logging.getLogger(SEARCH_SLOWLOG).removeHandler(counter)
    out["slow_log"] = dict(lines_at_0ms=lines[0], lines_after_reset=lines[1],
                           first=counter.records[0][:200])
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# raw: a raw pack (segments above 65,408 docs) and its pruned tiers
# ---------------------------------------------------------------------------

class RawRecorder:
    """Wraps merge_kernel's raw_merge_topk, pruned_candidates,
    pruned_rescore and pruned_order while a path runs and keeps every
    call's operands and outputs (device copies), and in `tiers`, in step
    with `calls`, the pruned tier the service ran each call for (None
    outside one)."""

    NAMES = ("raw_merge_topk", "pruned_candidates", "pruned_rescore",
             "pruned_order")

    def __init__(self, merge_kernel):
        import threading

        from elasticsearch_tpu_torch.search import gpu_service
        self.mk = merge_kernel
        self.gs = gpu_service
        self.real = {n: getattr(merge_kernel, n) for n in self.NAMES}
        self.real_execute = gpu_service._execute_pruned
        self.calls = []
        self.tiers = []
        self.tier = threading.local()

    def __enter__(self):
        gs = self.gs
        prefix = {gs.PREFIX_CAP2: "prefix-16k",
                  gs.PREFIX_CAP3: "escalated-64k"}

        def execute(resident, flats, k, **kw):
            self.tier.name = (f"full-{kw['full_slots']}"
                              if kw.get("full_slots") is not None
                              else prefix.get(kw.get("prefix_cap")))
            try:
                return self.real_execute(resident, flats, k, **kw)
            finally:
                self.tier.name = None

        gs._execute_pruned = execute
        for name, real in self.real.items():
            def record(*args, _name=name, _real=real, **kw):
                out = _real(*args, **kw)
                outs = out if isinstance(out, tuple) else (out,)
                self.calls.append((_name, args, dict(kw),
                                   tuple(o.clone() for o in outs)))
                self.tiers.append(getattr(self.tier, "name", None))
                return out
            setattr(self.mk, name, record)
        return self

    def __exit__(self, *exc):
        self.gs._execute_pruned = self.real_execute
        for name, real in self.real.items():
            setattr(self.mk, name, real)


def candidate_classes(mk, calls):
    """The queries each pruned_candidates class takes in the recorded
    calls (each call launched once more with stats, after the window's
    counts were read) → {class: queries}."""
    out = dict.fromkeys(mk.CAND_CLASSES, 0)
    for name, args, kw, _ in calls:
        if name != "pruned_candidates":
            continue
        stats = {}
        mk.pruned_candidates(*args, **dict(kw, stats=stats))
        for cls, n in stats["cand_classes"].items():
            out[cls] += n
    return out


def check_raw_calls(mk, calls):
    """Every recorded raw-path call against its plain version on its
    operands, bit for bit (a pruned_candidates gid only where its value
    is finite: a -inf entry's gid is free, the step zeroes it); raises on
    a mismatch. Empties `calls` → {kernel: calls checked}."""
    import torch
    plain = {"raw_merge_topk": mk.raw_merge_topk_plain,
             "pruned_candidates": mk.pruned_candidates_plain,
             "pruned_rescore": mk.pruned_rescore_plain,
             "pruned_order": mk.pruned_order_plain}
    kernel = {"raw_merge_topk": "raw_merge",
              "pruned_candidates": "pruned_candidates",
              "pruned_rescore": "pruned_rescore",
              "pruned_order": "pruned_rescore"}
    checked = {}
    while calls:
        name, args, kw, got = calls.pop()
        want = plain[name](*args, **kw)
        want = want if isinstance(want, tuple) else (want,)
        if name == "pruned_candidates":
            live = want[0] > float("-inf")
            same = (torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(got[1][live], want[1][live])
                    and torch.equal(got[2], want[2]))
        else:
            same = bitwise_equal(list(got), list(want))[0]
        if not same:
            raise AssertionError(f"{name} != plain at "
                                 f"{[tuple(a.shape) for a in args[:4] if hasattr(a, 'shape')]}")
        key = kernel[name] + ("" if name != "pruned_order" else ".order")
        checked[key] = checked.get(key, 0) + 1
        del args, kw, got, want
    return checked


def raw_probe_bodies(vocab):
    """Bodies, sent as trains of their own (a train's k is its largest
    from + size), that reach the tiers the e2e traffic may not: one head
    term at size 10 (33-128 slots a shard: full-128), two head terms and
    a rare one at size 10 (more than 128 slots: the prefix tier, whose
    bound the rare term's scores may clear) and three head terms at size
    10 (a bound that fails, so it escalates)."""
    head = vocab[:4]
    texts = [head[0], head[1]]
    texts += [f"{head[0]} {head[1]} {vocab[2000 + 500 * i]}"
              for i in range(4)]
    texts += [f"{head[0]} {head[1]} {head[2]}",
              f"{head[1]} {head[2]} {head[3]}"]
    return [{"query": {"match": {FIELD: t}}, "size": 10} for t in texts]


def raw_bytes(name, args, kw, got):
    """Least bytes a raw-path kernel must move for one call's data: each
    input read once, each output written once."""
    if name == "raw_merge":
        lanes = int(args[3].clamp(min=0).sum())
        r, t = args[2].shape
        cand = int(got[2].sum()) if len(got) > 2 else 0
        return lanes * 8 + r * t * 12 + cand * 8 + r * 4
    if name == "pruned_candidates":
        lanes = int(args[3].clamp(min=0, max=kw["max_len"]).sum())
        b, gt = args[2].shape
        return lanes * 8 + b * gt * 16 + int(got[2].sum()) * 8 + b * 4
    # pruned_rescore: each candidate's gid; each (candidate, term)'s
    # range and weight, search_iters probes and its impact; the output
    cand_gids, t_starts = args[2], args[3]
    b, c = cand_gids.shape
    terms = t_starts.shape[2]
    k = kw.get("k") or 0
    return (b * c * 8 + b * c * terms * (12 + 4 * kw["search_iters"] + 4)
            + b * k * 12)


def profiled_ms(fn, fn_names):
    """Mean device ms a call of fn spends in the named kernels, each
    launched once a call: the sum of their means per record, since a
    session may end without some or all of the device's kernel records
    (up to PROFILE_TRIES sessions until one holds a named kernel), and
    when none did what the last session listed → (ms, None) or (None,
    what was seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch.tools.kernel_ab import PROFILE_TRIES
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TIMED):
                fn()
            torch.cuda.synchronize()
        total, seen = 0.0, {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            seen[ev.key[:120]] = (us, ev.count)
            if any(f in ev.key for f in fn_names) and ev.count:
                total += us / 1e3 / ev.count
        if total:
            return total, None
    listed = sorted(seen.items(), key=lambda kv: -kv[1][0])[:8]
    return None, {"sessions": PROFILE_TRIES, "listed": listed}


def timed_entry(name, kernel, run, names, plain, plain_of, library,
                library_of, nbytes, **extra):
    """A kernels-line entry of one call: run(events) launches the kernel
    once; its ms by CUDA events, device ms over the `names` kernels, the
    plain version's ms and the library call's (measured by the caller)."""
    dev_ms, seen = profiled_ms(lambda: run(None), names)
    e = dict(name=name, kernel=kernel, ms=time_events(run, TIMED)[kernel],
             device_ms=dev_ms, plain_ms=time_cuda(plain, 5),
             plain_of=plain_of, library_ms=library, library_of=library_of,
             bytes=nbytes, **extra)
    if seen is not None:
        e["device_ms_seen"] = seen
    return e


def raw_kernel_entries(mk, calls, launches, n_trains, rescore_call,
                       tier_calls):
    """The kernels line's raw_merge, pruned_candidates and pruned_rescore
    entries, each timed alone: raw_merge and pruned_candidates on the
    fixed train's calls (the first 128 bodies as one train), and
    pruned_candidates also on the probes' widest prefix-16k and
    escalated-64k groups (`tier_calls`); pruned_rescore on
    `rescore_call`, the widest scoring call of the run (a prefix probe's
    score and order), and on the fixed train's widest order-only call:
    ms (CUDA events), device ms (torch.profiler), the plain version's
    ms, the bytes bound, the library call, and for pruned_candidates the
    classes its queries took, its blocks and their residency."""
    import torch

    from elasticsearch_tpu_torch.ops import sparse

    entry = timed_entry

    def widest(name):
        own = [c for c in calls if c[0] == name]
        return max(own, key=lambda c: c[1][2].numel() * (
            int(c[1][3].clamp(min=0).sum()) if c[1][3] is not None else 1))

    entries = []
    # raw_merge: the train's exact launch (its AND / msm bodies)
    _, args, kw, got = widest("raw_merge_topk")
    docs, _ = sparse._lane_decode(*args[:5], max_len=kw["max_len"],
                                  d_pad=kw["d_pad"], exact=False)
    lanes = torch.arange(kw["max_len"], device=docs.device)
    valid = lanes[None, None, :] < args[3][:, :, None]
    rows = torch.arange(docs.shape[0], device=docs.device)[:, None, None]
    keys = ((rows << 32) | docs)[valid]
    del docs, valid
    fn_kw = {k: v for k, v in kw.items() if k not in ("stats", "events")}
    entries.append(entry(
        "merge_topk.raw_merge", "raw_merge",
        lambda ev: mk.raw_merge_topk(*args, **dict(fn_kw, events=ev)),
        ("exact_merge_kernel<true>", "exact_finish_kernel<true>"),
        lambda: mk.raw_merge_topk_plain(*args, **fn_kw),
        "raw_merge_topk_plain: the whole ref pipeline with its top-k",
        time_cuda(lambda: torch.sort(keys, stable=True), TIMED),
        "torch.sort(stable=True) of the same lanes' (row << 32 | doc) "
        "keys: the sort alone", raw_bytes("raw_merge", args, fn_kw, got),
        shape={"rows": args[2].shape[0], "slots": args[2].shape[1],
               "max_len": kw["max_len"], "k": kw["k"],
               "lanes": int(keys.numel())}))
    del keys
    # pruned_candidates: the train's widest phase-A group, then the
    # probes' prefix tiers (a query of many bands)
    groups = [("merge_topk.pruned_candidates", widest("pruned_candidates"),
               "full-32: the fixed train's widest group")]
    groups += [(f"merge_topk.pruned_candidates.{tier.replace('-', '_')}",
                call, f"{tier}: the probes' widest group")
               for tier, call in tier_calls.items()]
    for name, (_, args, kw, got), group in groups:
        flat_docs, flat_imps, starts, lengths, weights, prow = args
        gid = (prow.to(torch.int64)[:, :, None] * (kw["d_pad"] + 1)
               + sparse._window(flat_docs, starts, kw["max_len"]))
        valid = (torch.arange(kw["max_len"], device=gid.device)[
            None, None, :] < lengths[:, :, None])
        qrow = torch.arange(gid.shape[0], device=gid.device)[:, None, None]
        gkeys = ((qrow << 40) | gid)[valid]
        del gid, valid
        stats = {}
        mk.pruned_candidates(*args, **dict(kw, stats=stats))
        entries.append(entry(
            name, "pruned_candidates",
            lambda ev, a=args, k=kw: mk.pruned_candidates(
                *a, **dict(k, events=ev)),
            ("cand_part_kernel", "cand_band_kernel"),
            lambda a=args, k=kw: mk.pruned_candidates_plain(*a, **k),
            "pruned_candidates_plain: the group's sort, run sums and top-k",
            time_cuda(lambda: torch.sort(gkeys, stable=True), TIMED),
            "torch.sort(stable=True) of the same lanes' (query << 40 | gid)"
            " keys: the sort alone",
            raw_bytes("pruned_candidates", args, kw, got), group=group,
            shape={"queries": starts.shape[0], "slots": starts.shape[1],
                   "max_len": kw["max_len"], "k": kw["k"],
                   "pack_keys": kw["pack_keys"],
                   "lanes": int(gkeys.numel())},
            size_classes=stats["cand_classes"], blocks=stats["cand_blocks"],
            smem=stats["cand_smem"],
            blocks_per_sm=stats["cand_blocks_per_sm"]))
        del gkeys
    # pruned_rescore: the run's widest scoring call (score and order)
    if rescore_call is not None:
        _, args, kw, got = rescore_call
        ds_docs, ds_imps, cgids, t_st, t_ln, t_w = args
        d1 = kw["d_pad"] + 1
        flat = ds_docs.reshape(-1).to(torch.int64)
        flat_imp = ds_imps.reshape(-1)
        # each ascending run of docs (a term's postings, or two that
        # chain) gets an id: (run << 20 | doc) is sorted over the whole
        # array, so one searchsorted finds a doc inside any term's range
        run_id = torch.cumsum(torch.cat([
            torch.zeros(1, dtype=torch.int64, device=flat.device),
            (flat[1:] <= flat[:-1]).long()]), 0)
        keys = (run_id << 20) | flat
        if kw["d_pad"] >= 1 << 20:
            raise AssertionError("the searchsorted yardstick keeps docs "
                                 "in 20 bits")
        row = torch.div(cgids, d1, rounding_mode="floor")
        ord_ = cgids - row * d1
        lr = row.clamp(0, t_st.shape[0] - 1)
        qsel = torch.arange(cgids.shape[0], device=cgids.device)[:, None]
        p_pad = kw["p_pad"]

        def library():
            total = torch.zeros(cgids.shape, dtype=torch.float32,
                                device=cgids.device)
            for t in range(t_st.shape[2]):
                lo = lr * p_pad + t_st[lr, qsel, t]
                ln = t_ln[lr, qsel, t]
                pos = torch.searchsorted(keys, (run_id[lo] << 20) | ord_)
                pos = pos.clamp(max=flat.numel() - 1)
                hit = (pos >= lo) & (pos < lo + ln) & (flat[pos] == ord_)
                total += torch.where(hit, t_w[lr, qsel, t] * flat_imp[pos],
                                     torch.zeros_like(total))
            return total

        mode = ("score_and_order" if kw.get("cand_vals") is not None
                else "score")
        stats = {}
        mk.pruned_rescore(*args, **dict(kw, stats=stats))
        entries.append(entry(
            "merge_topk.pruned_rescore", "pruned_rescore",
            lambda ev: mk.pruned_rescore(*args, **dict(kw, events=ev)),
            ("rescore_score_kernel", "rescore_order_kernel"),
            lambda: mk.pruned_rescore_plain(*args, **kw),
            f"pruned_rescore_plain ({mode})", time_cuda(library, TIMED),
            "torch.searchsorted per term of the candidates' docs plus the "
            "weighted sum (no range bounds, no order)",
            raw_bytes("pruned_rescore", args, kw, got),
            shape={"queries": cgids.shape[0], "candidates": cgids.shape[1],
                   "terms": t_st.shape[2], "mode": mode,
                   "search_iters": kw["search_iters"]},
            size_classes=stats["rescore_classes"],
            blocks=stats["rescore_blocks"], smem=stats["rescore_smem"],
            blocks_per_sm=stats["rescore_blocks_per_sm"]))
        del keys, run_id, flat
    # pruned_rescore's order alone: the fixed train's widest call
    orders = [c for c in calls if c[0] == "pruned_order"]
    if orders:
        _, args, kw, got = max(orders, key=lambda c: c[1][0].numel())
        stats = {}
        mk.pruned_order(*args, **dict(kw, stats=stats))
        entries.append(entry(
            "merge_topk.pruned_rescore.order", "pruned_rescore",
            lambda ev: mk.pruned_order(*args, **dict(kw, events=ev)),
            ("rescore_order_kernel",),
            lambda: mk.pruned_order_plain(*args, **kw),
            "pruned_order_plain", time_cuda(
                lambda: torch.sort(-args[0], dim=1), TIMED),
            "torch.sort of the candidates' -score (the order without its "
            "gid tie rule)",
            args[0].numel() * 16 + args[0].shape[0] * kw["k"] * 12,
            shape={"queries": args[0].shape[0],
                   "candidates": args[0].shape[1], "k": kw["k"],
                   "mode": "order"},
            size_classes=stats["rescore_classes"],
            blocks=stats["rescore_blocks"], smem=stats["rescore_smem"],
            blocks_per_sm=stats["rescore_blocks_per_sm"]))
    for e in entries:
        e.update(route="cuda", source=KERNEL_SOURCE,
                 replaces=RAW_LINES[e["kernel"]],
                 launches=launches[e["kernel"]], max_abs_err=0.0,
                 bound_ms=e["bytes"] / HBM_BYTES_PER_S * 1e3,
                 bound_by="bytes",
                 launches_per_batch=launches[e["kernel"]] / n_trains)
    return entries


def raw_rest_check(corpus, smi, data_root):
    """A default one-shard index of RAW_REST_DOCS documents by _bulk over
    HTTP, force-merged to one segment (a raw pack: d_pad past 2**16),
    then a match and an `and` _search: both answered 200 with hits, the
    pack raw; its breaker charge drained by DELETE."""
    import shutil

    import torch

    from elasticsearch_tpu_torch.node import Node, serve
    from elasticsearch_tpu_torch.parallel.mesh import make_mesh

    data = os.path.join(data_root, "chip_smoke_raw_rest")
    shutil.rmtree(data, ignore_errors=True)
    node = Node(data, mesh=make_mesh(devices=[torch.device("cuda", 0)]))
    server = serve(node, "127.0.0.1", 0)
    host, port = server.server_address
    out = {"docs": RAW_REST_DOCS}
    try:
        status, resp = rest_http(host, port, "PUT", f"/{RAW_REST_INDEX}", {
            "mappings": {"properties": {FIELD: {"type": "text"}}}})
        if status != 200:
            raise AssertionError(f"PUT index: {resp}")
        out["ingest_s"] = rest_bulk_load(host, port, corpus, RAW_REST_DOCS,
                                         index=RAW_REST_INDEX)
        for method, path in (("POST", f"/{RAW_REST_INDEX}/_forcemerge"),
                             ("POST", f"/{RAW_REST_INDEX}/_refresh")):
            status, resp = rest_http(host, port, method, path)
            if status != 200:
                raise AssertionError(f"{path}: {resp}")
        text = corpus.query_text(0)
        answers = []
        for spec in ({"query": text}, {"query": text, "operator": "and"}):
            status, resp = rest_http(
                host, port, "POST", f"/{RAW_REST_INDEX}/_search",
                {"query": {"match": {FIELD: spec}}, "size": 10})
            if status != 200:
                raise AssertionError(f"_search {status}: {str(resp)[:500]}")
            answers.append({"status": status,
                            "total": resp["hits"]["total"],
                            "hits": len(resp["hits"]["hits"])})
        (resident,) = node.gpu_search.packs.residents()
        if resident.streams is not None or resident.pack.d_pad < 1 << 16:
            raise AssertionError("the 70,000-doc shard did not take a raw "
                                 "pack")
        hbm = node.breakers.get_breaker("hbm")
        if hbm.used != resident.nbytes_device():
            raise AssertionError("raw REST pack charge != resident bytes")
        out.update(searches=answers, d_pad=resident.pack.d_pad,
                   segments=len(resident.pack.shard_doc_ids),
                   resident_bytes=resident.nbytes_device(),
                   tiers=dict(node.gpu_search.tier_queries))
        del resident
        status, resp = rest_http(host, port, "DELETE", f"/{RAW_REST_INDEX}")
        if status != 200 or hbm.used != 0:
            raise AssertionError(f"DELETE: {status}, hbm {hbm.used}")
    finally:
        server.shutdown()
        node.close()
        shutil.rmtree(data, ignore_errors=True)
    return out


def raw_phase(corpus, bodies, mk, smi, extra_sets, data_root):
    """The raw deployment: the corpus over RAW_SHARDS shards (a segment
    of ~500,000 docs each: d_pad past 2**16, so the pack is raw: int32
    docs and f32 impacts, doc-sorted and impact-sorted), resident through
    the service with an hbm breaker; the e2e bodies from 128 clients
    (counts reset just before, read just after: every raw kernel must
    launch), then the stop-word bodies at from + size 10,000, the exact
    phase's boost-1e-15 bodies and probes of the prefix tier (queries
    the raw merge's slot limit refuses counted, not raised); every
    recorded raw-path call against its plain version bit for bit, the
    sampled hits against the oracle, the breaker charge against the
    resident bytes and its drain to 0 (memory_allocated() back) after
    delete_index; the fixed train's kernels timed; and the REST check of
    a 70,000-document one-shard index → (log fields, kernels entries)."""
    import gc

    import torch

    from elasticsearch_tpu_torch.common.breaker import CircuitBreaker
    from elasticsearch_tpu_torch.parallel import distributed as dist
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.gpu_service import (
        GpuSearchService, TIERS, lower_query)

    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    breaker = CircuitBreaker("hbm", 64 << 30)
    svc = GpuSearchService(device="cuda:0", max_batch=128, breaker=breaker)
    out = {"nvidia_smi": smi, "docs": N_DOCS, "shards": RAW_SHARDS}
    try:
        t0 = time.perf_counter()
        segments = build_index(svc, RAW_INDEX, corpus, N_DOCS, RAW_SHARDS)
        t1 = time.perf_counter()
        resident = svc.resident(RAW_INDEX, FIELD)
        torch.cuda.synchronize()
        pack = resident.pack
        if resident.streams is not None or pack.d_pad < 1 << 16:
            raise AssertionError("the raw deployment did not take a raw "
                                 "pack")
        charge = dist.raw_image_nbytes(pack, *resident.imp_host)
        if not breaker.used == resident.nbytes_device() == charge:
            raise AssertionError(f"hbm {breaker.used} != resident "
                                 f"{resident.nbytes_device()} / {charge}")
        postings = int(sum(int(rs[-1]) for rs in pack.row_starts))
        out.update(segments_s=t1 - t0, pack_s=time.perf_counter() - t1,
                   shard_docs=[s.num_docs for s in segments],
                   d_pad=pack.d_pad, p_pad=pack.p_pad, postings=postings,
                   resident_bytes=resident.nbytes_device(),
                   hbm_charged=breaker.used,
                   bytes_per_posting=resident.nbytes_device() / postings)
        del resident, pack
        head_k = [b for label, _, bs in extra_sets if label == "k10000"
                  for b in bs]
        run_extra = head_k + exact_bodies(bodies[:128])
        probes = raw_probe_bodies(corpus.vocab)
        with RawRecorder(mk) as rec, TopkRecorder(mk) as top:
            drive(svc, RAW_INDEX, bodies[:64])   # warm-up
            n_warm = len(rec.calls)
            mk.reset_launches()
            svc.tier_queries.clear()
            svc.variant_launches.clear()
            svc.batcher.batch_sizes.clear()
            svc.stages.reset()
            svc.gte_results = 0
            refused = []
            t2 = time.perf_counter()
            responses = drive(svc, RAW_INDEX, bodies, refused)
            run_s = time.perf_counter() - t2
            launches = dict(mk.LAUNCHES)
            n_run = len(rec.calls)
            tiers = dict(svc.tier_queries)
            gte = svc.gte_results
            stages = svc.stages.snapshot()
            trains = dict(sorted(svc.batcher.batch_sizes.items()))
            svc.tier_queries.clear()
            svc.gte_results = 0
            mk.reset_launches()
            extra = drive(svc, RAW_INDEX, run_extra, refused)
            extra_launches = {n: mk.LAUNCHES[n] for n in RAW_KERNELS}
            n_extra = len(rec.calls)
            extra_tiers = dict(svc.tier_queries)
            extra_gte = svc.gte_results
            svc.tier_queries.clear()
            svc.gte_results = 0
            probed = drive(svc, RAW_INDEX, probes, refused)
            probe_tiers = dict(svc.tier_queries)
            probe_gte = svc.gte_results
        # phase B's kernel timed on its widest scoring call (the prefix
        # tier's), phase A's on the probes' widest group of each prefix
        # tier, before the checks consume the recorded calls
        scoring = [c for c in rec.calls if c[0] == "pruned_rescore"]
        rescore_call = (max(scoring, key=lambda c: c[1][2].numel())
                        if scoring else None)
        tier_calls = {}
        for tier in ("prefix-16k", "escalated-64k"):
            own = [c for c, t in zip(rec.calls, rec.tiers)
                   if c[0] == "pruned_candidates" and t == tier]
            if own:
                tier_calls[tier] = max(own, key=lambda c: int(
                    c[1][3].clamp(min=0, max=c[2]["max_len"]).sum()))
        del scoring, own
        windows = {"run": rec.calls[n_warm:n_run],
                   "extra": rec.calls[n_run:n_extra],
                   "probes": rec.calls[n_extra:]}
        cand_classes = {w: candidate_classes(mk, c)
                        for w, c in windows.items()}
        del windows
        cand_all = {c: sum(v[c] for v in cand_classes.values())
                    for c in mk.CAND_CLASSES}
        cand_not_taken = {c: CAND_CLASS_ABSENT[c] for c, n in
                          cand_all.items() if n == 0}
        zero = [n for n in RAW_KERNELS if launches[n] <= 0]
        if zero:
            raise AssertionError(f"raw kernels not launched on the raw "
                                 f"path: {zero}")
        if any(r is None for r in responses + probed):
            raise AssertionError("the raw slot limit refused e2e or probe "
                                 "bodies, which the checks below need")
        for body, resp in zip(head_k, extra):
            if resp is None:
                continue
            hits = resp["hits"]
            if len(hits["hits"]) != min(body["size"],
                                        hits["total"]["value"]):
                raise AssertionError(f"k10000: {len(hits['hits'])} hits "
                                     f"of {hits['total']}")
        sample = oracle_check(responses, bodies, corpus, segments)
        n_calls = len(rec.calls)
        checked = check_raw_calls(mk, rec.calls)
        topk_checked = check_topk_calls(mk, top.calls)
        all_tiers = {t: tiers.get(t, 0) + extra_tiers.get(t, 0)
                     + probe_tiers.get(t, 0) for t in TIERS}
        routes = {"run": (tiers, gte), "probes": (probe_tiers, probe_gte)}
        moved = {w: r for w, r in routes.items()
                 if r != (RAW_TIERS[w], RAW_GTE[w])}
        if (moved or sum(extra_tiers.values()) != RAW_EXTRA[0]
                or not set(extra_tiers) <= set(RAW_EXTRA[1]) or extra_gte):
            raise AssertionError(f"the raw traffic's routes moved: {moved}, "
                                 f"extra {extra_tiers} gte {extra_gte}; "
                                 f"expected {RAW_TIERS}, gte {RAW_GTE}, "
                                 f"extra {RAW_EXTRA}")
        out.update(
            queries=len(responses), seconds=run_s,
            qps=len(responses) / run_s, trains=trains,
            launches={n: launches[n] for n in RAW_KERNELS + ("shard_topk",)},
            tiers=tiers, gte=gte,
            stage_means_ms={s: v["mean_ms"] for s, v in stages.items()},
            extra_bodies=len(run_extra), extra_tiers=extra_tiers,
            extra_gte=extra_gte, extra_launches=extra_launches,
            probes=[{"query": b["query"]["match"][FIELD], "size": b["size"],
                     "total": r["hits"]["total"]}
                    for b, r in zip(probes, probed)],
            probe_tiers=probe_tiers, probe_gte=probe_gte,
            refused_slot_limit=len(refused),
            tiers_taken=all_tiers,
            tiers_not_taken=[t for t, n in all_tiers.items() if n == 0],
            tiers_expected=RAW_TIERS, gte_expected=RAW_GTE,
            extra_expected=RAW_EXTRA,
            cand_classes=cand_classes, cand_classes_not_taken=cand_not_taken,
            checked_calls=checked, recorded_calls=n_calls,
            shard_topk=topk_checked, oracle_checked=len(sample),
            oracle_tolerance="top-10 ids, scores rel=1e-5 abs=1e-6",
            tolerance="bitwise: scores as uint32, gids and totals exact")
        del responses, extra, probed
        out["wide"], wide_entries = wide_raw(svc, mk, corpus, segments)
        log("service", part="raw", **out["wide"])
        # the fixed train: the first 128 bodies as one train of k 1000
        mapper = svc._index(RAW_INDEX).mapper
        flats = [lower_query(dsl.parse_query(b["query"]), mapper)
                 for b in bodies[:128]]
        with RawRecorder(mk) as fixed:
            svc._execute(svc.resident(RAW_INDEX, FIELD), flats, K)
        kernels = raw_kernel_entries(mk, fixed.calls, launches,
                                     sum(trains.values()), rescore_call,
                                     tier_calls) + wide_entries
        fixed.calls.clear()
        del rescore_call, tier_calls
        svc.delete_index(RAW_INDEX)
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        if breaker.used != 0 or mem_after != mem_before:
            raise AssertionError(f"after delete: hbm {breaker.used}, "
                                 f"memory {mem_after} vs {mem_before}")
        out.update(hbm_after_delete=breaker.used,
                   memory_allocated_before=mem_before,
                   memory_allocated_after=mem_after)
    finally:
        svc.close()
    out["rest"] = raw_rest_check(corpus, smi, data_root)
    return out, kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from elasticsearch_tpu_torch.benchmark import corpus as corpus_mod
        from elasticsearch_tpu_torch.ops import _build
        from elasticsearch_tpu_torch.ops import merge_kernel as mk
        from elasticsearch_tpu_torch.search.gpu_service import \
            GpuSearchService
    except ImportError as exc:
        print(f"chip_smoke: the elasticsearch_tpu_torch package is not "
              f"beside this script ({exc})", file=sys.stderr)
        return 3

    import gc
    gc.callbacks.append(_gc_timer)
    smi = smi_line()
    log("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    corpus = corpus_mod.generate(N_DOCS, vocab_size=VOCAB,
                                 num_queries=N_QUERIES, seed=SEED)
    gen_s = time.perf_counter() - t1
    # a (1, 1) mesh of cuda:0 and the service's own window
    svc = GpuSearchService(device="cuda:0", max_batch=128)
    try:
        t2 = time.perf_counter()
        segments = build_index(svc, INDEX, corpus, N_DOCS, SHARDS)
        seg_s = time.perf_counter() - t2
        t3 = time.perf_counter()
        resident = svc.resident(INDEX, FIELD)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t3
        pack = resident.pack
        postings = int(sum(int(rs[-1]) for rs in pack.row_starts))
        from elasticsearch_tpu_torch.parallel import distributed as dist
        log("build", kernel_build_s=round(build_s, 3),
            corpus_s=round(gen_s, 3), segments_s=round(seg_s, 3),
            pack_s=round(pack_s, 3), docs=N_DOCS, shards=SHARDS,
            shard_docs=[s.num_docs for s in segments], d_pad=pack.d_pad,
            postings=postings, vocab=VOCAB, seed=SEED,
            delta_doc_stream=resident.streams.delta,
            delta_reason=dist.delta_pack_reason(pack),
            resident_bytes=resident.nbytes_device(),
            bytes_per_posting=resident.nbytes_device() / postings,
            bytes_per_doc=resident.nbytes_device() / N_DOCS,
            note=("synthetic MS MARCO-passage-shaped corpus, cut from "
                  "8.8M passages to 1M docs to fit the smoke's time limit"))
        bodies = make_bodies(corpus)

        # -- a warm-up pass of the main path, then the counted run; every
        # launch shape of both is recorded for kernel_parity, as are those
        # of single-term top-10 bodies (kernel k 128, where the block-max
        # skip drops lanes of long postings) and of a small u8-delta index
        delta_svc_docs = 3200
        with LaunchRecorder(mk) as rec:
            drive(svc, INDEX, bodies)
            drive(svc, INDEX, [
                {"query": {"term": {FIELD: corpus.vocab[1 + i]}},
                 "size": 10} for i in range(8)])
            build_index(svc, "delta", corpus, delta_svc_docs, SHARDS)
            if not svc.resident("delta", FIELD).streams.delta:
                raise AssertionError("the small index did not take the "
                                     "u8 delta doc stream")
            for wave in (bodies[:64], bodies[64:72]):
                drive(svc, "delta", wave)

            # -- e2e: the counted run ---------------------------------------
            mk.reset_launches()
            svc.variant_launches.clear()
            svc.launch_shapes.clear()
            svc.batcher.batch_sizes.clear()
            with TopkRecorder(mk) as e2e_topk:
                t4 = time.perf_counter()
                responses = drive(svc, INDEX, bodies)
                e2e_s = time.perf_counter() - t4
            launches = dict(mk.LAUNCHES)
            trains = dict(sorted(svc.batcher.batch_sizes.items()))
        zero = [n for n in MAIN_KERNELS if launches[n] <= 0]
        if zero:
            raise AssertionError(f"kernels not launched on the main path: "
                                 f"{zero}")
        n_trains = sum(trains.values())
        hits = sum(len(r["hits"]["hits"]) for r in responses)
        sample = oracle_check(responses, bodies, corpus, segments)
        log("e2e", queries=len(responses), hits=hits,
            seconds=round(e2e_s, 3), qps=round(len(responses) / e2e_s, 1),
            window_s=svc.batcher.window_s, trains=trains,
            launch_shapes={f"B{b}xT{t}xk{k}": n for (b, t, k), n
                           in sorted(svc.launch_shapes.items())},
            launches=launches,
            variant_launches=dict(svc.variant_launches),
            compressed_exact_launches=svc.variant_launches.get(
                "compressed_exact", 0),
            oracle_checked=len(sample),
            oracle_tolerance="top-10 ids, scores rel=1e-5 abs=1e-6")

        # -- launches past the main traffic: a match of the corpus's most
        # frequent terms (the Zipf head fills 4096-lane slots: T >= 16,
        # rows past the shared-memory sort and select) at k = 1000 and at
        # from + size = 10,000 (kernel k 16,384), and the first 128 bodies
        # at size 10 (kernel k 128): every shape the service gave them,
        # and each label's bodies as one train (timed in kernels_extra)
        from elasticsearch_tpu_torch.tools.kernel_ab import (extra_bodies,
                                                             fixed_train,
                                                             profiled)
        extra, extra_trains = [], []
        extra_sets = extra_bodies(corpus.vocab, FIELD, K, MAX_K,
                                  bodies[:128])
        for label, size, queries in extra_sets:
            with LaunchRecorder(mk) as special, \
                    TopkRecorder(mk) as extra_topk:
                answered = drive(svc, INDEX, queries)
            e2e_topk.calls += extra_topk.calls
            if label == "k10000":   # timed in kernels_extra
                big_topk = extra_topk.calls[-1][:2]
            for resp in answered:
                hits = resp["hits"]
                if len(hits["hits"]) != min(size, hits["total"]["value"]):
                    raise AssertionError(f"{label}: {len(hits['hits'])} "
                                         f"hits of {hits['total']}")
            extra += [(label, a, k) for a, k in special.shapes.values()]
            extra_trains.append((label, *fixed_train(
                svc, mk, LaunchRecorder, INDEX, FIELD, size, queries)))
        # the launch the kernels line times: the first 128 bodies as one
        # 128-query train (no batching window decides its operands, so two
        # runs time the same launch)
        with TopkRecorder(mk) as fixed_topk:
            fixed = fixed_train(svc, mk, LaunchRecorder, INDEX, FIELD, K,
                                bodies[:128])
        topk_in, topk_k = fixed_topk.calls[-1][:2]
        launches_checked = [("main", a, k) for a, k in rec.shapes.values()]
        launches_checked.append(("fixed", *fixed))
        checked, worst, classes = kernel_parity(
            mk, launches_checked + extra
            + [(f"{label} train", a, k) for label, a, k in extra_trains])
        topk_checked = check_topk_calls(mk, e2e_topk.calls)
        if not any("k16384" in key for key in topk_checked["shapes"]):
            raise AssertionError("no checked shard_topk at kernel k "
                                 "16,384 (its device class)")
        log("kernel_parity", shapes=checked, max_abs_err=worst,
            size_classes=classes, shard_topk=topk_checked,
            tolerance="bitwise: scores as uint32, docs and totals exact")

        # -- exact: the compressed_exact path at the same width ----------
        exact_log, exact_run, exact_responses, exact_launches, \
            exact_trains = exact_phase(svc, mk, corpus, bodies, segments,
                                       extra_sets[0][2])
        log("exact", **exact_log)

        # -- service: rows past 1,024 slots on the same pack --------------
        service = {}
        service["wide_rows"], wide_entries = wide_phase(
            svc, mk, corpus, segments, 1 if resident.streams.delta else 2)
        log("service", part="wide_rows", **service["wide_rows"])

        # -- mesh: the mesh step on one card, through the NCCL tail ------
        log("mesh", **mesh_phase(segments, bodies, mk, responses))

        # -- trace: a second run with stage timers and the profiler -------
        log("trace", **traced_run(svc, bodies, mk))

        # -- kernels: timings on the fixed train ----------------------------
        args, kw = fixed
        stats = {}
        mk.fused_merge_topk(*args, **dict(kw, stats=stats))
        for _ in range(3):
            mk.fused_merge_topk(*args, **kw)
        ms = time_events(
            lambda ev: mk.fused_merge_topk(*args, **dict(kw, events=ev)),
            TIMED)
        device_ms = profiled(lambda: mk.fused_merge_topk(*args, **kw),
                             TIMED)
        # the plain version is one pipeline: its time stands in each row
        plain_ms = time_cuda(
            lambda: mk.fused_merge_topk_plain(*args, **kw), 5)
        lib_input = library_sort_input(stats.pop("sort_input"))
        library = {"row_sort": time_cuda(
            lambda: [torch.sort(keys) for keys in lib_input], TIMED)}
        # slot_decode's yardstick: the k-th largest of the decoded lane
        # bounds, which is its kth output alone
        from elasticsearch_tpu_torch.ops import sparse
        _, imp = sparse._lane_decode(
            *args[:5], max_len=kw["max_len"], d_pad=kw["d_pad"],
            exact=False, doc_bases=kw.get("doc_bases"),
            dbs_starts=kw.get("dbs_starts"), dlo_starts=kw.get("dlo_starts"))
        library["slot_decode"] = time_cuda(
            lambda: torch.topk(imp, stats["kk"], dim=2), TIMED)
        del imp
        bounds = kernel_bounds(stats, 2 - stats["delta"])
        kernels = []
        for name in ("slot_decode", "row_pack", "row_sort", "run_sum",
                     "select_rescore"):
            kernels.append({
                "name": f"merge_topk.{name}", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": PALLAS_LINE,
                "launches": launches[name], "max_abs_err": worst,
                "ms": ms[name], "device_ms": device_ms.get(name),
                "plain_ms": plain_ms,
                "plain_of": "fused_merge_topk_plain, all five stages",
                "bound_ms": bounds[name] / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": library.get(name),
                "library_of": LIBRARY_OF[name],
                "launches_per_batch": launches[name] / n_trains,
                "shape": {"rows": args[2].shape[0],
                          "slots": args[2].shape[1],
                          "max_len": kw["max_len"], "k": kw["k"]},
                "bytes": bounds[name],
                "size_classes": {
                    c: n for c, n in stats["classes"].items()
                    if c.split(".")[0] in CLASSES_OF.get(name, ())}})
            if name == "slot_decode":
                kernels[-1]["select_slots"] = stats["select_slots"]
        kernels += newer_kernel_entries(
            mk, svc, [("merge_topk.shard_topk", (topk_in, topk_k)),
                      ("merge_topk.shard_topk.k16384", big_topk)],
            exact_run[:128], launches, n_trains, exact_launches,
            exact_trains, 2 - stats["delta"])
        del topk_in
        # the kernels at the launches past the main traffic, each one train
        log("kernels_extra", launches=[dict(
            launch=label, rows=a[2].shape[0], slots=a[2].shape[1],
            k=kw["k"], select_slots=int((a[3] >= min(
                kw["k"], a[3].shape[1] * kw["max_len"])).sum()),
            ms=time_events(
                lambda ev: mk.fused_merge_topk(*a, **dict(kw, events=ev)),
                5),
            device_ms=profiled(lambda: mk.fused_merge_topk(*a, **kw), 5))
            for label, a, kw in extra_trains], shard_topk=dict(
            launch="k10000 gather (the device class)",
            rows=big_topk[0].shape[0], width=big_topk[0].shape[1],
            k=big_topk[1], in_kernels_line="merge_topk.shard_topk.k16384"))
        del big_topk
        # -- rest: the node over HTTP, the path users call -------------
        rest, rest_launches, planner, planner_kernels, delta, \
            delta_kernels, delta_launches, fields, \
            fields_launches, rest_api, rest_api_launches, \
            features_launches = rest_phase(
                corpus, bodies, mk, smi, responses,
                os.path.join(here, "data"), exact_run, exact_responses)
        log("rest", **{k: v for k, v in rest.items() if k != "service"})
        log("planner", **planner)
        log("fields", **fields)
        log("rest_api", **rest_api)
        log("delta", **delta)
        kernels += planner_kernels
        # -- raw: segments past 65,408 docs, a raw pack, the pruned tiers
        raw, raw_kernels = raw_phase(corpus, bodies, mk, smi, extra_sets,
                                     os.path.join(here, "data"))
        service["rest"] = rest.pop("service")
        service["raw"] = raw.pop("wide")
        log("raw", **raw)
        seconds = {part: v["seconds"] for part, v in service.items()}
        log("service", part="summary", seconds=seconds,
            total_s=sum(seconds.values()), budget_s=SERVICE_BUDGET_S)
        for entry in kernels:
            entry["launches_rest"] = rest_launches[
                entry.get("kernel", entry["name"].split(".", 1)[1])]
        kernels += raw_kernels + delta_kernels
        for entry in kernels:
            name = entry.get("kernel", entry["name"].split(".", 1)[1])
            entry["launches_fields"] = fields_launches.get(name, 0)
            entry["launches_rest_api"] = rest_api_launches.get(name, 0)
            entry["launches_search_features"] = features_launches.get(
                name, 0)
            entry["launches_delta"] = delta_launches.get(
                "pruned_candidates.pack_keys"
                if entry["name"].endswith(".pack_keys") else name, 0)
        kernels += wide_entries
        print(json.dumps({"kernels": kernels}), flush=True)
    finally:
        svc.close()

    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
