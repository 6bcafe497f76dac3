"""Query planner: a parsed query evaluated densely over one segment.

Copy of the reference's ``search/planner.py`` (``SegmentQueryExecutor``)
in torch, on an explicit device: every node of the query tree evaluates
over the segment's padded doc axis,

  node → (match_mask bool[d_pad], score f32[d_pad])

with `score` zero outside `match_mask`, and parents combine children by
mask algebra and score addition in the reference's order (bool clauses
in clause order, function_score's functions left to right). Scoring
leaves run ``ops/bm25.score_and_mask`` in passes of at most 32 term
slots; a pass copies to the device only the postings rows it reads
(starts rebased), and a doc-value column or a field's norms once an
executor, which lives for one segment of one request. Phrase
verification is host-side over the candidate docs, as in the reference.

Also here: ``choose_kernel_variant``, the kernel path's variant choice.

Query types of field types the port does not map yet: geo and nested
queries match nothing (no such column or store can exist), as the
reference computes for them; ``percolate`` raises its
QueryShardException; ``script_score`` (the query, or a function of
``function_score``), ``knn_score_doc`` and ``rank_feature`` over a
numeric column raise NotLowerable, naming the queue item they wait for.
"""

from __future__ import annotations

import fnmatch
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (NotLowerable,
                                                   QueryShardException)
from elasticsearch_tpu_torch.index.reader import SegmentView, ShardReader
from elasticsearch_tpu_torch.index.segment import MISSING_I64
from elasticsearch_tpu_torch.mapping.types import (FieldType,
                                                   KeywordFieldType,
                                                   TextFieldType)
from elasticsearch_tpu_torch.ops import bm25, sparse
from elasticsearch_tpu_torch.ops.xla_math import xla_log10f, xla_logf
from elasticsearch_tpu_torch.ops.smallfloat import (LENGTH_TABLE,
                                                    bm25_norm_cache)
from elasticsearch_tpu_torch.parallel.device import resolve_device
from elasticsearch_tpu_torch.search import dsl

MAX_SLOTS_PER_PASS = 32

Pair = Tuple[torch.Tensor, torch.Tensor]


def choose_kernel_variant(d_pad: int,
                          weights: Optional[np.ndarray] = None,
                          enabled: bool = True,
                          compressed: bool = False) -> str:
    """Variant for one lowered (pack, batch), the reference's rule.
    A compressed pack: "compressed" (quantized sort keys + block-max
    pruning, the Hopper merge kernel on a card) when sparse.packable()
    holds for the doc axis and the slot weights, else "compressed_exact",
    exact for any weights. A raw pack: "packed" (the single-key sort and
    exact rescore; on a card the raw merge, bit-identical to "ref") when
    `enabled` (the packed_sort setting) and packable() holds, else "ref"
    — the variant for d_pad ≥ 2**16. (The reference's "pallas" spelling
    of "compressed" is the same kernel in the port; sorted_merge_topk
    still accepts it.)"""
    if compressed:
        if sparse.packable(d_pad, weights):
            return "compressed"
        return "compressed_exact"
    if enabled and sparse.packable(d_pad, weights):
        return "packed"
    return "ref"


def _edit_distance_lte(a: str, b: str, k: int) -> bool:
    """Damerau-Levenshtein (adjacent transposition = 1) ≤ k, banded with
    early exit."""
    if k == 0:
        return a == b
    if abs(len(a) - len(b)) > k:
        return False
    prev2: Optional[List[int]] = None
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        row_min = i
        for j in range(1, len(b) + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            d = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (prev2 is not None and i > 1 and j > 1
                    and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]):
                d = min(d, prev2[j - 2] + 1)
            cur[j] = d
            row_min = min(row_min, d)
        if row_min > k:
            return False
        prev2, prev = prev, cur
    return prev[len(b)] <= k


def _bucket(n: int, minimum: int = 1) -> int:
    """Round up to a power of two."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _analyzed_terms(ft, text) -> list:
    """`text` through the field's search analyzer, memoized on the
    FieldType (a mapping update swaps the FieldType and so drops the
    memo). Returns a fresh list."""
    text = str(text)
    memo = getattr(ft, "_terms_memo", None)
    if memo is None:
        memo = {}
        try:
            ft._terms_memo = memo
        except AttributeError:
            return ft.search_terms(text)
    hit = memo.get(text)
    if hit is None:
        hit = ft.search_terms(text)
        if len(memo) < 4096:
            memo[text] = hit
    return list(hit)


class _UnmappedField(Exception):
    def __init__(self, field: str):
        self.field = field


class SegmentQueryExecutor:
    """Evaluates one parsed query against one segment view on `device`
    (default: cuda:0; "cpu" for the plain path)."""

    _MAX_EXPANSIONS = 1024  # the reference's max_clause_count

    def __init__(self, reader: ShardReader, view_idx: int, device=None):
        self.reader = reader
        self.view_idx = view_idx
        self.view: SegmentView = reader.views[view_idx]
        self.pack = self.view.pack
        self.d_pad = self.pack.d_pad
        self.device = resolve_device(device)
        self._cols: Dict[Tuple[str, str], torch.Tensor] = {}

    # -------------- public --------------

    def execute(self, node: dsl.QueryNode) -> Pair:
        """→ (mask bool[d_pad], score f32[d_pad]); score zero off-mask."""
        return self._eval(node, scoring=True)

    # -------------- device operands --------------

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    def _column(self, kind: str, field: str, host) -> torch.Tensor:
        """A per-(kind, field) operand copied to the device once."""
        key = (kind, field)
        t = self._cols.get(key)
        if t is None:
            t = self._cols[key] = self._dev(host())
        return t

    def _const(self, mask: torch.Tensor, value: float) -> torch.Tensor:
        """f32 `value` where `mask`, 0 elsewhere."""
        return torch.where(mask, torch.tensor(value, dtype=torch.float32,
                                              device=self.device),
                           torch.zeros((), dtype=torch.float32,
                                       device=self.device))

    def _ones(self) -> torch.Tensor:
        return torch.ones(self.d_pad, dtype=torch.bool, device=self.device)

    def _none(self) -> Pair:
        return (torch.zeros(self.d_pad, dtype=torch.bool, device=self.device),
                torch.zeros(self.d_pad, dtype=torch.float32,
                            device=self.device))

    # -------------- recursive eval --------------

    def _eval(self, node: dsl.QueryNode, scoring: bool) -> Pair:
        if isinstance(node, dsl.MatchAllQuery):
            return self._ones(), torch.full(
                (self.d_pad,), node.boost if scoring else 0.0,
                dtype=torch.float32, device=self.device)
        if isinstance(node, dsl.MatchQuery):
            return self._eval_match(node, scoring)
        if isinstance(node, dsl.TermQuery):
            return self._eval_terms(node.field, [node.value], node.boost,
                                    scoring, "or", 1)
        if isinstance(node, dsl.TermsQuery):
            return self._eval_terms(node.field, node.values, node.boost,
                                    scoring, "or", 1)
        if isinstance(node, dsl.RangeQuery):
            return self._eval_range(node)
        if isinstance(node, dsl.ExistsQuery):
            mask = self._dev(self.reader.has_field_mask(self.view_idx,
                                                        node.field))
            return mask, self._const(mask, node.boost if scoring else 0.0)
        if isinstance(node, dsl.IdsQuery):
            mask = self._dev(self.reader.resolve_ids(self.view_idx,
                                                     node.values))
            return mask, self._const(mask, node.boost if scoring else 0.0)
        if isinstance(node, dsl.MatchPhraseQuery):
            return self._eval_phrase(node, scoring)
        if isinstance(node, dsl.ConstantScoreQuery):
            mask, _ = self._eval(node.filter_query, scoring=False)
            return mask, self._const(mask, node.boost if scoring else 0.0)
        if isinstance(node, dsl.BoolQuery):
            return self._eval_bool(node, scoring)
        if isinstance(node, dsl.MultiMatchQuery):
            return self._eval_multi_match(node, scoring)
        if isinstance(node, dsl.PrefixQuery):
            return self._eval_expanded_terms(
                node.field, self._expand_prefix(node.field, node.value),
                node.boost, scoring, constant=True)
        if isinstance(node, dsl.WildcardQuery):
            return self._eval_expanded_terms(
                node.field, self._expand_wildcard(node), node.boost,
                scoring, constant=True)
        if isinstance(node, dsl.FuzzyQuery):
            return self._eval_expanded_terms(
                node.field, self._expand_fuzzy(node), node.boost,
                scoring, constant=False)
        if isinstance(node, dsl.FunctionScoreQuery):
            return self._eval_function_score(node, scoring)
        if isinstance(node, dsl.ScriptScoreQuery):
            raise NotLowerable("a [script_score] query needs the script "
                               "module (Queue A5c)")
        if isinstance(node, dsl.KnnScoreDocQuery):
            raise NotLowerable("a [knn] search (Queue A7)")
        if isinstance(node, dsl.RankFeatureQuery):
            return self._eval_rank_feature(node)
        if isinstance(node, (dsl.GeoDistanceQuery, dsl.GeoBoundingBoxQuery,
                             dsl.NestedQuery)):
            # no geo_point column and no nested store exist in the port's
            # segments: the reference's evaluators match nothing there
            return self._none()
        if isinstance(node, dsl.PercolateQuery):
            raise QueryShardException(
                f"[percolate] field [{node.field}] is not a "
                f"[percolator] field")
        raise QueryShardException(f"unsupported query [{node.query_name()}]")

    def _eval_multi_match(self, node: dsl.MultiMatchQuery,
                          scoring: bool) -> Pair:
        """best_fields: the best field's score (+ tie_breaker × the
        rest); most_fields: the sum. The mask is the OR of the fields'."""
        per_field = []
        for field, fboost in node.fields:
            sub = dsl.MatchQuery(
                field=field, query=node.query, operator=node.operator,
                minimum_should_match=node.minimum_should_match,
                boost=fboost)
            per_field.append(self._eval_match(sub, scoring))
        if not per_field:
            return self._none()
        mask = per_field[0][0]
        for m, _ in per_field[1:]:
            mask = mask | m
        total = per_field[0][1]
        for _, s in per_field[1:]:
            total = total + s
        if node.type == "most_fields":
            score = total
        else:  # best_fields
            best = per_field[0][1]
            for _, s in per_field[1:]:
                best = torch.maximum(best, s)
            score = best + node.tie_breaker * (total - best)
        score = torch.where(mask, score * node.boost,
                            torch.zeros_like(score))
        return mask, score

    # ---- multi-term expansion ----

    def _field_vocab(self, field: str):
        fp = self.pack.fields.get(field)
        return fp.vocab if fp is not None else {}

    def _expand_prefix(self, field: str, prefix: str) -> List[str]:
        terms = [t for t in self._field_vocab(field)
                 if t.startswith(prefix)]
        self._check_expansion(terms, "prefix")
        return terms

    def _expand_wildcard(self, node: dsl.WildcardQuery) -> List[str]:
        pattern = node.value.lower() if node.case_insensitive \
            else node.value
        # fnmatchcase: only * and ? are wildcards; [] matches literally
        pattern = pattern.replace("[", "[[]")
        out = []
        for t in self._field_vocab(node.field):
            probe = t.lower() if node.case_insensitive else t
            if fnmatch.fnmatchcase(probe, pattern):
                out.append(t)
        self._check_expansion(out, "wildcard")
        return out

    def _expand_fuzzy(self, node: dsl.FuzzyQuery) -> List[str]:
        value = node.value
        if node.fuzziness == "AUTO" or isinstance(node.fuzziness, str):
            n = len(value)
            max_d = 0 if n < 3 else (1 if n < 6 else 2)
        else:
            max_d = int(node.fuzziness)
        pl = node.prefix_length
        prefix = value[:pl]
        out = []
        for t in self._field_vocab(node.field):
            if abs(len(t) - len(value)) > max_d:
                continue
            if pl and not t.startswith(prefix):
                continue
            if _edit_distance_lte(value, t, max_d):
                out.append(t)
            if len(out) >= node.max_expansions:
                break
        return out

    def _check_expansion(self, terms: List[str], kind: str) -> None:
        if len(terms) > self._MAX_EXPANSIONS:
            raise QueryShardException(
                f"[{kind}] query expands to {len(terms)} terms, more "
                f"than the {self._MAX_EXPANSIONS} clause limit")

    def _eval_expanded_terms(self, field: str, terms: List[str],
                             boost: float, scoring: bool, *,
                             constant: bool) -> Pair:
        """OR over an expanded term set: constant=True scores `boost`
        (prefix, wildcard), else BM25 as a terms disjunction (fuzzy)."""
        if not terms:
            return self._none()
        mask, score = self._eval_terms(field, terms, boost,
                                       scoring and not constant, "or", 1,
                                       pre_analyzed=True)
        if constant and scoring:
            score = self._const(mask, boost)
        return mask, score

    # ---- function_score ----

    def _eval_function_score(self, node: dsl.FunctionScoreQuery,
                             scoring: bool) -> Pair:
        if any(fn.script_score is not None for fn in node.functions):
            raise NotLowerable("a [function_score] with [script_score] "
                               "needs the script module (Queue A5c)")
        mask, score = self._eval(node.query, scoring)
        if not scoring:
            return mask, score
        zero = torch.zeros_like(score)
        if not node.functions:
            return mask, torch.where(mask, score * node.boost, zero)
        factors = []
        applies = []
        for fn in node.functions:
            factor = torch.ones(self.d_pad, dtype=torch.float32,
                                device=self.device)
            if fn.field_value_factor is not None:
                factor = factor * self._field_value_factor(
                    fn.field_value_factor)
            if fn.weight is not None:
                factor = factor * fn.weight
            if fn.filter_query is not None:
                fmask, _ = self._eval(fn.filter_query, scoring=False)
            else:
                fmask = self._ones()
            factors.append(factor)
            applies.append(fmask)
        n_applied = applies[0].to(torch.int32)
        for a in applies[1:]:
            n_applied = n_applied + a.to(torch.int32)
        # only the functions whose filter matches combine, left to right;
        # a doc matching none scores a neutral 1
        mode = node.score_mode
        if mode in ("multiply", "sum", "avg"):
            neutral = 1.0 if mode == "multiply" else 0.0
            combined = None
            for f, a in zip(factors, applies):
                term = torch.where(a, f, torch.full_like(f, neutral))
                if combined is None:
                    combined = term
                elif mode == "multiply":
                    combined = combined * term
                else:
                    combined = combined + term
            if mode == "avg":
                combined = combined / torch.clamp(n_applied, min=1)
        else:
            fill = float("-inf") if mode == "max" else float("inf")
            pick = torch.maximum if mode == "max" else torch.minimum
            combined = None
            for f, a in zip(factors, applies):
                term = torch.where(a, f, torch.full_like(f, fill))
                combined = term if combined is None else pick(combined,
                                                              term)
        combined = torch.where(n_applied > 0, combined,
                               torch.ones_like(combined))
        if node.max_boost is not None:
            combined = torch.minimum(combined, torch.tensor(
                node.max_boost, dtype=torch.float32, device=self.device))
        bm = node.boost_mode
        if bm == "multiply":
            final = score * combined
        elif bm == "sum":
            final = score + combined
        elif bm == "replace":
            final = combined
        elif bm == "avg":
            final = (score + combined) / 2.0
        elif bm == "max":
            final = torch.maximum(score, combined)
        else:  # min
            final = torch.minimum(score, combined)
        return mask, torch.where(mask, final * node.boost, zero)

    def _dv_column(self, field: str) -> Pair:
        """A numeric doc-value column → (values f32, present mask)."""
        pack = self.pack
        if field in pack.dv_f64:
            vals = self._column("f64", field,
                                lambda: pack.dv_f64[field]).to(torch.float32)
            return vals, ~torch.isnan(vals)
        if field in pack.dv_i64:
            raw = self._column("i64", field, lambda: pack.dv_i64[field])
            return raw.to(torch.float32), raw != MISSING_I64
        return (torch.zeros(self.d_pad, dtype=torch.float32,
                            device=self.device),
                torch.zeros(self.d_pad, dtype=torch.bool,
                            device=self.device))

    def _field_value_factor(self, fvf: dict) -> torch.Tensor:
        """Per-doc factor from a doc-value column (the reference's
        FieldValueFactorFunction; a missing value without [missing]
        counts 0)."""
        field = fvf["field"]
        factor = float(fvf.get("factor", 1.0))
        missing = fvf.get("missing")
        fill = 0.0 if missing is None else float(missing)
        vals, present = self._dv_column(field)
        vals = torch.where(present, vals, torch.full_like(vals, fill)) \
            * factor
        zero = torch.zeros_like(vals)
        mod = fvf.get("modifier", "none")
        # XLA:CPU's f32 log, op for op (torch.log is an ulp off on some
        # inputs)
        if mod == "log":
            vals = torch.where(vals > 0, xla_log10f(
                torch.clamp(vals, min=1e-9)), zero)
        elif mod == "log1p":
            vals = xla_log10f(torch.clamp(vals, min=0.0) + 1.0)
        elif mod == "log2p":
            vals = xla_log10f(torch.clamp(vals, min=0.0) + 2.0)
        elif mod == "ln":
            vals = torch.where(vals > 0, xla_logf(
                torch.clamp(vals, min=1e-9)), zero)
        elif mod == "ln1p":
            vals = xla_logf(torch.clamp(vals, min=0.0) + 1.0)
        elif mod == "ln2p":
            vals = xla_logf(torch.clamp(vals, min=0.0) + 2.0)
        elif mod == "square":
            vals = vals * vals
        elif mod == "sqrt":
            # correctly rounded: torch's f32 sqrt on the CPU is not (its
            # vector path is off by an ulp), f64 then one rounding is
            vals = torch.sqrt(torch.clamp(vals, min=0.0).to(torch.float64)
                              ).to(torch.float32)
        elif mod == "reciprocal":
            vals = torch.where(vals != 0, 1.0 / vals, zero)
        return vals.to(torch.float32)

    def _eval_rank_feature(self, node: dsl.RankFeatureQuery) -> Pair:
        """The reference scores a numeric column; without one (the
        field unmapped, or a text/keyword field) it matches nothing."""
        pack = self.pack
        if node.field in pack.dv_f64 or node.field in pack.dv_i64:
            raise NotLowerable("a [rank_feature] query over a numeric "
                               "column (Queue A5a-ii)")
        return self._none()

    # ---- bool ----

    def _eval_bool(self, node: dsl.BoolQuery, scoring: bool) -> Pair:
        mask = self._ones()
        score = torch.zeros(self.d_pad, dtype=torch.float32,
                            device=self.device)
        for child in node.must:
            cmask, cscore = self._eval(child, scoring)
            mask = mask & cmask
            score = score + cscore
        for child in node.filter:
            cmask, _ = self._eval(child, scoring=False)
            mask = mask & cmask
        for child in node.must_not:
            cmask, _ = self._eval(child, scoring=False)
            mask = mask & ~cmask
        if node.should:
            msm = node.minimum_should_match
            if msm is None:
                # 1 with nothing mandatory, else 0 (should only scores)
                msm = 0 if (node.must or node.filter) else 1
            count = torch.zeros(self.d_pad, dtype=torch.int32,
                                device=self.device)
            for child in node.should:
                cmask, cscore = self._eval(child, scoring)
                count = count + cmask.to(torch.int32)
                score = score + cscore
            if msm > 0:
                mask = mask & (count >= msm)
        score = torch.where(mask, score * node.boost,
                            torch.zeros_like(score))
        return mask, score

    # -------------- leaves --------------

    def _field_type(self, field: str) -> FieldType:
        ft = self.reader.mapper.field_type(field)
        if ft is None:
            # an unmapped field matches nothing
            raise _UnmappedField(field)
        return ft

    def _eval_match(self, node: dsl.MatchQuery, scoring: bool) -> Pair:
        try:
            ft = self._field_type(node.field)
        except _UnmappedField:
            return self._none()
        if isinstance(ft, TextFieldType):
            terms = _analyzed_terms(ft, node.query)
        else:
            # match on keyword/numeric behaves like a term query
            terms = [ft.normalize_term(node.query)]
        if not terms:
            return self._none()
        msm = 1 if node.operator == "or" else len(terms)
        if node.minimum_should_match is not None and node.operator == "or":
            msm = node.minimum_should_match
        return self._eval_terms(node.field, terms, node.boost, scoring,
                                node.operator, msm, pre_analyzed=True)

    def _eval_terms(self, field: str, values: Sequence, boost: float,
                    scoring: bool, operator: str, msm: int,
                    pre_analyzed: bool = False) -> Pair:
        try:
            ft = self._field_type(field)
        except _UnmappedField:
            return self._none()
        if pre_analyzed or isinstance(ft, TextFieldType):
            # term/terms queries are not analyzed, even on text fields
            terms = [str(v) for v in values]
        else:
            terms = [ft.normalize_term(v) for v in values]
        fp = self.pack.fields.get(field)
        if fp is None:
            return self._none()
        k1, b = self.reader.k1, self.reader.b
        doc_count, avgdl = self.reader.field_stats(field)
        cache = self._column("norm_cache", field,
                             lambda: bm25_norm_cache(k1, b, avgdl))
        norms = self._column("norms", field, lambda: fp.norms_u8)

        total_count = torch.zeros(self.d_pad, dtype=torch.int32,
                                  device=self.device)
        total_score = torch.zeros(self.d_pad, dtype=torch.float32,
                                  device=self.device)
        for chunk_start in range(0, len(terms), MAX_SLOTS_PER_PASS):
            chunk = terms[chunk_start: chunk_start + MAX_SLOTS_PER_PASS]
            t_pad = _bucket(len(chunk))
            starts = np.zeros((1, t_pad), dtype=np.int32)
            lengths = np.zeros((1, t_pad), dtype=np.int32)
            idf_boost = np.zeros((1, t_pad), dtype=np.float32)
            max_len = 1
            docs_parts, tfs_parts = [], []
            base = 0
            for t, term in enumerate(chunk):
                s, ln = fp.row_slice(fp.term_row(term))
                df = self.reader.doc_freq(field, term)
                # only the rows this pass reads go to the device, their
                # starts rebased: lanes past a row's length are masked,
                # so the rows' neighbours never mattered
                starts[0, t], lengths[0, t] = base, ln
                docs_parts.append(fp.flat_docs[s:s + ln])
                tfs_parts.append(fp.flat_tfs[s:s + ln])
                base += ln
                if scoring and df > 0:
                    idf = math.log(1.0 + (doc_count - df + 0.5) / (df + 0.5))
                    idf_boost[0, t] = boost * idf * (k1 + 1.0)
                max_len = max(max_len, ln)
            max_len = _bucket(max_len, 128)
            # one drop lane, so the flat arrays are never empty
            docs_parts.append(np.full(1, self.d_pad, dtype=np.int32))
            tfs_parts.append(np.zeros(1, dtype=np.int32))
            scores, termmask = bm25.score_and_mask(
                self._dev(np.concatenate(docs_parts)),
                self._dev(np.concatenate(tfs_parts)), norms, cache,
                self._dev(starts), self._dev(lengths),
                self._dev(idf_boost), max_len=max_len, d_pad=self.d_pad)
            tm = termmask[0, : self.d_pad]
            total_score = total_score + scores[0, : self.d_pad]
            # per-slot presence → the pass's match count
            bits = torch.tensor([bm25.slot_bit(t) for t in range(len(chunk))],
                                dtype=torch.int32, device=self.device)
            present = (tm[None, :] & bits[:, None]) != 0
            total_count = total_count + present.sum(dim=0,
                                                    dtype=torch.int32)
        if operator == "and":
            mask = total_count >= len(terms)
        else:
            mask = total_count >= max(1, msm)
        score = torch.where(mask, total_score, torch.zeros_like(total_score))
        return mask, score

    def _eval_range(self, node: dsl.RangeQuery) -> Pair:
        try:
            ft = self._field_type(node.field)
        except _UnmappedField:
            return self._none()
        if isinstance(ft, (TextFieldType, KeywordFieldType)):
            raise QueryShardException(
                f"range query on [{ft.type_name}] field [{node.field}] "
                f"is not supported")
        lo_raw = node.gte if node.gte is not None else node.gt
        hi_raw = node.lte if node.lte is not None else node.lt
        pack = self.pack
        if node.field in pack.dv_i64:
            col = self._column("i64", node.field,
                               lambda: pack.dv_i64[node.field])
            lo = -(2**62) if lo_raw is None \
                else int(ft.normalize_range_bound(lo_raw))
            hi = 2**62 if hi_raw is None \
                else int(ft.normalize_range_bound(hi_raw))
            if node.gt is not None and node.gte is None:
                lo += 1
            if node.lt is not None and node.lte is None:
                hi -= 1
            mask = bm25.range_mask_i64(
                col, torch.tensor([lo], dtype=torch.int64,
                                  device=self.device),
                torch.tensor([hi], dtype=torch.int64,
                             device=self.device))[0]
        elif node.field in pack.dv_f64:
            col = self._column("f64", node.field,
                               lambda: pack.dv_f64[node.field])
            lo = -np.inf if lo_raw is None \
                else float(ft.normalize_range_bound(lo_raw))
            hi = np.inf if hi_raw is None \
                else float(ft.normalize_range_bound(hi_raw))
            mask = bm25.range_mask_f64(
                col, torch.tensor([lo], dtype=torch.float64,
                                  device=self.device),
                torch.tensor([hi], dtype=torch.float64,
                             device=self.device))[0]
            if node.gt is not None and node.gte is None:
                mask = mask & (col != lo)
            if node.lt is not None and node.lte is None:
                mask = mask & (col != hi)
        else:
            return self._none()
        # ranges score a constant boost in a scoring context
        return mask, self._const(mask, node.boost)

    def _eval_phrase(self, node: dsl.MatchPhraseQuery,
                     scoring: bool) -> Pair:
        try:
            ft = self._field_type(node.field)
        except _UnmappedField:
            return self._none()
        if not isinstance(ft, TextFieldType):
            return self._eval_terms(node.field, [node.query], node.boost,
                                    scoring, "and", 1)
        terms = _analyzed_terms(ft, node.query)
        if not terms:
            return self._none()
        seg = self.view.segment
        # candidates: docs holding every term (host intersection of the
        # postings), then host-side position checks
        doc_sets = []
        for t in terms:
            entry = seg.postings.get(node.field, {}).get(t)
            if entry is None:
                return self._none()
            doc_sets.append(set(int(d) for d in entry[0]))
        candidates = sorted(set.intersection(*doc_sets))
        if not candidates:
            return self._none()
        k1, b = self.reader.k1, self.reader.b
        doc_count, avgdl = self.reader.field_stats(node.field)
        dfs = [self.reader.doc_freq(node.field, t) for t in terms]
        idf_sum = sum(math.log(1.0 + (doc_count - df + 0.5) / (df + 0.5))
                      for df in dfs if df > 0)
        mask = np.zeros(self.d_pad, dtype=bool)
        score = np.zeros(self.d_pad, dtype=np.float32)
        for d in candidates:
            plists = seg.doc_positions(node.field, terms, d)
            if any(p is None for p in plists):
                continue
            freq = _phrase_freq(plists, node.slop)
            if freq <= 0:
                continue
            mask[d] = True
            if scoring:
                dl = float(LENGTH_TABLE[seg.norms[node.field][d]])
                denom = freq + k1 * (1 - b + b * dl / (avgdl or 1.0))
                score[d] = node.boost * idf_sum * (k1 + 1.0) * freq / denom
        return self._dev(mask), self._dev(score)


def _phrase_freq(plists: List[np.ndarray], slop: int) -> int:
    """Exact phrase count (slop=0): positions p_i = p_0 + i. For slop > 0
    a window check (an approximation of the sloppy frequency)."""
    first = plists[0]
    count = 0
    for p0 in first:
        ok = True
        for i, pl in enumerate(plists[1:], start=1):
            target = p0 + i
            if slop == 0:
                if target not in pl:
                    ok = False
                    break
            else:
                if not ((np.abs(pl - target) <= slop).any()):
                    ok = False
                    break
        if ok:
            count += 1
    return count
