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

The rarer field types: ``rank_feature`` is column math on the f64 (or
i64) doc values, its log through ``ops/xla_math.xla_logf`` and its
sigmoid's power through ``xla_math.xla_powf`` (XLA:CPU's, op for op);
``geo_distance`` is ``ops/geo.distance_mask`` and ``geo_bounding_box``
comparisons on the lat/lon columns; an ip range or CIDR term compares
the (hi, lo) column pair lexicographically, with presence from the
exists mask; a range field matches by interval relation (intersects,
within, contains). ``nested`` and ``percolate`` run on the host object
by object and stored query by stored query, as in the reference, and
copy their masks to the device. ``script_score`` (the query, or a
function of ``function_score``) runs the script module's vector
interpreter over the segment's doc-value and ``dense_vector`` columns
on the device. ``knn_score_doc`` (a ``knn`` search's winners on this
segment) sums the clauses' boosted scores on the host in numpy float32,
as the reference does, and adds them to the base query's on the
device.
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
                                                   GeoPointFieldType,
                                                   IpFieldType,
                                                   KeywordFieldType,
                                                   PercolatorFieldType,
                                                   RangeFieldType,
                                                   RankFeatureFieldType,
                                                   TextFieldType)
from elasticsearch_tpu_torch.ops import bm25, geo, sparse
from elasticsearch_tpu_torch.ops.xla_math import (x86_nan, x86_nan_like,
                                                  xla_divf, xla_ftz,
                                                  xla_log10f, xla_logf,
                                                  xla_mulf, xla_powf)
from elasticsearch_tpu_torch.ops.smallfloat import (LENGTH_TABLE,
                                                    bm25_norm_cache)
from elasticsearch_tpu_torch.parallel.device import resolve_device
from elasticsearch_tpu_torch.script import FieldColumn, ScriptException
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
            ft = self.reader.mapper.field_type(node.field)
            if isinstance(ft, IpFieldType) and "/" in str(node.value):
                # a CIDR term is an address range
                lo, hi = IpFieldType.cidr_bounds(node.value)
                return self._eval_ip_range(node.field, lo, hi, node.boost)
            if isinstance(ft, RangeFieldType):
                v = ft.parse_bound(node.value)
                return self._eval_range_field(
                    dsl.RangeQuery(field=node.field, gte=v, lte=v,
                                   boost=node.boost), ft)
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
            return self._eval_script_score(node, scoring)
        if isinstance(node, dsl.KnnScoreDocQuery):
            return self._eval_knn_score_doc(node, scoring)
        if isinstance(node, dsl.RankFeatureQuery):
            return self._eval_rank_feature(node, scoring)
        if isinstance(node, dsl.GeoDistanceQuery):
            return self._eval_geo_distance(node)
        if isinstance(node, dsl.GeoBoundingBoxQuery):
            return self._eval_geo_bbox(node)
        if isinstance(node, dsl.NestedQuery):
            return self._eval_nested(node, scoring)
        if isinstance(node, dsl.PercolateQuery):
            return self._eval_percolate(node, scoring)
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
            if fn.script_score is not None:
                scripted = self._run_score_script(fn.script_score, score)
                factor = x86_nan(factor * scripted, factor, scripted)
            if fn.weight is not None:
                factor = x86_nan(factor * fn.weight, factor)
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
                    combined = x86_nan(combined * term, combined, term)
                else:
                    combined = x86_nan(combined + term, combined, term)
            if mode == "avg":
                combined = x86_nan(combined / torch.clamp(n_applied, min=1),
                                   combined)
        else:
            fill = float("-inf") if mode == "max" else float("inf")
            pick = torch.maximum if mode == "max" else torch.minimum
            combined = None
            for f, a in zip(factors, applies):
                term = torch.where(a, f, torch.full_like(f, fill))
                combined = term if combined is None else _nan_pick(
                    pick, combined, term)
        combined = torch.where(n_applied > 0, combined,
                               torch.ones_like(combined))
        if node.max_boost is not None:
            combined = _nan_pick(torch.minimum, combined, torch.full_like(
                combined, node.max_boost))
        # a script function's NaN keeps its x86 bits on every device
        bm = node.boost_mode
        if bm == "multiply":
            final = x86_nan(score * combined, score, combined)
        elif bm == "sum":
            final = x86_nan(score + combined, score, combined)
        elif bm == "replace":
            final = combined
        elif bm == "avg":
            final = x86_nan(x86_nan(score + combined, score, combined)
                            / 2.0, combined)
        elif bm == "max":
            final = _nan_pick(torch.maximum, score, combined)
        else:  # min
            final = _nan_pick(torch.minimum, score, combined)
        return mask, torch.where(mask, x86_nan(final * node.boost, final),
                                 zero)

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

    # ---- score scripts (the script module's vector interpreter) ----

    def _script_resolver(self, field: str) -> FieldColumn:
        """doc['field'] in a score script: the numeric doc-value column,
        missing values 0 beside the presence mask (lang-expression)."""
        vals, present = self._dv_column(field)
        return FieldColumn(torch.where(present, vals,
                                       torch.zeros_like(vals)), present)

    def _vec_column(self, field: str) -> torch.Tensor:
        """A dense_vector matrix f32[d_pad, dims] on the device (NaN rows
        missing); an unknown field is a 400."""
        mat = self.pack.dv_vec.get(field)
        if mat is None:
            raise ScriptException(f"[{field}] is not a dense_vector field")
        return self._column("vec", field, lambda: mat)

    def _run_score_script(self, script, base_score: torch.Tensor
                          ) -> torch.Tensor:
        try:
            return script.score_vector(self._script_resolver, base_score,
                                       vec_resolver=self._vec_column)
        except ScriptException:
            raise
        except Exception as e:  # noqa: BLE001 — surfaces as a 400
            raise ScriptException(f"runtime error in score script "
                                  f"[{script.source[:80]}]: {e}") from None

    def _eval_knn_score_doc(self, node: dsl.KnnScoreDocQuery,
                            scoring: bool) -> Pair:
        """The base query unioned with the pinned knn winners: a doc
        matches if the query matches or it is a winner; it scores
        query_score + Σ knn_score·boost (the reference's hybrid rule). A
        knn-only node scores 0 in filter context."""
        seg_name = self.view.segment.name
        knn_mask = np.zeros(self.d_pad, dtype=bool)
        knn_score = np.zeros(self.d_pad, dtype=np.float32)
        for doc_set, boost in zip(node.doc_sets, node.boosts):
            entry = doc_set.get(seg_name)
            if entry is None:
                continue
            ords, scores = entry
            knn_mask[ords] = True
            knn_score[ords] += scores * boost
        kmask = self._dev(knn_mask)
        kscore = self._dev(knn_score)
        if node.query is None:
            return kmask, (kscore if scoring else torch.zeros_like(kscore))
        bmask, bscore = self._eval(node.query, scoring)
        mask = bmask | kmask
        if not scoring:
            return mask, torch.zeros_like(kscore)
        return mask, xla_ftz(torch.where(bmask, bscore,
                                         torch.zeros_like(bscore)) + kscore)

    def _eval_script_score(self, node: dsl.ScriptScoreQuery,
                           scoring: bool) -> Pair:
        # min_score prunes matches, so it runs in filter context too (a
        # filter-placed script_score matches what a query-placed one
        # does)
        needs_script = scoring or node.min_score is not None
        mask, score = self._eval(node.query, scoring or needs_script)
        if not needs_script:
            return mask, score
        scripted = self._run_score_script(node.script, score)
        # negative script scores are refused (since 7.x): clamped to 0,
        # a NaN kept as it is
        zero = torch.zeros_like(scripted)
        scripted = torch.where(torch.isnan(scripted), scripted,
                               torch.maximum(scripted, zero))
        if node.min_score is not None:
            mask = mask & (scripted >= node.min_score)
        if not scoring:
            return mask, zero
        return mask, torch.where(
            mask, x86_nan(scripted * node.boost, scripted), zero)

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

    # ---- the rarer field types ----

    def _f32(self, value: float) -> torch.Tensor:
        return torch.tensor(value, dtype=torch.float32, device=self.device)

    def _eval_rank_feature(self, node: dsl.RankFeatureQuery,
                           scoring: bool) -> Pair:
        """Feature-value scoring on a numeric column (reference:
        RankFeatureQuery); docs without a value do not match. Every step
        in f32 as the reference's weakly typed scalars give it, each
        denormal result flushed as XLA:CPU flushes it."""
        vals, present = self._dv_column(node.field)
        mask = present
        if not scoring:
            return mask, torch.zeros(self.d_pad, dtype=torch.float32,
                                     device=self.device)
        zero = torch.zeros_like(vals)
        ft = self.reader.mapper.field_type(node.field)
        if isinstance(ft, RankFeatureFieldType) \
                and not ft.positive_score_impact:
            # negative impact: smaller values score higher
            vals = torch.where(present, xla_divf(
                torch.ones_like(vals),
                torch.maximum(vals, self._f32(1e-9))), zero)
        x = torch.where(present, vals, zero)
        # an arithmetic op reads a denormal x as zero; powf is handed
        # its bits
        xa = xla_ftz(x)
        if node.function == "linear":
            score = xa
        elif node.function == "log":
            score = xla_logf(torch.maximum(
                self._f32(node.scaling_factor) + xa, self._f32(1e-9)))
        elif node.function == "sigmoid":
            xp = xla_powf(x, node.exponent)
            score = xla_divf(xp, xla_ftz(xp + self._f32(
                _pow64(node.pivot, node.exponent))))
        else:  # saturation
            pivot = node.pivot
            if pivot is None:
                pivot = self._rank_feature_default_pivot(node.field)
            score = xla_divf(xa, xla_ftz(xa + self._f32(pivot)))
        score = xla_mulf(score, self._f32(node.boost))
        # a NaN here (a negative base's power, inf / inf) is the x86
        # default NaN in the reference; a card's arithmetic makes the
        # positive one, which top-k ranks at the other end
        score = torch.where(torch.isnan(score), x86_nan_like(score), score)
        return mask, torch.where(mask, score, zero)

    def _rank_feature_default_pivot(self, field: str) -> float:
        """The geometric mean of the shard's positive feature values, in
        host f64 over the views in order (the reference's rule)."""
        cache = getattr(self.reader, "_rf_pivot_cache", None)
        if cache is None:
            cache = {}
            self.reader._rf_pivot_cache = cache
        if field in cache:
            return cache[field]
        logs, count = 0.0, 0
        for v in self.reader.views:
            col = v.segment.doc_values.get(field)
            if col is None or col.kind != "f64":
                continue
            vals = col.values
            ok = ~np.isnan(vals) & (vals > 0)
            if ok.any():
                logs += float(np.log(vals[ok]).sum())
                count += int(ok.sum())
        pivot = float(np.exp(logs / count)) if count else 1.0
        cache[field] = pivot
        return pivot

    def _geo_columns(self, field: str):
        """(lat f64, lon f64) of a geo_point field on the device, or
        None when this segment has no such columns."""
        pack = self.pack
        lat_key = field + GeoPointFieldType.LAT_SUFFIX
        lon_key = field + GeoPointFieldType.LON_SUFFIX
        if lat_key not in pack.dv_f64 or lon_key not in pack.dv_f64:
            return None
        return (self._column("f64", lat_key, lambda: pack.dv_f64[lat_key]),
                self._column("f64", lon_key, lambda: pack.dv_f64[lon_key]))

    def _eval_geo_distance(self, node: dsl.GeoDistanceQuery) -> Pair:
        cols = self._geo_columns(node.field)
        if cols is None:
            return self._none()
        mask = geo.distance_mask(cols[0], cols[1], node.lat, node.lon,
                                 node.distance_m)
        return mask, self._const(mask, node.boost)

    def _eval_geo_bbox(self, node: dsl.GeoBoundingBoxQuery) -> Pair:
        cols = self._geo_columns(node.field)
        if cols is None:
            return self._none()
        lat, lon = cols
        lat_ok = (lat <= node.top) & (lat >= node.bottom)
        if node.left <= node.right:
            lon_ok = (lon >= node.left) & (lon <= node.right)
        else:
            # a box across the antimeridian
            lon_ok = (lon >= node.left) | (lon <= node.right)
        mask = ~torch.isnan(lat) & lat_ok & lon_ok
        return mask, self._const(mask, node.boost)

    def _eval_percolate(self, node: dsl.PercolateQuery,
                        scoring: bool) -> Pair:
        """Every live stored query of this segment against the
        percolated document(s) (``search/percolator.py``); a matching
        stored query scores `boost`."""
        from elasticsearch_tpu_torch.search import percolator as perc
        ft = self.reader.mapper.field_type(node.field)
        if not isinstance(ft, PercolatorFieldType):
            raise QueryShardException(
                f"[percolate] field [{node.field}] is not a "
                f"[percolator] field")
        # the documents' reader is built once a request and a mapper (a
        # multi-index search parses them per index)
        readers = getattr(node, "_doc_readers", None)
        if readers is None:
            readers = {}
            node._doc_readers = readers
        cached = readers.get(id(self.reader.mapper))
        if cached is None:
            cached = perc.build_doc_reader(self.reader.mapper,
                                           node.documents)
            readers[id(self.reader.mapper)] = cached
        queries = perc.segment_parsed_queries(self.view.segment,
                                              node.field)
        doc_exec = SegmentQueryExecutor(cached, 0, self.device)
        doc_live = self._dev(cached.views[0].live_mask)
        live = self.view.live_mask  # tombstoned stored queries are skipped
        mask = np.zeros(self.d_pad, dtype=bool)
        for ord_, q in queries.items():
            if not live[ord_]:
                continue
            try:
                qmask, _ = doc_exec._eval(q, scoring=False)
            except NotLowerable:
                raise   # a feature of a later module: typed, not skipped
            except Exception:  # noqa: BLE001 — one stored query that
                continue  # raises (a type clash with the document's
                #           dynamic fields, say) must not fail the search
            if bool((qmask[: len(doc_live)] & doc_live).any()):
                mask[ord_] = True
        m = self._dev(mask)
        return m, self._const(m, node.boost if scoring else 0.0)

    def _eval_nested(self, node: dsl.NestedQuery, scoring: bool) -> Pair:
        """Per-object matching over the segment's nested store. Child
        scores are constant (boost per matching object); score_mode
        combines them: sum → count · boost, avg/min/max → boost,
        none → 0."""
        store = self.view.segment.nested_store.get(node.path)
        if not store:
            return self._none()
        mapper = self.reader.mapper
        if hasattr(mapper, "mapper"):  # MapperService → DocumentMapper
            mapper = mapper.mapper
        mask = np.zeros(self.d_pad, dtype=bool)
        score = np.zeros(self.d_pad, dtype=np.float32)
        for ord_, objs in store.items():
            n_matched = 0
            for obj in objs:
                if _nested_object_matches(node.query, obj, mapper,
                                          node.path):
                    n_matched += 1
            if n_matched:
                mask[ord_] = True
                if scoring and node.score_mode != "none":
                    child = float(node.boost)
                    score[ord_] = (child * n_matched
                                   if node.score_mode == "sum" else child)
        return self._dev(mask), self._dev(score)

    def _eval_ip_range(self, field: str, lo128: int, hi128: int,
                       boost: float) -> Pair:
        """[lo128, hi128] over the ip field's signed-offset (hi, lo) i64
        columns: a 128-bit compare as two lexicographic 64-bit ones."""
        pack = self.pack
        hk = field + IpFieldType.HI_SUFFIX
        lk = field + IpFieldType.LO_SUFFIX
        if hk not in pack.dv_i64 or lk not in pack.dv_i64 or lo128 > hi128:
            return self._none()
        h = self._column("i64", hk, lambda: pack.dv_i64[hk])
        lo = self._column("i64", lk, lambda: pack.dv_i64[lk])
        lo_h, lo_l = IpFieldType.split128(lo128)
        hi_h, hi_l = IpFieldType.split128(hi128)
        # presence from the exists mask, not the i64 sentinel: an
        # IPv4-mapped address has hi == 0, which is MISSING_I64 after
        # the signed offset
        present = self._dev(self.reader.has_field_mask(self.view_idx,
                                                       field))
        ge = (h > lo_h) | ((h == lo_h) & (lo >= lo_l))
        le = (h < hi_h) | ((h == hi_h) & (lo <= hi_l))
        mask = present & ge & le
        return mask, self._const(mask, boost)

    def _eval_range_field(self, node: dsl.RangeQuery,
                          ft: RangeFieldType) -> Pair:
        """Interval against interval on a range field: relation
        intersects (the default), within or contains."""
        pack = self.pack
        kind = ft.bound_kind
        cols = pack.dv_i64 if kind == "i64" else pack.dv_f64
        gk = node.field + RangeFieldType.GTE_SUFFIX
        lk = node.field + RangeFieldType.LTE_SUFFIX
        if gk not in cols or lk not in cols:
            return self._none()
        g = self._column(kind, gk, lambda: cols[gk])
        lte = self._column(kind, lk, lambda: cols[lk])
        q_lo, q_hi = ft.parse_range({k: v for k, v in
                                     (("gt", node.gt), ("gte", node.gte),
                                      ("lt", node.lt), ("lte", node.lte))
                                     if v is not None})
        present = (g != MISSING_I64) if kind == "i64" else ~torch.isnan(g)
        relation = (node.relation or "intersects").lower()
        if relation == "within":
            hit = (g >= q_lo) & (lte <= q_hi)
        elif relation == "contains":
            hit = (g <= q_lo) & (lte >= q_hi)
        elif relation == "intersects":
            hit = (g <= q_hi) & (lte >= q_lo)
        else:
            raise QueryShardException(
                f"[range] unknown relation [{relation}]")
        mask = present & hit
        return mask, self._const(mask, node.boost)

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
        if isinstance(ft, IpFieldType):
            lo = 0
            hi = (1 << 128) - 1
            if node.gte is not None:
                lo = ft.parse_ip(node.gte)
            elif node.gt is not None:
                lo = ft.parse_ip(node.gt) + 1
            if node.lte is not None:
                hi = ft.parse_ip(node.lte)
            elif node.lt is not None:
                hi = ft.parse_ip(node.lt) - 1
            return self._eval_ip_range(node.field, lo, hi, node.boost)
        if isinstance(ft, RangeFieldType):
            return self._eval_range_field(node, ft)
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


def _nan_pick(pick, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.maximum / minimum with a NaN operand passed through as it
    is, the first one first (jnp's max and min propagate NaN)."""
    return torch.where(torch.isnan(a), a,
                       torch.where(torch.isnan(b), b, pick(a, b)))


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


def _pow64(x: float, y: float) -> float:
    """float64 x ** y through the C library's pow, as XLA:CPU computes
    ``jnp.power`` of two Python floats (0 ** negative → inf, a negative
    base with a fractional exponent → NaN)."""
    try:
        return math.pow(x, y)
    except ValueError:
        return math.inf if x == 0 else math.nan
    except OverflowError:
        return math.inf


def _nested_object_matches(q: dsl.QueryNode, obj: Dict[str, list],
                           doc_mapper, path: str) -> bool:
    """Evaluate an inner nested query against ONE object's flat
    {absolute subfield path: [raw values]} map — the per-sub-document
    match the reference gets from indexing each nested object as its own
    Lucene doc. Field types normalize both sides."""
    if isinstance(q, dsl.MatchAllQuery):
        return True
    if isinstance(q, dsl.BoolQuery):
        for c in list(q.must) + list(q.filter):
            if not _nested_object_matches(c, obj, doc_mapper, path):
                return False
        for c in q.must_not:
            if _nested_object_matches(c, obj, doc_mapper, path):
                return False
        if q.should:
            msm = q.minimum_should_match
            if msm is None:
                msm = 0 if (q.must or q.filter) else 1
            if msm > 0:
                n = sum(1 for c in q.should
                        if _nested_object_matches(c, obj, doc_mapper, path))
                if n < msm:
                    return False
        return True
    if isinstance(q, dsl.ConstantScoreQuery):
        return _nested_object_matches(q.filter_query, obj, doc_mapper, path)
    if isinstance(q, dsl.NestedQuery):
        raise QueryShardException(
            "[nested] within [nested] is not supported yet")
    if isinstance(q, dsl.ExistsQuery):
        return bool(obj.get(q.field))
    if isinstance(q, (dsl.TermQuery, dsl.TermsQuery)):
        ft = doc_mapper.fields.get(q.field)
        vals = obj.get(q.field)
        if ft is None or not vals:
            return False
        wants = ([q.value] if isinstance(q, dsl.TermQuery)
                 else list(q.values))
        try:
            want_norm = {ft.normalize_term(w) for w in wants}
            return any(ft.normalize_term(v) in want_norm for v in vals)
        except Exception:
            return False
    if isinstance(q, dsl.MatchQuery):
        ft = doc_mapper.fields.get(q.field)
        vals = obj.get(q.field)
        if ft is None or not vals:
            return False
        if isinstance(ft, TextFieldType):
            q_terms = _analyzed_terms(ft, q.query)
            if not q_terms:
                return False
            doc_terms = set()
            for v in vals:
                doc_terms.update(ft.analyzer.terms(str(v)))
            hits = sum(1 for t in q_terms if t in doc_terms)
            if q.operator == "and":
                return hits == len(q_terms)
            need = q.minimum_should_match or 1
            return hits >= need
        try:
            want = ft.normalize_term(q.query)
            return any(ft.normalize_term(v) == want for v in vals)
        except Exception:
            return False
    if isinstance(q, dsl.RangeQuery):
        ft = doc_mapper.fields.get(q.field)
        vals = obj.get(q.field)
        if ft is None or not vals:
            return False
        try:
            for v in vals:
                dv = ft.doc_value(v) if ft.has_doc_values \
                    else ft.normalize_range_bound(v)
                if q.gt is not None and \
                        not dv > ft.normalize_range_bound(q.gt):
                    continue
                if q.gte is not None and \
                        not dv >= ft.normalize_range_bound(q.gte):
                    continue
                if q.lt is not None and \
                        not dv < ft.normalize_range_bound(q.lt):
                    continue
                if q.lte is not None and \
                        not dv <= ft.normalize_range_bound(q.lte):
                    continue
                return True
        except Exception:
            return False
        return False
    raise QueryShardException(
        f"[nested] unsupported inner query [{q.query_name()}]")
