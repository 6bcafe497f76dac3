/* response_splice — assemble the hits-array JSON bytes from pre-encoded
 * columns without re-entering Python per hit.
 *
 * The serializer pre-encodes each column with ONE C-level json.dumps call
 * (ids as a string array, scores as a number array, index names as a
 * string array, per-hit residual fields as an object array).  This
 * splicer splits each encoded array into its top-level elements and
 * concatenates per-hit objects
 *
 *   {"_index":<name>,"_id":<id>,"_score":<score>[,<extras inner>]}
 *
 * byte-for-byte identical to json.dumps(hit_dict, separators=(",",":"))
 * of the materialized form, because every byte comes from a json.dumps
 * of the same value.  Inputs are ASCII (ensure_ascii=True is the
 * serializer's default), so no UTF-8 handling is needed.
 *
 * The element scanner is string-escape and bracket-depth aware: inside
 * an encoded JSON string a quote can only appear escaped, and commas
 * only separate top-level elements at depth 0 outside strings.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    const char *p;
    long len;
} span_t;

/* Split a compact JSON array into its top-level element spans.
 * Returns the element count, or -1 on malformed input / overflow. */
static int32_t scan_array(const char *s, span_t *elems, int32_t max_elems)
{
    const char *p = s;
    if (*p != '[')
        return -1;
    p++;
    if (*p == ']')
        return 0;
    int32_t count = 0;
    const char *start = p;
    int depth = 0, in_str = 0, esc = 0;
    for (;; p++) {
        char c = *p;
        if (!c)
            return -1; /* unterminated */
        if (in_str) {
            if (esc)
                esc = 0;
            else if (c == '\\')
                esc = 1;
            else if (c == '"')
                in_str = 0;
            continue;
        }
        if (c == '"') {
            in_str = 1;
        } else if (c == '{' || c == '[') {
            depth++;
        } else if (c == '}') {
            if (--depth < 0)
                return -1;
        } else if (c == ']') {
            if (depth == 0) {
                if (count >= max_elems)
                    return -1;
                elems[count].p = start;
                elems[count].len = p - start;
                return count + 1;
            }
            depth--;
        } else if (c == ',' && depth == 0) {
            if (count >= max_elems)
                return -1;
            elems[count].p = start;
            elems[count].len = p - start;
            count++;
            start = p + 1;
        }
    }
}

#define PUT(str, n)                                   \
    do {                                              \
        long _n = (n);                                \
        if (w + _n > cap) {                           \
            rc = -1;                                  \
            goto done;                                \
        }                                             \
        memcpy(out + w, (str), (size_t)_n);           \
        w += _n;                                      \
    } while (0)

/* Assemble the hits array.
 *   ids_json    compact JSON array of n encoded _id values
 *   scores_json compact JSON array of n encoded _score values
 *   names_json  compact JSON array of encoded _index names (deduped)
 *   name_idx    n indices into names_json's elements
 *   extras_json NULL, or compact JSON array of n objects holding each
 *               hit's residual fields ({} when none)
 * Writes the result into out (capacity cap); returns bytes written,
 * -1 when cap is too small (caller grows and retries), -2 on malformed
 * input (caller uses the Python fallback). */
long es_splice_hits(const char *ids_json, const char *scores_json,
                    const char *names_json, const int32_t *name_idx,
                    const char *extras_json, int32_t n,
                    char *out, long cap)
{
    if (n < 0)
        return -2;
    if (n == 0)
        return cap >= 2 ? (memcpy(out, "[]", 2), 2) : -1;
    long rc = -2;
    long w = 0;
    span_t *ids = malloc(sizeof(span_t) * (size_t)n);
    span_t *scores = malloc(sizeof(span_t) * (size_t)n);
    span_t *names = malloc(sizeof(span_t) * (size_t)n);
    span_t *extras = extras_json ? malloc(sizeof(span_t) * (size_t)n) : NULL;
    int32_t n_names;
    if (!ids || !scores || !names || (extras_json && !extras))
        goto done;
    if (scan_array(ids_json, ids, n) != n)
        goto done;
    if (scan_array(scores_json, scores, n) != n)
        goto done;
    n_names = scan_array(names_json, names, n);
    if (n_names <= 0)
        goto done;
    if (extras_json && scan_array(extras_json, extras, n) != n)
        goto done;
    PUT("[", 1);
    for (int32_t i = 0; i < n; i++) {
        int32_t ni = name_idx[i];
        if (ni < 0 || ni >= n_names) {
            rc = -2;
            goto done;
        }
        if (i)
            PUT(",", 1);
        PUT("{\"_index\":", 10);
        PUT(names[ni].p, names[ni].len);
        PUT(",\"_id\":", 7);
        PUT(ids[i].p, ids[i].len);
        PUT(",\"_score\":", 10);
        PUT(scores[i].p, scores[i].len);
        if (extras && extras[i].len > 2) {
            /* non-empty residual object: splice its inner bytes */
            PUT(",", 1);
            PUT(extras[i].p + 1, extras[i].len - 2);
        }
        PUT("}", 1);
    }
    PUT("]", 1);
    rc = w;
done:
    free(ids);
    free(scores);
    free(names);
    free(extras);
    return rc;
}
