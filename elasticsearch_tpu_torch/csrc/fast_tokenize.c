/* fast_tokenize — C implementation of the standard-analyzer hot loop.
 *
 * Replaces `_WORD_RE.findall(text)` + per-token str.lower() for ASCII
 * text (the overwhelming case for log/search corpora). Semantics match
 * analyzers.standard_tokenize + the lowercase filter:
 *   token := \w+([.']\w+)*  over ASCII, lowercased, '_' stripped,
 *   overlong tokens punted.
 * Non-ASCII or pathological input returns -1 and the caller falls back
 * to the Python regex path, so Unicode behavior stays byte-identical
 * with the pure Python analyzer.
 *
 * Output: tokens written into `out` separated by '\n' (which can never
 * appear inside a token), so Python materializes the token list with a
 * single C-speed decode+split. *out_len receives the byte length.
 * Returns the token count, -1 for fallback, -2 when out_cap is too
 * small (caller retries with a larger buffer).
 */

#include <stddef.h>

static int is_word(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z')
        || (c >= '0' && c <= '9') || c == '_';
}

static unsigned char lower(unsigned char c) {
    return (c >= 'A' && c <= 'Z') ? (unsigned char)(c + 32) : c;
}

long fast_tokenize_ascii(const unsigned char *text, long n,
                         long max_token_length,
                         unsigned char *out, long out_cap,
                         long *out_len) {
    long i = 0, ntok = 0, w = 0;
    for (long k = 0; k < n; k++) {
        if (text[k] >= 0x80) return -1;
    }
    while (i < n) {
        if (!is_word(text[i])) { i++; continue; }
        long start = i;
        while (i < n) {
            if (is_word(text[i])) { i++; continue; }
            /* [.'] joins only between word chars */
            if ((text[i] == '.' || text[i] == '\'')
                    && i + 1 < n && is_word(text[i + 1])) {
                i += 2;
                continue;
            }
            break;
        }
        long tok_begin = w;
        if (ntok > 0) {
            if (w >= out_cap) return -2;
            out[w++] = '\n';
            tok_begin = w;
        }
        for (long k = start; k < i; k++) {
            unsigned char c = text[k];
            if (c == '_') continue;
            if (w >= out_cap) return -2;
            out[w++] = lower(c);
        }
        if (w == tok_begin) {          /* all-underscore token: drop */
            w = (ntok > 0) ? w - 1 : w; /* and its separator */
            continue;
        }
        if (w - tok_begin > max_token_length) {
            return -1;                  /* overlong: Python splits these */
        }
        ntok++;
    }
    *out_len = w;
    return ntok;
}

/* murmur3_x86_32(seed 0) over a byte buffer — the routing hash
 * (Murmur3HashFunction over UTF-16LE code units; the Python caller
 * encodes). Returns the SIGNED i32 value, matching the pure-Python
 * implementation in indices/routing.py bit for bit. */
#include <stdint.h>

int32_t murmur3_32(const unsigned char *data, long n) {
    const uint32_t c1 = 0xCC9E2D51u, c2 = 0x1B873593u;
    uint32_t h1 = 0;
    long nblocks = n & ~3L;
    for (long i = 0; i < nblocks; i += 4) {
        uint32_t k1 = (uint32_t)data[i] | ((uint32_t)data[i + 1] << 8)
            | ((uint32_t)data[i + 2] << 16) | ((uint32_t)data[i + 3] << 24);
        k1 *= c1;
        k1 = (k1 << 15) | (k1 >> 17);
        k1 *= c2;
        h1 ^= k1;
        h1 = (h1 << 13) | (h1 >> 19);
        h1 = h1 * 5u + 0xE6546B64u;
    }
    uint32_t k1 = 0;
    switch (n & 3) {
    case 3: k1 ^= (uint32_t)data[nblocks + 2] << 16; /* fall through */
    case 2: k1 ^= (uint32_t)data[nblocks + 1] << 8;  /* fall through */
    case 1:
        k1 ^= (uint32_t)data[nblocks];
        k1 *= c1;
        k1 = (k1 << 15) | (k1 >> 17);
        k1 *= c2;
        h1 ^= k1;
    }
    h1 ^= (uint32_t)n;
    h1 ^= h1 >> 16;
    h1 *= 0x85EBCA6Bu;
    h1 ^= h1 >> 13;
    h1 *= 0xC2B2AE35u;
    h1 ^= h1 >> 16;
    return (int32_t)h1;
}
