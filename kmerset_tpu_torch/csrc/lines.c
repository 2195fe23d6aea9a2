/* The SPSS dump's text codec: PackedStrings (one code 0..3 a base, int64
 * offsets) to and from the newline-terminated ACGT blob that
 * KmerSetCompact.dump writes and .load reads (reference:
 * lib/core/kmer_set_compact.h:57-87, one string per line), each way in one
 * serial pass.  Host C, no OpenMP, linked against libc alone; built on
 * first use by kmerset_tpu_torch/_nativebuild.py (build_lines) and bound
 * through ctypes in core/native.py (lines_encode, lines_decode), which
 * keeps the numpy passes of core/strings.py as the fallback.
 */

#include <stdint.h>
#include <string.h>

/* Code c in 0..3 is the byte 65 + 2c + 2h + 11t with h = c >> 1 and
 * t = c & h: 'A', 'C', 'G', 'T'.  Arithmetic instead of a table lookup, so
 * that the compiler vectorizes the inner loops. */
static inline uint8_t code_base(uint8_t c) {
    uint8_t h = (c >> 1) & 1, t = c & h;
    return (uint8_t)(65 + 2 * c + 2 * h + 11 * t);
}

/* Writes string i of (codes, offsets) as its bases and a '\n', for i in
 * [0, n), into out: offsets[n] - offsets[0] + n bytes, allocated by the
 * caller.  Returns the bytes written; -1, with nothing written, when the
 * offsets decrease; -1 when a code is above 3 (out is then written). */
long kmerset_lines_encode(const uint8_t *codes, const int64_t *offsets,
                          long n, uint8_t *out) {
    for (long i = 0; i < n; i++)
        if (offsets[i + 1] < offsets[i]) return -1;
    uint8_t seen = 0;
    long pos = 0;
    for (long i = 0; i < n; i++) {
        const uint8_t *src = codes + offsets[i];
        long len = offsets[i + 1] - offsets[i];
        uint8_t *dst = out + pos;
        for (long j = 0; j < len; j++) {
            seen |= src[j];
            dst[j] = code_base(src[j]);
        }
        pos += len;
        out[pos++] = '\n';
    }
    return (seen & ~3) ? -1 : pos;
}

/* Inverse of kmerset_lines_encode: each '\n' of data[0..m) ends a string
 * (and so does the end of data, after a last byte other than '\n').
 * Writes the base codes to codes_out and offsets_out[0..count] (0 first);
 * with both NULL it writes nothing and only counts the strings, to size
 * them: codes_out takes m less the newlines, offsets_out count + 1.
 * Returns the string count, or -1 on a byte other than A/C/G/T/'\n'. */
long kmerset_lines_decode(const uint8_t *data, long m, uint8_t *codes_out,
                          int64_t *offsets_out) {
    long pos = 0, n_codes = 0, n_str = 0;
    uint8_t bad = 0;
    if (offsets_out) offsets_out[0] = 0;
    while (pos < m) {
        const uint8_t *nl = memchr(data + pos, '\n', (size_t)(m - pos));
        long end = nl ? nl - data : m;
        long len = end - pos;
        if (codes_out) {
            const uint8_t *src = data + pos;
            uint8_t *dst = codes_out + n_codes;
            for (long j = 0; j < len; j++) {
                /* A, C, G, T map to 0..3; any other byte maps back to a
                 * base other than itself. */
                uint8_t c = src[j], v = ((c >> 1) ^ (c >> 2)) & 3;
                bad |= code_base(v) ^ c;
                dst[j] = v;
            }
        }
        n_codes += len;
        n_str++;
        if (offsets_out) offsets_out[n_str] = n_codes;
        pos = end + 1;
    }
    return bad ? -1 : n_str;
}
