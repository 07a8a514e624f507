/* fastio: the host parsers of mad_tpu_torch (PDB records, Situs voxel
 * text) in plain C, loaded with ctypes (no Python headers).
 *
 * Port of mad_tpu/native/fastio.c, a CPython extension, with its line
 * rules and number parsers: the callers get the same values and fields.
 * The PDB parser fills caller-sized buffers (an accepted line takes 54
 * bytes and its newline, so the caller sizes them from the file's
 * length); the float parser grows its own buffer, which the caller frees
 * with mad_fastio_free.
 *
 * Exported:
 *   mad_fastio_parse_pdb(data, size, cap, coords f64[cap * 3],
 *                        serial i64[cap], resnum i64[cap],
 *                        text u8[cap * MAD_PDB_TEXT]) -> atoms, or -1
 *                        when more than cap atoms are found
 *   mad_fastio_parse_floats(data, size, &n) -> f64[n] (NULL: no memory)
 *   mad_fastio_free(p)
 * data must be NUL-terminated at data[size] (a Python bytes object is):
 * strtod may read up to that NUL, as it does in mad_tpu's extension.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* An atom's text record: name (stripped, left-aligned), residue name,
 * chain, element (stripped, left-aligned), the two stripped lengths and
 * the HETATM flag. */
#define MAD_PDB_TEXT 16
enum { kName = 0, kResName = 4, kChain = 7, kElem = 8, kNameLen = 10,
       kElemLen = 11, kHet = 12 };

/* ---- fixed-column fields (mad_tpu/native/fastio.c:25-47) -------------- */

static int parse_int_field(const char *s, int len, long *out) {
    char buf[16];
    if (len >= (int)sizeof(buf)) return -1;
    memcpy(buf, s, len);
    buf[len] = 0;
    char *end;
    long v = strtol(buf, &end, 10);
    if (end == buf) return -1;
    *out = v;
    return 0;
}

static int parse_float_field(const char *s, int len, double *out) {
    char buf[32];
    if (len >= (int)sizeof(buf)) return -1;
    memcpy(buf, s, len);
    buf[len] = 0;
    char *end;
    double v = strtod(buf, &end);
    if (end == buf) return -1;
    *out = v;
    return 0;
}

/* s[0:len] without leading blanks and tabs and trailing blanks, tabs and
 * carriage returns, copied to out; returns its length. */
static int stripped(const char *s, int len, unsigned char *out) {
    int a = 0, b = len;
    while (a < b && (s[a] == ' ' || s[a] == '\t')) a++;
    while (b > a && (s[b - 1] == ' ' || s[b - 1] == '\t' || s[b - 1] == '\r'))
        b--;
    memcpy(out, s + a, b - a);
    return b - a;
}

/* ---- PDB (mad_tpu/native/fastio.c:59-149) ----------------------------- */

int64_t mad_fastio_parse_pdb(const char *data, int64_t size, int64_t cap,
                             double *coords, int64_t *serials,
                             int64_t *resnums, unsigned char *text) {
    int64_t pos = 0, n = 0;
    while (pos < size) {
        int64_t eol = pos;
        while (eol < size && data[eol] != '\n') eol++;
        const int64_t len = eol - pos;
        const char *line = data + pos;
        pos = eol + 1;

        if (len < 54) continue;
        const int is_atom = memcmp(line, "ATOM", 4) == 0
                            && (line[4] == ' ' || line[4] == '\t');
        const int is_het = memcmp(line, "HETATM", 6) == 0;
        if (!is_atom && !is_het) continue;

        long serial, resnum;
        double x, y, z;
        /* Fixed columns per PDB v3.30 (parity mad/PDB.py:20-54). */
        if (parse_int_field(line + 6, 5, &serial)) continue;
        if (parse_int_field(line + 22, 4, &resnum)) continue;
        if (parse_float_field(line + 30, 8, &x)) continue;
        if (parse_float_field(line + 38, 8, &y)) continue;
        if (parse_float_field(line + 46, 8, &z)) continue;
        if (n == cap) return -1;

        coords[3 * n] = x;
        coords[3 * n + 1] = y;
        coords[3 * n + 2] = z;
        serials[n] = serial;
        resnums[n] = resnum;
        unsigned char *t = text + n * MAD_PDB_TEXT;
        memset(t, 0, MAD_PDB_TEXT);
        t[kNameLen] = (unsigned char)stripped(line + 12, 4, t + kName);
        memcpy(t + kResName, line + 17, 3);
        t[kChain] = (unsigned char)line[21];
        t[kElemLen] = len >= 78
            ? (unsigned char)stripped(line + 76, 2, t + kElem) : 0;
        t[kHet] = (unsigned char)is_het;
        n++;
    }
    return n;
}

/* ---- Situs voxel text (mad_tpu/native/fastio.c:156-185) --------------- */

/* Powers of ten that doubles hold exactly. */
static const double kPow10[23] = {
    1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

/* strtod(p, next). A short decimal token, [space][sign]digits[.digits]
 * with no exponent or hex form after it, a mantissa below 2^53 and at
 * most 22 digits after the point, is the quotient of two doubles that
 * hold their values exactly, which IEEE division rounds once to nearest:
 * strtod's correctly rounded value. Every other token goes to strtod. */
static double parse_number(const char *p, char **next) {
    const char *s = p;
    while (*s == ' ' || (*s >= '\t' && *s <= '\r')) s++;
    const int neg = *s == '-';
    if (*s == '+' || *s == '-') s++;
    uint64_t m = 0;
    int digits = 0, frac = 0;
    for (; *s >= '0' && *s <= '9'; s++, digits++) {
        m = m * 10 + (uint64_t)(*s - '0');
        if (m >= (1ULL << 53)) return strtod(p, next);
    }
    if (*s == '.') {
        for (s++; *s >= '0' && *s <= '9'; s++, digits++, frac++) {
            m = m * 10 + (uint64_t)(*s - '0');
            if (m >= (1ULL << 53) || frac == 22) return strtod(p, next);
        }
    }
    if (digits == 0 || *s == 'e' || *s == 'E' || *s == 'x' || *s == 'X')
        return strtod(p, next);
    *next = (char *)s;
    const double v = (double)m / kPow10[frac];
    return neg ? -v : v;
}

double *mad_fastio_parse_floats(const char *data, int64_t size,
                                int64_t *n_out) {
    const char *p = data, *end = data + size;
    int64_t cap = 4096, n = 0;
    double *vals = malloc(cap * sizeof(double));
    if (!vals) return NULL;
    while (p < end) {
        char *next;
        const double v = parse_number(p, &next);
        if (next == p) {          /* a byte that does not parse: skip it */
            p++;
            continue;
        }
        if (n == cap) {
            cap *= 2;
            double *grown = realloc(vals, cap * sizeof(double));
            if (!grown) {
                free(vals);
                return NULL;
            }
            vals = grown;
        }
        vals[n++] = v;
        p = next;
    }
    *n_out = n;
    return vals;
}

void mad_fastio_free(void *p) { free(p); }
