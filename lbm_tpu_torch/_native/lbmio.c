/* lbmio — native formatted I/O of the port's host side.
 *
 * Plain C with a C interface (no Python.h), loaded with ctypes by
 * lbm_tpu_torch/_native/__init__.py.  The output is byte-identical to the
 * pure-Python writers of lbm_tpu_torch/io.py, and the parser accepts and
 * rejects exactly what lbm_tpu_torch/geometry.py's pure-Python parser
 * does, with the same messages.
 *
 *   lbm_write_final_state(path, ux, uy, speed, pressure, obstacles, ny, nx, &libc)
 *       ux/uy/speed/pressure: float64[ny*nx]; obstacles: uint8[ny*nx];
 *       "%d %d %.12E %.12E %.12E %.12E %d\n" per cell, y outer, x inner.
 *   lbm_write_av_vels(path, av, n, &libc)
 *       av: float64[n]; "%ld:\t%.12E\n" per step.
 *   lbm_parse_obstacles(path, nx, ny, mask_out, &free_out, err_buf, err_len)
 *       "xx yy 1" triplets into mask_out (uint8[ny*nx], zeroed by the
 *       caller), the duplicate-guarded free-cell count into free_out.
 *
 * The writers format every value that is a float32 widened to a double
 * with the exact converter put_exact below, and every other finite value
 * with snprintf's "%.12E"; libc (may be NULL) receives the count of the
 * latter.
 *
 * Every function returns 0, or a positive errno for a failed open, read
 * or write, or a negative LBMIO_* code below.
 */

#define _GNU_SOURCE
#include <errno.h>
#include <locale.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* The file broke the obstacle contract; err_buf holds "<line>: <message>". */
#define LBMIO_PARSE_ERROR (-1)
/* The file holds a byte outside ASCII: Python decodes the text and splits
 * it on Unicode whitespace, so only the pure-Python parser can tell what
 * such a file means.  The caller runs it instead. */
#define LBMIO_NOT_ASCII (-2)
/* No C locale could be made for the formatting. */
#define LBMIO_NO_LOCALE (-3)

typedef unsigned __int128 u128;

#define TEN12 1000000000000ULL
#define TEN13 10000000000000ULL

/* 5^k for k in [0, 57], three 64-bit limbs each, least significant first:
 * 5^57 < 2^133 scales the least float32, 2^-149, to 13 digits. */
static uint64_t pow5[58][3];

__attribute__((constructor)) static void init_pow5(void)
{
    pow5[0][0] = 1;
    for (int k = 1; k < 58; ++k) {
        u128 carry = 0;
        for (int l = 0; l < 3; ++l) {
            u128 t = (u128)pow5[k - 1][l] * 5 + carry;
            pow5[k][l] = (uint64_t)t;
            carry = t >> 64;
        }
    }
}

/* Whether the finite, nonzero v is a float32 value: then v = m * 2^q with m
 * odd, m < 2^24 and q >= -149, and 2^b <= |v| < 2^(b+1) with b <= 127. */
static int float32_parts(double v, uint64_t *m, int *q, int *b)
{
    uint64_t bits;
    memcpy(&bits, &v, sizeof bits);
    int biased = (int)(bits >> 52) & 0x7ff;
    if (biased == 0) /* a double's denormal: far below the least float32 */
        return 0;
    int e = biased - 1023;
    if (e < -149 || e > 127)
        return 0;
    uint64_t sig = (bits & ((1ULL << 52) - 1)) | (1ULL << 52);
    int tz = __builtin_ctzll(sig);
    sig >>= tz;
    if (sig >= (1ULL << 24) || e - 52 + tz < -149)
        return 0;
    *m = sig;
    *q = e - 52 + tz;
    *b = e;
    return 1;
}

/* Where m * 2^q * 10^k lies between two integers: its floor, and its
 * fraction as one of these. */
enum { FRAC_ZERO, FRAC_BELOW_HALF, FRAC_HALF, FRAC_ABOVE_HALF };

/* The floor of m * 5^k * 2^(q+k) for 0 <= k <= 57 (a 192-bit product,
 * then a shift), with its fraction in *frac.  The floor is below 2^64. */
static uint64_t scaled_up(uint64_t m, int q, int k, int *frac)
{
    uint64_t limb[4];
    u128 t = (u128)m * pow5[k][0];
    limb[0] = (uint64_t)t;
    t = (u128)m * pow5[k][1] + (t >> 64);
    limb[1] = (uint64_t)t;
    t = (u128)m * pow5[k][2] + (t >> 64);
    limb[2] = (uint64_t)t;
    limb[3] = 0;
    int s = -(q + k); /* the bits shifted out */
    if (s <= 0) {
        *frac = FRAC_ZERO;
        return limb[0] << -s;
    }
    int i = s >> 6, h = s - 1;
    uint64_t n = (uint64_t)((((u128)limb[i + 1] << 64) | limb[i]) >> (s & 63));
    int half = (int)(limb[h >> 6] >> (h & 63)) & 1;
    int sticky = (limb[h >> 6] & ((1ULL << (h & 63)) - 1)) != 0;
    for (int l = 0; l < (h >> 6); ++l)
        sticky |= limb[l] != 0;
    *frac = half ? (sticky ? FRAC_ABOVE_HALF : FRAC_HALF)
                 : (sticky ? FRAC_BELOW_HALF : FRAC_ZERO);
    return n;
}

/* The floor of m * 2^q / 10^j for 1 <= j <= 26 (5^j < 2^61) and q >= j: a
 * 128-by-64-bit division.  5^j is odd, so the fraction is never a half. */
static uint64_t scaled_down(uint64_t m, int q, int j, int *frac)
{
    u128 num = (u128)m << (q - j);
    uint64_t d = pow5[j][0];
    uint64_t n = (uint64_t)(num / d);
    uint64_t r = (uint64_t)(num - (u128)n * d);
    *frac = r == 0 ? FRAC_ZERO : 2 * r < d ? FRAC_BELOW_HALF : FRAC_ABOVE_HALF;
    return n;
}

static const char PAIRS[] =
    "00010203040506070809101112131415161718192021222324252627282930313233343536373839"
    "40414243444546474849505152535455565758596061626364656667686970717273747576777879"
    "8081828384858687888990919293949596979899";

/* "%.12E" of a finite float32 value v, written at p; returns the end.
 * The 13 digits N are v * 10^(12-E) rounded half to even, found exactly:
 * 10^E <= |v| < 10^(E+1), E first taken as floor(b * log10 2) and raised
 * by one where the scaled value reaches 10^13. */
static char *put_exact(char *p, double v, uint64_t m, int q, int b)
{
    if (v < 0)
        *p++ = '-';
    int e10 = (b * 78913) >> 18; /* floor(b * log10 2) for every float32 b */
    int frac, k = 12 - e10;
    uint64_t n = k >= 0 ? scaled_up(m, q, k, &frac) : scaled_down(m, q, -k, &frac);
    if (n >= TEN13) {
        uint64_t r = n % 10;
        n /= 10;
        ++e10;
        frac = r < 5 ? (r == 0 && frac == FRAC_ZERO ? FRAC_ZERO : FRAC_BELOW_HALF)
             : r == 5 ? (frac == FRAC_ZERO ? FRAC_HALF : FRAC_ABOVE_HALF)
                      : FRAC_ABOVE_HALF;
    }
    if (frac == FRAC_ABOVE_HALF || (frac == FRAC_HALF && (n & 1)))
        ++n;
    if (n == TEN13) {
        n = TEN12;
        ++e10;
    }
    p[0] = (char)('0' + n / TEN12);
    p[1] = '.';
    uint64_t rest = n % TEN12;
    for (int i = 12; i > 0; i -= 2) {
        memcpy(p + i, PAIRS + 2 * (rest % 100), 2);
        rest /= 100;
    }
    p[14] = 'E';
    p[15] = e10 < 0 ? '-' : '+';
    memcpy(p + 16, PAIRS + 2 * (e10 < 0 ? -e10 : e10), 2);
    return p + 18;
}

/* Python's format(v, ".12E") and glibc's "%.12E" both round correctly, so
 * they agree on every finite value and on -0.0.  They differ on NaN (glibc
 * writes "-NAN" where the sign bit is set, Python "NAN" for every NaN):
 * NaN and the infinities are written here as Python writes them.  A float32
 * value takes put_exact; any other double snprintf, counted in *libc. */
static char *put_e12(char *p, double v, long *libc)
{
    uint64_t m;
    int q, b;
    if (isnan(v) || isinf(v) || v == 0) {
        const char *s = isnan(v) ? "NAN" : isinf(v) ? (v < 0 ? "-INF" : "INF")
                      : signbit(v) ? "-0.000000000000E+00" : "0.000000000000E+00";
        size_t len = strlen(s);
        memcpy(p, s, len);
        return p + len;
    }
    if (float32_parts(v, &m, &q, &b))
        return put_exact(p, v, m, q, b);
    ++*libc;
    return p + snprintf(p, 32, "%.12E", v);
}

/* A non-negative integer in decimal, as "%ld" writes it. */
static char *put_count(char *p, long v)
{
    char tmp[24];
    int n = 0;
    do {
        tmp[n++] = (char)('0' + v % 10);
        v /= 10;
    } while (v);
    while (n)
        *p++ = tmp[--n];
    return p;
}

/* Format under the C locale whatever the process's LC_NUMERIC is (a set
 * locale would print ',' as the decimal point), and restore the thread's
 * locale after. */
typedef struct {
    locale_t c_loc;
    locale_t prev;
} c_numeric;

static int c_numeric_enter(c_numeric *s)
{
    s->c_loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
    if (s->c_loc == (locale_t)0)
        return LBMIO_NO_LOCALE;
    s->prev = uselocale(s->c_loc);
    return 0;
}

static void c_numeric_leave(c_numeric *s)
{
    uselocale(s->prev);
    freelocale(s->c_loc);
}

/* fclose's flush is a write of up to the last buffer: its failure is a
 * failed write, never a silently truncated file. */
static int finish(FILE *fp, int err)
{
    if (fclose(fp) != 0 && err == 0)
        err = errno ? errno : EIO;
    return err;
}

/* Lines built in a block of memory, written with fwrite a block at a time:
 * a block is written once fewer than LINE_ROOM bytes are left in it, more
 * than any line of either file takes. */
#define BLOCK (1 << 20)
#define LINE_ROOM 256

typedef struct {
    c_numeric loc;
    FILE *fp;
    char *buf;
    size_t len;
    int err;
} writer;

static int writer_open(writer *w, const char *path)
{
    int err = c_numeric_enter(&w->loc);
    if (err)
        return err;
    w->len = 0;
    w->err = 0;
    w->buf = malloc(BLOCK);
    w->fp = w->buf ? fopen(path, "w") : NULL;
    if (!w->fp) {
        err = w->buf ? errno : ENOMEM;
        free(w->buf);
        c_numeric_leave(&w->loc);
        return err;
    }
    return 0;
}

static void writer_flush(writer *w)
{
    if (w->len && !w->err && fwrite(w->buf, 1, w->len, w->fp) != w->len)
        w->err = errno ? errno : EIO;
    w->len = 0;
}

/* Room for one more line at the block's end, written first if it is full;
 * NULL after a failed write. */
static char *writer_line(writer *w)
{
    if (w->len > BLOCK - LINE_ROOM)
        writer_flush(w);
    return w->err ? NULL : w->buf + w->len;
}

static int writer_close(writer *w)
{
    writer_flush(w);
    int err = finish(w->fp, w->err);
    free(w->buf);
    c_numeric_leave(&w->loc);
    return err;
}

int lbm_write_final_state(const char *path, const double *ux, const double *uy,
                          const double *speed, const double *pressure,
                          const uint8_t *obstacles, long ny, long nx, long *libc_out)
{
    const double *cols[4] = {ux, uy, speed, pressure};
    writer w;
    long libc = 0;
    int err = writer_open(&w, path);
    if (err)
        return err;
    for (long y = 0; y < ny; ++y) {
        for (long x = 0; x < nx; ++x) {
            long i = y * nx + x;
            char *p = writer_line(&w);
            if (!p)
                goto done;
            p = put_count(p, x);
            *p++ = ' ';
            p = put_count(p, y);
            *p++ = ' ';
            for (int c = 0; c < 4; ++c) {
                p = put_e12(p, cols[c][i], &libc);
                *p++ = ' ';
            }
            p = put_count(p, obstacles[i]);
            *p++ = '\n';
            w.len = (size_t)(p - w.buf);
        }
    }
done:
    if (libc_out)
        *libc_out = libc;
    return writer_close(&w);
}

int lbm_write_av_vels(const char *path, const double *av, long n, long *libc_out)
{
    writer w;
    long libc = 0;
    int err = writer_open(&w, path);
    if (err)
        return err;
    for (long i = 0; i < n; ++i) {
        char *p = writer_line(&w);
        if (!p)
            break;
        p = put_count(p, i);
        *p++ = ':';
        *p++ = '\t';
        p = put_e12(p, av[i], &libc);
        *p++ = '\n';
        w.len = (size_t)(p - w.buf);
    }
    if (libc_out)
        *libc_out = libc;
    return writer_close(&w);
}

/* The ASCII whitespace of Python's str.split(): the line ends are handled
 * apart, as Python's text mode splits lines at "\n", "\r\n" and "\r". */
static int is_space(int c)
{
    return c == ' ' || c == '\t' || c == '\v' || c == '\f' || (c >= 0x1c && c <= 0x1f);
}

/* A saturated magnitude: any coordinate beyond it is out of range, as a
 * Python int of any size would be. */
#define BIG ((long)1 << 40)

typedef struct {
    int ntok;       /* tokens on the line so far */
    int in_tok;     /* inside a token */
    int tok_ok;     /* the current token is [+-]?[0-9]+ so far */
    int tok_digits; /* digits in the current token */
    int tok_neg;    /* the current token has a '-' sign */
    long tok_mag;   /* its magnitude, saturated at BIG */
    int all_int;    /* every finished token matched */
    long val[3];    /* the first three tokens' values */
} line_state;

static void tok_start(line_state *s)
{
    s->in_tok = 1;
    s->tok_ok = 1;
    s->tok_digits = 0;
    s->tok_neg = 0;
    s->tok_mag = 0;
}

static void tok_byte(line_state *s, int c, int first)
{
    if (first && (c == '+' || c == '-')) {
        s->tok_neg = c == '-';
    } else if (c >= '0' && c <= '9') {
        s->tok_digits++;
        if (s->tok_mag < BIG)
            s->tok_mag = s->tok_mag * 10 + (c - '0');
    } else {
        s->tok_ok = 0;
    }
}

static void tok_end(line_state *s)
{
    if (!s->tok_ok || s->tok_digits == 0)
        s->all_int = 0;
    else if (s->ntok < 3)
        s->val[s->ntok] = s->tok_neg ? -s->tok_mag : s->tok_mag;
    s->ntok++;
    s->in_tok = 0;
}

/* One finished line: 0 if it is blank or a valid triplet (marked in the
 * mask), else LBMIO_PARSE_ERROR with the message in err_buf. */
static int end_line(line_state *s, long lineno, long nx, long ny, uint8_t *mask,
                    long *free_cells, char *err_buf, long err_len)
{
    if (s->in_tok)
        tok_end(s);
    const char *msg = NULL;
    if (s->ntok == 0)
        return 0;
    if (s->ntok != 3) {
        snprintf(err_buf, (size_t)err_len, "%ld: expected 3 values per line, got %d",
                 lineno, s->ntok);
        return LBMIO_PARSE_ERROR;
    }
    if (!s->all_int)
        msg = "expected 3 integers per line";
    else if (s->val[0] < 0 || s->val[0] >= nx)
        msg = "obstacle x-coord out of range";
    else if (s->val[1] < 0 || s->val[1] >= ny)
        msg = "obstacle y-coord out of range";
    else if (s->val[2] != 1)
        msg = "obstacle blocked value should be 1";
    if (msg) {
        snprintf(err_buf, (size_t)err_len, "%ld: %s", lineno, msg);
        return LBMIO_PARSE_ERROR;
    }
    uint8_t *cell = &mask[s->val[1] * nx + s->val[0]];
    if (!*cell) {
        *cell = 1;
        --*free_cells;
    }
    return 0;
}

int lbm_parse_obstacles(const char *path, long nx, long ny, uint8_t *mask_out,
                        long *free_out, char *err_buf, long err_len)
{
    FILE *fp = fopen(path, "r");
    if (!fp)
        return errno;
    long free_cells = nx * ny, lineno = 0;
    int rc = 0, after_cr = 0, pending = 0;
    line_state s;
    memset(&s, 0, sizeof s);
    s.all_int = 1;
    int c;
    errno = 0;
    while ((c = getc_unlocked(fp)) != EOF) {
        if (c >= 0x80) {
            rc = LBMIO_NOT_ASCII;
            break;
        }
        if (rc != 0)
            continue; /* a line failed: only look for bytes beyond ASCII */
        if (c == '\n' && after_cr) { /* the "\n" of a "\r\n" */
            after_cr = 0;
            continue;
        }
        after_cr = 0;
        if (c == '\n' || c == '\r') {
            after_cr = c == '\r';
            rc = end_line(&s, ++lineno, nx, ny, mask_out, &free_cells, err_buf, err_len);
            memset(&s, 0, sizeof s);
            s.all_int = 1;
            pending = 0;
            continue;
        }
        pending = 1;
        if (is_space(c)) {
            if (s.in_tok)
                tok_end(&s);
        } else {
            int first = !s.in_tok;
            if (first)
                tok_start(&s);
            tok_byte(&s, c, first);
        }
    }
    if (ferror(fp)) {
        int err = errno ? errno : EIO;
        fclose(fp);
        return err;
    }
    fclose(fp);
    if (rc == 0 && pending) /* a last line without its newline */
        rc = end_line(&s, ++lineno, nx, ny, mask_out, &free_cells, err_buf, err_len);
    if (rc == 0)
        *free_out = free_cells;
    return rc;
}
