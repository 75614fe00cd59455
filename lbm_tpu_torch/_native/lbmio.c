/* lbmio — native formatted I/O of the port's host side.
 *
 * Plain C with a C interface (no Python.h), loaded with ctypes by
 * lbm_tpu_torch/_native/__init__.py.  The output is byte-identical to the
 * pure-Python writers of lbm_tpu_torch/io.py, and the parser accepts and
 * rejects exactly what lbm_tpu_torch/geometry.py's pure-Python parser
 * does, with the same messages.
 *
 *   lbm_write_final_state(path, ux, uy, speed, pressure, obstacles, ny, nx)
 *       ux/uy/speed/pressure: float64[ny*nx]; obstacles: uint8[ny*nx];
 *       "%d %d %.12E %.12E %.12E %.12E %d\n" per cell, y outer, x inner.
 *   lbm_write_av_vels(path, av, n)
 *       av: float64[n]; "%ld:\t%.12E\n" per step.
 *   lbm_parse_obstacles(path, nx, ny, mask_out, &free_out, err_buf, err_len)
 *       "xx yy 1" triplets into mask_out (uint8[ny*nx], zeroed by the
 *       caller), the duplicate-guarded free-cell count into free_out.
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
#include <string.h>

/* The file broke the obstacle contract; err_buf holds "<line>: <message>". */
#define LBMIO_PARSE_ERROR (-1)
/* The file holds a byte outside ASCII: Python decodes the text and splits
 * it on Unicode whitespace, so only the pure-Python parser can tell what
 * such a file means.  The caller runs it instead. */
#define LBMIO_NOT_ASCII (-2)
/* No C locale could be made for the formatting. */
#define LBMIO_NO_LOCALE (-3)

/* printf's "%.12E" and Python's format(v, ".12E") both round correctly, so
 * they agree on every finite value and on -0.0.  They differ on NaN (glibc
 * writes "-NAN" where the sign bit is set, Python "NAN" for every NaN):
 * NaN and the infinities are written here as Python writes them. */
static int put_e12(FILE *fp, double v, char sep)
{
    if (isnan(v))
        return fprintf(fp, "NAN%c", sep);
    if (isinf(v))
        return fprintf(fp, v < 0 ? "-INF%c" : "INF%c", sep);
    return fprintf(fp, "%.12E%c", v, sep);
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

int lbm_write_final_state(const char *path, const double *ux, const double *uy,
                          const double *speed, const double *pressure,
                          const uint8_t *obstacles, long ny, long nx)
{
    c_numeric loc;
    int err = c_numeric_enter(&loc);
    if (err)
        return err;
    FILE *fp = fopen(path, "w");
    if (!fp) {
        err = errno;
        c_numeric_leave(&loc);
        return err;
    }
    setvbuf(fp, NULL, _IOFBF, 1 << 20);
    for (long y = 0; y < ny && !err; ++y) {
        for (long x = 0; x < nx; ++x) {
            long i = y * nx + x;
            if (fprintf(fp, "%ld %ld ", x, y) < 0 || put_e12(fp, ux[i], ' ') < 0 ||
                put_e12(fp, uy[i], ' ') < 0 || put_e12(fp, speed[i], ' ') < 0 ||
                put_e12(fp, pressure[i], ' ') < 0 ||
                fprintf(fp, "%d\n", (int)obstacles[i]) < 0) {
                err = errno ? errno : EIO;
                break;
            }
        }
    }
    err = finish(fp, err);
    c_numeric_leave(&loc);
    return err;
}

int lbm_write_av_vels(const char *path, const double *av, long n)
{
    c_numeric loc;
    int err = c_numeric_enter(&loc);
    if (err)
        return err;
    FILE *fp = fopen(path, "w");
    if (!fp) {
        err = errno;
        c_numeric_leave(&loc);
        return err;
    }
    setvbuf(fp, NULL, _IOFBF, 1 << 20);
    for (long i = 0; i < n; ++i) {
        if (fprintf(fp, "%ld:\t", i) < 0 || put_e12(fp, av[i], '\n') < 0) {
            err = errno ? errno : EIO;
            break;
        }
    }
    err = finish(fp, err);
    c_numeric_leave(&loc);
    return err;
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
