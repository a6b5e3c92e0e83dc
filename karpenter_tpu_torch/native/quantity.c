/* Native k8s resource.Quantity parser.
 *
 * The quantity grammar (sign, decimal mantissa, binary/decimal SI suffix or
 * scientific exponent) is parsed on every manifest ingest and every pod
 * watch-event re-encode — the host-side hot path feeding the device solver
 * (reference semantics: k8s.io/apimachinery resource.Quantity, modeled in
 * karpenter_tpu/utils/quantity.py whose parser this accelerates; the pure-
 * Python path remains the fallback and the semantic oracle).
 *
 * parse(s) -> (numerator, denominator, format) with exact integer
 * arithmetic in unsigned __int128; anything that would overflow or that
 * this parser does not recognize raises ValueError and the caller falls
 * back to Python. format: 0=DecimalSI, 1=BinarySI, 2=DecimalExponent.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;

static const u128 U128_MAX = ~(u128)0;

/* multiply with overflow check; returns 0 on overflow */
static int mul_u128(u128 a, u128 b, u128 *out) {
    if (a != 0 && b > U128_MAX / a) return 0;
    *out = a * b;
    return 1;
}

static PyObject *u128_to_pylong(u128 v) {
    /* split into two 64-bit halves: (hi << 64) | lo; every intermediate is
     * NULL-checked — an allocation failure must raise, not crash */
    uint64_t hi = (uint64_t)(v >> 64), lo = (uint64_t)v;
    if (hi == 0) return PyLong_FromUnsignedLongLong(lo);
    PyObject *phi = NULL, *shift = NULL, *plo = NULL, *hs = NULL,
             *res = NULL;
    phi = PyLong_FromUnsignedLongLong(hi);
    if (phi == NULL) goto done;
    shift = PyLong_FromLong(64);
    if (shift == NULL) goto done;
    plo = PyLong_FromUnsignedLongLong(lo);
    if (plo == NULL) goto done;
    hs = PyNumber_Lshift(phi, shift);
    if (hs == NULL) goto done;
    res = PyNumber_Or(hs, plo);
done:
    Py_XDECREF(phi);
    Py_XDECREF(shift);
    Py_XDECREF(plo);
    Py_XDECREF(hs);
    return res;
}

static int pow_u128(u128 base, int exp, u128 *out) {
    u128 r = 1;
    while (exp-- > 0) {
        if (!mul_u128(r, base, &r)) return 0;
    }
    *out = r;
    return 1;
}

static PyObject *parse_error(const char *s) {
    PyErr_Format(PyExc_ValueError, "unable to parse quantity '%s'", s);
    return NULL;
}

static PyObject *quantity_parse(PyObject *self, PyObject *arg) {
    Py_ssize_t len;
    const char *s = PyUnicode_AsUTF8AndSize(arg, &len);
    if (s == NULL) return NULL;

    /* strip() like the Python parser */
    const char *p = s, *end = s + len;
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        p++;
    while (end > p && (end[-1] == ' ' || end[-1] == '\t' ||
                       end[-1] == '\n' || end[-1] == '\r'))
        end--;
    if (p == end) return parse_error(s);

    int negative = 0;
    if (*p == '+' || *p == '-') {
        negative = (*p == '-');
        p++;
    }

    /* mantissa: \d+(\.\d*)? | \.\d+  -> digits with implicit scale */
    u128 mantissa = 0;
    int int_digits = 0, frac_digits = 0, seen_dot = 0;
    while (p < end) {
        if (*p >= '0' && *p <= '9') {
            if (!mul_u128(mantissa, 10, &mantissa)) return parse_error(s);
            u128 add = (u128)(*p - '0');
            if (mantissa > U128_MAX - add) return parse_error(s);
            mantissa += add;
            if (seen_dot) frac_digits++;
            else int_digits++;
            p++;
        } else if (*p == '.' && !seen_dot) {
            seen_dot = 1;
            p++;
        } else {
            break;
        }
    }
    if (int_digits == 0 && frac_digits == 0) return parse_error(s);
    if (seen_dot && int_digits == 0 && frac_digits == 0)
        return parse_error(s);

    /* value so far = mantissa / 10^frac_digits */
    u128 num = mantissa, den;
    if (!pow_u128(10, frac_digits, &den)) return parse_error(s);

    int format = 0; /* DecimalSI */

    if (p < end) {
        Py_ssize_t rest = end - p;
        u128 scale;
        if (rest == 2 && p[1] == 'i') {
            /* binary suffix Ki Mi Gi Ti Pi Ei */
            int power;
            switch (p[0]) {
            case 'K': power = 1; break;
            case 'M': power = 2; break;
            case 'G': power = 3; break;
            case 'T': power = 4; break;
            case 'P': power = 5; break;
            case 'E': power = 6; break;
            default: return parse_error(s);
            }
            if (!pow_u128(1024, power, &scale)) return parse_error(s);
            if (!mul_u128(num, scale, &num)) return parse_error(s);
            format = 1; /* BinarySI */
        } else if (rest == 1 && p[0] != '\0' &&
                   strchr("numkMGTPE", p[0]) != NULL) {
            format = 0; /* DecimalSI */
            switch (p[0]) {
            case 'n':
                if (!mul_u128(den, 1000000000ULL, &den))
                    return parse_error(s);
                break;
            case 'u':
                if (!mul_u128(den, 1000000ULL, &den)) return parse_error(s);
                break;
            case 'm':
                if (!mul_u128(den, 1000ULL, &den)) return parse_error(s);
                break;
            case 'k':
                if (!mul_u128(num, 1000ULL, &num)) return parse_error(s);
                break;
            case 'M':
                if (!mul_u128(num, 1000000ULL, &num)) return parse_error(s);
                break;
            case 'G':
                if (!mul_u128(num, 1000000000ULL, &num))
                    return parse_error(s);
                break;
            case 'T':
                if (!mul_u128(num, 1000000000000ULL, &num))
                    return parse_error(s);
                break;
            case 'P':
                if (!mul_u128(num, 1000000000000000ULL, &num))
                    return parse_error(s);
                break;
            case 'E':
                if (!mul_u128(num, 1000000000000000000ULL, &num))
                    return parse_error(s);
                break;
            }
        } else if ((p[0] == 'e' || p[0] == 'E') && rest >= 2) {
            /* scientific exponent [eE][+-]?\d+ */
            const char *q = p + 1;
            int eneg = 0;
            if (*q == '+' || *q == '-') {
                eneg = (*q == '-');
                q++;
            }
            if (q == end) return parse_error(s);
            long exp = 0;
            while (q < end) {
                if (*q < '0' || *q > '9') return parse_error(s);
                exp = exp * 10 + (*q - '0');
                if (exp > 64) return parse_error(s); /* fallback to Python */
                q++;
            }
            if (eneg) {
                if (!pow_u128(10, (int)exp, &scale)) return parse_error(s);
                if (!mul_u128(den, scale, &den)) return parse_error(s);
            } else {
                if (!pow_u128(10, (int)exp, &scale)) return parse_error(s);
                if (!mul_u128(num, scale, &num)) return parse_error(s);
            }
            format = 2; /* DecimalExponent */
        } else {
            return parse_error(s);
        }
    }

    /* reduce by gcd so Fraction construction is cheap */
    u128 a = num, b = den;
    while (b != 0) {
        u128 t = a % b;
        a = b;
        b = t;
    }
    if (a > 1) {
        num /= a;
        den /= a;
    }

    PyObject *pnum = u128_to_pylong(num);
    if (pnum == NULL) return NULL;
    if (negative) {
        PyObject *neg = PyNumber_Negative(pnum);
        Py_DECREF(pnum);
        pnum = neg;
        if (pnum == NULL) return NULL;
    }
    PyObject *pden = u128_to_pylong(den);
    if (pden == NULL) {
        Py_DECREF(pnum);
        return NULL;
    }
    PyObject *result = Py_BuildValue("(NNi)", pnum, pden, format);
    return result;
}

static PyMethodDef methods[] = {
    {"parse", quantity_parse, METH_O,
     "parse(s) -> (numerator, denominator, format_code); exact."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_kquantity",
    "Native k8s resource.Quantity parser", -1, methods,
};

PyMODINIT_FUNC PyInit__kquantity(void) { return PyModule_Create(&module); }
