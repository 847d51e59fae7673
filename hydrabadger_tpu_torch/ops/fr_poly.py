"""FFT-backed multipoint evaluation and interpolation over Fr: the DKG's
share-evaluation plane (host code).

The port's copy of hydrabadger_tpu/ops/fr_poly.py, residue for residue.
The DKG evaluates degree-t polynomials at all n node indices, which are
the consecutive integers 1..n; that admits the Newton-basis trick

    f(i)/i!  =  sum_j  (D^j f(0) / j!) * 1/(i-j)!

so evaluation at every point 0..N is one convolution of the scaled
forward differences against the inverse factorials, O(M(n)) by the
radix-2/4 NTT below, after an O(t^2) Horner seed of the t+1 values that
determine f.  Arbitrary point sets take Horner.  Interpolation at zero
rides the same factorial tables when the t+1 nodes form a consecutive
run (O(t) Lagrange weights); any gapped node set falls back to the
generic quadratic formula, bit-identical.  Everything is exact host
arithmetic mod R.  `crypto/dkg` routes here at >= 384 evaluation points
(`HYDRABADGER_NTT_MIN_N`) and >= 64 interpolation points.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Sequence

from ..crypto.bls12_381 import R
from ..obs import metrics as M

# ---------------------------------------------------------------------------
# Radix-2/4 NTT over Fr
# ---------------------------------------------------------------------------

FR_TWO_ADICITY = 32
FR_GENERATOR = 7  # smallest multiplicative generator of Fr
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)


@lru_cache(maxsize=64)
def _fr_twiddles(n: int, invert: bool) -> tuple:
    """(w^0, .., w^{n-1}) for the order-n root (or its inverse)."""
    w = pow(FR_ROOT_OF_UNITY, (1 << FR_TWO_ADICITY) // n, R)
    if invert:
        w = pow(w, R - 2, R)
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * w % R
    return tuple(out)


def fr_ntt(vec: Sequence[int], invert: bool = False) -> List[int]:
    """Length-2^k NTT over Fr: decimation in time, radix-4 butterflies
    (25% fewer twiddle muls than radix-2, quarter-order root reused)
    with one radix-2 layer peeling odd log2 sizes.  ``invert=True``
    runs the inverse transform INCLUDING the 1/n scale."""
    n = len(vec)
    if n & (n - 1):
        raise ValueError(f"NTT size must be a power of two, got {n}")
    if n > (1 << FR_TWO_ADICITY):
        raise ValueError("size exceeds the 2-adicity of Fr")
    if n == 1:
        return [vec[0] % R]
    tw = _fr_twiddles(n, invert)
    quarter_i = tw[n >> 2] if n >= 4 else 0  # the 4th root of unity

    def rec(a: List[int]) -> List[int]:
        m = len(a)
        if m == 1:
            return a
        if m == 2:
            return [(a[0] + a[1]) % R, (a[0] - a[1]) % R]
        stride = n // m
        out = [0] * m
        if m % 4 == 0:
            subs = [rec([a[i] for i in range(r, m, 4)]) for r in range(4)]
            q = m >> 2
            for k in range(q):
                t0 = subs[0][k]
                t1 = subs[1][k] * tw[stride * k] % R
                t2 = subs[2][k] * tw[2 * stride * k] % R
                t3 = subs[3][k] * tw[3 * stride * k] % R
                u0, u1 = (t0 + t2) % R, (t0 - t2) % R
                u2, u3 = (t1 + t3) % R, (t1 - t3) * quarter_i % R
                out[k] = (u0 + u2) % R
                out[k + q] = (u1 + u3) % R
                out[k + 2 * q] = (u0 - u2) % R
                out[k + 3 * q] = (u1 - u3) % R
        else:  # one radix-2 layer peels the odd power of two
            e = rec([a[i] for i in range(0, m, 2)])
            o = rec([a[i] for i in range(1, m, 2)])
            h = m >> 1
            for k in range(h):
                t = o[k] * tw[stride * k] % R
                out[k] = (e[k] + t) % R
                out[k + h] = (e[k] - t) % R
        return out

    res = rec([x % R for x in vec])
    if invert:
        n_inv = pow(n, R - 2, R)
        res = [x * n_inv % R for x in res]
    return res


def fr_intt(vec: Sequence[int]) -> List[int]:
    """Inverse NTT (scaled): fr_intt(fr_ntt(v)) == v."""
    return fr_ntt(vec, invert=True)


def fr_poly_mul(a: Sequence[int], b: Sequence[int]) -> List[int]:
    """Polynomial product over Fr via the NTT (coeffs low-to-high)."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return []
    res_len = la + lb - 1
    if min(la, lb) < 16:  # schoolbook beats transform overhead
        out = [0] * res_len
        for i, x in enumerate(a):
            if x:
                for j, y in enumerate(b):
                    out[i + j] += x * y
        return [v % R for v in out]
    size = 1 << (res_len - 1).bit_length()
    ea = fr_ntt(list(a) + [0] * (size - la))
    eb = fr_ntt(list(b) + [0] * (size - lb))
    return fr_intt([x * y % R for x, y in zip(ea, eb)])[:res_len]


# factorials / inverse factorials mod R, grown on demand (process-wide:
# R is fixed and the tables are append-only)
_FACT: List[int] = [1]
_INV_FACT: List[int] = [1]


def _ensure_factorials(n: int) -> None:
    while len(_FACT) <= n:
        _FACT.append(_FACT[-1] * len(_FACT) % R)
    if len(_INV_FACT) <= n:
        inv = pow(_FACT[n], R - 2, R)
        missing = list(range(len(_INV_FACT), n + 1))
        tail: Dict[int, int] = {}
        for i in reversed(missing):
            tail[i] = inv
            inv = inv * (i) % R  # 1/i! * i = 1/(i-1)!
        for i in missing:
            _INV_FACT.append(tail[i])


def _conv(a: Sequence[int], b: Sequence[int], out_len: int) -> List[int]:
    """First ``out_len`` coefficients of a*b, NTT above a cutoff."""
    la, lb = len(a), len(b)
    if min(la, lb) < 16 or la + lb < 64:
        out = [0] * out_len
        for i, x in enumerate(a):
            if x:
                top = min(lb, out_len - i)
                for j in range(top):
                    out[i + j] += x * b[j]
        return [v % R for v in out]
    res_len = min(la + lb - 1, out_len)
    size = 1 << (la + lb - 2).bit_length()
    _note_lanes(size, la + lb - 1)
    ea = fr_ntt(list(a) + [0] * (size - la))
    eb = fr_ntt(list(b) + [0] * (size - lb))
    prod = fr_ntt([x * y % R for x, y in zip(ea, eb)], invert=True)
    out = prod[:res_len]
    return out + [0] * (out_len - len(out))


def _conv_spec(
    a: Sequence[int], spec: Sequence[int], full_len: int, out_len: int
) -> List[int]:
    """a convolved against a PRE-TRANSFORMED fixed operand (its NTT
    spectrum): one forward + one inverse transform per call instead of
    three — the per-row saving that makes the batched DKG route pay.
    ``full_len`` is the true product length (lane accounting)."""
    size = len(spec)
    _note_lanes(size, full_len)
    ea = fr_ntt(list(a) + [0] * (size - len(a)))
    prod = fr_ntt(
        [x * y % R for x, y in zip(ea, spec)], invert=True
    )
    out = prod[:out_len]
    return out + [0] * (out_len - len(out))


@lru_cache(maxsize=64)
def _alt_invfact_spectrum(t1: int, size: int) -> tuple:
    """NTT spectrum of [(-1)^m / m!]_{m<t1}, zero-padded to size."""
    _ensure_factorials(t1)
    s = [
        _INV_FACT[m] if m % 2 == 0 else (R - _INV_FACT[m]) % R
        for m in range(t1)
    ]
    return tuple(fr_ntt(s + [0] * (size - t1)))


@lru_cache(maxsize=64)
def _invfact_spectrum(length: int, size: int) -> tuple:
    """NTT spectrum of [1/m!]_{m<length}, zero-padded to size."""
    _ensure_factorials(length)
    return tuple(
        fr_ntt(list(_INV_FACT[:length]) + [0] * (size - length))
    )


def _note_lanes(size: int, real: int) -> None:
    reg = M.default_registry()
    reg.gauge(M.FR_NTT_BATCH_LANES).track(size)
    reg.counter(M.FR_NTT_PAD_LANES).inc(max(0, size - real))
    reg.counter(M.FR_NTT_REAL_LANES).inc(real)


def _horner(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def _is_consecutive(xs: Sequence[int]) -> bool:
    return all(xs[i + 1] == xs[i] + 1 for i in range(len(xs) - 1))


def eval_consecutive(coeffs: Sequence[int], start: int, count: int) -> List[int]:
    """[f(start), .., f(start+count-1)] for 0 <= start, via the Newton
    convolution: Horner-seed f at 0..t, convert to scaled forward
    differences (one convolution), then one convolution against the
    inverse factorials yields f at EVERY integer up to the last point."""
    t = len(coeffs) - 1
    last = start + count - 1
    if t < 1 or count <= t + 1:
        return [_horner(coeffs, start + i) for i in range(count)]
    _ensure_factorials(last)
    # seed: the t+1 values that determine f
    fv = [_horner(coeffs, i) for i in range(t + 1)]
    u = [fv[i] * _INV_FACT[i] % R for i in range(t + 1)]
    # forward differences against alternating inverse factorials, then
    # one long convolution against 1/m! — the fixed operands ride
    # cached spectra, so each row pays one forward + one inverse NTT
    # per convolution
    if t + 1 < 16 or 2 * t + 1 < 64:
        s = [
            _INV_FACT[m] if m % 2 == 0 else (R - _INV_FACT[m]) % R
            for m in range(t + 1)
        ]
        dhat = _conv(u, s, t + 1)  # dhat[j] = D^j f(0) / j!
    else:
        size = 1 << (2 * t).bit_length()
        dhat = _conv_spec(
            u, _alt_invfact_spectrum(t + 1, size), 2 * t + 1, t + 1
        )
    wl = last + 1
    if t + 1 < 16 or t + wl < 64:
        w = [_INV_FACT[m] for m in range(wl)]
        scaled = _conv(dhat, w, wl)  # scaled[i] = f(i) / i!
    else:
        size = 1 << (t + wl - 1).bit_length()
        scaled = _conv_spec(
            dhat, _invfact_spectrum(wl, size), t + wl, wl
        )
    return [
        scaled[start + i] * _FACT[start + i] % R for i in range(count)
    ]


def eval_many(
    rows: Sequence[Sequence[int]], xs: Sequence[int]
) -> List[List[int]]:
    """Evaluate each coefficient row at every x in xs; consecutive
    ascending point sets (the DKG's 1..n) take the convolution route,
    anything else the Horner reference — identical residues either
    way."""
    xs = [int(x) for x in xs]
    if len(xs) >= 2 and _is_consecutive(xs) and xs[0] >= 0:
        return [
            eval_consecutive([int(c) % R for c in row], xs[0], len(xs))
            for row in rows
        ]
    return [[_horner(row, x) for x in xs] for row in rows]


def interpolate_at_zero(points: Dict[int, int]) -> int:
    """f(0) from t+1 distinct (x, y) samples.  Consecutive runs of
    nodes (x, x+1, .., x+t with x >= 1) use O(t) factorial-collapsed
    Lagrange weights; gapped sets use the generic quadratic formula.
    Returns the same canonical residue either way."""
    xs = sorted(points)
    t = len(xs) - 1
    if t >= 1 and xs[0] >= 1 and _is_consecutive(xs):
        _ensure_factorials(max(t, xs[-1]))
        # prefix/suffix products of the nodes
        pre = [1] * (t + 2)
        for i, x in enumerate(xs):
            pre[i + 1] = pre[i] * x % R
        suf = [1] * (t + 2)
        for i in range(t, -1, -1):
            suf[i] = suf[i + 1] * xs[i] % R
        acc = 0
        for i in range(t + 1):
            # prod_{j != i} (x_j - x_i) = (-1)^i * i! * (t-i)!
            num = pre[i] * suf[i + 1] % R
            li = num * _INV_FACT[i] % R * _INV_FACT[t - i] % R
            if i % 2 == 1:
                li = (R - li) % R
            acc = (acc + points[xs[i]] * li) % R
        return acc
    # generic fallback (mirrors threshold.poly_interpolate_at_zero)
    acc = 0
    for xi in xs:
        num, den = 1, 1
        for xj in xs:
            if xj == xi:
                continue
            num = num * xj % R
            den = den * (xj - xi) % R
        acc = (acc + points[xi] * num * pow(den, -1, R)) % R
    return acc
