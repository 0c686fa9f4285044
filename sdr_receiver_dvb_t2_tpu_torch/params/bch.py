"""BCH outer code: encode + full syndrome/Berlekamp-Massey/Chien decode.

DVB-T2 outer BCH codes (ETSI EN 302 755 clause 6.1.1, table 7):
  * normal FECFRAME: GF(2^16), primitive poly x^16+x^5+x^3+x^2+1, t=12
  * short FECFRAME:  GF(2^14), primitive poly x^14+x^5+x^3+x+1,  t=12
The generator polynomial is the product of the minimal polynomials of
alpha^1, alpha^3, ..., alpha^23 (computed here from the field itself, which
reproduces the g1..g12 products of table 7).

The reference receiver leaves BCH correction unimplemented
(reference/src/DVB_T2/bch_decoder.cpp:130 "TODO BCH decode"); this
module implements it fully.  Everything is NumPy; the no-error fast path
(syndrome == 0) can also be evaluated on-device as a GF(2) matmul using
:func:`parity_check_matrix`.

Bit convention: message bit 0 is the coefficient of x^(k-1) (first
transmitted bit = highest power); parity bits follow, highest power first.
"""
from __future__ import annotations

import functools
import numpy as np

_PRIM_POLY = {16: (16, 5, 3, 2, 0), 14: (14, 5, 3, 1, 0)}
DEFAULT_T = 12


class GF2m:
    """GF(2^m) arithmetic with log/antilog tables."""

    def __init__(self, m: int):
        self.m = m
        self.size = 1 << m
        self.order = self.size - 1
        poly = 0
        for p in _PRIM_POLY[m]:
            poly |= 1 << p
        exp = np.empty(2 * self.order, dtype=np.int64)
        log = np.zeros(self.size, dtype=np.int64)
        x = 1
        for i in range(self.order):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & self.size:
                x ^= poly
        exp[self.order:] = exp[:self.order]
        self.exp, self.log = exp, log

    def mul(self, a, b):
        a, b = np.asarray(a), np.asarray(b)
        out = self.exp[(self.log[a] + self.log[b]) % self.order]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        return self.exp[self.order - self.log[a]]

    def pow_alpha(self, e):
        """alpha^e for integer (array) exponent e (may be negative/large)."""
        return self.exp[np.mod(e, self.order)]


@functools.lru_cache(maxsize=None)
def field(m: int) -> GF2m:
    return GF2m(m)


def _minimal_poly(gf: GF2m, e: int) -> np.ndarray:
    """Minimal polynomial of alpha^e as a uint8 coefficient array (low->high)."""
    # conjugacy class {e, 2e, 4e, ...}
    cls, x = [], e % gf.order
    while x not in cls:
        cls.append(x)
        x = (2 * x) % gf.order
    # poly = prod (X - alpha^c); coefficients in GF(2^m), ends up binary
    poly = np.zeros(len(cls) + 1, dtype=np.int64)
    poly[0] = 1
    deg = 0
    for c in cls:
        root = gf.pow_alpha(c)
        new = np.zeros_like(poly)
        new[1:deg + 2] ^= poly[:deg + 1]          # X * poly
        prod = gf.mul(poly[:deg + 1], root)
        new[:deg + 1] ^= prod
        poly = new
        deg += 1
    assert np.all((poly == 0) | (poly == 1))
    return poly.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def generator_poly(m: int, t: int = DEFAULT_T) -> np.ndarray:
    """Generator polynomial coefficients (low->high), degree t*m."""
    gf = field(m)
    g = np.array([1], dtype=np.uint8)
    for i in range(1, 2 * t, 2):
        mp = _minimal_poly(gf, i)
        conv = np.zeros(len(g) + len(mp) - 1, dtype=np.int64)
        for k, c in enumerate(mp):
            if c:
                conv[k:k + len(g)] ^= g
        g = (conv & 1).astype(np.uint8)
    assert len(g) - 1 == t * m
    return g


@functools.lru_cache(maxsize=None)
def _remainder_rows(k: int, m: int, t: int = DEFAULT_T) -> np.ndarray:
    """R[i] = x^(n-1-i) mod g(x) as bits [k, t*m] (parity high power first)."""
    g = generator_poly(m, t)
    nk = len(g) - 1
    gbits = g[:nk][::-1].astype(np.uint8)        # x^(nk-1) .. x^0 coefficients
    # state = current power's remainder, coefficients high->low
    rows = np.empty((k, nk), dtype=np.uint8)
    state = np.zeros(nk, dtype=np.uint8)
    state[-1] = 1                                 # x^0
    # advance to x^nk mod g
    for _ in range(nk):
        state = _shift_mod(state, gbits)
    rows[k - 1] = state                           # message bit k-1 -> x^(nk)
    for i in range(k - 2, -1, -1):
        state = _shift_mod(state, gbits)
        rows[i] = state
    return rows


def _shift_mod(state: np.ndarray, gbits: np.ndarray) -> np.ndarray:
    carry = state[0]
    out = np.roll(state, -1)
    out[-1] = 0
    if carry:
        out ^= gbits
    return out


def encode(msg_bits: np.ndarray, m: int, t: int = DEFAULT_T) -> np.ndarray:
    """[..., k] -> [..., k + t*m] systematic BCH codeword(s)."""
    msg_bits = np.asarray(msg_bits, dtype=np.uint8)
    k = msg_bits.shape[-1]
    rows = _remainder_rows(k, m, t)
    parity = np.mod(msg_bits.astype(np.int64) @ rows.astype(np.int64), 2)
    return np.concatenate([msg_bits, parity.astype(np.uint8)], axis=-1)


def parity_check_matrix(k: int, m: int, t: int = DEFAULT_T) -> np.ndarray:
    """[k + t*m, t*m] uint8 H^T such that codeword @ H^T == 0 (mod 2)."""
    rows = _remainder_rows(k, m, t)
    eye = np.eye(t * m, dtype=np.uint8)
    return np.concatenate([rows, eye], axis=0)


def syndromes(cw: np.ndarray, m: int, t: int = DEFAULT_T) -> np.ndarray:
    """S_j = r(alpha^j) for j = 1..2t; [2t] field elements."""
    gf = field(m)
    n = len(cw)
    pos = np.nonzero(np.asarray(cw, dtype=np.uint8))[0]
    e = (n - 1 - pos).astype(np.int64)            # exponents of set terms
    j = np.arange(1, 2 * t + 1)[:, None]
    vals = gf.pow_alpha(j * e[None, :])
    return np.bitwise_xor.reduce(vals, axis=1) if len(pos) else np.zeros(2 * t, dtype=np.int64)


def decode(cw: np.ndarray, m: int, t: int = DEFAULT_T) -> tuple[np.ndarray, int]:
    """Correct up to t errors in place; returns (corrected, n_errors).

    n_errors = -1 signals decoding failure (uncorrectable).
    """
    cw = np.asarray(cw, dtype=np.uint8).copy()
    s = syndromes(cw, m, t)
    if not s.any():
        return cw, 0
    gf = field(m)
    # Berlekamp-Massey over GF(2^m)
    C = np.zeros(2 * t + 1, dtype=np.int64); C[0] = 1
    B = C.copy()
    L, mm, b = 0, 1, 1
    for nn in range(2 * t):
        d = s[nn]
        for i in range(1, L + 1):
            d ^= gf.mul(C[i], s[nn - i])
        if d == 0:
            mm += 1
        elif 2 * L <= nn:
            T = C.copy()
            coef = gf.mul(d, gf.inv(b))
            shifted = np.zeros_like(B)
            shifted[mm:] = B[:len(B) - mm]
            C ^= gf.mul(coef, shifted)
            L, B, b, mm = nn + 1 - L, T, d, 1
        else:
            coef = gf.mul(d, gf.inv(b))
            shifted = np.zeros_like(B)
            shifted[mm:] = B[:len(B) - mm]
            C ^= gf.mul(coef, shifted)
            mm += 1
    if L > t:
        return cw, -1
    # Chien search: roots of C(x); error at position i iff C(alpha^-(n-1-i)) == 0
    n = len(cw)
    coeffs = C[:L + 1]
    exps = np.arange(n)
    e_exp = (n - 1 - exps).astype(np.int64)        # exponent of term for pos i
    acc = np.zeros(n, dtype=np.int64)
    for kk, ck in enumerate(coeffs):
        if ck:
            acc ^= gf.mul(ck, gf.pow_alpha(-kk * e_exp))
    err_pos = np.nonzero(acc == 0)[0]
    if len(err_pos) != L:
        return cw, -1
    cw[err_pos] ^= 1
    if syndromes(cw, m, t).any():
        return cw, -1
    return cw, int(L)
