"""Rational approximation of period ratios for harmonic identification
(parity: reference utils/approx_harm.py).

Continued-fraction expansion of a/b, stopping at the first convergent within
0.01 of the true ratio.

A copy of ``pypulsar_tpu/utils/approx_harm.py``
(the port imports nothing of the JAX package).
"""


def approx_harm(a, b, maxsteps=20):
    """Return (m, n) with m/n ~ a/b (within 0.01), or None if no convergent
    is found in ``maxsteps``."""
    q = [float("nan"), float("nan")]
    m = [0, 1]
    n = [1, 0]
    x, y = a, b
    origfrac = float(a) / float(b)
    for k in range(2, maxsteps + 2):
        if y == 0:
            break
        q.append(int(x / y))
        x, y = y, x % y
        m.append(q[k] * m[k - 1] + m[k - 2])
        n.append(q[k] * n[k - 1] + n[k - 2])
        if n[k]:
            if abs(origfrac - float(m[k]) / float(n[k])) < 0.01:
                return m[k], n[k]
    return None


def output_harm(a, b):
    """Human-readable harmonic ratio: 'm/n +/- err', or the plain float for
    high-order ratios."""
    result = approx_harm(a, b)
    origfrac = float(a) / float(b)
    if result is None:
        return "%f" % origfrac
    m, k = result
    if m > 9 and k > 9:
        return "%f" % origfrac
    frac = "%d/%d" % (m, k)
    err = origfrac - float(m) / float(k)
    if err > 0:
        return "%s + %.2g" % (frac, abs(err))
    if err < 0:
        return "%s - %.2g" % (frac, abs(err))
    return frac


def main(argv=None):
    import sys

    args = argv if argv is not None else sys.argv[1:]
    print(output_harm(float(args[0]), float(args[1])))


if __name__ == "__main__":
    main()
