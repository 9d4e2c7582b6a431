"""The paper's Table 3 golden values, the port's own copy.

Copied from ``benchmarks/table3_nrmse.py`` (``ROWS`` and ``PAPER``), which
imports JAX: NRMSE of frequency-moment estimates from ell_p samples, n =
10^4, k = 100, CountSketch ~ k x 31 (paper Sec. 7).
"""

ROWS = [  # (p, alpha, power)  -- the five Table 3 rows
    (2.0, 2.0, 3.0),
    (2.0, 2.0, 2.0),
    (1.0, 2.0, 1.0),
    (1.0, 1.0, 3.0),
    (1.0, 2.0, 3.0),
]

# Paper Table 3 reference values (NRMSE):
PAPER = {
    (2.0, 2.0, 3.0): dict(wr=1.16e-4, wor=2.09e-11, one=1.06e-3,
                          two=2.08e-11),
    (2.0, 2.0, 2.0): dict(wr=7.96e-5, wor=1.26e-7, one=1.14e-2,
                          two=1.25e-7),
    (1.0, 2.0, 1.0): dict(wr=9.51e-3, wor=1.60e-3, one=2.79e-2,
                          two=1.60e-3),
    (1.0, 1.0, 3.0): dict(wr=3.59e-1, wor=5.73e-3, one=5.14e-3,
                          two=5.72e-3),
    (1.0, 2.0, 3.0): dict(wr=3.45e-4, wor=7.34e-10, one=5.11e-5,
                          two=7.38e-10),
}
