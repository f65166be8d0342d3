"""Plot helpers (parity: reference utils/plot_utils.py). matplotlib is
imported lazily so headless pipelines never pay for it.

A copy of ``pypulsar_tpu/utils/plot_utils.py``
(the port imports nothing of the JAX package).
"""

import numpy as np


def hist(xx, bins, tot=None, bottom=None, *args, **kwargs):
    """Normalized filled step histogram. Returns (counts, edges); counts are
    scaled by ``tot`` (default: len(xx)) and stacked on ``bottom`` if given."""
    import matplotlib.pyplot as plt

    tot = float(len(xx)) if tot is None else float(tot)
    counts, edges = np.histogram(xx, bins=bins)
    counts = counts / tot
    if bottom is not None:
        counts = counts + bottom
    # build the step outline from the returned edges so an integer bin count
    # works too (np.histogram accepts both)
    x = np.asarray(edges).repeat(2)
    y = np.zeros(len(edges) * 2)
    y[1:-1] = counts.repeat(2)
    plt.fill(x, y, *args, **kwargs)
    return counts, edges
