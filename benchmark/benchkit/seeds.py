"""Seeds for each purpose of one run, all drawn from the run's ``--seed``."""
from __future__ import annotations

import numpy as np

TRAFFIC, DENSE, TABLE = 1, 2, 3  # the purposes sub_seed tells apart


def sub_seed(seed: int, *tags: int) -> int:
    """A generator seed under 2^63 for one purpose of one run's seed (any
    non-negative whole number, also past 32 bits)."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))
