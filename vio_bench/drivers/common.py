"""What the drivers share: the check's sampler."""
from __future__ import annotations

import numpy as np


class Sampler:
    """Keeps the program's states before and after the ticks the check
    samples, and in them `n_rows` rows, half from each half of the batch,
    and the row whose start is checked, all drawn from the run's seed. The
    ticks are `n_ticks` of the window's first `within`, one from each of
    `n_ticks` equal stretches of them, so that they cover the filling
    window and the full one alike. Holds references only: the program
    builds its states out of place, so nothing is copied inside the
    window."""

    def __init__(self, seed: int, B: int, n_ticks: int, n_rows: int,
                 within: int):
        rng = np.random.default_rng([int(seed), 7])
        edges = np.linspace(0, within, n_ticks + 1).astype(int)
        self.ticks = {int(rng.integers(lo, max(hi, lo + 1)))
                      for lo, hi in zip(edges, edges[1:])}
        half, lo = B // 2, n_rows // 2
        rows = set(rng.choice(max(half, 1), min(lo, max(half, 1)),
                              replace=False).tolist())
        rows |= set((half + rng.choice(B - half, min(n_rows - lo, B - half),
                                       replace=False)).tolist())
        self.rows = sorted(rows)
        self.start_row = int(rng.integers(B))  # the row the start is held on
        self.i, self.kept, self._pending = 0, [], None

    def pending(self) -> bool:
        """Whether a sampled tick is still to come."""
        return self.i <= max(self.ticks)

    def before(self, k: int, states: tuple):
        self._pending = (k, states) if self.i in self.ticks else None

    def after(self, states: tuple):
        if self._pending is not None:
            self.kept.append((*self._pending, states))
        self.i += 1

    def rows_of(self, row) -> list:
        """[(frame, row r, states before, states after)] with each state's
        row r taken by row(tree, r)."""
        out = []
        for k, before, after in self.kept:
            for r in self.rows:
                out.append((k, r, tuple(row(x, r) for x in before),
                            tuple(row(x, r) for x in after)))
        return out
