"""Per-application glue, one file per ``app`` a configuration names.

Each module gives ``build(config, seed, device) -> System``, ``judge(system,
queries, results, config) -> {check: value}`` and ``control(system, queries,
config) -> results``.  ``build`` makes the inputs from the seed and hands them
to the port's own constructors; ``judge`` reads only the inputs the
benchmark made and the answers it is given; ``control`` answers the same
queries in the program's place, in the program's form, for ``judge``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class System:
    """What a run drives and what its check reads.

    engine : the port's engine (``submit``/``pump``)
    pool   : vertices queries are drawn from
    views  : view name -> (V,) out-degree of that view, from the inputs
    data   : the benchmark's own inputs, for the reference
    """

    engine: Any
    pool: np.ndarray
    views: dict
    data: dict

    def release(self) -> None:
        """Drop the port's state, so the reference runs on a freed card."""
        self.engine = None
