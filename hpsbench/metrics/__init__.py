"""Per-layer metrics: ``metrics/<base>.py`` reads every metric whose name
starts with ``<base>`` and a dot (``k1_roofline.b64`` -> ``k1_roofline``).

Each module has ``read(ctx) -> float | None``: the metric from the run's
spans, counters or profiled slice (``hpsbench.run.Context``), or None where
it finds nothing to read; the harness then leaves the metric out of the
line. A share of a roofline or of a peak is never made up as 0.
"""

from __future__ import annotations

import importlib


def reader(name: str):
    return importlib.import_module(f"hpsbench.metrics.{name.split('.')[0]}")
