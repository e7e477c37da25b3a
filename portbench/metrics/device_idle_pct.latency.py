"""``device_idle_pct`` in the cells whose end-to-end metric is ``frame_ms_p90``: the same
reader, under the name whose ``moves`` is that metric."""

from portbench.metrics.device_idle_pct import read  # noqa: F401
