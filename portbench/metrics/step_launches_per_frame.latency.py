"""``step_launches_per_frame`` in the cells whose end-to-end metric is ``frame_ms_p90``: the same
reader, under the name whose ``moves`` is that metric."""

from portbench.metrics.step_launches_per_frame import read  # noqa: F401
