"""``fused_frame_ms`` in the cells whose end-to-end metric is ``frame_ms_p90``: the same
reader, under the name whose ``moves`` is that metric."""

from portbench.metrics.fused_frame_ms import read  # noqa: F401
