"""``patch_roofline`` in the cells whose end-to-end metric is ``frame_ms_p90``: the same
reader, under the name whose ``moves`` is that metric."""

from portbench.metrics.patch_roofline import read  # noqa: F401
