"""The benchmark of ``orbslam_in_practice_tpu_torch`` on the H100: one
cell a run, driven by ``BENCHMARK.json`` and the data files here
(``python3 -m portbench.run``)."""
