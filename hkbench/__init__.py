"""The benchmark of the PyTorch and CUDA port (hekaton_tpu_torch); BENCHMARK.json at the root names its cells."""
