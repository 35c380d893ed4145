"""elxbench: the benchmark of elementalx_torch on NVIDIA GPUs.

``run.py`` is the command; ``README.md`` says how a cell, a configuration
or a per-layer metric is added as files.
"""
