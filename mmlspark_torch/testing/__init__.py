"""Test infrastructure of the port: the control plane's scenario harness
(``testing.benchmarks``). The fuzzing traits, the benchmark CSV harness
and the rest of the JAX package's ``testing`` come with ROADMAP.md §1
item 11.
"""
