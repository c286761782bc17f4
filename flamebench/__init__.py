"""flamebench: the benchmark of cuburn_tpu_torch, the PyTorch and CUDA
renderer of fractal flames, on NVIDIA cards.

`python -m flamebench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the repository's BENCHMARK.json.  The
package holds the harness (`harness.py`), the discovery of cells,
configurations, mixes and metrics by name (`spec.py`), the yardstick
(`roofline.py`: peaks and each function's work; `trace.py`: the
profiler's trace reduced to spans; `compare.py`: what decides
`correct`), and the plain reference the program is held to
(`reference/`).  It imports neither JAX nor the JAX package.
"""
