"""cuburn_tpu_torch — the cuburn-tpu fractal-flame renderer on PyTorch
and CUDA.

A port of `cuburn_tpu` (JAX on a TPU) for one NVIDIA H100.  Module
names mirror `cuburn_tpu/`.  The host layers that never used JAX —
`cuburn_tpu.genome`, `cuburn_tpu.models`, `cuburn_tpu.profile` and
`cuburn_tpu.output` — are imported from there, not copied.  Plain
tensor work is PyTorch; the kernel that carries the main path, the
windowed histogram flush, is hand-written CUDA for sm_90a
(`csrc/win_flush.cu`, built at first use by `kernels/build.py`).

  device.py     — explicit device resolution; never picks CPU by itself
  params.py     — GenomeParams and iteration state as tensors
  ops/          — RNG, camera, variations, xforms, iterate, sort,
                  flush, histogram, filtering, density estimation
  render.py     — Renderer.render_frame: accumulate, then filter
  main.py       — the `cuburn-tpu-torch` command line (stills)
"""

__version__ = "0.1.0"
