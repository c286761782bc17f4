"""cuburn_tpu_torch — the cuburn-tpu fractal-flame renderer on PyTorch
and CUDA.

A port of `cuburn_tpu` (JAX on a TPU) for one NVIDIA H100.  Module
names mirror `cuburn_tpu/`.  The port imports nothing of `cuburn_tpu`:
the host layers that never used JAX — `genome/`, `models/`,
`profile.py`, `output.py` and the command line's parser — are copies
kept here, and a genome of the JAX package crosses over through its
JSON form (`params.genome_from_jax`).  Plain tensor work is PyTorch;
every Pallas kernel of the JAX package has a hand-written CUDA
counterpart for sm_90a in `csrc/`, built at first use by
`kernels/build.py`:

  win_flush.cu        windowed flush (backend pallas_win)
  scatter_flush.cu    atomic flushes (backends pallas, pallas_merged,
                      and the port's own atomic, the default: pallas's
                      flush on pallas_win's 8-bit records, unsorted; a
                      TPU has no scatter-add, so JAX has no counterpart)
  win_flush_rgb16.cu  windowed flush into f32 density + bf16 rgb
                      (backend pallas_rgb16)
  bitonic_sort.cu     tiled bitonic sort (ops/tiled_sort.py)
  tile_scan.cuh       the pass over a tile of sorted records that the two
                      windowed flushes share

  device.py     — explicit device resolution; never picks CPU by itself
  params.py     — GenomeParams and iteration state as tensors
  genome/, models/, profile.py, output.py — host layers (copies)
  ops/          — RNG, camera, variations, xforms, iterate, sort,
                  flush, histogram, filtering, density estimation
  render.py     — Renderer.render_frame: accumulate, then filter
  parallel/     — a frame over several devices, one process each
                  (shard.py, launch.py), and the frame farm (farm.py)
  main.py       — the `cuburn-tpu-torch` command line
"""

__version__ = "0.1.0"
