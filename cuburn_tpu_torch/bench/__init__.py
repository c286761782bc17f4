"""The system's own measurement and on-device validation tools.

Ports of the JAX package's `bench.py` and `bench/` tools, each an entry
point that runs on the card unless it is passed `--cpu` (without a GPU
it raises at once):

  python -m cuburn_tpu_torch.bench             the headline samples/s JSON
                                               line (bench.py)
  python -m cuburn_tpu_torch.bench.configs     BASELINE.md's five binding
                                               configurations (bench/configs.py)
  python -m cuburn_tpu_torch.bench.parity      a whole render, card against
                                               CPU (bench/tpuparity.py)
  python -m cuburn_tpu_torch.bench.tileddiff   scatter against pallas_win,
                                               bin by bin, past L2
                                               (bench/tileddiff.py)
  python -m cuburn_tpu_torch.bench.sortbench   every histogram backend
                                               against a numpy bincount
                                               (sortbench.py)
  python -m cuburn_tpu_torch.bench.breakdown   the render loop stage by
                                               stage (bench/breakdown.py)

Each prints JSON lines and exits non-zero when a check it makes fails.
`_card` holds what they share.
"""
