"""`python -m cuburn_tpu_torch.bench`: the headline (headline.py)."""

from cuburn_tpu_torch.bench.headline import main

if __name__ == "__main__":
    raise SystemExit(main())
