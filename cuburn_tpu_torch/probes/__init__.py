"""Silicon probes: small kernels that isolate one mechanism of a larger
one and hold it against its plain version on the card.

`bf16probe` is the counterpart of `bench/bf16probe.py`: the rgb16 split
flush's bf16 staging through on-chip memory, and its write-back
skeleton, as bulk-copy kernels for Hopper.
"""
