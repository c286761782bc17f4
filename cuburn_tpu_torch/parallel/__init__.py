"""Rendering on several devices.

Two ways, as in `cuburn_tpu/parallel/`: `shard.ShardedRenderer` splits
one frame over the ranks of a `torch.distributed` group, one process a
device (`launch.spawn`); `farm` hands whole frames to workers over TCP.
"""
