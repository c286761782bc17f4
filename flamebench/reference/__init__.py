"""The plain reference of the benchmark: a frozen copy of the plain
path of `cuburn_tpu_torch` (commit e39ad89), imports pointed here, and
`render.py`, the frame pipeline built from it.  It imports nothing of
the program, so a change to the program cannot move what `correct` is
judged against."""
