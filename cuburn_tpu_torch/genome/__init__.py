"""Genome layer: flam3-compatible schema, splines, conversion, palettes.

The port's own copy of `cuburn_tpu/genome/` (the reference's
cuburn/genome/ package, SURVEY.md §2 layer 3).  Everything here is
host-side plain Python / numpy; device code only ever sees evaluated
parameter records.
"""

from cuburn_tpu_torch.genome.spline import Spline
from cuburn_tpu_torch.genome.specs import Genome, XForm, GenomeParams

__all__ = ["Spline", "Genome", "XForm", "GenomeParams"]
