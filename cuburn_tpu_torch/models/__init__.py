"""Built-in genome gallery, including the binding benchmark configs."""

from cuburn_tpu_torch.models.gallery import (GALLERY, get_genome, sierpinski,
                                       classic_swirl, full_feature,
                                       animated_spark)

__all__ = ["GALLERY", "get_genome", "sierpinski", "classic_swirl",
           "full_feature", "animated_spark"]
