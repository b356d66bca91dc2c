"""The reference's `segment_anything_cs` names on this package.

`from crowdsam_tpu_torch.segment_anything_cs import sam_model_registry,
SamPredictor, SamAutomaticMaskGenerator` gives the same names as the JAX
package's `crowdsam_tpu.segment_anything_cs`; `build_sam` is
`build_sam_vit_h`, as there.
"""

from crowdsam_tpu_torch.models.build import (  # noqa: F401
    build_sam,
    build_sam_vit_b,
    build_sam_vit_h,
    build_sam_vit_l,
    sam_model_registry,
)
from crowdsam_tpu_torch.pipeline.amg_generator import (  # noqa: F401
    SamAutomaticMaskGenerator,
)
from crowdsam_tpu_torch.pipeline.predictor import SamPredictor  # noqa: F401
