"""Weight formats shared with the JAX package, and the one-way importer
for the published TF N-HANS checkpoints (reference ``trained_model/``
Saver triplets) into the port's flat flax-named variables, with no
TensorFlow dependency."""

from nhans_tpu_torch.compat.tf_bundle import TFBundleReader  # noqa: F401
from nhans_tpu_torch.compat.tf_import import (  # noqa: F401
    import_tf_checkpoint,
    tf_name_map,
)
