"""Training-data input: manifests, the corpus banks on the device, the
streaming loader and the on-device training batch."""

from nhans_tpu_torch.data.manifest import (  # noqa: F401
    create_seeds,
    create_speech_seeds,
    create_noise_seeds,
    load_seeds,
)
