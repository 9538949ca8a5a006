"""Training-data input: manifests, the corpus banks on the device, the
streaming loader and the on-device training batch."""
