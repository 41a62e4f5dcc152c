"""Ports of the JAX package's ``examples/`` scripts, run as modules
(``python -m apex_tpu_torch.examples.<name>``)."""
