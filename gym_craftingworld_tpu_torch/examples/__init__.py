"""Examples of the port's public API (``python -m gym_craftingworld_tpu_torch.examples.<name>``)."""
