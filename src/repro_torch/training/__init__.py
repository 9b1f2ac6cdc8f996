"""Training substrate of the port: AdamW, checkpoints, and the pytree order
both share with the reference (``tree``)."""
