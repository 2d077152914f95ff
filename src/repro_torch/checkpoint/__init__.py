"""Checkpoints in the reference's msgpack format (``io``), written and
read by the port's own codec (``codec``)."""
from repro_torch.checkpoint.io import load_pytree, save_pytree  # noqa: F401
