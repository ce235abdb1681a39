from . import checkpoint, metrics  # noqa: F401
