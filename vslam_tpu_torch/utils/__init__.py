from . import checkpoint, metrics, tracks  # noqa: F401
