from . import overlays  # noqa: F401
