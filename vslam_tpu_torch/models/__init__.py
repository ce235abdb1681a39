from . import superpoint  # noqa: F401
