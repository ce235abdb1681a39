"""Place recognition, loop closure and relocalization (port of
``vslam_tpu/loop``)."""
