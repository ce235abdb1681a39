"""Offline tools: stereo calibration and the dataset viewer (port of
``vslam_tpu/tools``)."""
