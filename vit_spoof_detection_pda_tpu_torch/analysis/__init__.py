"""Score analysis: ``calibration.py`` (temperature scaling)."""
