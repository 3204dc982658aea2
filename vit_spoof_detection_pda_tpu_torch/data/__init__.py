"""Host-side data: ``loader.py`` (image decoding for the serving front)."""
