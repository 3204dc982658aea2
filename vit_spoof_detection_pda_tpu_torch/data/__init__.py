"""Host-side data: ``conventions.py`` (labels), ``manifest.py`` (scans,
splits, manifests) and ``loader.py`` (decoding, the threaded pipeline,
device prefetch)."""
