"""Host-side data: ``conventions.py`` (labels), ``manifest.py`` (scans,
splits, manifests), ``loader.py`` (decoding, the threaded pipeline,
device prefetch), ``shards.py`` (the decode-once memmapped shard store)
and ``native`` (the libjpeg/libpng codec, built at first use)."""
