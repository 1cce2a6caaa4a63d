"""Developer scripts of the port (counterparts of the repository's
``scripts/dev_smoke.py`` and ``scripts/paged_smoke.py``)."""
