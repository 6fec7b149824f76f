"""The benchmark of ``xugrid_tpu_torch`` on the H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix or metric is a file of its own
here, found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``generator`` names
``generators/<generator>.py``), ``metrics/<metric>.py``.  ``reference/`` holds
the plain computations that decide ``correct``; it imports nothing of
the port.
"""
