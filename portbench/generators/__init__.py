"""The general generator of the benchmark's traffic: one module per kind
of call, named by a traffic file's ``generator`` and given the file's
parameters.  Each defines ``Generator(run)`` with ``setup()``, ``call(k)
-> (output, units)``, ``counters()``, ``counts()``, ``release()``,
``check(kept) -> {name: (value, limit)}`` and ``notes()``."""
