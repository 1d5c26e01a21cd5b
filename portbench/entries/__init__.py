"""The entries a cell's window drives, one module each, named by the
traffic file's ``entry``. Each has ``build(cell)``, ``window(state,
seconds)``, ``traced(state, tracer)`` and ``check(state)``
(``portbench/harness.py`` calls them in that order)."""
