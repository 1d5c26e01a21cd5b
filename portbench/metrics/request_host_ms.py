"""request_host_ms: total length of the program's serving spans
(``serve_load``, ``serve_upload``, ``serve_fetch``, ``serve_detok``)
over its requests, one ``serve_upload`` each (the greedy captioner has
no load, fetch or words of its own; its caller does them)."""

from ._spans import ms_per

SERVE = ("serve_load", "serve_upload", "serve_fetch", "serve_detok")


def read(reading):
    return ms_per(reading, SERVE, ("serve_upload",))
