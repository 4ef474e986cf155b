"""Spans around the calls into the program's layers, recorded from the
benchmark's side: a wrapper is installed at the name the caller looks up
(module attribute), synchronises the device before and after the call, and
records (layer, name, request, t0, t1) on the host clock. Only the outermost
call of a layer is recorded, so a layer's calls that nest (the assessment
view's prep inside `_assessment_view_from_if`) count once. Installed only in
the traced run."""

from __future__ import annotations

import contextlib
import importlib
import time


class SpanLog:
    def __init__(self, sync):
        self.sync = sync
        self.spans = []          # (layer, name, request, t0, t1)
        self.request = None
        self._open = set()

    def wrap(self, layer: str, target: str):
        """Replace module attribute `target` ("pkg.mod:attr") by a recording
        wrapper; returns the undo."""
        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        real = getattr(mod, attr)
        log = self

        def spy(*args, **kwargs):
            if layer in log._open or log.request is None:
                return real(*args, **kwargs)
            log._open.add(layer)
            log.sync()
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                log.sync()
                log.spans.append((layer, attr, log.request, t0, time.perf_counter()))
                log._open.discard(layer)

        setattr(mod, attr, spy)
        return lambda: setattr(mod, attr, real)

    @contextlib.contextmanager
    def installed(self, targets):
        """targets: [(layer, "pkg.mod:attr"), ...]."""
        undo = [self.wrap(layer, t) for layer, t in targets]
        try:
            yield self
        finally:
            for u in reversed(undo):
                u()

    def of_request(self, i: int, layer: str = None):
        return [s for s in self.spans if s[2] == i and (layer is None or s[0] == layer)]
