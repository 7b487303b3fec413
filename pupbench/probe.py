"""The phase timers of the ``PileUpper`` that ``coolpuppy_tpu_torch.pileup``
builds, reached by a probe: within the block the engine's ``PileUpper`` is
a subclass that records each instance, and ``seconds()`` returns the
``PhaseTimers`` seconds of the last one. ``pileup()`` does not return its
``PileUpper``; the probe goes once it does."""

from __future__ import annotations

import importlib

ENGINE = "coolpuppy_tpu_torch.engine.pileup"


class PhaseProbe:
    def __enter__(self):
        self.engine = importlib.import_module(ENGINE)
        self.saved = self.engine.PileUpper
        probe = self
        self.last = None

        class Recorded(self.saved):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                probe.last = self

        self.engine.PileUpper = Recorded
        return self

    def __exit__(self, *exc):
        self.engine.PileUpper = self.saved

    def seconds(self):
        """The last job's phase seconds, and forget it."""
        last, self.last = self.last, None
        if last is None or last.timers is None:
            return {}
        return dict(last.timers.seconds)
