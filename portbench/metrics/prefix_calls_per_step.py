"""Calls of the segmented prefix by the rule slots (``models/flow.py`` and
``models/param_flow.py``, as they bind it) an entry step, over the
window."""


def read(t):
    return t.prefix_calls / t.rounds if t.rounds else None
