"""Host syncs a round: the admission thread's reads of a device value
(``utils/device.py:SYNCS``) over the window's rounds, the metric timer's
left out."""


def read(t):
    return t.host_syncs / t.rounds if t.rounds else None
