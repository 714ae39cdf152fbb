"""What a wrapper works out on the host from a tensor it is given (a host
copy of taps, a kernel's table), kept for that tensor, so that a call
reads nothing back from the device after its first."""

from __future__ import annotations

from torch.utils.weak import WeakIdKeyDictionary


class PerTensor:
    """build() kept per (tensor, key). The tensor's entries die with it and
    are worked out again once it is written in place (its ``_version``
    moves)."""

    def __init__(self):
        self._hits = WeakIdKeyDictionary()

    def get(self, t, key, build):
        hit = self._hits.get(t)
        if hit is None or hit[0] != t._version:
            hit = self._hits[t] = (t._version, {})
        if key not in hit[1]:
            hit[1][key] = build()
        return hit[1][key]
