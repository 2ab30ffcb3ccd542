"""The per-stream scratch of the single-pass kernels (``csrc/compact.cu``,
``csrc/scan.cu``): zeroed 64-bit words, a fixed number per tile, and two
zeroed u32 counters, which every launch leaves zeroed again.

One ``StreamScratch`` per kernel keeps its scratch per (device, stream),
so that launches enqueued on two streams never share a ticket.  It
allocates at first use and when a call needs more tiles than the words
hold, and keeps at most ``max_streams`` streams: past it the oldest entry
is freed, and its stream, if it comes back, gets a new one.  PyTorch
hands out its streams from a pool of 32 per priority and device, so only
external streams reach that bound.  Freeing is safe: the allocator gives
the memory back only to later allocations on the same stream.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["StreamScratch"]


class StreamScratch:
    """``words_per_tile`` int64 words a tile, for at least ``min_tiles``
    tiles, and two int32 counters, per (device, raw stream)."""

    max_streams = 64

    def __init__(self, words_per_tile: int, min_tiles: int):
        self.words_per_tile = words_per_tile
        self.min_tiles = min_tiles
        #: (device, raw stream) -> (words, counters)
        self.entries: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def get(self, device: torch.device, stream: int,
            tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(words, counters) of this stream on ``device``, the words a
        (words_per_tile, capacity) view holding at least ``tiles`` tiles."""
        key = (device, stream)
        s = self.entries.get(key)
        if s is None or s[0].shape[1] < tiles:
            cap = max(tiles, self.min_tiles, 2 * s[0].shape[1] if s else 0)
            s = (torch.zeros(self.words_per_tile, cap, dtype=torch.int64,
                             device=device),
                 torch.zeros(2, dtype=torch.int32, device=device))
            self.entries[key] = s
            while len(self.entries) > self.max_streams:
                del self.entries[next(iter(self.entries))]
        return s
