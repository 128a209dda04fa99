"""Huffman code lengths for the regression eval's bits-per-parameter
accounting (port of ``huffman_code_lengths`` in
boosting_nerv_tpu/compress/huffman.py): only the code table's lengths are
used, no bitstream is written."""

from __future__ import annotations

import heapq
import itertools
from typing import Dict


def huffman_code_lengths(counts: Dict) -> Dict:
    """Symbol -> Huffman code length (bits) for the frequency table."""
    if not counts:
        return {}
    if len(counts) == 1:
        return {next(iter(counts)): 1}
    tiebreak = itertools.count()
    heap = [(freq, next(tiebreak), [sym]) for sym, freq in counts.items()]
    heapq.heapify(heap)
    lengths = {sym: 0 for sym in counts}
    while len(heap) > 1:
        f1, _, syms1 = heapq.heappop(heap)
        f2, _, syms2 = heapq.heappop(heap)
        for s in syms1 + syms2:
            lengths[s] += 1
        heapq.heappush(heap, (f1 + f2, next(tiebreak), syms1 + syms2))
    return lengths
