"""Draft-model-free speculative drafting: per-slot n-gram suffix lookup
(copy of serving/spec.py; pure Python, no tensors).

Decode is bound by the bytes of the KV cache it reads, so verifying k
drafted tokens in ONE multi-query attention pass buys up to (k+1) tokens
per step at about the same bytes moved. The draft source needs no model:
generations repeat their own prompt and history, so the continuation of
the current suffix n-gram's most recent earlier occurrence is a strong
proposal on repetitive text and a harmless one elsewhere (a wrong draft
costs only the wasted verify rows; rollback is the engine's set-length
commit).

`NgramDraftIndex` holds, per slot, the token history (prompt + committed
tokens, both already on the host at the scheduling boundary, so drafting
adds no device syncs) and a bounded map from recent n-grams to their
occurrence positions. `propose(slot, k)` matches the longest suffix gram
(n = max_ngram..min_ngram) that recurs earlier WITH a continuation and
returns up to k continuation tokens.

Proposals are a pure function of the committed history (no clock, no
random numbers), so a rerun derives identical drafts.

Environment knobs (read by the engine):
- `DL4J_TPU_SPEC_DECODE=1` enables speculative decode (default off);
- `DL4J_TPU_SPEC_DRAFT`    max draft tokens per step (default 4);
- `DL4J_TPU_SPEC_NGRAM`    longest suffix gram to match (default 3).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_DRAFT = 4
DEFAULT_NGRAM = 3


def resolve_spec_decode(spec_decode: Optional[bool] = None) -> bool:
    """Engine-level enable: explicit argument wins, else the env knob."""
    if spec_decode is not None:
        return bool(spec_decode)
    return os.environ.get("DL4J_TPU_SPEC_DECODE", "0") == "1"


def resolve_spec_draft(spec_draft: Optional[int] = None) -> int:
    """Max draft tokens proposed per spec step (>= 1)."""
    if spec_draft is None:
        spec_draft = int(os.environ.get("DL4J_TPU_SPEC_DRAFT",
                                        str(DEFAULT_DRAFT)))
    return max(1, int(spec_draft))


class NgramDraftIndex:
    """Per-slot suffix-match index over host-visible token history.

    max_ngram/min_ngram: the suffix gram lengths tried, longest first.
    positions_per_gram: retention cap per gram; a proposal wants the MOST
    RECENT occurrence that still has a continuation, so a short
    most-recent-first list suffices and bounds memory."""

    def __init__(self, max_ngram: Optional[int] = None, min_ngram: int = 1,
                 positions_per_gram: int = 4):
        if max_ngram is None:
            max_ngram = int(os.environ.get("DL4J_TPU_SPEC_NGRAM",
                                           str(DEFAULT_NGRAM)))
        self.max_ngram = max(1, int(max_ngram))
        self.min_ngram = max(1, min(int(min_ngram), self.max_ngram))
        self.positions_per_gram = max(1, int(positions_per_gram))
        self._tokens: Dict[int, List[int]] = {}
        # slot -> gram tuple -> start positions, most recent first
        self._grams: Dict[int, Dict[Tuple[int, ...], List[int]]] = {}

    def reset(self, slot: int, tokens: Sequence[int]) -> None:
        """(Re)build the slot's index from its prompt (admission time)."""
        self._tokens[slot] = []
        self._grams[slot] = {}
        self.extend(slot, tokens)

    def drop(self, slot: int) -> None:
        """Forget a retired slot's history."""
        self._tokens.pop(slot, None)
        self._grams.pop(slot, None)

    def extend(self, slot: int, tokens: Sequence[int]) -> None:
        """Append committed tokens (the prompt at reset, then each
        readback), indexing every gram ending at each new position."""
        if slot not in self._tokens:
            self._tokens[slot] = []
            self._grams[slot] = {}
        hist = self._tokens[slot]
        grams = self._grams[slot]
        for t in tokens:
            hist.append(int(t))
            p_end = len(hist)
            for n in range(self.min_ngram, self.max_ngram + 1):
                if p_end < n:
                    break
                g = tuple(hist[p_end - n:p_end])
                lst = grams.setdefault(g, [])
                lst.insert(0, p_end - n)
                del lst[self.positions_per_gram:]

    def history_len(self, slot: int) -> int:
        return len(self._tokens.get(slot, ()))

    def propose(self, slot: int, max_tokens: int) -> List[int]:
        """Draft up to `max_tokens` continuation tokens for the slot's
        current suffix: longest gram first, most recent occurrence that is
        NOT the suffix itself. Returns [] when nothing matches; the engine
        then runs the slot as a plain decode row (draft length 0)."""
        hist = self._tokens.get(slot)
        if not hist or max_tokens < 1:
            return []
        T = len(hist)
        grams = self._grams[slot]
        for n in range(min(self.max_ngram, T), self.min_ngram - 1, -1):
            suffix = tuple(hist[T - n:T])
            for start in grams.get(suffix, ()):
                cont = start + n
                if cont >= T:
                    continue            # the suffix occurrence itself
                return hist[cont:cont + max_tokens]
        return []
